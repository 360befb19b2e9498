"""Inference serving of the port (counterpart of ``mxtpu/serving``).

* ``BucketSpec`` / ``Predictor`` (``engine``): declared shape buckets, one
  captured CUDA graph per bucket on the card, pad-up and slice-back, a
  parameter snapshot of its own, int8 weights;
* ``MicroBatcher`` (``batcher``): bounded-queue dynamic micro-batching,
  deadlines, priority classes, shedding and fault points;
* ``ReplicaSet`` / ``ReplicaDispatcher`` (``replicas``): one warmed
  Predictor per device, least-loaded routing, a wedge watchdog with
  exactly-once re-dispatch and per-replica circuit breakers;
* ``ModelServer`` (``server``): the HTTP front with ``/predict``,
  ``/healthz``, ``/metrics`` and drain.

Not ported yet (ROADMAP A2): ``ServingController``, ``ModelZoo`` /
``ZooScheduler`` and ``DecodeEngine``.
"""
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .engine import BucketSpec, Predictor, pad_nd
from .replicas import Replica, ReplicaDispatcher, ReplicaFailure, ReplicaSet
from .server import ModelServer

__all__ = ["BucketSpec", "Predictor", "pad_nd", "MicroBatcher", "QueueFull",
           "DeadlineExceeded", "Replica", "ReplicaSet", "ReplicaDispatcher",
           "ReplicaFailure", "ModelServer"]
