"""Inference serving of the port (counterpart of ``mxtpu/serving``).

* ``BucketSpec`` / ``Predictor`` (``engine``): declared shape buckets, one
  captured CUDA graph per bucket on the card, pad-up and slice-back, a
  parameter snapshot of its own, int8 weights;
* ``MicroBatcher`` (``batcher``): bounded-queue dynamic micro-batching,
  deadlines, priority classes, shedding and fault points;
* ``ReplicaSet`` / ``ReplicaDispatcher`` (``replicas``): one warmed
  Predictor per device, least-loaded routing, a wedge watchdog with
  exactly-once re-dispatch and per-replica circuit breakers;
* ``ServingController`` (``controller``): predictive admission from a
  per-bucket latency model, autoscaling of a ReplicaSet with hysteresis,
  and replacement of a replica whose breaker stays open;
* ``ModelZoo`` / ``ZooScheduler`` / ``ZooVersion`` (``zoo``): several
  models over one device pool, placement by count and device bytes,
  page-in and eviction, tenant classes, canary rollout with promote and
  rollback;
* ``DecodeEngine`` / ``DecodeModel`` / ``DecodeFuture`` /
  ``KVCacheAccountant`` (``decode``): continuous-batching autoregressive
  decode over KV-cache slots, one captured graph per cohort bucket,
  rowed or paged KV, a prefix cache, speculative decoding, int8 KV, and
  the ledger that sheds by KV residency (``decode_bench`` holds the
  reference decode model);
* ``ModelServer`` (``server``): the HTTP front with ``/predict``,
  ``/healthz``, ``/metrics`` and drain, over one model or a zoo.
"""
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .controller import ServingController
from .decode import DecodeEngine, DecodeFuture, DecodeModel, KVCacheAccountant
from .engine import BucketSpec, Predictor, pad_nd
from .replicas import Replica, ReplicaDispatcher, ReplicaFailure, ReplicaSet
from .server import ModelServer
from .zoo import ModelZoo, ZooScheduler, ZooVersion

__all__ = ["BucketSpec", "Predictor", "pad_nd", "MicroBatcher", "QueueFull",
           "DeadlineExceeded", "Replica", "ReplicaSet", "ReplicaDispatcher",
           "ReplicaFailure", "ModelServer", "ServingController", "ModelZoo",
           "ZooScheduler", "ZooVersion", "DecodeEngine", "DecodeFuture",
           "DecodeModel", "KVCacheAccountant"]
