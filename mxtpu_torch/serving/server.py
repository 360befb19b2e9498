"""Load-shedding HTTP model server over the Predictor and MicroBatcher
(counterpart of ``mxtpu/serving/server.py``).

* **Admission control**: a full queue answers 503 now (``serving.shed``
  by reason) with a ``Retry-After`` from the attached
  :class:`~mxtpu_torch.serving.controller.ServingController`'s predicted
  drain time (1 s without one), a missed deadline 504, a request that
  admission refuses as malformed 400. A batch that fails after admission
  answers 503 for a replica failure and 500 for any other error (the JAX
  package answers 400 for every ``MXNetError``, which blames the client
  for the server).
* **Several models**: over a :class:`~mxtpu_torch.serving.zoo.
  ZooScheduler` a request names its ``model`` (and may pin a
  ``version``); an unknown one answers 404 with the known names.
* **Observability**: ``/metrics`` returns ``telemetry.snapshot()`` as JSON,
  or the Prometheus text exposition for ``Accept: text/plain``.
* **Graceful drain**: SIGTERM (``install_signal_handlers``) or
  :meth:`begin_drain` rejects new work with 503 while queued and in-flight
  batches finish and answer; :meth:`close` then stops the listener.

Stdlib-threaded (``ThreadingHTTPServer``): one handler thread parks per
in-flight request while the batcher's worker owns every device call. JSON
in and out; inputs are converted to the Predictor's template dtypes
(bfloat16, which numpy lacks, goes as float32 and is cast on the device).

Endpoints::

    POST /predict   {"data": [[...], ...], "deadline_ms": 250,
                     "priority": "interactive"|"batch",
                     "model": name, "version": v, "tenant": t}  (the last
                    three over a ZooScheduler)
                    -> 200 {"outputs": [...], "n": k, "trace_id": ...,
                            "e2e_ms": ..., "breakdown_ms": {stage: ms}}
                    -> 503 shed/draining/replica failure (Retry-After),
                       504 deadline, 400 bad request, 404 unknown model
                       or version, 500 failed batch
    GET  /healthz   {"status": "ok"|"degraded"|"unhealthy"|"draining",
                     "queue_depth": d, "replicas": [...],
                     "kv": {tag: {...}}, "controller": {...},
                     "zoo": {...}}
                    (each block where it applies)
    GET  /metrics   telemetry.snapshot() as JSON, or Prometheus text

On SIGTERM the drain thread first dumps ``flight_record("sigterm")`` (with
the queue depth) and flushes the telemetry sink.
"""
from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError, numpy_dtype
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .replicas import ReplicaDispatcher, ReplicaFailure, ReplicaSet
from .zoo import ZooScheduler

__all__ = ["ModelServer"]

_log = logging.getLogger("mxtpu_torch.serving")


def _json_dtype(dt):
    """The numpy dtype a JSON input is read as for a template dtype."""
    if dt is None:
        return None
    npdt = numpy_dtype(dt)
    return np.float32 if npdt == torch.bfloat16 else npdt


class ModelServer:
    """HTTP front for a :class:`~mxtpu_torch.serving.batcher.MicroBatcher`
    (a bare Predictor gets a default MicroBatcher, a ReplicaSet a
    ReplicaDispatcher) or a :class:`~mxtpu_torch.serving.zoo.ZooScheduler`
    (requests route by their ``model`` field). ``port=0`` picks a free
    port; ``address`` is the bound (host, port)."""

    def __init__(self, batcher, host="127.0.0.1", port=0,
                 request_timeout_s=30.0):
        self._zoo = None
        if isinstance(batcher, ZooScheduler):
            self._zoo = batcher
        elif isinstance(batcher, ReplicaSet):
            batcher = ReplicaDispatcher(batcher)
        elif not isinstance(batcher, MicroBatcher):
            batcher = MicroBatcher(batcher)
        self._batcher = batcher
        self._timeout = float(request_timeout_s)
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread = None
        self._drain_thread = None
        self._prev_handlers = {}
        self.draining = False

    @property
    def address(self):
        return self._httpd.server_address

    @property
    def batcher(self):
        return self._batcher

    # ---------------------------------------------------------------- running
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05}, daemon=True,
                name="mxtpu-serving-http")
            self._thread.start()
        return self

    def serve_forever(self):
        """Foreground mode (a deployment's main thread)."""
        self.install_signal_handlers()
        self._httpd.serve_forever(poll_interval=0.05)

    # ------------------------------------------------------------------ drain
    def install_signal_handlers(self, signals=(signal.SIGTERM,)):
        """SIGTERM -> graceful drain (main thread only; elsewhere call
        :meth:`begin_drain` on shutdown)."""
        try:
            for sig in signals:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        except ValueError:
            _log.warning("ModelServer: cannot install signal handlers off "
                         "the main thread; call begin_drain() on shutdown")
        return self

    def uninstall_signal_handlers(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    def _on_signal(self, signum, frame):
        # the handler only flips the flag; the drain runs on a thread
        self.draining = True
        telemetry.inc("serving.drains")
        t = threading.Thread(target=self._drain_with_flight, daemon=True,
                             name="mxtpu-serving-drain")
        self._drain_thread = t
        t.start()

    def _drain_with_flight(self):
        """The SIGTERM drain: the flight artifact and the sink's last
        window before the drain tears the state down."""
        telemetry.flight_record("sigterm", extra={
            "queue_depth": self._batcher.queue_depth})
        telemetry.flush()
        self.begin_drain()

    def begin_drain(self, timeout=None):
        """Reject new work, finish queued and in-flight batches; the
        listener stays up (503, ``/healthz`` "draining") until
        :meth:`close`. True when fully drained."""
        self.draining = True
        return self._batcher.drain(timeout=timeout)

    def close(self, timeout=5.0):
        """Drain, stop the batcher's worker, stop the listener."""
        self.begin_drain(timeout=timeout)
        self._batcher.close(timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.uninstall_signal_handlers()
        return self

    # ---------------------------------------------------------------- request
    def _retry_after(self):
        """The 503's ``Retry-After`` seconds: the attached controller's
        predicted time to drain the queue, 1 without a controller."""
        ctrl = getattr(self._batcher, "_controller", None)
        if ctrl is not None:
            try:
                return ctrl.retry_after_s()
            except Exception:  # noqa: BLE001 — a header, not control flow
                _log.debug("retry_after_s failed", exc_info=True)
        return 1

    def _handle_predict(self, body):
        """(status, payload, extra headers or None), on the handler
        thread, which parks on the future while the batcher coalesces."""
        if self.draining:
            telemetry.inc("serving.shed", tag="draining")
            return 503, {"error": "draining"}, \
                {"Retry-After": str(self._retry_after())}
        raw = body.get("inputs")
        if raw is None:
            raw = [body.get("data")]
        if not raw or raw[0] is None:
            return 400, {"error": "missing 'data' (or 'inputs') field"}, None
        model = version = None
        if self._zoo is not None:
            # the body names the model (404 with the known names) and may
            # pin a version (404 with that model's versions)
            reg = self._zoo.registry
            model = body.get("model")
            if not model:
                return 400, {"error": "missing 'model' field",
                             "known_models": reg.models()}, None
            if model not in reg.models():
                return 404, {"error": "unknown model %r" % (model,),
                             "known_models": reg.models()}, None
            version = body.get("version")
            if version is not None and version not in reg.versions(model):
                return 404, {"error": "unknown version %r of model %r"
                             % (version, model),
                             "known_versions": reg.versions(model)}, None
            templates = self._zoo.input_templates(model)
        else:
            templates = getattr(self._batcher._pred, "input_templates",
                                None)
        arrays = []
        for i, a in enumerate(raw):
            dtype = None
            if templates is not None and i < len(templates):
                dtype = _json_dtype(templates[i][1])
            try:
                arrays.append(np.asarray(a, dtype=dtype))
            except (ValueError, TypeError) as e:  # ragged/unconvertible
                return 400, {"error": "input %d not array-shaped: %s"
                             % (i, e)}, None
        try:
            # the batcher's deadline defaults to the handler's timeout: a
            # request the handler gave up on expires instead of running
            deadline_ms = body.get("deadline_ms", self._timeout * 1e3)
            if self._zoo is not None:
                fut = self._zoo.submit(model, tuple(arrays),
                                       tenant=body.get("tenant"),
                                       deadline_ms=deadline_ms,
                                       priority=body.get("priority"),
                                       version=version)
            else:
                fut = self._batcher.submit(
                    tuple(arrays), deadline_ms=deadline_ms,
                    priority=body.get("priority", "interactive"))
        except QueueFull as e:
            return 503, {"error": str(e)}, \
                {"Retry-After": str(self._retry_after())}
        except MXNetError as e:
            # admission refuses malformed requests: the client's fault
            return 400, {"error": str(e)}, None
        try:
            out = fut.result(timeout=self._timeout)
        except (QueueFull, ReplicaFailure) as e:
            return 503, {"error": str(e)}, \
                {"Retry-After": str(self._retry_after())}
        except DeadlineExceeded as e:
            return 504, {"error": str(e)}, None
        except Exception as e:  # noqa: BLE001 — the batch failed server-side
            return 500, {"error": "%s: %s" % (type(e).__name__, e)}, None
        outs = list(out) if isinstance(out, tuple) else [out]
        payload = {"outputs": [np.asarray(o).tolist() for o in outs],
                   "n": int(arrays[0].shape[0])}
        if fut.trace_id is not None:
            payload["trace_id"] = fut.trace_id
            payload["e2e_ms"] = round(fut.e2e_s * 1e3, 3)
            payload["breakdown_ms"] = {
                k: round(v * 1e3, 4)
                for k, v in sorted(fut.breakdown.items())}
        return 200, payload, None


def _make_handler(srv):
    class Handler(BaseHTTPRequestHandler):
        server_version = "mxtpu-serving/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            _log.debug("http %s", fmt % args)

        def _reply(self, code, payload, headers=None):
            body = json.dumps(payload, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = {
                    "status": "draining" if srv.draining else "ok",
                    "queue_depth": srv._batcher.queue_depth}
                states = getattr(srv._batcher, "replica_states", None)
                if callable(states):
                    reps = states()
                    payload["replicas"] = reps
                    healthy = sum(1 for r in reps
                                  if r["state"] == "healthy")
                    payload["healthy_replicas"] = healthy
                    if not srv.draining and healthy < len(reps):
                        payload["status"] = ("degraded" if healthy
                                             else "unhealthy")
                acct = getattr(getattr(srv._batcher, "replica_set", None),
                               "accountant", None)
                if acct is not None:
                    # KV residency per replica pool
                    payload["kv"] = acct.snapshot()
                if srv._zoo is not None:
                    payload["zoo"] = srv._zoo.view()
                ctrl = getattr(srv._batcher, "_controller", None)
                if ctrl is not None:
                    payload["controller"] = ctrl.view()
                self._reply(200, payload)
            elif self.path == "/metrics":
                accept = self.headers.get("Accept", "")
                if "text/plain" in accept or "openmetrics" in accept:
                    body = telemetry.prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; "
                                     "charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(200, telemetry.snapshot())
            else:
                self._reply(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path %s" % self.path})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": "bad json: %s" % e})
                return
            if not isinstance(body, dict):
                self._reply(400, {"error": "the body must be a JSON object"})
                return
            try:
                code, payload, headers = srv._handle_predict(body)
            except Exception as e:  # noqa: BLE001 — a handler crash must
                _log.exception("predict handler failed")  # answer, not hang
                code, payload, headers = 500, {"error": "%s: %s"
                                               % (type(e).__name__, e)}, None
            self._reply(code, payload, headers)

    return Handler
