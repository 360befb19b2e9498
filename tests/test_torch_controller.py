"""The port's SLO control plane (``mxtpu_torch/serving/controller.py`` and
the elastic ReplicaSet it drives) against the JAX package's on the CPU.

Both packages get the same weights, the same observed breakdowns and the
same fake-clock script through ``poll()``: each test holds the sequence of
``(action, reason)`` decisions, the predicted latency, ``retry_after_s``,
the attainment, the replica indices and states, and every answer (within
1e-5 of max|output|, float32) to the reference's. The port's replicas run
on CPU stand-ins ``cpu:<i>`` (``replicas.visible_devices`` patched), the
reference's on the eight virtual CPU devices. Predicted latencies and
attainments agree within 1e-9 (the same float64 arithmetic on the same
samples). Every future, urlopen and join has a timeout."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.gluon import nn as jnn
from mxtpu.serving import (BucketSpec as JBucketSpec,
                           KVCacheAccountant as JKVCacheAccountant,
                           ReplicaDispatcher as JReplicaDispatcher,
                           ReplicaSet as JReplicaSet,
                           ServingController as JServingController)
from mxtpu.serving import engine as jengine
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.serving import (BucketSpec, ModelServer,
                                 ReplicaDispatcher, ReplicaSet,
                                 ServingController)
from mxtpu_torch.serving import controller as tcontroller
from mxtpu_torch.serving import engine as tengine
from mxtpu_torch.serving import replicas as treplicas

IN_DIM, OUT_DIM = 12, 4
T = 30   # seconds any wait may take
# the shape of a delivered request's stage breakdown, with a service time
# far above the deadlines the predictive tests use
SLOW_BREAKDOWN = {"serving.queue_wait": 0.05, "serving.pad": 0.01,
                  "serving.predict": 0.19}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_TELEMETRY", "MXTPU_TRACE", "MXTPU_FAULT_INJECT",
                "MXTPU_SERVE_REPLICAS", "MXTPU_SERVE_DISPATCH_TIMEOUT_MS",
                "MXTPU_SERVE_BREAKER_THRESHOLD",
                "MXTPU_SERVE_BREAKER_BACKOFF_MS",
                "MXTPU_SERVE_BREAKER_BACKOFF_MAX_MS",
                "MXTPU_SERVE_MAX_BATCH", "MXTPU_SERVE_MAX_WAIT_MS",
                "MXTPU_SERVE_QUEUE", "MXTPU_SERVE_BATCH_AGING_MS",
                "MXTPU_SERVE_MIN_REPLICAS", "MXTPU_SERVE_MAX_REPLICAS",
                "MXTPU_SERVE_SCALE_COOLDOWN_MS",
                "MXTPU_SERVE_REPLACE_AFTER_MS"):
        monkeypatch.delenv(var, raising=False)
    for mod in (jtel, ttel):
        mod.reset()
    jres.reset_faults()
    tres.reset_faults()
    yield
    for mod in (jtel, ttel):
        mod.reset()
    jres.reset_faults()
    tres.reset_faults()
    ttel.set_tracing(True)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _stand_ins(monkeypatch, k):
    """The port sees ``k`` distinct CPU devices ``cpu:0`` .. ``cpu:k-1``."""
    devs = [torch.device("cpu", i) for i in range(k)]
    monkeypatch.setattr(treplicas, "visible_devices", lambda: list(devs))
    return devs


def _mlps():
    def build(nn):
        net = nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu", in_units=IN_DIM),
                    nn.Dense(OUT_DIM, in_units=16))
        return net

    jnet, net = build(jnn), build(tnn)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=4)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    convert.load_mxtpu_params(net, arrays)
    return jnet, net


def _x(n, seed=0):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


def _log_decisions(ctrl):
    """Every ``(action, reason)`` the controller records, in order."""
    log = []
    record = ctrl._record

    def logged(action, reason, now, mark=True):
        log.append((action, reason))
        return record(action, reason, now, mark)

    ctrl._record = logged
    return log


class Pair:
    """The same dispatcher + controller in both packages, driven in
    lockstep on two fake clocks."""

    def __init__(self, monkeypatch, n=1, visible=3, max_batch=4,
                 disp_kw=None, ctrl_kw=None, **set_kw):
        self.devices = _stand_ins(monkeypatch, visible)
        jnet, net = _mlps()
        set_kw.setdefault("breaker_backoff_ms", 1000)
        example = np.zeros((1, IN_DIM), np.float32)
        self.jrs = JReplicaSet(jnet, JBucketSpec.pow2(max_batch), n=n,
                               example=example, warmup=True, **set_kw)
        self.rs = ReplicaSet(net, BucketSpec.pow2(max_batch),
                             devices=self.devices[:n], example=example,
                             warmup=True, **set_kw)
        kw = {"max_batch_size": max_batch, "max_wait_ms": 5,
              "dispatch_timeout_ms": 2000}
        kw.update(disp_kw or {})
        self.jclk, self.clk = FakeClock(), FakeClock()
        self.jbat = JReplicaDispatcher(self.jrs, clock=self.jclk,
                                       start=False, **kw)
        self.bat = ReplicaDispatcher(self.rs, clock=self.clk, start=False,
                                     **kw)
        ckw = {"min_replicas": 1, "max_replicas": 2,
               "scale_cooldown_ms": 1000, "min_samples": 4}
        ckw.update(ctrl_kw or {})
        self.jctrl = JServingController(self.jbat, **ckw)
        self.ctrl = ServingController(self.bat, **ckw)
        self.jlog, self.log = (_log_decisions(self.jctrl),
                               _log_decisions(self.ctrl))
        self.futs = []

    def advance(self, s):
        self.jclk.advance(s)
        self.clk.advance(s)

    def both(self, fn):
        """``fn(side)`` on each side, where side is (dispatcher, controller,
        replica set); the two results."""
        return (fn(self.jbat, self.jctrl, self.jrs),
                fn(self.bat, self.ctrl, self.rs))

    def poll(self):
        got = self.both(lambda b, c, s: b.poll())
        assert got[0] == got[1]
        return got[1]

    def drain(self):
        while self.poll():
            pass

    def submit(self, n, seed, **kw):
        """Submit to both; the outcome (a shed's reason or "queued")."""
        outs = []
        futs = []
        for b in (self.jbat, self.bat):
            try:
                futs.append(b.submit(_x(n, seed), **kw))
                outs.append("queued")
            except Exception as e:  # noqa: BLE001 — the outcome compared
                outs.append("%s: %s" % (type(e).__name__,
                                        str(e).split(": ")[-1]))
        assert outs[0] == outs[1], outs
        if len(futs) == 2:
            self.futs.append(tuple(futs))
        return outs[1]

    def same(self):
        """Decisions, replica indices and states, and answers agree."""
        assert self.log == self.jlog
        assert [(r.index, r.state) for r in self.rs.replicas] == \
            [(r.index, r.state) for r in self.jrs.replicas]
        for jf, f in self.futs:
            assert f.done() == jf.done()
            if f.done():
                assert (f._error is None) == (jf._error is None)
                if f._error is None:
                    ref = jf.result(0)
                    np.testing.assert_allclose(
                        f.result(0), ref, rtol=0,
                        atol=1e-5 * max(1.0, np.abs(ref).max()))
                else:
                    assert type(f._error).__name__ == \
                        type(jf._error).__name__


def _decisions(tag):
    v = ttel.value("serving.controller.decisions", tag=tag)
    assert v == jtel.value("serving.controller.decisions", tag=tag), tag
    return v


# ------------------------------------------------------- predictive admission
def test_predictive_shed_before_the_depth_bound_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, ctrl_kw={"max_replicas": 1})
    for _ in range(6):
        for ctrl, clk in ((p.jctrl, p.jclk), (p.ctrl, p.clk)):
            ctrl.observe(None, SLOW_BREAKDOWN, hit=True, now=clk())
    jpred, pred = p.both(lambda b, c, s: c.predicted_s(None))
    assert pred == pytest.approx(jpred, abs=1e-9)
    assert pred == pytest.approx(0.25, abs=0.06)
    assert p.submit(1, 0, deadline_ms=50) == "QueueFull: predicted_miss"
    assert ttel.value("serving.shed", tag="predicted_miss") == 1
    assert _decisions("predicted_shed") == 1
    assert p.submit(1, 1, deadline_ms=2000) == "queued"
    assert p.submit(1, 2) == "queued"
    p.advance(0.006)
    assert p.poll() == 2
    p.same()
    assert p.log == [("predicted_shed",
                      "predicted %.1f ms > deadline 50.0 ms" % (pred * 1e3))]


def test_latency_model_fed_from_deliveries_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, ctrl_kw={"max_replicas": 1})
    for i in range(5):
        p.submit(1, i, deadline_ms=10000)
        p.advance(0.2)                  # 200 ms of fake-clock queue wait
        assert p.poll() == 1
    jq, q = p.both(lambda b, c, s: c._models[None]["total"].quantile(
        0.9, c._disp._clock()))
    # the totals add host-measured pad/predict seconds to the exact
    # queue wait: equal within what the host's own timings add
    assert q >= 0.2 and jq >= 0.2 and q == pytest.approx(jq, abs=0.05)
    jv, v = p.both(lambda b, c, s: c.view())
    assert v["slo_attainment"] == jv["slo_attainment"] == 1.0
    assert set(v) == set(jv)
    p.same()


def test_cold_model_falls_back_to_the_depth_bound_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, disp_kw={"max_queue": 4},
             ctrl_kw={"max_replicas": 1, "min_samples": 8})
    assert p.submit(1, 0, deadline_ms=1) == "queued"   # cold: admitted
    for i in range(3):
        assert p.submit(1, i + 1, deadline_ms=10000) == "queued"
    assert p.submit(1, 9, deadline_ms=10000) == "QueueFull: queue_full"
    p.advance(0.006)
    p.poll()
    p.same()
    assert type(p.futs[0][1]._error).__name__ == "DeadlineExceeded"


def test_retry_after_and_attainment_like_mxtpu(monkeypatch):
    """The same observations and expiries give the same drain estimate,
    Retry-After, decayed attainment and per-tenant attainment."""
    p = Pair(monkeypatch, ctrl_kw={"max_replicas": 1})
    assert p.both(lambda b, c, s: c.retry_after_s()) == (1, 1)
    for i in range(6):
        for ctrl, clk in ((p.jctrl, p.jclk), (p.ctrl, p.clk)):
            ctrl.observe(None, SLOW_BREAKDOWN, hit=i % 3 != 0, now=clk(),
                         meta={"tenant": "gold" if i % 2 else "free"})
        p.advance(0.5)
    for ctrl, clk in ((p.jctrl, p.jclk), (p.ctrl, p.clk)):
        ctrl.note_expired(clk(), meta={"tenant": "gold"})
    for i in range(8):
        p.submit(1, i)
    jd, d = p.both(lambda b, c, s: c.estimate_drain_s())
    assert d == pytest.approx(jd, abs=1e-9) and d > 0
    assert p.both(lambda b, c, s: c.retry_after_s())[0] == \
        p.ctrl.retry_after_s()
    (ja, jw), (a, w) = p.both(lambda b, c, s: c.attainment())
    assert a == pytest.approx(ja, abs=1e-9) and w == pytest.approx(jw)
    assert 0.0 < a < 1.0
    jt, t = p.both(lambda b, c, s: c.tenant_attainment())
    assert t == jt and set(t) == {"gold", "free"}
    assert ttel.gauge_value("serving.tenant_attainment", tag="gold") == \
        pytest.approx(jtel.gauge_value("serving.tenant_attainment",
                                       tag="gold"))
    jv, v = p.both(lambda b, c, s: c.view())
    for key in ("slo_attainment", "tenant_attainment", "recent_sheds",
                "queue_depths", "min_replicas", "max_replicas",
                "replica_target", "replica_actual", "replica_warming"):
        assert v[key] == jv[key], key
    p.drain()
    p.same()


def test_latency_model_trains_with_tracing_off(monkeypatch):
    """Without traces the enqueue-to-deliver interval trains the model
    (``MXTPU_TRACE=0`` on the reference, ``set_tracing(False)`` here)."""
    monkeypatch.setenv("MXTPU_TRACE", "0")
    jtel.reset()
    ttel.set_tracing(False)
    p = Pair(monkeypatch, ctrl_kw={"max_replicas": 1, "min_samples": 4})
    for i in range(5):
        p.submit(1, i, deadline_ms=10000)
        p.advance(0.2)
        assert p.poll() == 1
        assert p.futs[-1][1].breakdown is None
    jq, q = p.both(lambda b, c, s: c._models[None]["total"].quantile(
        0.9, c._disp._clock()))
    assert q == pytest.approx(jq, abs=1e-9) and q >= 0.2
    assert p.submit(1, 7, deadline_ms=50) == "queued"
    for i in range(3):
        p.submit(1, i)
    assert p.submit(1, 9, deadline_ms=50) == "QueueFull: predicted_miss"
    p.advance(0.006)
    p.drain()
    p.same()


# ---------------------------------------------------------- elastic ReplicaSet
def test_warming_replica_never_routed_then_joins_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch)
    spec = p.rs.spec
    for s in (p.jrs, p.rs):
        rep = s.add_replica(warm=False)
        assert rep.state == "warming" and rep.index == 1
        assert s.healthy_count() == 1 and s.pick().index == 0
    assert ttel.retrace_stats("serving.predict.r1") is None
    assert p.rs.replicas[1].device == p.devices[1]   # the first free one
    for s in (p.jrs, p.rs):
        s.warm_replica(s.replicas[1])
    st = ttel.retrace_stats("serving.predict.r1")
    assert st["compiles"] == len(spec) and st["trips"] == 0
    assert ttel.value("serving.replica.joins", tag="r1") == \
        jtel.value("serving.replica.joins", tag="r1") == 1
    x = _x(2, seed=3)
    ref = p.jrs.replicas[1].predictor.predict(x).asnumpy()
    np.testing.assert_allclose(
        p.rs.replicas[1].predictor.predict(x).asnumpy(), ref, rtol=0,
        atol=1e-5 * np.abs(ref).max())
    p.same()


def test_scale_up_on_queue_pressure_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, disp_kw={"max_queue": 8},
             ctrl_kw={"min_samples": 999, "scale_cooldown_ms": 0})
    for i in range(4):                        # pressure 0.5: the high bar
        p.submit(1, i)
    p.advance(0.006)
    p.poll()                                  # maintain -> tick -> grow
    assert [r.state for r in p.rs.replicas] == ["healthy", "healthy"]
    assert p.log == [("scale_up",
                      "pressure=0.50 sheds=0.0 attainment=n/a kv=0.00")]
    assert _decisions("scale_up") == 1
    st = ttel.retrace_stats("serving.predict.r1")
    assert st["compiles"] == len(p.rs.spec) and st["trips"] == 0
    assert ttel.gauge_value("serving.replicas") == 2
    p.drain()
    p.same()


def test_scale_down_drains_without_failing_futures_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, n=2, ctrl_kw={"min_samples": 999})
    p.submit(2, 0)
    p.advance(0.006)
    p.poll()
    p.advance(1.2)                            # idle past the cooldown
    p.poll()                                  # tick -> scale_down
    assert p.log == [("scale_down", "r1 retiring (idle)")]
    assert [r.state for r in p.rs.replicas] == ["healthy", "retiring"]
    p.submit(1, 1)
    p.advance(0.006)
    p.poll()                                  # finalize + dispatch
    assert [r.index for r in p.rs.replicas] == [0]
    assert ttel.value("serving.replica.retirements", tag="r1") == 1
    assert ttel.gauge_value("serving.replicas") == 1
    p.same()
    assert all(f.done() and f._error is None for _, f in p.futs)


def test_cooldown_hysteresis_suppresses_flapping_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, disp_kw={"max_queue": 8},
             ctrl_kw={"min_samples": 999})
    for i in range(4):
        p.submit(1, i)
    p.advance(0.006)
    p.poll()                                  # spike -> scale_up
    p.drain()
    p.advance(0.5)
    p.poll()                                  # inside the cooldown
    assert [a for a, _ in p.log] == ["scale_up"]
    p.advance(1.1)
    p.poll()                                  # idle past the cooldown
    p.poll()                                  # finalize
    p.advance(0.5)
    p.poll()                                  # at the floor: stable
    assert [a for a, _ in p.log] == ["scale_up", "scale_down"]
    assert len(p.rs.replicas) == 1
    p.same()


def test_dead_replica_replaced_on_a_free_device_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, n=2, ctrl_kw={
        "min_replicas": 2, "max_replicas": 2, "replace_after_ms": 500,
        "scale_cooldown_ms": 100000, "min_samples": 999})
    p.advance(1.0)
    for b in (p.jbat, p.bat):
        b.quarantine_replica(0, backoff_s=3600)   # a dead chip
    p.advance(0.3)
    p.poll()                                  # before the bound: nothing
    assert p.log == []
    p.advance(0.3)
    p.poll()                                  # tick -> replace
    p.poll()                                  # finalize the retired one
    assert p.log == [("replace", "r0 breaker open 0.6 s (>= 0.5 s)")]
    assert [(r.index, r.state) for r in p.rs.replicas] == \
        [(1, "healthy"), (2, "healthy")]
    # the first device no replica used, in both packages
    assert p.rs.replicas[-1].device == p.devices[2]
    assert p.jrs.replicas[-1].device is mx_devices()[2]
    st = ttel.retrace_stats("serving.predict.r2")
    assert st["compiles"] == len(p.rs.spec) and st["trips"] == 0
    p.submit(2, 5)
    p.advance(0.006)
    assert p.poll() == 1
    assert ttel.value("serving.replica.retirements", tag="r0") == 1
    p.same()


def mx_devices():
    import jax
    return jax.devices()


def test_dead_replica_replaced_on_its_own_device_like_mxtpu(monkeypatch):
    """No free device: the replacement goes to the dead replica's own
    (one card). The reference's set is told no device is free."""
    p = Pair(monkeypatch, n=2, visible=2, ctrl_kw={
        "min_replicas": 2, "max_replicas": 2, "replace_after_ms": 500,
        "scale_cooldown_ms": 100000, "min_samples": 999})
    monkeypatch.setattr(p.jrs, "free_devices", lambda: [])
    assert p.rs.free_devices() == []
    dead = p.rs.replicas[0].device
    jdead = p.jrs.replicas[0].device
    for b in (p.jbat, p.bat):
        b.quarantine_replica(0, backoff_s=3600)
    p.advance(0.6)
    p.poll()
    p.poll()
    assert [a for a, _ in p.log] == ["replace"]
    assert [r.index for r in p.rs.replicas] == [1, 2]
    assert p.rs.replicas[-1].device == dead
    assert p.jrs.replicas[-1].device is jdead
    p.submit(1, 1)
    p.advance(0.006)
    assert p.poll() == 1
    p.same()


def test_bring_up_failure_recorded_as_warmup_failed_like_mxtpu(monkeypatch):
    p = Pair(monkeypatch, disp_kw={"max_queue": 8},
             ctrl_kw={"min_samples": 999, "scale_cooldown_ms": 0})

    def dead(self):
        raise RuntimeError("device dead at bring-up")

    monkeypatch.setattr(jengine.Predictor, "warmup", dead)
    monkeypatch.setattr(tengine.Predictor, "warmup", dead)
    for i in range(4):
        p.submit(1, i)
    p.advance(0.006)
    p.poll()                                  # tick -> scale_up -> boom
    assert [a for a, _ in p.log] == ["scale_up", "warmup_failed"]
    assert p.log[1] == ("warmup_failed",
                        "RuntimeError: device dead at bring-up")
    assert [r.index for r in p.rs.replicas] == [0]   # never joined
    p.drain()
    p.same()


def test_scale_up_refused_on_one_device_like_mxtpu(monkeypatch):
    """Every visible device already hosts a replica: the scale-up is
    recorded, then refused as ``warmup_failed`` (the one-card case)."""
    p = Pair(monkeypatch, visible=1, disp_kw={"max_queue": 8},
             ctrl_kw={"min_samples": 999, "scale_cooldown_ms": 0})
    monkeypatch.setattr(p.jrs, "_free_devices_locked", lambda: [])
    assert p.rs.free_devices() == []
    for i in range(4):
        p.submit(1, i)
    p.advance(0.006)
    p.poll()
    assert [a for a, _ in p.log] == ["scale_up", "warmup_failed"]
    assert "every visible device already hosts a replica" in p.log[1][1]
    assert [r.index for r in p.rs.replicas] == [0]
    p.drain()
    p.same()


def test_kv_pressure_is_a_scale_signal_like_mxtpu(monkeypatch):
    """Each package's accountant, attached to its ReplicaSet, at the same
    residency: the port's controller reads the real accountant's pressure
    and scales up as the reference's does."""
    from mxtpu_torch.serving import KVCacheAccountant
    p = Pair(monkeypatch, ctrl_kw={"min_samples": 999,
                                   "scale_cooldown_ms": 0})
    for s, acct in ((p.jrs, JKVCacheAccountant(overcommit=2.0)),
                    (p.rs, KVCacheAccountant(overcommit=2.0))):
        acct.register("r0", per_slot_bytes=64, slots=2)
        for _ in range(4):
            assert acct.try_admit("r0")
        s.attach_accountant(acct)
    assert p.rs.accountant.pressure() == p.jrs.accountant.pressure() == 1.0
    p.advance(0.01)
    p.poll()
    assert p.log == [("scale_up",
                      "pressure=0.00 sheds=0.0 attainment=n/a kv=1.00")]
    assert len(p.rs.replicas) == 2
    p.same()


def test_kv_pressure_from_decode_engines_scales_like_mxtpu(monkeypatch):
    """The pressure comes from a live DecodeEngine in each package: queued
    prompts against two slots at overcommit 2 reach the controller's
    ``kv_pressure_high`` and it scales up; below it, it holds."""
    import os
    import sys
    from mxtpu.serving import DecodeEngine as JDecodeEngine
    from mxtpu_torch.serving import DecodeEngine, KVCacheAccountant
    from mxtpu_torch.serving import decode_bench
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import serve_bench as sb
    jmodel = sb.build_decode_model(vocab=16, dim=8, max_len=16, seed=2)
    model = decode_bench.build_decode_model(16, 8, 16, seed=2)
    p = Pair(monkeypatch, ctrl_kw={"min_samples": 999,
                                   "scale_cooldown_ms": 0,
                                   "kv_pressure_high": 0.75})
    engines = []
    for s, E, B, A, m, kw in (
            (p.jrs, JDecodeEngine, JBucketSpec, JKVCacheAccountant, jmodel,
             {}),
            (p.rs, DecodeEngine, BucketSpec, KVCacheAccountant, model,
             {"device": "cpu"})):
        acct = A(overcommit=2.0)
        s.attach_accountant(acct)
        engines.append(E(m, B([1], seq_lens=[4, 8]),
                         B.pow2(decode_slots=2), max_len=12,
                         accountant=acct, **kw))
    for i in range(2):
        for e in engines:
            e.submit(np.arange(2 + i).astype(np.int32), max_new=3)
    p.advance(0.01)
    p.poll()
    assert p.log == [] and p.rs.accountant.pressure() == 0.5
    for e in engines:
        e.submit(np.arange(3).astype(np.int32), max_new=3)
    assert p.rs.accountant.pressure() == p.jrs.accountant.pressure() == 0.75
    p.advance(0.01)
    p.poll()
    assert p.log == [("scale_up",
                      "pressure=0.00 sheds=0.0 attainment=n/a kv=0.75")]
    p.same()
    for e in engines:
        e.close(timeout=5.0)
    assert p.rs.accountant.pressure() == 0.0


# ----------------------------------------------------------------- HTTP front
def _http(addr, path, payload=None):
    url = "http://%s:%d%s" % (addr[0], addr[1], path)
    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=T) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_server_retry_after_and_healthz_controller_block(monkeypatch):
    devs = _stand_ins(monkeypatch, 1)
    _, net = _mlps()
    rs = ReplicaSet(net, BucketSpec.pow2(4), devices=devs,
                    example=np.zeros((1, IN_DIM), np.float32))
    bat = ReplicaDispatcher(rs, max_batch_size=4, max_wait_ms=1)
    ctrl = ServingController(bat, min_replicas=1, max_replicas=1,
                             min_samples=4)
    srv = ModelServer(bat).start()
    try:
        x = _x(2, seed=5)
        code, out, _h = _http(srv.address, "/predict", {"data": x.tolist()})
        assert code == 200 and out["n"] == 2
        code, out, _h = _http(srv.address, "/predict",
                              {"data": x.tolist(), "priority": "bogus"})
        assert code == 400 and "priority" in out["error"]
        code, health, _h = _http(srv.address, "/healthz")
        view = health["controller"]
        assert view["replica_target"] == 1 and view["replica_actual"] == 1
        assert view["queue_depths"] == {"interactive": 0, "batch": 0}
        assert {"last_decision", "estimated_drain_s", "slo_attainment",
                "tenant_attainment", "recent_sheds"} <= set(view)
        # the drain estimate of an empty queue: the 1 s floor
        srv.draining = True
        code, out, headers = _http(srv.address, "/predict",
                                   {"data": x.tolist()})
        assert code == 503 and headers["Retry-After"] == \
            str(ctrl.retry_after_s()) == "1"
    finally:
        srv.draining = False
        srv.close(timeout=T)


def test_controller_refuses_bad_bounds_and_reads_no_environment(monkeypatch):
    p = Pair(monkeypatch, ctrl_kw={"max_replicas": 1})
    with pytest.raises(mt.MXNetError, match="min_replicas"):
        ServingController(p.bat, min_replicas=2, max_replicas=1)
    monkeypatch.setenv("MXTPU_SERVE_MAX_REPLICAS", "7")
    c = ServingController(p.bat, max_replicas=0)
    assert c.max_replicas == 3                # the visible stand-ins
    assert (c.min_replicas, c.cooldown_s, c.replace_after_s) == (
        tcontroller.MIN_REPLICAS, tcontroller.SCALE_COOLDOWN_MS / 1e3,
        tcontroller.REPLACE_AFTER_MS / 1e3) == (1, 5.0, 30.0)
