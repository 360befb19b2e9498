"""The port's replica serving (``mxtpu_torch/serving/replicas.py``) against
the JAX package's: two replicas on the CPU in the port (two of the eight
virtual CPU devices in the JAX package), the same weights, the same fault
schedule (``MXTPU_FAULT_INJECT`` set with ``monkeypatch.setenv`` on the JAX
side, ``resilience.set_faults`` on the port's) and the same fake-clock
script through both ReplicaDispatchers. After every step the replica
states and each future's outcome must agree, and every answer agrees
within 1e-5 of max|output| (float32): routing, the breaker and its
half-open probe, the wedge watchdog's exactly-once re-dispatch, and
retirement through the drain; then the port's elastic growth (indices
never reused, the first free device, bring-up on a thread of its own
while traffic flows)."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.gluon import nn as jnn
from mxtpu.serving import BucketSpec as JBucketSpec
from mxtpu.serving import ReplicaDispatcher as JReplicaDispatcher
from mxtpu.serving import ReplicaSet as JReplicaSet
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.serving import (BucketSpec, ModelServer, ReplicaDispatcher,
                                 ReplicaSet)
from mxtpu_torch.serving import replicas as replicas_mod

IN_DIM, OUT_DIM = 12, 4
T = 30


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_TELEMETRY", "MXTPU_TRACE", "MXTPU_FAULT_INJECT",
                "MXTPU_SERVE_REPLICAS", "MXTPU_SERVE_DISPATCH_TIMEOUT_MS",
                "MXTPU_SERVE_BREAKER_THRESHOLD",
                "MXTPU_SERVE_BREAKER_BACKOFF_MS",
                "MXTPU_SERVE_BREAKER_BACKOFF_MAX_MS"):
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


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


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
                                   seed=1)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    convert.load_mxtpu_params(net, arrays)
    return jnet, net


def _x(n, seed=0):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


def _sets(n=2, max_batch=4, **kw):
    """(JAX ReplicaSet, port ReplicaSet, port net) over the same weights."""
    jnet, net = _mlps()
    kw.setdefault("breaker_backoff_ms", 1000)
    example = np.zeros((1, IN_DIM), np.float32)
    jrs = JReplicaSet(jnet, JBucketSpec.pow2(max_batch), n=n,
                      example=example, warmup=True, **kw)
    rs = ReplicaSet(net, BucketSpec.pow2(max_batch),
                    devices=["cpu"] * n, example=example, warmup=True, **kw)
    return jrs, rs, net


def _dispatchers(jrs, rs, **kw):
    kw.setdefault("max_batch_size", rs.spec.max_batch)
    kw.setdefault("max_wait_ms", 5)
    kw.setdefault("dispatch_timeout_ms", 2000)
    jclk, clk = FakeClock(), FakeClock()
    return (JReplicaDispatcher(jrs, clock=jclk, start=False, **kw), jclk,
            ReplicaDispatcher(rs, clock=clk, start=False, **kw), clk)


def _faults(monkeypatch, spec):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
    jres.reset_faults()
    tres.set_faults(spec)


def _outcome(f):
    if not f.done():
        return None
    return "ok" if f._error is None else type(f._error).__name__


def _run(bat, clk, script):
    """Run ``script`` ((op, arg) steps) through one dispatcher; returns the
    trace of (poll result, states, outcomes) after each step and the
    answers."""
    futs, trace = [], []
    for i, (op, arg) in enumerate(script):
        got = None
        if op == "submit":
            try:
                futs.append(bat.submit(_x(arg, seed=i)))
            except Exception as e:  # noqa: BLE001 — the outcome compared
                got = type(e).__name__
        elif op == "advance":
            clk.advance(arg)
        else:
            got = bat.poll()
        trace.append((got, [s["state"] for s in bat.replica_states()],
                      [_outcome(f) for f in futs]))
    answers = [f.result(0) for f in futs if _outcome(f) == "ok"]
    return trace, answers


def _same(jbat, jclk, bat, clk, script):
    jtrace, janswers = _run(jbat, jclk, script)
    trace, answers = _run(bat, clk, script)
    assert trace == jtrace
    assert len(answers) == len(janswers)
    for mine, ref in zip(answers, janswers):
        np.testing.assert_allclose(mine, ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    return trace


def _counters(*names):
    for name in names:
        assert ttel.tagged(name) == jtel.tagged(name), name


# ------------------------------------------------------------------ ReplicaSet
def test_replicas_warm_their_own_sites_and_snapshots():
    jrs, rs, net = _sets()
    spec = rs.spec
    for i, rep in enumerate(rs.replicas):
        assert rep.device.type == "cpu" and rep.tag == "r%d" % i
        st = ttel.retrace_stats("serving.predict.r%d" % i)
        assert st == {**st, "compiles": len(spec), "trips": 0}
        assert jtel.retrace_stats("serving.predict.r%d" % i)["compiles"] \
            == len(spec)
    assert ttel.retrace_stats("serving.predict") is None
    a, b = (r.predictor._stored[0] for r in rs.replicas)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert a.data_ptr() != net.collect_params()["mlp_dense0_weight"] \
        ._tensor().data_ptr()
    assert ttel.gauge_value("serving.replicas") == \
        jtel.gauge_value("serving.replicas") == 2
    assert rs.warmed and len(rs) == 2
    x = _x(3, seed=42)
    ref = jrs.replicas[0].predictor.predict(x).asnumpy()
    for rep in rs.replicas:
        np.testing.assert_allclose(rep.predictor.predict(x).asnumpy(), ref,
                                   rtol=0, atol=1e-5 * np.abs(ref).max())


def test_replicaset_device_rules(monkeypatch):
    _, net = _mlps()
    spec = BucketSpec.pow2(2)
    example = np.zeros((1, IN_DIM), np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            ReplicaSet(net, spec, example=example, warmup=False)
    with pytest.raises(mt.MXNetError, match="empty"):
        ReplicaSet(net, spec, devices=[], example=example, warmup=False)
    with pytest.raises(mt.MXNetError, match="ReplicaSet"):
        ReplicaDispatcher(object())
    cold = ReplicaSet(net, spec, devices=["cpu"], example=example,
                      warmup=False)
    with pytest.raises(mt.MXNetError, match="cold"):
        ReplicaDispatcher(cold)


def test_pick_least_loaded_skips_quarantined_like_mxtpu():
    jrs, rs, _ = _sets()
    for s in (jrs, rs):
        assert s.pick().index == 0
        s.acquire(s.replicas[0])
        assert s.pick().index == 1
        s.release(s.replicas[0])
        s.force_quarantine(1, now=0.0)
        assert s.pick().index == 0
        s.force_quarantine(0, now=0.0)
        assert s.pick() is None
    assert [r["state"] for r in rs.states()] == \
        [r["state"] for r in jrs.states()]


# -------------------------------------------------------------- wedge watchdog
def test_wedge_recovery_full_cycle_like_mxtpu(monkeypatch):
    """A wedged dispatch re-dispatches on the healthy replica, the wedged
    one is quarantined and a half-open probe restores it."""
    _faults(monkeypatch, "replica_wedge@0")
    jrs, rs, _ = _sets()
    trace = _same(*_dispatchers(jrs, rs), [
        ("submit", 2), ("submit", 1), ("advance", 0.006), ("poll", None),
        ("advance", 2.5), ("poll", None), ("advance", 1.2), ("poll", None),
        ("submit", 2), ("advance", 0.006), ("poll", None)])
    assert trace[4][1:] == (["healthy", "healthy"], [None, None])
    assert trace[6][1:] == (["quarantined", "healthy"], ["ok", "ok"])
    assert trace[-1][1:] == (["healthy", "healthy"], ["ok"] * 3)
    _counters("serving.replica.wedges", "serving.replica.quarantines",
              "serving.replica.redispatches", "serving.replica.restores",
              "serving.replica.dispatches")
    assert ttel.value("serving.replica.redispatches", tag="r0") == 1
    assert tres.FAULT_STATS["fired"] == [("replica_wedge", 0)]


def test_wedge_redispatch_exactly_once_like_mxtpu(monkeypatch):
    _faults(monkeypatch, "replica_wedge@0,1")
    jrs, rs, _ = _sets()
    trace = _same(*_dispatchers(jrs, rs), [
        ("submit", 1), ("advance", 0.006), ("poll", None), ("advance", 2.5),
        ("poll", None), ("advance", 2.5), ("poll", None)])
    assert trace[-1][1:] == (["healthy", "quarantined"],
                             ["DeadlineExceeded"])
    assert ttel.value("serving.replica.wedges") == 2


def test_wedge_on_a_single_replica_sheds_like_mxtpu(monkeypatch):
    _faults(monkeypatch, "replica_wedge@0")
    jrs, rs, _ = _sets(n=1)
    trace = _same(*_dispatchers(jrs, rs), [
        ("submit", 1), ("advance", 0.006), ("poll", None), ("advance", 2.5),
        ("poll", None), ("submit", 1)])
    assert trace[4][2] == ["QueueFull"] and trace[5][0] == "QueueFull"
    _counters("serving.shed")


# -------------------------------------------------------------- circuit breaker
def test_breaker_opens_after_threshold_like_mxtpu(monkeypatch):
    _faults(monkeypatch, "replica_fail@0,1,2")
    jrs, rs, _ = _sets(breaker_threshold=3)
    step = [("submit", 1), ("advance", 0.006), ("poll", None)]
    trace = _same(*_dispatchers(jrs, rs), step * 4)
    assert trace[-1][1:] == (["quarantined", "healthy"],
                             ["ReplicaFailure"] * 3 + ["ok"])
    _counters("serving.replica.failures", "serving.replica.quarantines",
              "serving.replica.dispatches")


def test_breaker_needs_consecutive_failures_like_mxtpu(monkeypatch):
    _faults(monkeypatch, "replica_fail@0,2,4")
    jrs, rs, _ = _sets(breaker_threshold=3)
    step = [("submit", 1), ("advance", 0.006), ("poll", None)]
    trace = _same(*_dispatchers(jrs, rs), step * 6)
    assert trace[-1][1] == ["healthy", "healthy"]


def test_all_down_sheds_then_a_probe_restores_like_mxtpu(monkeypatch):
    _faults(monkeypatch, "replica_fail@0,1;replica_wedge@2")
    jrs, rs, _ = _sets(breaker_threshold=2, breaker_backoff_ms=10000)
    step = [("submit", 1), ("advance", 0.006), ("poll", None)]
    trace = _same(*_dispatchers(jrs, rs), step * 3 + [
        ("advance", 2.5), ("poll", None), ("submit", 1), ("advance", 11.0),
        ("submit", 1), ("advance", 0.006), ("poll", None)])
    assert trace[10][1] == ["quarantined", "quarantined"]
    assert trace[11][0] == "QueueFull"           # all down: shed
    assert trace[-1][1:] == (["healthy", "healthy"],
                             ["ReplicaFailure", "ReplicaFailure",
                              "QueueFull", "ok"])
    _counters("serving.shed", "serving.replica.restores")
    assert ttel.value("serving.replica.restores") == 2


def test_failed_probe_doubles_backoff_like_mxtpu(monkeypatch):
    _faults(monkeypatch, "replica_fail@0")
    jrs, rs, _ = _sets(breaker_threshold=1, breaker_backoff_ms=1000,
                       breaker_backoff_max_ms=3000)

    def dead(rep):
        raise RuntimeError("dead")

    for s in (jrs, rs):
        monkeypatch.setattr(s, "run_probe", dead)
    _same(*_dispatchers(jrs, rs), [
        ("submit", 1), ("advance", 0.006), ("poll", None), ("advance", 1.2),
        ("poll", None), ("advance", 2.2), ("poll", None)])
    assert rs.replicas[0].backoff_s == jrs.replicas[0].backoff_s == \
        pytest.approx(3.0)
    assert ttel.value("serving.replica.restores") == 0


def test_dispatcher_drain_waits_for_a_wedged_entry(monkeypatch):
    _faults(monkeypatch, "replica_wedge@0")
    jrs, rs, _ = _sets()
    jbat, jclk, bat, clk = _dispatchers(jrs, rs)
    for b, c in ((jbat, jclk), (bat, clk)):
        f = b.submit(_x(1))
        c.advance(0.006)
        b.poll()
        assert b.drain(timeout=1) is False
        c.advance(2.5)
        assert b.drain(timeout=1) is True
        assert f.done() and f._error is None


# ------------------------------------------------------------------ HTTP, threads
def test_server_answers_503_for_a_replica_failure(monkeypatch):
    """The injected ``replica_fail`` of the first dispatch reaches its
    client as 503 with Retry-After (the JAX package answers 400); the
    next dispatch is served."""
    _faults(monkeypatch, "replica_fail@0")
    _, rs, _ = _sets()
    srv = ModelServer(rs).start()

    def post(x):
        req = urllib.request.Request(
            "http://%s:%d/predict" % srv.address,
            data=json.dumps({"data": x.tolist()}).encode())
        try:
            with urllib.request.urlopen(req, timeout=T) as r:
                return r.status, json.loads(r.read()), r.headers
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers

    try:
        code, out, headers = post(_x(1, seed=0))
        assert code == 503 and "injected replica failure" in out["error"]
        assert headers["Retry-After"] == "1"
        code, out, _ = post(_x(1, seed=1))
        assert code == 200 and out["n"] == 1
    finally:
        srv.close()


def test_server_healthz_reports_replica_states():
    _, rs, net = _sets()
    srv = ModelServer(rs).start()
    assert isinstance(srv.batcher, ReplicaDispatcher)

    def get(path, body=None):
        req = urllib.request.Request(
            "http://%s:%d%s" % (srv.address + (path,)),
            data=None if body is None else json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=T) as r:
            return json.loads(r.read())

    try:
        x = _x(2, seed=5)
        out = get("/predict", {"data": x.tolist()})
        want = net(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(np.asarray(out["outputs"][0]), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())
        health = get("/healthz")
        assert health["status"] == "ok" and health["healthy_replicas"] == 2
        assert [r["device"] for r in health["replicas"]] == ["cpu", "cpu"]
        srv.batcher.quarantine_replica(0, backoff_s=3600)
        health = get("/healthz")
        assert health["status"] == "degraded"
        assert health["healthy_replicas"] == 1
        assert get("/predict", {"data": x.tolist()})["n"] == 2
        m = get("/metrics")
        assert "r0" in m["counters"]["serving.replica.quarantines"]
        assert {"serving.predict.r0", "serving.predict.r1"} <= \
            set(m["retrace"])
    finally:
        srv.close()


def test_threaded_replicas_serve_a_burst_with_no_hang():
    _, rs, _ = _sets(max_batch=4)
    bat = ReplicaDispatcher(rs, max_batch_size=4, max_wait_ms=1,
                            max_queue=4096)
    errors = []

    def client(k, n_req):
        rng = np.random.RandomState(k)
        for _ in range(n_req):
            n = int(rng.randint(1, 4))
            try:
                out = bat.submit(rng.randn(n, IN_DIM).astype(
                    np.float32)).result(timeout=T)
                assert out.shape == (n, OUT_DIM)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(k, 40))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    bat.close(timeout=T)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert ttel.value("serving.requests") == 160
    per = ttel.tagged("serving.replica.dispatches")
    assert sum(per.values()) == ttel.value("serving.batches")
    for i in range(2):
        st = ttel.retrace_stats("serving.predict.r%d" % i)
        assert st["compiles"] == len(rs.spec) and st["trips"] == 0


# ------------------------------------------------------------------ elasticity
def test_retiring_replica_drains_its_inflight_then_leaves_like_mxtpu(
        monkeypatch):
    """A retiring replica stops pulling work at once and leaves the set
    only when its in-flight dispatch is over (here a wedged one, released
    by the watchdog); the batch re-dispatches on the survivor."""
    _faults(monkeypatch, "replica_wedge@0")
    jrs, rs, _ = _sets()
    jbat, jclk, bat, clk = _dispatchers(jrs, rs)
    states = []
    for b, c, s in ((jbat, jclk, jrs), (bat, clk, rs)):
        f = b.submit(_x(1))
        c.advance(0.006)
        b.poll()                                  # wedges on r0
        b.remove_replica(0)
        b.poll()                                  # inflight 1: stays
        row = [(r.index, r.state, r.inflight) for r in s.replicas]
        c.advance(2.5)
        b.poll()                                  # watchdog: release, move
        b.poll()                                  # finalize, serve on r1
        states.append((row, [(r.index, r.state) for r in s.replicas],
                       f.done() and f._error is None))
    assert states[0] == states[1] == (
        [(0, "retiring", 1), (1, "healthy", 0)], [(1, "healthy")], True)
    assert ttel.value("serving.replica.retirements", tag="r0") == 1


def test_probe_verdict_cannot_revive_a_retired_replica_like_mxtpu():
    jrs, rs, _ = _sets()
    for s in (jrs, rs):
        rep = s.force_quarantine(1, now=0.0)
        assert rep.down_since == 0.0
        s.due_probes(5.0)                         # claimed: probing
        s.remove_replica(1)
        s.probe_result(rep, True, 6.0)
        assert rep.state == "retiring"
        assert [r.index for r in s.finalize_retiring()] == [1]
        assert rep.state == "removed" and len(s.replicas) == 1


def test_add_replica_indices_are_never_reused_and_free_devices(monkeypatch):
    devs = [torch.device("cpu", i) for i in range(3)]
    monkeypatch.setattr(replicas_mod, "visible_devices", lambda: devs)
    _, net = _mlps()
    rs = ReplicaSet(net, BucketSpec.pow2(2), devices=devs[:1],
                    example=np.zeros((1, IN_DIM), np.float32))
    assert rs.free_devices() == devs[1:]
    r1 = rs.add_replica()
    assert (r1.index, r1.device, r1.state) == (1, devs[1], "healthy")
    rs.remove_replica(1)
    rs.finalize_retiring()
    r2 = rs.add_replica()
    assert (r2.index, r2.device) == (2, devs[1])   # a new index, a free device
    r3 = rs.add_replica(device=devs[0])            # doubling up, explicitly
    assert r3.index == 3 and rs.free_devices() == [devs[2]]
    rs.add_replica()
    with pytest.raises(mt.MXNetError, match="every visible device"):
        rs.add_replica()
    assert [r.index for r in rs.replicas] == [0, 2, 3, 4]
    for i in (2, 3, 4):
        st = ttel.retrace_stats("serving.predict.r%d" % i)
        assert st["compiles"] == len(rs.spec)
    assert ttel.retrace_stats("serving.predict.r5") is None   # refused


def test_threaded_bring_up_joins_while_traffic_flows():
    """In threaded mode the new replica warms on a thread of its own while
    r0 keeps serving, then gets a worker and takes traffic; no request
    fails and no capture happens on the serving path."""
    _, rs, _ = _sets(n=1, max_batch=4)
    bat = ReplicaDispatcher(rs, max_batch_size=4, max_wait_ms=1,
                            max_queue=4096)
    errors = []
    try:
        rep = bat.add_replica(device="cpu")
        assert rep.index == 1
        futs = [bat.submit(_x(1 + i % 3, seed=i)) for i in range(40)]
        for f in futs:
            try:
                f.result(timeout=T)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        deadline = time.monotonic() + T
        while rep.state != "healthy" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rep.state == "healthy"
        more = [bat.submit(_x(2, seed=100 + i)) for i in range(40)]
        for f in more:
            assert f.result(timeout=T).shape == (2, OUT_DIM)
    finally:
        bat.close(timeout=T)
    assert not errors, errors[:3]
    assert len(bat._threads) == 2 and not any(t.is_alive()
                                              for t in bat._threads)
    for i in range(2):
        st = ttel.retrace_stats("serving.predict.r%d" % i)
        assert st["compiles"] == len(rs.spec) and st["trips"] == 0
    assert ttel.value("serving.replica.joins", tag="r1") == 1


# ------------------------------------------------------- KV accountability
def test_attach_accountant_admission_and_shed_like_mxtpu():
    """A KV accountant attached to both ReplicaSets: the same states rows
    (resident bytes, a paged pool's pages), ``kv_admissible`` and the
    dispatcher's ``kv_residency`` shed once no healthy replica admits."""
    from mxtpu.serving import KVCacheAccountant as JKVCacheAccountant
    from mxtpu_torch.serving import KVCacheAccountant
    jrs, rs, _ = _sets()
    jbat, jclk, bat, clk = _dispatchers(jrs, rs)
    accts = []
    for s, A in ((jrs, JKVCacheAccountant), (rs, KVCacheAccountant)):
        assert s.accountant is None and s.kv_admissible()
        acct = A(overcommit=1.0)
        assert s.attach_accountant(acct) is s and s.accountant is acct
        acct.register("r0", per_slot_bytes=64, slots=1)
        acct.register("r1", per_slot_bytes=16, slots=2, page_tokens=8)
        accts.append(acct)
    assert rs.states() == [
        {**row, "device": "cpu"} for row in jrs.states()]
    for a in accts:
        assert a.try_admit("r0")
        a.occupy("r0")
    assert rs.kv_admissible() == jrs.kv_admissible() is True   # r1 admits
    for a in accts:
        assert a.try_admit("r1", n=2)
        a.occupy("r1", n=2)
    assert rs.kv_admissible() == jrs.kv_admissible() is False
    assert [r["kv_resident_bytes"] for r in rs.states()] == \
        [r["kv_resident_bytes"] for r in jrs.states()] == [64, 32]
    assert rs.states()[1]["kv_pages_live"] == 2
    for b in (jbat, bat):
        with pytest.raises(Exception, match="kv_residency") as e:
            b.submit(_x(1))
        assert type(e.value).__name__ == "QueueFull"
    _counters("serving.shed")
    # a quarantined replica's headroom does not count
    for a in accts:
        a.release("r1", n=2)
    for s in (jrs, rs):
        s.force_quarantine(1, 0.0, backoff_s=3600)
    assert rs.kv_admissible() == jrs.kv_admissible() is False


def _reasons(d):
    return sorted(p.name.split("_")[1] + ("_" + p.name.split("_")[2]
                                          if p.name.startswith(
                                              ("flight_replica",
                                               "flight_breaker"))
                                          else "")
                  for p in d.glob("flight_*.json")) if d.exists() else []


@pytest.mark.parametrize("spec,steps,want", [
    ("replica_wedge@0", [("submit", 2), ("advance", 0.006), ("poll", None),
                         ("advance", 2.5), ("poll", None)],
     "replica_wedge"),
    ("replica_fail@0,1,2", [("submit", 1), ("advance", 0.006),
                            ("poll", None)] * 3, "breaker_open"),
], ids=["wedge", "breaker"])
def test_flight_dumps_at_their_faults_like_mxtpu(monkeypatch, tmp_path,
                                                 spec, steps, want):
    """A wedge dumps ``flight_record("replica_wedge")`` (after the serving
    lock is released) and the failure that opens a breaker
    ``flight_record("breaker_open")``, each with its batch's traces."""
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "jax"))
    ttel.set_flight_dir(str(tmp_path / "port"))
    try:
        _faults(monkeypatch, spec)
        jrs, rs, _ = _sets(breaker_threshold=3)
        _same(*_dispatchers(jrs, rs), steps)
    finally:
        ttel.set_flight_dir(None)
    got, ref = _reasons(tmp_path / "port"), _reasons(tmp_path / "jax")
    assert got == ref and want in got
    art = next((tmp_path / "port").glob("flight_%s_*" % want))
    rec = json.loads(art.read_text())
    assert rec["extra"]["replica"] in (0, 1) and rec["trace_ids"]
