"""The port's serving plane against the JAX package's on the CPU: the
Predictor (its own parameter snapshot, the reference's predict contract,
bucket and padding parity, chunking, the compile budget, refresh_params),
``hybridize``, the MicroBatcher driven by a fake clock through ``poll()``,
and the ModelServer over HTTP on 127.0.0.1.

Both packages serve the same small nets with the same seeded weights
(``convert.seeded_params``); float32 outputs agree within 1e-5 of
max|output|. The JAX package's levers are set with ``monkeypatch.setenv``
only, the port's with ``resilience.set_faults``. Every future, urlopen and
join has a timeout of its own."""
import json
import os
import signal
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
from mxtpu.serving import DeadlineExceeded as JDeadlineExceeded
from mxtpu.serving import MicroBatcher as JMicroBatcher
from mxtpu.serving import QueueFull as JQueueFull
from mxtpu.serving import Predictor as JPredictor
from mxtpu.serving import ServingController as JServingController
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch import xprof
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.serving import (BucketSpec, DeadlineExceeded, MicroBatcher,
                                 ModelServer, Predictor, QueueFull,
                                 ServingController)

IN_DIM, OUT_DIM = 12, 4
TOL = 1e-5
T = 30   # seconds any wait may take


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_TELEMETRY", "MXTPU_TRACE", "MXTPU_RETRACE_BUDGET",
                "MXTPU_FAULT_INJECT", "MXTPU_SERVE_MAX_BATCH",
                "MXTPU_SERVE_MAX_WAIT_MS", "MXTPU_SERVE_QUEUE",
                "MXTPU_SERVE_INT8"):
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


def _load(jnet, net, seed):
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=seed)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    convert.load_mxtpu_params(net, arrays)
    return arrays


def _mlps(seed=0):
    """(mxtpu MLP, port MLP) with the same seeded weights."""
    def build(nn):
        net = nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu", in_units=IN_DIM),
                    nn.Dense(OUT_DIM, in_units=16))
        return net

    jnet, net = build(jnn), build(tnn)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load(jnet, net, seed)
    return jnet, net


def _x(n, seed=0, dim=IN_DIM):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()))


def _port_pred(net, spec, site="serving.predict", **kw):
    return Predictor(net, spec, example=np.zeros((1, IN_DIM), np.float32),
                     warmup=True, device="cpu", site=site, **kw)


def _jax_pred(jnet, spec, **kw):
    return JPredictor(jnet, spec, example=np.zeros((1, IN_DIM), np.float32),
                      warmup=True, **kw)


# ------------------------------------------------------------- Predictor
def test_predictor_snapshots_params_and_leaves_the_block_alone():
    """C6: the Predictor serves its own snapshot. The block's tensors stay
    where and what they are, and a set_data on the block changes the
    answers only after refresh_params(), in both packages."""
    jnet, net = _mlps()
    params = net.collect_params()
    before = {k: p._tensor() for k, p in params.items()}
    pred = _port_pred(net, BucketSpec.pow2(4))
    jpred = _jax_pred(jnet, JBucketSpec.pow2(4))
    assert all(params[k]._tensor() is t for k, t in before.items())
    assert all(p.data().to_torch().requires_grad for p in params.values())
    x = _x(3, seed=1)
    old_j, old_t = jpred.predict(x).asnumpy(), pred.predict(x).asnumpy()
    _close(old_t, old_j)
    fresh = convert.seeded_params(
        {k: p.shape for k, p in jnet.collect_params().items()}, seed=5)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(fresh[k]))
    convert.load_mxtpu_params(net, fresh)
    np.testing.assert_array_equal(jpred.predict(x).asnumpy(), old_j)
    np.testing.assert_array_equal(pred.predict(x).asnumpy(), old_t)
    jpred.refresh_params(version="v2")
    pred.refresh_params(version="v2")
    new_j, new_t = jpred.predict(x).asnumpy(), pred.predict(x).asnumpy()
    assert np.abs(new_j - old_j).max() > 0.1
    _close(new_t, new_j)
    assert pred.param_version == jpred.param_version == "v2"
    assert ttel.value("serving.param_refreshes", tag="serving.predict") == \
        jtel.value("serving.param_refreshes", tag="serving.predict") == 1
    assert pred.compile_stats()["compiles"] == 3


def test_refresh_refuses_a_new_shape():
    _, net = _mlps()
    pred = _port_pred(net, BucketSpec([2]))
    net.collect_params()["mlp_dense1_bias"].shape = None
    net.collect_params()["mlp_dense1_bias"].set_data(np.zeros(5, np.float32))
    with pytest.raises(mt.MXNetError, match="new Predictor"):
        pred.refresh_params()


class _TwoOut:
    """A block with nested outputs (y, (relu(y), 2y)), one per package."""

    @staticmethod
    def build(gluon):
        class Two(gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.dense = gluon.nn.Dense(OUT_DIM, in_units=IN_DIM)

            def hybrid_forward(self, F, x):
                y = self.dense(x)
                return y, (F.relu(y), y * 2)

        return Two(prefix="two_")


def test_predict_contract_matches_mxtpu():
    """C7: predict_flat returns (flat NDArrays, out_fmt, bucket) and
    predict regroups them into NDArrays, as the JAX package does."""
    jnet, net = _TwoOut.build(mx.gluon), _TwoOut.build(mt.gluon)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load(jnet, net, seed=2)
    spec = dict(batch_sizes=(2, 4))
    pred = _port_pred(net, BucketSpec(**spec))
    jpred = _jax_pred(jnet, JBucketSpec(**spec))
    for n in (1, 3, 6):
        x = _x(n, seed=n)
        flat, fmt, bucket = pred.predict_flat((x,))
        jflat, jfmt, jbucket = jpred.predict_flat((x,))
        assert (fmt, bucket) == (jfmt, jbucket)
        assert all(isinstance(o, mt.nd.NDArray) for o in flat)
        for a, b in zip(flat, jflat):
            _close(a.asnumpy(), b.asnumpy())
        out = pred.predict(x)
        assert isinstance(out, tuple) and isinstance(out[1], tuple)
        assert all(isinstance(o, mt.nd.NDArray)
                   for o in (out[0],) + out[1])
        assert out[1][1].shape == (n, OUT_DIM)
    single = _port_pred(_mlps()[1], BucketSpec([2]), site="single")
    one = single.predict(_x(1))
    assert isinstance(one, mt.nd.NDArray) and one.shape == (1, OUT_DIM)
    assert single.predict_flat((_x(2),))[1:] == ([0], 2)


@pytest.mark.parametrize("n,s", [(1, 3), (2, 4), (3, 7), (4, 8), (9, 5),
                                 (2, 1)])
def test_seq_buckets_and_chunks_match_mxtpu(n, s):
    def build(nn):
        net = nn.HybridSequential(prefix="seq_")
        with net.name_scope():
            net.add(nn.Dense(6, flatten=False, in_units=5))
        return net

    jnet, net = build(jnn), build(tnn)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load(jnet, net, seed=4)
    spec = dict(batch_sizes=(1, 2, 4), seq_lens=(4, 8))
    example = np.zeros((1, 4, 5), np.float32)
    pred = Predictor(net, BucketSpec(**spec), example=example, warmup=True,
                     device="cpu", site="seq")
    jpred = JPredictor(jnet, JBucketSpec(**spec), example=example,
                       warmup=True)
    x = np.random.RandomState(n * 10 + s).randn(n, s, 5).astype(np.float32)
    flat, fmt, bucket = pred.predict_flat((x,))
    jflat, jfmt, jbucket = jpred.predict_flat((x,))
    assert (fmt, bucket) == (jfmt, jbucket)
    assert flat[0].shape == jflat[0].shape == (n, 4 if s <= 4 else 8, 6)
    _close(flat[0].asnumpy(), jflat[0].asnumpy())
    assert pred.compile_stats()["compiles"] == len(pred.spec) == 6
    with pytest.raises(mt.MXNetError, match="cannot be chunked"):
        pred.predict(np.zeros((1, 9, 5), np.float32))


def test_pad_values_and_empty_requests():
    _, net = _mlps()
    pred = Predictor(net, BucketSpec([4], pad_value=0), device="cpu",
                     site="pads")
    x = _x(2, seed=3)
    ref = net(torch.from_numpy(x)).detach().numpy()
    _close(pred.predict(x).asnumpy(), ref)            # settles lazily
    _close(pred.predict(torch.from_numpy(x)).asnumpy(), ref)
    _close(pred.predict(mt.nd.array(x, ctx=mt.cpu())).asnumpy(), ref)
    _close(pred.predict(x.astype(np.float64)).asnumpy(), ref)
    with pytest.raises(mt.MXNetError, match="empty"):
        pred.predict(np.zeros((0, IN_DIM), np.float32))
    with pytest.raises(mt.MXNetError, match="input"):
        pred.predict_flat((x, x))
    assert pred.compile_stats()["compiles"] == 1


def test_load_paths_not_ported_yet_raise(tmp_path):
    """``from_checkpoint`` is ported (tests/test_torch_export.py serves
    through it): a checkpoint that is not there raises reading it;
    ``from_trainer_checkpoint`` still needs A9."""
    _, net = _mlps()
    with pytest.raises(OSError):
        Predictor.from_checkpoint(str(tmp_path / "model"), 0,
                                  BucketSpec([1]), device="cpu")
    with pytest.raises(mt.MXNetError, match="A9"):
        Predictor.from_trainer_checkpoint(net, "ckpt", BucketSpec([1]))


def test_oom_fault_fails_the_dispatch(monkeypatch):
    # occurrence 0 is the warm-up's run of the one bucket
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "oom@2")
    tres.set_faults("oom@2")
    jnet, net = _mlps()
    pred = _port_pred(net, BucketSpec([2]))
    jpred = _jax_pred(jnet, JBucketSpec([2]))
    for p, err in ((jpred, jres.ResourceExhausted),
                   (pred, tres.ResourceExhausted)):
        p.predict(_x(1))
        with pytest.raises(err):
            p.predict(_x(1))
        p.predict(_x(1))


def test_compile_budget_500_mixed_requests():
    """The reference's acceptance run (tests/test_serving.py): 500
    mixed-shape closed-loop requests from 4 threads through a started
    MicroBatcher leave the builds at the number of buckets, attribute no
    sync to the predict span, and fetch once per batch."""
    _, net = _mlps()
    spec = BucketSpec.pow2(8)
    pred = _port_pred(net, spec)
    assert pred.compile_stats()["compiles"] == len(spec)
    bat = MicroBatcher(pred, max_batch_size=8, max_wait_ms=1,
                       max_queue=2048)
    errors = []

    def client(k, n_req):
        rng = np.random.RandomState(k)
        for _ in range(n_req):
            n = int(rng.randint(1, 4))
            x = rng.randn(n, IN_DIM).astype(np.float32)
            try:
                out = bat.submit(x).result(timeout=T)
                assert out.shape == (n, OUT_DIM)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(k, 125))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    bat.close(timeout=T)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert ttel.value("serving.requests") == 500
    st = pred.compile_stats()
    assert st["compiles"] == len(spec) and st["trips"] == 0
    snap = ttel.snapshot()
    assert snap["counters"].get("serving.predict.d2h", 0) == 0
    assert snap["histograms"]["serving.fetch"]["count"] == \
        ttel.value("serving.batches")
    assert snap["histograms"]["serving.latency_s"]["count"] == 500


def test_hybridize_on_the_cpu_runs_eagerly_like_mxtpu():
    jnet, net = _mlps()
    x = _x(3, seed=9)
    ref = net(torch.from_numpy(x)).detach().numpy()
    jnet.hybridize()
    net.hybridize()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    _close(got, jnet(mx.nd.array(x)).asnumpy())
    out = net(mt.nd.array(x, ctx=mt.cpu()))
    assert isinstance(out, mt.nd.NDArray)
    np.testing.assert_array_equal(out.asnumpy(), ref)
    with mt.autograd.record():       # a recording call runs eagerly too
        loss = net(mt.nd.array(x, ctx=mt.cpu())).sum()
    loss.backward()
    assert np.abs(net.collect_params()["mlp_dense1_weight"].grad()
                  .asnumpy()).max() > 0
    assert net._cached_op is None and ttel.retrace_stats("cached_op") is None
    net.cast("float32")
    net.hybridize(False)
    assert net._active is False
    assert not any(c._active for c in net._child_blocks())


# ------------------------------------------------------------ MicroBatcher
def _batchers(jpred, pred, **kw):
    jclk, clk = FakeClock(), FakeClock()
    return (JMicroBatcher(jpred, clock=jclk, start=False, **kw), jclk,
            MicroBatcher(pred, clock=clk, start=False, **kw), clk)


def test_batcher_cohorts_and_outputs_match_mxtpu():
    """One request stream, by size and by wait, through both batchers:
    the same dispatch counts per poll, the same fills and counters, and
    outputs within 1e-5."""
    jnet, net = _mlps()
    jbat, jclk, bat, clk = _batchers(
        _jax_pred(jnet, JBucketSpec.pow2(8)),
        _port_pred(net, BucketSpec.pow2(8)), max_batch_size=8,
        max_wait_ms=5)
    script = [("submit", 2), ("submit", 3), ("poll",), ("advance", 0.004),
              ("poll",), ("submit", 3), ("poll",), ("submit", 1),
              ("advance", 0.006), ("poll",), ("submit", 5),
              ("submit", 4), ("poll",), ("advance", 0.01), ("poll",),
              ("poll",)]
    for b, c, futs, polls in ((jbat, jclk, [], []), (bat, clk, [], [])):
        for i, step in enumerate(script):
            if step[0] == "submit":
                futs.append((_x(step[1], seed=i), b.submit(_x(step[1],
                                                               seed=i))))
            elif step[0] == "advance":
                c.advance(step[1])
            else:
                polls.append(b.poll())
        b._outcome = (futs, polls)
    (jfuts, jpolls), (futs, polls) = jbat._outcome, bat._outcome
    assert polls == jpolls == [0, 0, 3, 1, 0, 1, 1]
    for (x, jf), (_, f) in zip(jfuts, futs):
        assert f.done() and jf.done()
        _close(f.result(0), jf.result(0))
        assert f.result(0).shape == (x.shape[0], OUT_DIM)
        assert set(f.breakdown) == set(jf.breakdown)
        assert f.trace_id is not None
    for name in ("serving.requests", "serving.batches", "serving.items"):
        assert ttel.value(name) == jtel.value(name)
    for name in ("serving.batch_fill", "serving.latency_s"):
        mine = ttel.snapshot()["histograms"][name]
        ref = jtel.snapshot()["histograms"][name]
        assert {k: mine[k] for k in ("count", "min", "max", "sum")} == \
            pytest.approx({k: ref[k] for k in ("count", "min", "max",
                                               "sum")})


def test_batcher_controller_hooks_match_mxtpu():
    """A controller on a plain MicroBatcher: predictive admission, the
    per-class queue depths, ``draining``, and each verdict reaching the
    controller with the request's ``meta`` (per-tenant attainment)."""
    jnet, net = _mlps()
    jbat, jclk, bat, clk = _batchers(
        _jax_pred(jnet, JBucketSpec.pow2(4)),
        _port_pred(net, BucketSpec.pow2(4)), max_batch_size=4,
        max_wait_ms=5, max_queue=4)
    got = []
    for cls, b, c in ((JServingController, jbat, jclk),
                      (ServingController, bat, clk)):
        ctrl = cls(b, min_replicas=1, max_replicas=1, min_samples=2)
        assert b._controller is ctrl and not b.draining
        futs = [b.submit(_x(1, seed=i), deadline_ms=1000,
                         meta={"tenant": "gold"}) for i in range(2)]
        futs.append(b.submit(_x(1, seed=2), deadline_ms=50,
                             meta={"tenant": "free"}))
        futs.append(b.submit(_x(1, seed=3), priority="batch",
                             meta={"tenant": "free"}))
        depths = b.queue_depths()
        # the queue is full: the interactive submit evicts the batch one
        futs.append(b.submit(_x(1, seed=4), meta={"tenant": "gold"}))
        c.advance(0.2)
        b.poll()         # the 50 ms request expired in the queue
        with pytest.raises(Exception, match="predicted_miss"):
            b.submit(_x(1, seed=5), deadline_ms=2)
        b.drain(timeout=1)
        got.append((depths, b.draining, ctrl.tenant_attainment(c()),
                    round(ctrl._sheds, 9),
                    [type(f._error).__name__ for f in futs],
                    # warm: its value holds host-measured pad and predict
                    ctrl.predicted_s(None, now=c()) is not None))
    assert got[0] == got[1]
    assert got[1][0] == {"interactive": 3, "batch": 1} and got[1][1]
    assert got[1][2] == {"gold": 1.0, "free": 0.0}
    assert got[1][4] == ["NoneType", "NoneType", "DeadlineExceeded",
                         "QueueFull", "NoneType"]
    for name in ("serving.shed", "serving.controller.decisions"):
        assert ttel.tagged(name) == jtel.tagged(name), name


def test_predictor_footprint_preflight_and_release(monkeypatch):
    """The bytes a warmed Predictor holds are recorded at its site (on the
    CPU: the snapshot, the static inputs and the buckets' outputs); the
    pre-flight before the build adds ``co_resident()`` and counts
    ``memory.overcommit`` past the device's limit; ``release()`` drops the
    buckets and the snapshot, and a later request builds again."""
    _, net = _mlps()
    spec = BucketSpec.pow2(4)
    site = "serving.predict.footprint"
    xprof.drop(site)
    pred = _port_pred(net, spec, site=site)
    params = sum(p.data().size * 4 for p in net.collect_params().values())
    statics = sum(b * IN_DIM * 4 for b in spec.batch_sizes)
    outs = sum(b * OUT_DIM * 4 for b in spec.batch_sizes)
    assert pred.param_bytes() == params
    assert xprof.site_footprint(site) == params + statics + outs
    assert ttel.value("memory.overcommit", tag=site) == 0
    monkeypatch.setattr(xprof, "CPU_BYTES_LIMIT", params + statics)
    other = Predictor(net, spec, example=np.zeros((1, IN_DIM), np.float32),
                      device="cpu", site=site + ".b", co_resident=lambda: 1)
    other.warmup()
    assert ttel.value("memory.overcommit", tag=site + ".b") == 1
    assert ttel.gauge_value("memory.preflight_bytes", tag=site + ".b") == \
        params + statics + 1
    x = _x(3, seed=8)
    before = pred.predict(x).asnumpy()
    pred.release()
    assert pred._buckets == {} and pred._stored is None
    np.testing.assert_array_equal(pred.predict(x).asnumpy(), before)
    assert pred.compile_stats()["compiles"] == len(spec) + 1
    xprof.drop(site)
    assert xprof.site_footprint(site, family=True) == 0


def test_batcher_fifo_within_seq_bucket_matches_mxtpu():
    def build(nn):
        net = nn.HybridSequential(prefix="fifo_")
        with net.name_scope():
            net.add(nn.Dense(3, flatten=False, in_units=5))
        return net

    jnet, net = build(jnn), build(tnn)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load(jnet, net, seed=6)
    spec = dict(batch_sizes=(1, 2), seq_lens=(4, 8))
    example = np.zeros((1, 4, 5), np.float32)
    jbat, jclk, bat, clk = _batchers(
        JPredictor(jnet, JBucketSpec(**spec), example=example, warmup=True),
        Predictor(net, BucketSpec(**spec), example=example, warmup=True,
                  device="cpu", site="fifo"),
        max_batch_size=2, max_wait_ms=5)
    rng = np.random.RandomState(0)
    xs = [rng.randn(1, s, 5).astype(np.float32) for s in (3, 7, 2)]
    for b, c in ((jbat, jclk), (bat, clk)):
        f1, f2, f3 = [b.submit(x) for x in xs]
        assert b.poll() == 2     # r1 + r3 (seq 4) together, in order
        assert f1.done() and f3.done() and not f2.done()
        c.advance(0.006)
        assert b.poll() == 1
        b._outs = [f.result(0) for f in (f1, f2, f3)]
    for mine, ref, x in zip(bat._outs, jbat._outs, xs):
        assert mine.shape == ref.shape
        _close(mine, ref)
        want = net(torch.from_numpy(x)).detach().numpy()
        _close(mine[:, :x.shape[1]], want)


def test_batcher_sheds_expires_and_validates_like_mxtpu():
    jnet, net = _mlps()
    jbat, jclk, bat, clk = _batchers(
        _jax_pred(jnet, JBucketSpec.pow2(8)),
        _port_pred(net, BucketSpec.pow2(8)), max_batch_size=8,
        max_wait_ms=5, max_queue=4)
    for b, c, err, qf, de in (
            (jbat, jclk, mx.base.MXNetError, JQueueFull, JDeadlineExceeded),
            (bat, clk, mt.MXNetError, QueueFull, DeadlineExceeded)):
        dead = b.submit(_x(1, seed=0), deadline_ms=3)
        live = b.submit(_x(2, seed=1), deadline_ms=50)
        with pytest.raises(qf):
            b.submit(_x(2, seed=2))              # 3 + 2 > max_queue 4
        for bad in (np.zeros((1, IN_DIM + 3), np.float32),
                    np.zeros((1, IN_DIM, 2), np.float32), np.float32(5.0),
                    (_x(1), _x(1)), _x(9), np.zeros((0, IN_DIM))):
            with pytest.raises(err):
                b.submit(bad)
        with pytest.raises(err, match="priority"):
            b.submit(_x(1), priority="urgent")
        c.advance(0.006)
        assert b.poll() == 2
        with pytest.raises(de):
            dead.result(0)
        assert live.result(0).shape == (2, OUT_DIM)
    for name, tag in (("serving.shed", "queue_full"),
                      ("serving.deadline_expired", None),
                      ("serving.requests", None), ("serving.batches", None)):
        assert ttel.value(name, tag) == jtel.value(name, tag) > 0


def test_batcher_priority_classes_match_mxtpu():
    """Sequence buckets keep cohorts apart: an interactive cohort takes the
    slot before an older batch-class one until that has aged past
    ``batch_aging_ms``, and under queue pressure the newest batch entry is
    evicted. Both packages finish the same futures after each poll."""
    def build(nn):
        net = nn.HybridSequential(prefix="prio_")
        with net.name_scope():
            net.add(nn.Dense(3, flatten=False, in_units=5))
        return net

    jnet, net = build(jnn), build(tnn)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load(jnet, net, seed=8)
    spec = dict(batch_sizes=(1, 2), seq_lens=(4, 8))
    example = np.zeros((1, 4, 5), np.float32)
    jbat, jclk, bat, clk = _batchers(
        JPredictor(jnet, JBucketSpec(**spec), example=example, warmup=True),
        Predictor(net, BucketSpec(**spec), example=example, warmup=True,
                  device="cpu", site="prio"),
        max_batch_size=2, max_wait_ms=5, max_queue=4, batch_aging_ms=100)

    def req(i, seq):
        return np.random.RandomState(i).randn(1, seq, 5).astype(np.float32)

    script = [("batch", 8), ("batch", 8), ("inter", 4), ("advance", 0.006),
              ("poll",), ("batch", 4), ("inter", 4), ("inter", 8),
              ("advance", 0.2), ("poll",), ("poll",), ("poll",)]
    for b, c in ((jbat, jclk), (bat, clk)):
        futs, trace = [], []
        for i, step in enumerate(script):
            if step[0] == "advance":
                c.advance(step[1])
            elif step[0] == "poll":
                trace.append((b.poll(), [f.done() for f in futs]))
            else:
                futs.append(b.submit(req(i, step[1]), priority=(
                    "batch" if step[0] == "batch" else "interactive")))
                trace.append([f.done() for f in futs])
        b._trace = trace
        b._errors = [type(f._error).__name__ if f._error else None
                     for f in futs]
        b._outs = [f.result(0) for f in futs if f.done() and not f._error]
    assert bat._trace == jbat._trace
    assert bat._errors == jbat._errors
    assert "QueueFull" in bat._errors
    for mine, ref in zip(bat._outs, jbat._outs):
        _close(mine, ref)
    for name, tag in (("serving.shed", "priority_evict"),
                      ("serving.controller.decisions", "yield")):
        assert ttel.value(name, tag) == jtel.value(name, tag)
    assert ttel.value("serving.shed", "priority_evict") == 1


@pytest.mark.parametrize("kind", ["serve_timeout@0", "serve_overload@1"])
def test_batcher_fault_points_match_mxtpu(monkeypatch, kind):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", kind)
    tres.set_faults(kind)
    jnet, net = _mlps()
    jbat, jclk, bat, clk = _batchers(
        _jax_pred(jnet, JBucketSpec.pow2(4)),
        _port_pred(net, BucketSpec.pow2(4)), max_batch_size=4,
        max_wait_ms=5)
    outcomes = []
    for b, c in ((jbat, jclk), (bat, clk)):
        got = []
        for i in range(3):
            try:
                got.append(b.submit(_x(1, seed=i)))
            except Exception as e:  # noqa: BLE001 — the outcome compared
                got.append(type(e).__name__)
        c.advance(0.006)
        b.poll()
        outcomes.append([g if isinstance(g, str) else
                         (type(g._error).__name__ if g._error else "ok")
                         for g in got])
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] == (["DeadlineExceeded"] * 3 if "timeout" in kind
                           else ["ok", "QueueFull", "ok"])
    assert tres.FAULT_STATS["fired"] == jres.FAULT_STATS["fired"]


def test_worker_crash_fails_queued_futures():
    _, net = _mlps()
    bat = MicroBatcher(_port_pred(net, BucketSpec.pow2(4)), max_batch_size=4,
                       max_wait_ms=5, clock=FakeClock(), start=False)
    fut = bat.submit(_x(1))
    bat._worker_crashed(RuntimeError("boom"))
    with pytest.raises(mt.MXNetError, match="crashed"):
        fut.result(0)
    with pytest.raises(QueueFull, match="worker_crashed"):
        bat.submit(_x(1))


def test_cold_predictor_refused():
    _, net = _mlps()
    cold = Predictor(net, BucketSpec([2]), device="cpu", site="cold")
    with pytest.raises(mt.MXNetError, match="warmup"):
        MicroBatcher(cold)
    MicroBatcher(cold, allow_cold=True).close(timeout=T)


# ------------------------------------------------------------- ModelServer
def _http(addr, path, payload=None, accept=None):
    url = "http://%s:%d%s" % (addr[0], addr[1], path)
    headers = {"Content-Type": "application/json"}
    if accept:
        headers["Accept"] = accept
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=T) as r:
            body = r.read()
            return r.status, (body.decode() if accept else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _server(net, **kw):
    pred = _port_pred(net, BucketSpec.pow2(8))
    return ModelServer(MicroBatcher(pred, max_batch_size=8, max_wait_ms=1),
                       **kw).start()


def test_server_round_trip_healthz_metrics():
    jnet, net = _mlps()
    srv = _server(net)
    try:
        x = _x(2, seed=5)
        code, out = _http(srv.address, "/predict", {"data": x.tolist()})
        assert code == 200 and out["n"] == 2
        _close(np.asarray(out["outputs"][0]), jnet(mx.nd.array(x)).asnumpy())
        assert out["trace_id"] and out["e2e_ms"] >= 0
        assert {"serving.queue_wait", "serving.predict", "serving.fetch",
                "serving.submit", "serving.deliver",
                "serving.pad"} <= set(out["breakdown_ms"])
        code, health = _http(srv.address, "/healthz")
        assert code == 200 and health == {"status": "ok", "queue_depth": 0}
        code, m = _http(srv.address, "/metrics")
        assert code == 200 and m["counters"]["serving.requests"] == 1
        assert m["retrace"]["serving.predict"]["compiles"] == 4
        code, text = _http(srv.address, "/metrics", accept="text/plain")
        assert code == 200 and "mxtpu_serving_requests 1" in text
        assert _http(srv.address, "/nope")[0] == 404
    finally:
        srv.close()


def test_server_sheds_503_on_injected_overload():
    tres.set_faults("serve_overload@0")
    _, net = _mlps()
    srv = _server(net)
    try:
        code, out = _http(srv.address, "/predict",
                          {"data": _x(1, seed=0).tolist()})
        assert code == 503 and "shed" in out["error"]
        code, _ = _http(srv.address, "/predict",
                        {"data": _x(1, seed=1).tolist()})
        assert code == 200
        assert ttel.value("serving.shed", tag="injected_overload") == 1
    finally:
        srv.close()


def test_server_bad_requests_are_400():
    _, net = _mlps()
    srv = _server(net)
    try:
        for body in ({}, {"deadline_ms": 5}, {"inputs": []},
                     {"data": [[1.0, 2.0], [3.0]]}, {"data": 5},
                     {"data": np.ones((1, IN_DIM + 1)).tolist()}):
            assert _http(srv.address, "/predict", body)[0] == 400, body
        code, out = _http(srv.address, "/predict",
                          {"data": _x(9).tolist()})
        assert code == 400 and "max_batch" in out["error"]
    finally:
        srv.close()


def test_server_answers_500_when_an_admitted_batch_fails(monkeypatch):
    """An error raised while the batch runs is the server's, not the
    client's: 500, with the error named, and the next request is served."""
    _, net = _mlps()
    srv = _server(net)
    pred = srv.batcher._pred
    real = pred.predict_flat
    calls = []

    def failing(args):
        calls.append(1)
        if len(calls) == 1:
            raise mt.MXNetError("device lost")
        return real(args)

    monkeypatch.setattr(pred, "predict_flat", failing)
    try:
        code, out = _http(srv.address, "/predict",
                          {"data": _x(1, seed=0).tolist()})
        assert code == 500 and "device lost" in out["error"]
        assert _http(srv.address, "/predict",
                     {"data": _x(1, seed=1).tolist()})[0] == 200
        assert ttel.value("serving.batch_errors") == 1
    finally:
        srv.close()


def test_server_drain_finishes_queued_then_503():
    """begin_drain: requests already queued finish and answer 200, a new
    POST gets 503 and /healthz says draining."""
    _, net = _mlps()
    clk = FakeClock()
    bat = MicroBatcher(_port_pred(net, BucketSpec.pow2(8)),
                       max_batch_size=8, max_wait_ms=5, clock=clk,
                       start=False)
    srv = ModelServer(bat).start()
    results = []
    try:
        posts = [threading.Thread(target=lambda i=i: results.append(_http(
            srv.address, "/predict", {"data": _x(1, seed=i).tolist()})))
            for i in range(3)]
        for t in posts:
            t.start()
        deadline = time.monotonic() + T
        while bat.queue_depth < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert bat.queue_depth == 3
        assert srv.begin_drain(timeout=T) is True
        for t in posts:
            t.join(T)
        assert sorted(code for code, _ in results) == [200, 200, 200]
        code, out = _http(srv.address, "/predict",
                          {"data": _x(1).tolist()})
        assert code == 503 and out["error"] == "draining"
        assert _http(srv.address, "/healthz")[1]["status"] == "draining"
    finally:
        srv.close()


def test_server_sigterm_drains():
    _, net = _mlps()
    srv = _server(net).install_signal_handlers()
    try:
        assert _http(srv.address, "/predict",
                     {"data": _x(2).tolist()})[0] == 200
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + T
        while not srv.draining and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.draining
        srv._drain_thread.join(T)
        assert srv.batcher.queue_depth == 0
        assert _http(srv.address, "/predict",
                     {"data": _x(1).tolist()})[0] == 503
        assert ttel.value("serving.drains") == 1
    finally:
        srv.close()
    assert signal.getsignal(signal.SIGTERM) != srv._on_signal


def test_server_orphans_expire_instead_of_executing():
    """A request whose handler already answered 504 expires at dispatch:
    the batcher's deadline defaults to the handler's timeout."""
    _, net = _mlps()
    clk = FakeClock()
    bat = MicroBatcher(_port_pred(net, BucketSpec.pow2(8)),
                       max_batch_size=8, max_wait_ms=5, clock=clk,
                       start=False)
    srv = ModelServer(bat, request_timeout_s=0.05).start()
    try:
        code, _ = _http(srv.address, "/predict", {"data": _x(1).tolist()})
        assert code == 504
        clk.advance(1.0)
        assert bat.poll() == 1
        assert ttel.value("serving.deadline_expired") == 1
        assert ttel.value("serving.batches") == 0
    finally:
        srv.close()


def test_server_reads_json_in_the_template_dtype():
    """A bfloat16 model's JSON input goes as float32 and is cast into the
    bucket; the answer equals the direct predict."""
    _, net = _mlps()
    net.cast("bfloat16")
    pred = Predictor(net, BucketSpec([2]), device="cpu", warmup=True,
                     example=torch.zeros(1, IN_DIM, dtype=torch.bfloat16),
                     site="bf16")
    srv = ModelServer(pred).start()
    try:
        x = _x(2, seed=8)
        code, out = _http(srv.address, "/predict", {"data": x.tolist()})
        assert code == 200
        want = pred.predict(torch.from_numpy(x).to(torch.bfloat16))
        np.testing.assert_array_equal(np.asarray(out["outputs"][0]),
                                      want.asnumpy())
        assert pred.compile_stats()["compiles"] == 1
    finally:
        srv.close()


# ------------------------------------------------------- KV residency hooks
def test_batcher_admission_gate_sheds_like_mxtpu():
    """A KV accountant's gate plugs into the plain MicroBatcher of either
    package: a full pool sheds ``kv_residency`` at submit, a freed one
    admits again, and the counters agree."""
    from mxtpu.serving import KVCacheAccountant as JKVCacheAccountant
    from mxtpu_torch.serving import KVCacheAccountant
    jnet, net = _mlps()
    accts = [JKVCacheAccountant(capacity_bytes=100, overcommit=1.0),
             KVCacheAccountant(capacity_bytes=100, overcommit=1.0)]
    for a in accts:
        a.register("r0", per_slot_bytes=100, slots=1)
    jclk, clk = FakeClock(), FakeClock()
    jbat = JMicroBatcher(_jax_pred(jnet, JBucketSpec([2])), clock=jclk,
                         start=False, max_batch_size=2, max_wait_ms=5,
                         admission_gate=accts[0].gate("r0"))
    bat = MicroBatcher(_port_pred(net, BucketSpec([2])), clock=clk,
                       start=False, max_batch_size=2, max_wait_ms=5,
                       admission_gate=accts[1].gate("r0"))
    futs = []
    for b, a, qf in ((jbat, accts[0], JQueueFull),
                     (bat, accts[1], QueueFull)):
        futs.append(b.submit(_x(1, seed=1)))     # the pool is empty
        assert a.try_admit("r0")
        a.occupy("r0")                           # now it is full
        with pytest.raises(qf, match="kv_residency"):
            b.submit(_x(1, seed=2))
        a.release("r0")
        futs.append(b.submit(_x(1, seed=3)))
    for c in (jclk, clk):
        c.advance(0.006)
    assert jbat.poll() == bat.poll() == 2
    for mine, ref in zip(futs[2:], futs[:2]):
        _close(mine.result(T), ref.result(T))
    assert ttel.value("serving.shed", "kv_residency") == \
        jtel.value("serving.shed", "kv_residency") == 1


def test_server_healthz_kv_block():
    """Over a ReplicaDispatcher whose ReplicaSet carries a KV accountant,
    ``/healthz`` reports its snapshot under ``kv`` and each replica's
    resident bytes; without one, no ``kv`` block."""
    from mxtpu_torch.serving import KVCacheAccountant, ReplicaSet
    _, net = _mlps()
    rs = ReplicaSet(net, BucketSpec.pow2(4), devices=["cpu"],
                    example=np.zeros((1, IN_DIM), np.float32), warmup=True)
    srv = ModelServer(rs).start()
    try:
        code, health = _http(srv.address, "/healthz")
        assert code == 200 and "kv" not in health
        acct = KVCacheAccountant(overcommit=2.0)
        rs.attach_accountant(acct)
        acct.register("r0", per_slot_bytes=48, slots=4, bucket_slots=(2, 4))
        assert acct.try_admit("r0", n=3)
        acct.occupy("r0", n=2)
        code, health = _http(srv.address, "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["kv"] == {"r0": {
            "capacity_bytes": 192, "per_slot_bytes": 48, "slots": 4,
            "page_tokens": 0, "live": 2, "queued": 1,
            "resident_bytes": 96, "bucket_bytes": {"2": 96, "4": 192}}}
        assert health["replicas"][0]["kv_resident_bytes"] == 96
    finally:
        srv.close()
