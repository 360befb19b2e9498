"""The port's model zoo (``mxtpu_torch/serving/zoo.py``, with ``xprof`` and
the Predictor's co-residency pre-flight) against the JAX package's on the
CPU.

Both zoos register the same small nets with the same seeded weights
(``convert.seeded_params``) and get the same traffic and fake-clock script
through ``poll()``: the tests hold the canary arm each request id takes
(``crc32``), the order of page-ins and evictions under a count cap and a
byte budget, the cold policies with their overflow, the ``zoo_cold`` and
``canary_rollback`` faults, promote and rollback with no dropped future,
and every answer (within 1e-5 of max|output|, float32) to the reference's.
Footprints differ by design (the port counts what its Predictors hold, the
reference its executables' ledger), so decisions are compared, not bytes.
Then the port's own differences: a page-in captures one graph per bucket
and reads nothing from disk, and a checkpoint version loads its
parameters through ``model.load_checkpoint`` on first use.
Every future, urlopen and join has a timeout."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import mxtpu as mx
from mxtpu import compile_service as jcsvc
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.gluon import nn as jnn
from mxtpu.serving import BucketSpec as JBucketSpec
from mxtpu.serving import ModelZoo as JModelZoo
from mxtpu.serving import ZooScheduler as JZooScheduler
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch import xprof
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.serving import (BucketSpec, ModelServer, ModelZoo,
                                 QueueFull, ZooScheduler, ZooVersion)
from mxtpu_torch.serving import zoo as tzoo

IN_DIM, OUT_DIM = 6, 4
ZOO_SITE = "serving.predict.zoo"
T = 30   # seconds any wait may take


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_TELEMETRY", "MXTPU_TRACE", "MXTPU_RETRACE_BUDGET",
                "MXTPU_FAULT_INJECT", "MXTPU_SERVE_MAX_BATCH",
                "MXTPU_SERVE_MAX_WAIT_MS", "MXTPU_SERVE_QUEUE",
                "MXTPU_SERVE_BATCH_AGING_MS", "MXTPU_SERVE_INT8",
                "MXTPU_ZOO_MAX_RESIDENT", "MXTPU_ZOO_HBM_BUDGET",
                "MXTPU_ZOO_COLD_POLICY", "MXTPU_ZOO_PAGEIN_QUEUE",
                "MXTPU_ZOO_DEMAND_HORIZON_S", "MXTPU_ZOO_CANARY_FLOOR",
                "MXTPU_ZOO_CANARY_WINDOW", "MXTPU_ZOO_PARITY_TOL",
                "MXTPU_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    for mod in (jtel, ttel):
        mod.reset()
    jres.reset_faults()
    tres.reset_faults()
    jcsvc.reset()
    xprof.drop("serving")        # every footprint record of a serving site
    yield
    for mod in (jtel, ttel):
        mod.reset()
    jres.reset_faults()
    tres.reset_faults()
    jcsvc.reset()
    xprof.drop("serving")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _mlps(seed):
    def build(nn):
        net = nn.HybridSequential(prefix="mlp%d_" % seed)
        with net.name_scope():
            net.add(nn.Dense(8, activation="relu", in_units=IN_DIM),
                    nn.Dense(OUT_DIM, in_units=8))
        return net

    jnet, net = build(jnn), build(tnn)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=10 + seed)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    convert.load_mxtpu_params(net, arrays)
    return jnet, net, arrays


def _x(n, seed=0):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


class Zoos:
    """The same zoo and scheduler in both packages, on two fake clocks;
    every page-in and eviction is logged in order."""

    def __init__(self, models=("alpha",), manifest_dir=None, jenv=None,
                 monkeypatch=None, **kw):
        for k, v in (jenv or {}).items():
            monkeypatch.setenv(k, v)
        self.jzoo, self.zoo = JModelZoo(manifest_dir=manifest_dir), \
            ModelZoo(manifest_dir=manifest_dir)
        self.arrays = {}
        ex = np.zeros((1, IN_DIM), np.float32)
        for i, name in enumerate(models):
            jnet, net, arrays = _mlps(i)
            self.arrays[name] = arrays
            self.jzoo.register(name, jnet, JBucketSpec([1, 4]), example=ex)
            self.zoo.register(name, net, BucketSpec([1, 4]), example=ex)
        kw.setdefault("start", False)
        self.jclk, self.clk = FakeClock(), FakeClock()
        jkw = {k: v for k, v in kw.items() if k not in (
            "canary_floor", "canary_window", "int8")}
        self.jsched = JZooScheduler(self.jzoo, clock=self.jclk,
                                    devices=[jax.devices()[0]], **jkw)
        self.sched = ZooScheduler(self.zoo, clock=self.clk,
                                  devices=["cpu"], **kw)
        self.jevents, self.events = self._log(self.jsched), \
            self._log(self.sched)
        self.futs = []

    @staticmethod
    def _log(sched):
        events = []
        pagein, evict = sched._pagein, sched._evict

        def logged_pagein(model):
            events.append(("pagein", model))
            return pagein(model)

        def logged_evict(model, reason):
            events.append(("evict", model, reason))
            return evict(model, reason)

        sched._pagein, sched._evict = logged_pagein, logged_evict
        return events

    def both(self, fn):
        return fn(self.jsched, self.jzoo), fn(self.sched, self.zoo)

    def advance(self, s):
        self.jclk.advance(s)
        self.clk.advance(s)

    def drive(self, rounds=3, dt=0.006):
        """Advance and poll ``rounds`` times, then until both are idle."""
        for k in range(rounds + 64):
            self.advance(dt)
            got = self.both(lambda s, z: s.poll())
            assert got[0] == got[1]
            if k >= rounds and not got[1]:
                return
        raise AssertionError("the schedulers never went idle")

    def submit(self, model, n, seed, **kw):
        outs, futs = [], []
        for s in (self.jsched, self.sched):
            try:
                futs.append(s.submit(model, _x(n, seed), **kw))
                outs.append("queued")
            except Exception as e:  # noqa: BLE001 — the outcome compared
                outs.append(type(e).__name__ + ": " + str(e))
        assert outs[0] == outs[1], outs
        if len(futs) == 2:
            self.futs.append(tuple(futs))
        return outs[1]

    def same(self):
        """Page-in/eviction order, residents and every outcome agree."""
        assert self.events == self.jevents
        assert sorted(self.sched._residents) == \
            sorted(self.jsched._residents)
        for jf, f in self.futs:
            assert f.done() == jf.done()
            try:
                ref = jf.result(timeout=T)
            except Exception as e:  # noqa: BLE001 — the outcome compared
                with pytest.raises(Exception) as got:
                    f.result(timeout=T)
                assert (type(got.value).__name__, str(got.value)) == \
                    (type(e).__name__, str(e))
                continue
            _close(f.result(timeout=T), ref)


def _counters(*names):
    for name in names:
        assert ttel.tagged(name) == jtel.tagged(name), name


# ------------------------------------------------------------- cold policy
def test_cold_policy_shed_like_mxtpu():
    z = Zoos(cold_policy="shed")
    assert z.submit("alpha", 1, 0) == \
        "QueueFull: request shed: zoo_cold (model 'alpha')"
    assert ttel.value("serving.shed", tag="zoo_cold") == 1
    assert not z.sched._residents
    z.same()


def test_cold_queue_bounded_pagein_wait_like_mxtpu():
    z = Zoos(pagein_queue=2)
    assert z.submit("alpha", 1, 1) == "queued"
    assert z.submit("alpha", 2, 2) == "queued"
    assert not z.futs[0][1].done()
    assert z.submit("alpha", 1, 3).startswith("QueueFull")   # overflow
    z.drive()
    z.same()
    assert z.submit("alpha", 1, 4) == "queued"   # warm now
    z.drive()
    z.same()
    assert z.events == [("pagein", "alpha")]
    _counters("zoo.pageins", "serving.shed")


def test_zoo_cold_fault_like_mxtpu(monkeypatch):
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "zoo_cold@0")
    jres.reset_faults()
    tres.set_faults("zoo_cold@0")
    assert z.submit("alpha", 1, 0).startswith("QueueFull: request shed: "
                                              "zoo_cold")
    assert z.submit("alpha", 1, 1) == "queued"    # exactly once
    z.drive()
    z.same()
    assert tres.FAULT_STATS["fired"] == [("zoo_cold", 0)]


def test_unknown_model_refused_with_the_known_names():
    z = Zoos(("alpha", "beta"))
    assert z.submit("nope", 1, 0) == \
        "MXNetError: ModelZoo: unknown model 'nope' (known: alpha, beta)"


# --------------------------------------------------------------- placement
def test_eviction_order_under_a_count_cap_like_mxtpu():
    """Three models, two slots: the coldest resident goes first, and
    every queued future of an evicted model completes before it does."""
    z = Zoos(("alpha", "beta", "gamma"), max_resident=2)
    for i in range(3):
        z.submit("alpha", 1, i)
    z.drive()
    # one cold model at a time: page-ins pending together run in the order
    # of a set of names in both packages
    z.submit("beta", 1, 10)
    z.drive()
    z.advance(0.5)
    z.submit("alpha", 1, 20)         # queued on alpha, not dispatched
    z.submit("gamma", 2, 21)         # evicts beta (the colder)
    z.drive()
    z.advance(0.5)
    for i in range(4):
        z.submit("gamma", 1, 30 + i)
    z.submit("beta", 1, 40)          # evicts alpha now
    z.drive()
    z.same()
    assert z.events == [
        ("pagein", "alpha"), ("pagein", "beta"), ("pagein", "gamma"),
        ("evict", "beta", "capacity"), ("pagein", "beta"),
        ("evict", "alpha", "capacity")]
    _counters("zoo.evictions", "zoo.pageins")
    assert all(f.result(timeout=T) is not None for _, f in z.futs)


def test_count_cap_alternation_never_strands_like_mxtpu():
    z = Zoos(("alpha", "beta"), max_resident=1)
    for k in range(6):
        model = ("alpha", "beta")[k % 2]
        z.submit(model, 1, k)
        z.submit(model, 2, 100 + k)
        z.drive()
    z.same()
    # a page-in is logged as it starts; the eviction it makes follows
    assert z.events == [e for k in range(6) for e in (
        [("pagein", ("alpha", "beta")[k % 2])] + (
            [("evict", ("alpha", "beta")[(k + 1) % 2], "capacity")]
            if k else []))]
    assert ttel.gauge_value("zoo.resident_models") == 1
    assert ttel.gauge_value("zoo.hbm_resident_bytes", tag="alpha") == 0


def test_byte_budget_evicts_like_mxtpu():
    z = Zoos(("alpha", "beta"))
    ra = z.sched.ensure_resident("alpha")
    jra = z.jsched.ensure_resident("alpha")
    assert ra.footprint > 0 and jra.footprint > 0
    z.sched.hbm_budget = int(ra.footprint * 1.5)
    z.jsched.hbm_budget = int(jra.footprint * 1.5)
    z.submit("beta", 1, 0)
    z.drive()
    z.same()
    assert ("evict", "alpha", "capacity") in z.events
    assert ttel.value("zoo.evictions", tag="alpha:capacity") == 1


def test_manual_evict_completes_queued_and_releases():
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    pred = z.sched._residents["alpha"].stable.predictor
    assert xprof.site_footprint(ZOO_SITE + ".alpha") > 0
    z.submit("alpha", 2, 0)
    released = z.both(lambda s, zz: s.evict("alpha", "manual"))[1]
    assert released == 2 and pred._buckets == {} and pred._stored is None
    assert xprof.site_footprint(ZOO_SITE + ".alpha") == 0
    z.submit("alpha", 1, 1)          # cold again
    z.drive()
    z.same()
    _counters("zoo.pageins", "zoo.evictions")
    assert ttel.value("zoo.pageins", tag="alpha") == 2


def test_co_residency_preflight_warns_before_a_pagein(monkeypatch):
    """The pre-flight adds the co-residents' bytes: a limit that fits beta
    alone but not beside alpha counts ``memory.overcommit`` at beta's
    page-in, before it builds."""
    z = Zoos(("alpha", "beta"))
    ra = z.sched.ensure_resident("alpha")
    site_b = ZOO_SITE + ".beta"
    alone = z.sched._residents["alpha"].stable.predictor._static_bytes()
    # placement reads the budget, the pre-flight the device's limit
    z.sched.hbm_budget = 1 << 40
    monkeypatch.setattr(xprof, "CPU_BYTES_LIMIT",
                        alone + ra.footprint // 2)
    z.sched.ensure_resident("beta")
    assert ttel.value("memory.overcommit", tag=site_b) == 1
    assert ttel.gauge_value("memory.preflight_bytes", tag=site_b) == \
        alone + ra.footprint
    fp_b = xprof.site_footprint(site_b, family=True)
    limit = fp_b + ra.footprint // 2
    assert xprof.preflight(site_b, limit=limit) == (fp_b, limit)
    need, _ = xprof.preflight(site_b, limit=limit, extra_bytes=ra.footprint)
    assert need == fp_b + ra.footprint > limit
    assert ttel.value("memory.overcommit", tag=site_b) == 2


# ----------------------------------------------------------------- rollout
def _v2(z, model="alpha", scale=1.01):
    """A version whose weights are the first's times ``scale``, in both."""
    params = {k: np.asarray(v) * np.float32(scale)
              for k, v in z.arrays[model].items()}
    z.jzoo.add_version(model, "v2", params=params)
    z.zoo.add_version(model, "v2", params=params)
    return params


def test_canary_routes_by_crc32_like_mxtpu():
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    _v2(z)
    outs = z.both(lambda s, zz: zz.deploy("alpha", "v2", canary_frac=0.5))
    assert outs[0]["mode"] == outs[1]["mode"] == "canary"
    jres_, res = z.jsched._residents["alpha"], z.sched._residents["alpha"]
    arms = [z.sched._pick_arm(res, None, i).version for i in range(200)]
    assert arms == [z.jsched._pick_arm(jres_, None, i).version
                    for i in range(200)]
    assert 60 < arms.count("v2") < 140
    for i in range(24):
        z.submit("alpha", 1, i, request_id=i)
    assert res.canary.batcher.queue_depth == \
        jres_.canary.batcher.queue_depth > 0
    z.drive()
    z.same()            # each arm answers as its own version


def test_promote_swaps_params_without_capture_like_mxtpu():
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    params = _v2(z)
    z.both(lambda s, zz: zz.deploy("alpha", "v2", canary_frac=0.5))
    res = z.sched._residents["alpha"]
    stable = res.stable.predictor
    compiles = ttel.retrace_stats(ZOO_SITE + ".alpha")["compiles"]
    for i in range(24):
        z.submit("alpha", 1, i, request_id=i)
    outs = z.both(lambda s, zz: s.promote("alpha"))
    assert outs[0]["mode"] == outs[1]["mode"] == "promoted"
    z.drive()
    z.same()            # zero drops across the promote
    assert res.canary is None and res.stable.predictor is stable
    assert z.zoo.active_version("alpha") == "v2"
    assert stable.param_version == "v2"
    assert ttel.retrace_stats(ZOO_SITE + ".alpha")["compiles"] == compiles
    assert ttel.value("serving.param_refreshes",
                      tag=ZOO_SITE + ".alpha") == 1
    assert xprof.site_footprint(ZOO_SITE + ".alpha.canary") == 0
    _counters("zoo.promotes", "zoo.deploys")
    # after the promote the stable arm answers as v2
    x = _x(3, seed=77)
    net = z.zoo._get("alpha").block
    ref = z.jsched._residents["alpha"].stable.predictor.predict(x)
    _close(stable.predict(x).asnumpy(), ref.asnumpy())
    assert set(params) == set(z.zoo.version("alpha", "v2").params)
    assert net is not None


def test_canary_build_does_not_move_the_stable_arm():
    """The shared block gets the canary's weights for its build; the
    stable Predictor serves its own snapshot throughout."""
    z = Zoos()
    z.sched.ensure_resident("alpha")
    stable = z.sched._residents["alpha"].stable.predictor
    x = _x(2, seed=5)
    before = stable.predict(x).asnumpy()
    _v2(z, scale=3.0)
    z.zoo.deploy("alpha", "v2", canary_frac=0.5)
    np.testing.assert_array_equal(stable.predict(x).asnumpy(), before)
    canary = z.sched._residents["alpha"].canary.predictor
    assert np.abs(canary.predict(x).asnumpy() - before).max() > 1e-3


def test_injected_rollback_mid_cohort_zero_drops_like_mxtpu(monkeypatch):
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    _v2(z)
    z.both(lambda s, zz: zz.deploy("alpha", "v2", canary_frac=0.5))
    res = z.sched._residents["alpha"]
    for i in range(24):
        z.submit("alpha", 1, i, request_id=i)
    assert res.canary.batcher.queue_depth > 0
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "canary_rollback@0")
    jres.reset_faults()
    tres.set_faults("canary_rollback@0")
    z.both(lambda s, zz: s.tick(s._clock()))
    assert res.canary is None
    z.drive()
    z.same()
    assert z.zoo.active_version("alpha") == "v1"
    _counters("zoo.rollbacks")
    assert ttel.value("zoo.rollbacks", tag="injected") == 1
    z.submit("alpha", 1, 999, request_id=999)
    z.drive()
    z.same()


def test_slo_rollback_like_mxtpu(monkeypatch):
    z = Zoos(jenv={"MXTPU_ZOO_CANARY_WINDOW": "4",
                   "MXTPU_ZOO_CANARY_FLOOR": "0.8"},
             monkeypatch=monkeypatch, canary_window=4, canary_floor=0.8)
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    _v2(z)
    z.both(lambda s, zz: zz.deploy("alpha", "v2", canary_frac=0.5))
    for s in (z.jsched, z.sched):
        arm = s._residents["alpha"].canary
        for _ in range(3):
            arm.ctrl.note_expired(s._clock(), meta={"tenant": "gold"})
        s.tick(s._clock())
        assert s._residents["alpha"].canary is not None   # window not full
        for _ in range(3):
            arm.ctrl.note_expired(s._clock(), meta={"tenant": "gold"})
        s.tick(s._clock())
        assert s._residents["alpha"].canary is None
    _counters("zoo.rollbacks")
    assert ttel.value("zoo.rollbacks", tag="slo") == 1


def test_parity_probe_rolls_back_like_mxtpu():
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    bad = {k: np.asarray(v) * 100.0 + 7.0
           for k, v in z.arrays["alpha"].items()}
    z.jzoo.add_version("alpha", "v2", params=bad)
    z.zoo.add_version("alpha", "v2", params=bad)
    outs = z.both(lambda s, zz: zz.deploy(
        "alpha", "v2", canary_frac=0.5, parity_example=_x(2, seed=9),
        parity_tol=1e-3))
    assert outs[1]["mode"] == outs[0]["mode"] == "rolled_back"
    assert outs[1]["reason"] == "parity"
    assert outs[1]["diff"] == pytest.approx(outs[0]["diff"], rel=1e-5)
    assert z.sched._residents["alpha"].canary is None
    assert xprof.site_footprint(ZOO_SITE + ".alpha.canary") == 0
    for zz in (z.jzoo, z.zoo):
        zz.add_version("alpha", "v3")
    outs = z.both(lambda s, zz: zz.deploy(
        "alpha", "v3", canary_frac=0.5, parity_example=_x(2, seed=9),
        parity_tol=1e-3))
    assert outs[0]["mode"] == outs[1]["mode"] == "canary"
    _counters("zoo.rollbacks")


def test_version_pinning_like_mxtpu():
    z = Zoos()
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    _v2(z)
    z.both(lambda s, zz: zz.deploy("alpha", "v2", canary_frac=0.3))
    assert z.submit("alpha", 1, 0, version="v2", request_id=1) == "queued"
    assert z.sched._residents["alpha"].canary.batcher.queue_depth == 1
    assert z.submit("alpha", 1, 1, version="v9") == \
        "MXNetError: ModelZoo: version 'v9' of model 'alpha' is not live " \
        "(live: v1, v2)"
    z.drive()
    z.same()


def test_int8_pin_holds_across_a_versioned_swap_like_mxtpu(monkeypatch):
    z = Zoos(jenv={"MXTPU_SERVE_INT8": "1"}, monkeypatch=monkeypatch,
             int8=True)
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    pred = z.sched._residents["alpha"].stable.predictor
    assert pred.int8
    qd0 = list(pred._qdtypes)
    assert any(q is not None for q in qd0)
    compiles = ttel.retrace_stats(ZOO_SITE + ".alpha")["compiles"]
    zeros = {k: np.zeros_like(np.asarray(v))
             for k, v in z.arrays["alpha"].items()}
    z.jzoo.add_version("alpha", "v2", params=zeros)
    z.zoo.add_version("alpha", "v2", params=zeros)
    z.both(lambda s, zz: zz.deploy("alpha", "v2"))
    assert pred.param_version == "v2" and list(pred._qdtypes) == qd0
    z.submit("alpha", 2, 0)
    z.drive()
    z.same()
    np.testing.assert_allclose(z.futs[0][1].result(timeout=T), 0.0,
                               atol=1e-6)
    assert ttel.retrace_stats(ZOO_SITE + ".alpha")["compiles"] == compiles
    assert ttel.gauge_value("zoo.active_version", tag="alpha") == 1


# ------------------------------------------------------------ tenancy/SLO
def test_tenant_classes_and_priority_isolation_like_mxtpu():
    z = Zoos(batcher_kw={"max_queue": 4, "max_wait_ms": 5},
             tenants={"gold": {"priority": "interactive",
                               "deadline_ms": 500},
                      "free": {"priority": "batch", "deadline_ms": 500}})
    z.both(lambda s, zz: s.ensure_resident("alpha"))
    for i in range(4):
        z.submit("alpha", 1, i, tenant="free")
    z.submit("alpha", 2, 9, tenant="gold")      # evicts, never sheds
    assert [f.done() for _, f in z.futs] == [jf.done() for jf, _ in z.futs]
    z.drive()
    z.same()
    z.submit("alpha", 1, 10, tenant="gold")
    z.drive()
    z.same()
    _counters("serving.shed")
    ta = z.both(lambda s, zz: s._residents["alpha"].stable.ctrl
                .tenant_attainment(s._clock()))
    assert ta[0] == ta[1] and ta[1]["gold"] == 1.0 and "free" in ta[1]
    assert ttel.gauge_value("serving.tenant_attainment", tag="gold") == 1.0


def test_pagein_deadline_expiry_feeds_tenant_attainment_like_mxtpu():
    z = Zoos(tenants={"gold": {"priority": "interactive",
                               "deadline_ms": 50}})
    z.submit("alpha", 1, 0, tenant="gold")
    z.advance(0.2)                  # the page-in takes 200 ms
    z.both(lambda s, zz: s.poll())
    z.same()
    with pytest.raises(mt.MXNetError, match="page-in"):
        z.futs[0][1].result(timeout=T)
    assert ttel.value("serving.deadline_expired") == 1
    ta = z.both(lambda s, zz: s._residents["alpha"].stable.ctrl
                .tenant_attainment(s._clock()))
    assert ta[0] == ta[1] == {"gold": 0.0}


# ---------------------------------------------------------------- registry
def test_registry_manifest_and_refusals(tmp_path):
    z = Zoos(manifest_dir=str(tmp_path))
    z.zoo.add_version("alpha", "v2")
    man = z.zoo.manifest()
    assert man["format"] == 1 and man["models"]["alpha"]["active"] == "v1"
    assert set(man["models"]["alpha"]["versions"]) == {"v1", "v2"}
    assert man["models"]["alpha"]["versions"]["v2"]["ordinal"] == 1
    z.zoo.set_active("alpha", "v2")
    assert z.zoo.manifest()["models"]["alpha"]["active"] == "v2"
    ver = z.zoo.version("alpha", "v2")
    assert isinstance(ver, ZooVersion)
    # a snapshot is a copy: it does not move with the block
    net = z.zoo._get("alpha").block
    w = next(iter(net.collect_params().values()))
    before = ver.params[w.name].clone()
    w.set_data(np.zeros(w.shape, np.float32))
    assert torch.equal(ver.params[w.name], before)
    _, other, _ = _mlps(5)
    with pytest.raises(mt.MXNetError, match="already registered"):
        z.zoo.register("alpha", other, BucketSpec([1]))
    with pytest.raises(mt.MXNetError, match="immutable"):
        z.zoo.add_version("alpha", "v1")
    with pytest.raises(mt.MXNetError, match="unknown version"):
        z.zoo.version("alpha", "v9")
    with pytest.raises(mt.MXNetError, match="A-Za-z0-9"):
        ModelZoo().register("bad name!", other, BucketSpec([1]))


def test_checkpoint_versions_raise_naming_a7(tmp_path):
    """A version that names a checkpoint ``(prefix, epoch)`` registers
    without reading it; ``apply_version`` loads its parameters through
    ``model.load_checkpoint`` on first use (as the reference's lazy
    page-in does) and keeps them. A checkpoint that is not there raises at
    that first use, and nothing names A7 any more."""
    z = Zoos()
    _, other, arrays = _mlps(6)
    block = z.zoo._get("alpha").block
    # the other net's weights under alpha's parameter names
    saved = dict(zip(block.collect_params(), arrays.values()))
    prefix = str(tmp_path / "alpha")
    with mt.cpu():
        mt.model.save_checkpoint(
            prefix, 3, None, {k: mt.nd.array(v) for k, v in saved.items()},
            {})
    ver = z.zoo.add_version("alpha", "v2", checkpoint=(prefix, 3))
    assert ver.params is None and ver.describe()["checkpoint"] == (prefix, 3)
    z.zoo.apply_version("alpha", "v2")
    assert sorted(ver.params) == sorted(saved)
    for k, p in block.collect_params().items():
        np.testing.assert_array_equal(p._tensor().detach().numpy(), saved[k])
    z.zoo.add_version("alpha", "v3", checkpoint=(str(tmp_path / "no"), 1))
    with pytest.raises(OSError):
        z.zoo.apply_version("alpha", "v3")
    m = ModelZoo().register("m", other, BucketSpec([1]),
                            checkpoint=(prefix, 3))
    assert m.versions["v1"].params is None
    assert z.zoo.versions("alpha") == ["v1", "v2", "v3"]


def test_pagein_captures_one_graph_per_bucket_and_reads_no_disk():
    """Deliberate difference: the reference's page-in loads executables
    from the compile cache; the port's builds each bucket once at
    ``serving.predict.zoo.<model>`` (a capture on the card) and nothing
    after it."""
    z = Zoos()
    site = ZOO_SITE + ".alpha"
    res = z.sched.ensure_resident("alpha")
    assert res.warm_summary == {"built": 2, "disk": 0}
    assert ttel.retrace_stats(site)["compiles"] == 2
    for i in range(12):
        z.sched.submit("alpha", _x(1 + i % 4, seed=i))
        z.clk.advance(0.006)
        z.sched.poll()
    assert ttel.retrace_stats(site)["compiles"] == 2
    z.sched.evict("alpha")
    res = z.sched.ensure_resident("alpha")
    assert res.warm_summary == {"built": 2, "disk": 0}
    assert ttel.retrace_stats(site)["compiles"] == 4
    view = z.sched.view()["models"]["alpha"]
    assert view["warm_compiles"] == 2 and view["warm_disk_hits"] == 0


def test_drain_fails_pending_and_sheds_new_like_mxtpu():
    z = Zoos()
    z.submit("alpha", 1, 0)          # pending behind the page-in
    assert z.both(lambda s, zz: s.drain(timeout=1)) == (True, True)
    z.same()
    with pytest.raises(QueueFull, match="draining"):
        z.futs[0][1].result(timeout=1)
    assert z.submit("alpha", 1, 1).startswith("QueueFull: request shed: "
                                              "draining")


def test_scheduler_device_rules(monkeypatch):
    z = Zoos()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        ZooScheduler(z.zoo, start=False)
    with pytest.raises(mt.MXNetError, match="cold_policy"):
        ZooScheduler(z.zoo, devices=["cpu"], start=False, cold_policy="x")
    s = ZooScheduler(z.zoo, devices=["cpu"], start=False)
    assert (s.max_resident, s.hbm_budget, s.cold_policy, s.pagein_queue,
            s.canary_floor, s.canary_window) == (
        tzoo.MAX_RESIDENT, tzoo.HBM_BUDGET, tzoo.COLD_POLICY,
        tzoo.PAGEIN_QUEUE, tzoo.CANARY_FLOOR, tzoo.CANARY_WINDOW) == (
        0, 0, "queue", 64, 0.8, 8.0)


# --------------------------------------------------------------- HTTP front
def _http(addr, path, payload=None):
    url = "http://%s:%d%s" % (addr[0], addr[1], path)
    req = urllib.request.Request(
        url, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=T) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_routes_by_model_with_404s_and_the_zoo_block():
    z = Zoos(("alpha", "beta"))
    sched = ZooScheduler(z.zoo, devices=["cpu"], start=True)
    sched.set_tenant("gold", priority="interactive", deadline_ms=5000)
    srv = ModelServer(sched).start()
    try:
        x = _x(2, seed=5)
        for model in ("alpha", "beta"):
            code, out = _http(srv.address, "/predict",
                              {"model": model, "data": x.tolist(),
                               "tenant": "gold"})
            assert code == 200 and out["n"] == 2
            z.jsched.ensure_resident(model)
            ref = z.jsched._residents[model].stable.predictor.predict(x)
            _close(np.asarray(out["outputs"][0], np.float32),
                   ref.asnumpy())
        code, out = _http(srv.address, "/predict",
                          {"model": "gamma", "data": x.tolist()})
        assert code == 404 and sorted(out["known_models"]) == \
            ["alpha", "beta"]
        code, out = _http(srv.address, "/predict",
                          {"model": "alpha", "version": "v9",
                           "data": x.tolist()})
        assert code == 404 and out["known_versions"] == ["v1"]
        code, out = _http(srv.address, "/predict", {"data": x.tolist()})
        assert code == 400 and "model" in out["error"]
        code, health = _http(srv.address, "/healthz")
        assert code == 200 and health["status"] == "ok"
        zb = health["zoo"]
        assert zb["resident_models"] == 2
        assert zb["models"]["alpha"]["stable_version"] == "v1"
        assert "controller" not in health
        code, met = _http(srv.address, "/metrics")
        assert met["gauges"]["zoo.resident_models"] == 2
        assert met["gauges"]["zoo.hbm_resident_bytes"]["alpha"] > 0
    finally:
        srv.close(timeout=T)
        sched.close(timeout=T)
