"""The port's continuous-batching decode (``mxtpu_torch/serving/decode.py``)
against the JAX package's ``DecodeEngine`` on the CPU.

Both packages decode the same workloads over the same weights: the
reference model of ``tools/serve_bench.py`` (vocab 48, dim 12, max_len 40,
seed 7) and the port's copy (``serving.decode_bench``) loaded with its
weights by ``convert.load_mxtpu_params``. Greedy tokens must equal the
reference's token for token (rowed, continuous and restart-per-batch,
eos / ``max_new`` / ``max_len`` stopping, int8 KV held int8 against
int8), and equal an eager full-prefix greedy loop of the port's model;
prefill and first-step logits agree within 1e-5 of max|logit| (float32).
Then the engine's contract on the port alone, as ``tests/test_decode.py``
holds the reference's: the ``decode_slots=`` spelling and its refusals,
the KV accountant's ledger and sheds, one build per executable and none
after warm-up, no device-to-host read inside ``serving.decode``, the
wedge watchdog under a fake clock (the carry reset in place), deadlines,
the queue bound, threaded serving, the crash barrier, probation, and
decode reading the Predictor's snapshot. The JAX engines are built once
per configuration and shared across the file's tests."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.serving import BucketSpec as JBucketSpec
from mxtpu.serving import DecodeEngine as JDecodeEngine
from mxtpu.serving import KVCacheAccountant as JKVCacheAccountant
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.serving import (BucketSpec, DeadlineExceeded, DecodeEngine,
                                 KVCacheAccountant, Predictor, QueueFull)
from mxtpu_torch.serving import decode_bench

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import serve_bench as sb  # noqa: E402  (the reference DecodeModel)

VOCAB, DIM, MAX_LEN = 48, 12, 40
T = 30   # seconds any wait may take
_JAX_ENV = ("MXTPU_TELEMETRY", "MXTPU_RETRACE_BUDGET", "MXTPU_FAULT_INJECT",
            "MXTPU_SERVE_INT8", "MXTPU_DECODE_SLOTS", "MXTPU_DECODE_QUEUE",
            "MXTPU_DECODE_MAX_NEW", "MXTPU_SERVE_KV_OVERCOMMIT",
            "MXTPU_SERVE_DISPATCH_TIMEOUT_MS", "MXTPU_FLIGHT_DIR",
            "MXTPU_KV_PAGE_TOKENS", "MXTPU_PREFIX_CACHE",
            "MXTPU_SPEC_DECODE_K")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in _JAX_ENV:
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

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _jax_arrays(jmodel):
    return {n: p.data().asnumpy() for n, p in
            jmodel.collect_params().items()}


def port_model_of(jmodel, seed=7):
    net = decode_bench.build_decode_model(VOCAB, DIM, MAX_LEN, seed=seed)
    convert.load_mxtpu_params(net, _jax_arrays(jmodel))
    return net


@pytest.fixture(scope="module")
def jmodel():
    return sb.build_decode_model(vocab=VOCAB, dim=DIM, max_len=MAX_LEN,
                                 seed=7)


@pytest.fixture(scope="module")
def model(jmodel):
    return port_model_of(jmodel)


def _pspec(spec_cls=BucketSpec):
    return spec_cls([1], seq_lens=[6, 12])


def _engine(model, slots=2, eos=None, int8=False, continuous=True,
            accountant=None, clock=time.monotonic, timeout_ms=10000.0,
            max_queue=256, max_len=32, **kw):
    return DecodeEngine(model, _pspec(), BucketSpec.pow2(decode_slots=slots),
                        max_len=max_len, eos_id=eos, int8=int8,
                        continuous=continuous, accountant=accountant,
                        clock=clock, dispatch_timeout_ms=timeout_ms,
                        max_queue=max_queue, device="cpu", warmup=True,
                        start=False, **kw)


_JAX_ENGINES = {}


def jax_engine(jmodel, slots=2, eos=None, int8=False, continuous=True,
               max_len=32, page_tokens=None, pool_pages=None, prefix=None,
               draft=None, spec_k=None):
    """One warmed JAX engine per configuration, shared by the tests (its
    executables are the expensive part); it is idle between uses."""
    key = (id(jmodel), slots, eos, int8, continuous, max_len, page_tokens,
           pool_pages, prefix, id(draft), spec_k)
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        eng = _JAX_ENGINES[key] = JDecodeEngine(
            jmodel, _pspec(JBucketSpec),
            JBucketSpec.pow2(decode_slots=slots), max_len=max_len,
            eos_id=eos, int8=int8, continuous=continuous,
            page_tokens=page_tokens, pool_pages=pool_pages,
            prefix_cache=prefix, draft_model=draft, spec_k=spec_k,
            warmup=True, start=False)
    return eng


def _run_all(eng, futs, limit=2000):
    n = 0
    while not all(f.done() for f in futs) and n < limit:
        eng.poll()
        n += 1
    return [f.result(timeout=2.0) for f in futs]


def run_tokens(eng, reqs, steps_of=None):
    """Submit every (prompt, max_new) at once and poll to the end: the token
    lists, and the decode steps taken (``steps_of`` the telemetry module
    whose ``serving.decode.steps`` counts them)."""
    s0 = steps_of.value("serving.decode.steps") if steps_of else 0
    outs = _run_all(eng, [eng.submit(p, max_new=m) for p, m in reqs])
    steps = steps_of.value("serving.decode.steps") - s0 if steps_of else None
    return [o.tolist() for o in outs], steps


def reference_greedy(model, prompt, max_new, eos=None, max_len=MAX_LEN):
    """The port model's eager full-prefix greedy loop: no KV cache, no
    buckets, no executable of the engine."""
    toks, out = list(prompt), []
    for _ in range(max_new):
        logits, _k, _v = model(torch.tensor(np.asarray(toks, np.int32)[None]))
        nxt = int(torch.argmax(logits[0, len(toks) - 1]))
        out.append(nxt)
        toks.append(nxt)
        if eos is not None and nxt == eos:
            break
        if len(toks) >= max_len:
            break
    return out


def assert_tokens_like_mxtpu(got, ref):
    assert [len(g) for g in got] == [len(r) for r in ref]
    assert got == ref


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def _reqs(seed, n, lo=3, hi=11, mlo=2, mhi=9):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, VOCAB, size=rng.randint(lo, hi))
             .astype(np.int32), int(rng.randint(mlo, mhi)))
            for _ in range(n)]


# ------------------------------------------------------- BucketSpec spelling
def test_decode_slots_spelling():
    d = BucketSpec(decode_slots=(2, 8, 4))
    assert d.is_decode and d.decode_slots == (2, 4, 8)
    assert d.max_slots == 8 and d.slot_bucket(3) == 4
    assert d.slot_bucket(9) is None
    assert BucketSpec.pow2(decode_slots=8).decode_slots == (1, 2, 4, 8)
    assert repr(d) == repr(JBucketSpec(decode_slots=(2, 8, 4)))
    p = BucketSpec.pow2(4)
    assert not p.is_decode and p.decode_slots is None
    with pytest.raises(MXNetError, match="decode_slots"):
        p.max_slots
    with pytest.raises(MXNetError, match="decode_slots"):
        p.slot_bucket(1)


@pytest.mark.parametrize("bad", [
    lambda B: B(batch_sizes=[2], decode_slots=[2]),
    lambda B: B(decode_slots=[2], seq_lens=[8]),
    lambda B: B(decode_slots=[0]),
    lambda B: B(),
    lambda B: B.pow2(8, decode_slots=8),
    lambda B: B.pow2(decode_slots=8, seq_lens=[16]),
    lambda B: B.pow2(),
])
def test_decode_slots_validation_is_loud_like_mxtpu(bad):
    with pytest.raises(MXNetError):
        bad(BucketSpec)
    with pytest.raises(Exception, match="BucketSpec"):
        bad(JBucketSpec)


def test_predictor_refuses_decode_spec():
    net = tnn.Dense(4, in_units=3)
    net.initialize(ctx=mt.cpu())
    with pytest.raises(MXNetError, match="decode-cohort"):
        Predictor(net, BucketSpec(decode_slots=[2]),
                  example=np.zeros((1, 3), np.float32), device="cpu")


def test_engine_refuses_misdeclared_specs(model):
    with pytest.raises(MXNetError, match="decode_slots= spelling"):
        DecodeEngine(model, _pspec(), BucketSpec.pow2(4), warmup=False,
                     device="cpu")
    with pytest.raises(MXNetError, match="prefill_spec is a decode"):
        DecodeEngine(model, BucketSpec(decode_slots=[2]),
                     BucketSpec(decode_slots=[2]), warmup=False,
                     device="cpu")
    with pytest.raises(MXNetError, match="seq_lens"):
        DecodeEngine(model, BucketSpec([1]), BucketSpec(decode_slots=[2]),
                     warmup=False, device="cpu")
    with pytest.raises(MXNetError, match="decode_step"):
        DecodeEngine(tnn.HybridSequential(), _pspec(),
                     BucketSpec(decode_slots=[2]), warmup=False,
                     device="cpu")


def test_cold_engine_refuses_submit(model):
    cold = DecodeEngine(model, _pspec(), BucketSpec(decode_slots=[2]),
                        warmup=False, device="cpu")
    with pytest.raises(MXNetError, match="cold DecodeEngine"):
        cold.submit(np.arange(3).astype(np.int32))
    with pytest.raises(MXNetError, match="cold engine"):
        cold.start()


def test_engine_defaults_are_the_references(model):
    """The reference's levers become constructor arguments with its
    defaults (decode_slots 8, queue 256, max_new 32, overcommit 2.0, rowed,
    no prefix cache, no speculation, the dispatch timeout), and the engine
    runs on the CUDA device unless given the CPU."""
    eng = DecodeEngine(model, _pspec(), warmup=False, device="cpu")
    assert eng.capacity == 8 and eng._max_queue == 256
    assert eng._max_len == 12 + 32 and eng._timeout_s == 10.0
    assert eng.page_tokens == 0 and eng.spec_k == 0
    assert eng._prefix is None and not eng.int8
    assert KVCacheAccountant()._overcommit == 2.0
    assert eng.device == torch.device("cpu")


# --------------------------------------------------------- model and logits
def test_model_forward_and_decode_step_match_mxtpu(jmodel, model):
    import jax.numpy as jnp
    from mxtpu.ndarray import NDArray as JNDArray
    toks = np.random.RandomState(4).randint(0, VOCAB, (2, 9)).astype(
        np.int32)
    jl, jk, jv = jmodel(JNDArray(jnp.asarray(toks)))
    tl, tk, tv = model(torch.from_numpy(toks))
    for got, ref in ((tl, jl), (tk, jk), (tv, jv)):
        _close(got.detach().numpy(), ref.asnumpy())
    # one decode step on a cache of the first 5 positions
    kv = [np.zeros((2, 16, DIM), np.float32) for _ in range(2)]
    kv[0][:, :5], kv[1][:, :5] = jk.asnumpy()[:, :5], jv.asnumpy()[:, :5]
    tok, pos = toks[:, 5], np.array([5, 5], np.int32)
    jlog, jent = jmodel.decode_step([jnp.asarray(a) for a in kv],
                                    jnp.asarray(tok), jnp.asarray(pos))
    tlog, tent = model.decode_step([torch.from_numpy(a) for a in kv],
                                   torch.from_numpy(tok),
                                   torch.from_numpy(pos))
    _close(tlog.detach().numpy(), np.asarray(jlog))
    for got, ref in zip(tent, jent):
        _close(got.detach().numpy(), np.asarray(ref))
    # and the step equals the prefill's row at that position
    _close(tlog.detach().numpy(), tl[:, 5].detach().numpy())


def test_prefill_and_step_logits_match_mxtpu(jmodel, model):
    prompt = np.arange(2, 9).astype(np.int32)
    eng = _engine(model, slots=2)
    jeng = jax_engine(jmodel)
    _close(eng.prefill_logits(prompt), jeng.prefill_logits(prompt))
    _close(eng.step_logits_probe(prompt), jeng.step_logits_probe(prompt))
    assert ttel.value("serving.decode.d2h") == 0


# --------------------------------------------------------- decode correctness
def test_engine_matches_mxtpu_and_eager_reference(jmodel, model):
    reqs = list(zip(
        [p for p, _ in _reqs(1, 5)], [4, 7, 3, 6, 5]))
    got, _ = run_tokens(_engine(model, slots=2), reqs)
    ref, _ = run_tokens(jax_engine(jmodel), reqs)
    assert_tokens_like_mxtpu(got, ref)
    for out, (p, m) in zip(got, reqs):
        assert out == reference_greedy(model, p, m)


@pytest.mark.parametrize("continuous", [True, False])
def test_continuous_and_restart_tokens_like_mxtpu(jmodel, model, continuous):
    """Slot insert and the in-place carry are invisible to a sequence's
    math: continuous and restart-per-batch give the reference's streams,
    in the reference's number of steps."""
    reqs = _reqs(2, 6)
    got, steps = run_tokens(_engine(model, slots=2, continuous=continuous),
                            reqs, ttel)
    ref, jsteps = run_tokens(jax_engine(jmodel, continuous=continuous),
                             reqs, jtel)
    assert_tokens_like_mxtpu(got, ref)
    assert steps == jsteps


def test_eos_stops_generation_like_mxtpu(jmodel, model):
    prompt = np.arange(3, 8).astype(np.int32)
    eos = reference_greedy(model, prompt, 8)[2]
    got, _ = run_tokens(_engine(model, slots=1, eos=eos), [(prompt, 8)])
    ref, _ = run_tokens(jax_engine(jmodel, slots=1, eos=eos), [(prompt, 8)])
    assert_tokens_like_mxtpu(got, ref)
    assert got[0] == reference_greedy(model, prompt, 8, eos=eos)
    assert got[0][-1] == eos and len(got[0]) == 3


def test_max_len_stops_generation_like_mxtpu(jmodel, model):
    """A budget past the cache: generation stops at ``max_len``."""
    reqs = [(np.arange(11).astype(np.int32), 30),
            (np.arange(2, 12).astype(np.int32), 3)]
    got, _ = run_tokens(_engine(model, slots=2, max_len=16), reqs)
    ref, _ = run_tokens(jax_engine(jmodel, max_len=16), reqs)
    assert_tokens_like_mxtpu(got, ref)
    # the first token sits at position 11, the last step writes row 15
    assert len(got[0]) == 16 - 11 + 1
    assert got[0] == reference_greedy(model, reqs[0][0], 16 - 11 + 1)


def test_max_new_one_completes_at_insert(jmodel, model):
    eng = _engine(model, slots=1)
    fut = eng.submit(np.arange(4).astype(np.int32), max_new=1)
    eng.poll()
    out = fut.result(timeout=2.0)
    ref, _ = run_tokens(jax_engine(jmodel, slots=1),
                        [(np.arange(4).astype(np.int32), 1)])
    assert out.tolist() == ref[0] == reference_greedy(model, np.arange(4), 1)
    # done at insert: the first token came from the prefill logits
    assert ttel.value("serving.decode.steps") == 0
    assert fut.ttft_s is not None and fut.ttft_s <= fut.e2e_s


def test_submit_validation_is_loud(model):
    eng = _engine(model, slots=1)
    with pytest.raises(MXNetError, match="1-d"):
        eng.submit(np.zeros((2, 3), np.int32))
    with pytest.raises(MXNetError, match="integer"):
        eng.submit(np.zeros(3, np.float32))
    with pytest.raises(MXNetError, match="exceeds the largest declared"):
        eng.submit(np.zeros(13, np.int32))
    with pytest.raises(MXNetError, match="max_new"):
        eng.submit(np.zeros(3, np.int32), max_new=0)
    with pytest.raises(MXNetError, match="no room to decode"):
        DecodeEngine(model, _pspec(), BucketSpec(decode_slots=[1]),
                     max_len=12, warmup=False, device="cpu")


# ------------------------------------------------ continuous batching + builds
def test_continuous_batching_fewer_steps_flat_builds(jmodel, model):
    """Same workload, equal capacity: the continuous cohort takes strictly
    fewer steps than restart-per-batch, as many as the reference's; no
    build at serving.decode after warm-up and no device-to-host read
    inside the armed span."""
    reqs = _reqs(3, 10, mhi=13)
    steps, jsteps = {}, {}
    for continuous in (True, False):
        eng = _engine(model, slots=4, continuous=continuous)
        st = ttel.retrace_stats(eng._site)
        # one build per cohort bucket and per prefill seq bucket
        assert st["compiles"] == 3 + 2 and st["trips"] == 0
        ttel.reset()
        got, steps[continuous] = run_tokens(eng, reqs, ttel)
        assert ttel.retrace_stats(eng._site) is None
        ref, jsteps[continuous] = run_tokens(
            jax_engine(jmodel, slots=4, continuous=continuous), reqs, jtel)
        assert_tokens_like_mxtpu(got, ref)
        assert ttel.value("serving.decode.d2h") == 0
    assert steps[True] < steps[False], steps
    assert steps == jsteps


def test_joiner_enters_running_cohort(model):
    eng = _engine(model, slots=2)
    first = eng.submit(np.arange(3).astype(np.int32), max_new=10)
    for _ in range(3):
        eng.poll()
    assert eng.live_slots == 1 and not first.done()
    joiner = eng.submit(np.arange(5).astype(np.int32), max_new=5)
    eng.poll()
    assert eng.live_slots == 2
    outs = _run_all(eng, [first, joiner])
    assert outs[0].tolist() == reference_greedy(model, np.arange(3), 10)
    assert outs[1].tolist() == reference_greedy(model, np.arange(5), 5)
    assert ttel.retrace_stats(eng._site)["compiles"] == 2 + 2


def test_breakdown_and_ttft(model):
    eng = _engine(model, slots=2)
    fut = eng.submit(np.arange(6).astype(np.int32), max_new=4)
    _run_all(eng, [fut])
    for stage in ("serving.submit", "serving.queue_wait", "serving.prefill",
                  "serving.decode", "serving.fetch", "serving.deliver"):
        assert stage in fut.breakdown, (stage, sorted(fut.breakdown))
    assert fut.trace_id is not None
    assert fut.ttft_s is not None and 0 <= fut.ttft_s <= fut.e2e_s
    assert ttel.value("serving.decode.tokens") == 4
    # one declared fetch a step and one at insert, none in the step span
    assert ttel.value("transfer.d2h") == 4
    assert ttel.value("serving.decode.d2h") == 0


# ----------------------------------------------------------------- int8 path
def test_engine_int8_tokens_like_mxtpu_int8(jmodel, model):
    """int8 against int8: the port's int8 engine (int8 weights and KV)
    gives the reference int8 engine's tokens; its logits stay near f32's
    and its KV costs at most ~half f32's bytes a slot, the reference's
    count exactly."""
    eng_f = _engine(model, slots=2)
    eng_q = _engine(model, slots=2, int8=True)
    jeng_q = jax_engine(jmodel, int8=True)
    prompt = np.arange(2, 9).astype(np.int32)
    lf, lq = eng_f.prefill_logits(prompt), eng_q.prefill_logits(prompt)
    assert np.abs(lf - lq).mean() / (np.abs(lf).mean() + 1e-9) < 0.05
    _close(lq, jeng_q.prefill_logits(prompt))
    sf, sq = eng_f.step_logits_probe(prompt), eng_q.step_logits_probe(prompt)
    assert np.abs(sf - sq).mean() / (np.abs(sf).mean() + 1e-9) < 0.05
    _close(sq, jeng_q.step_logits_probe(prompt))
    assert eng_q.per_slot_kv_bytes() <= 0.55 * eng_f.per_slot_kv_bytes()
    assert eng_q.per_slot_kv_bytes() == jeng_q.per_slot_kv_bytes()
    assert eng_f.per_slot_kv_bytes() == \
        jax_engine(jmodel).per_slot_kv_bytes()
    reqs = _reqs(6, 5)
    got, _ = run_tokens(eng_q, reqs)
    ref, _ = run_tokens(jeng_q, reqs)
    assert_tokens_like_mxtpu(got, ref)
    assert ttel.value("serving.decode.d2h") == 0


def test_int8_kv_grid_is_the_references():
    """The KV grid rule (per-row symmetric int8 through the quantize op)
    gives the reference's bytes and ranges, zero rows included."""
    from mxtpu.serving.decode import _quantize_rows as jq
    from mxtpu_torch.serving.decode import _quantize_rows as tq
    x = np.random.RandomState(2).randn(5, 7, 3).astype(np.float32)
    x[1] = 0.0
    q, r = tq(torch.from_numpy(x))
    jqv, jr = jq(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


# ------------------------------------------------------------- KV accounting
def test_kv_residency_shed_at_overcommit(model):
    acct = KVCacheAccountant()
    eng = _engine(model, slots=1, accountant=acct)
    cap = acct.snapshot()["r0"]
    assert cap["per_slot_bytes"] == eng.per_slot_kv_bytes()
    assert cap["bucket_bytes"] == {1: eng.per_slot_kv_bytes()}
    futs = [eng.submit(np.arange(3).astype(np.int32), max_new=4)
            for _ in range(2)]
    with pytest.raises(QueueFull, match="kv_residency"):
        eng.submit(np.arange(3).astype(np.int32), max_new=4)
    assert ttel.value("serving.shed", tag="kv_residency") == 1
    _run_all(eng, futs)
    _run_all(eng, [eng.submit(np.arange(3).astype(np.int32), max_new=2)])
    snap = acct.snapshot()["r0"]
    assert snap["live"] == 0 and snap["queued"] == 0
    assert acct.resident_bytes("r0") == 0


def test_accountant_gauges_track_residency(model):
    acct = KVCacheAccountant(overcommit=10.0)
    eng = _engine(model, slots=2, accountant=acct)
    assert ttel.gauge_value("serving.kv_capacity_bytes") == \
        2 * eng.per_slot_kv_bytes()
    fut = eng.submit(np.arange(3).astype(np.int32), max_new=6)
    eng.poll()
    assert ttel.gauge_value("serving.kv_resident_bytes") == \
        eng.per_slot_kv_bytes()
    _run_all(eng, [fut])
    assert ttel.gauge_value("serving.kv_resident_bytes") == 0


def test_accountant_ledger_like_mxtpu():
    """The same ledger script through both accountants: every answer,
    snapshot, pressure and gauge agrees."""
    accts = (JKVCacheAccountant(overcommit=1.5), KVCacheAccountant(
        overcommit=1.5))
    script = [("register", ("r0", 100, 2), {"bucket_slots": (1, 2)}),
              ("register", ("r1", 40, 4), {"page_tokens": 8}),
              ("try_admit", ("r0",), {}), ("try_admit", ("r0",), {"n": 2}),
              ("would_admit", ("r0",), {}), ("try_admit", ("r0",), {}),
              ("occupy", ("r0",), {}), ("would_admit", ("r9",), {}),
              ("try_admit", ("r1",), {"n": 5}), ("occupy", ("r1",), {"n": 3}),
              ("unqueue", ("r1",), {"n": 2}), ("release", ("r0",), {}),
              ("resident_bytes", (), {}), ("resident_bytes", ("r1",), {}),
              ("pressure", (), {}), ("snapshot", (), {})]
    for name, args, kw in script:
        ref, got = (getattr(a, name)(*args, **kw) for a in accts)
        assert got == ref, (name, got, ref)
        for g in ("serving.kv_capacity_bytes", "serving.kv_resident_bytes"):
            assert ttel.gauge_value(g) == jtel.gauge_value(g)
    gates = [a.gate("r0")(1) for a in accts]
    assert gates[0] == gates[1]
    with pytest.raises(MXNetError, match="unregistered"):
        accts[1].occupy("r7")


# ------------------------------------------------------------- wedge + fault
def test_decode_wedge_fake_clock_resets_carry_in_place(model):
    """An injected wedge at step 1 under a fake clock: the scan trips the
    watchdog past the timeout, the stuck futures fail loud, the carry is
    reset in place (every tensor keeps its storage, which the executables
    were built over) and the engine decodes correctly after."""
    tres.set_faults("decode_wedge@1")
    clock = FakeClock()
    eng = _engine(model, slots=2, clock=clock, timeout_ms=100.0)
    c = eng._carry
    ptrs = [t.data_ptr() for t in c["kv"] + [c["tok"], c["pos"],
                                              c["active"], c["rem"]]]
    stuck = [eng.submit(np.arange(3).astype(np.int32), max_new=6)
             for _ in range(2)]
    eng.poll()
    eng.poll()
    assert not any(f.done() for f in stuck)
    clock.advance(0.2)
    eng.poll()
    for f in stuck:
        assert f.done()
        with pytest.raises(DeadlineExceeded, match="wedged"):
            f.result(timeout=0)
    assert ttel.value("serving.decode.wedges") == 1
    assert eng.live_slots == 0 and eng._carry_stale
    out = _run_all(eng, [eng.submit(np.arange(4).astype(np.int32),
                                    max_new=3)])[0]
    assert out.tolist() == reference_greedy(model, np.arange(4), 3)
    assert not eng._carry_stale and eng._carry is c
    assert [t.data_ptr() for t in c["kv"] + [c["tok"], c["pos"],
                                             c["active"], c["rem"]]] == ptrs
    assert not bool(c["active"].any())


def test_deadline_expires_while_queued(model):
    clock = FakeClock()
    eng = _engine(model, slots=1, clock=clock)
    hog = eng.submit(np.arange(3).astype(np.int32), max_new=10)
    eng.poll()
    late = eng.submit(np.arange(4).astype(np.int32), max_new=2,
                      deadline_ms=50.0)
    clock.advance(0.1)
    _run_all(eng, [hog])
    eng.poll()
    assert late.done()
    with pytest.raises(DeadlineExceeded, match="KV slot"):
        late.result(timeout=0)
    assert ttel.value("serving.deadline_expired") == 1


def test_queue_bound_sheds(model):
    eng = _engine(model, slots=1, max_queue=2)
    futs = [eng.submit(np.arange(3).astype(np.int32), max_new=3)
            for _ in range(2)]
    with pytest.raises(QueueFull, match="queue_full"):
        eng.submit(np.arange(3).astype(np.int32), max_new=3)
    _run_all(eng, futs)
    eng.drain()
    with pytest.raises(QueueFull, match="draining"):
        eng.submit(np.arange(3).astype(np.int32), max_new=3)


# ------------------------------------------------------------- threaded mode
def test_threaded_end_to_end(model):
    acct = KVCacheAccountant(overcommit=50.0)
    eng = _engine(model, slots=2, accountant=acct)
    eng.start()
    try:
        prompts = [p for p, _ in _reqs(5, 8)]
        results = [None] * len(prompts)

        def client(i):
            results[i] = eng.submit(prompts[i],
                                    max_new=3 + i % 4).result(timeout=T)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        for i, (p, out) in enumerate(zip(prompts, results)):
            assert out is not None, "request %d hung" % i
            assert out.tolist() == reference_greedy(model, p, 3 + i % 4)
        snap = acct.snapshot()["r0"]
        assert snap["live"] == 0 and snap["queued"] == 0, snap
    finally:
        eng.close(timeout=10.0)


def _boom(*a, **k):
    raise RuntimeError("boom")


def test_crash_barrier_fails_loud(model, monkeypatch):
    eng = _engine(model, slots=1)
    eng.start()
    try:
        monkeypatch.setattr(eng, "_harvest", _boom)
        fut = eng.submit(np.arange(3).astype(np.int32), max_new=4)
        with pytest.raises(MXNetError, match="decode loop crashed"):
            fut.result(timeout=T)
        assert ttel.value("serving.worker_crashes") == 1
        with pytest.raises(QueueFull, match="worker_crashed"):
            eng.submit(np.arange(3).astype(np.int32))
    finally:
        eng.close(timeout=5.0)


def test_threaded_injected_wedge_recovers(model):
    tres.set_faults("decode_wedge@0")
    eng = _engine(model, slots=2, timeout_ms=100.0)
    eng.start()
    try:
        stuck = eng.submit(np.arange(3).astype(np.int32), max_new=6)
        with pytest.raises(DeadlineExceeded, match="wedged"):
            stuck.result(timeout=T)
        assert ttel.value("serving.decode.wedges") == 1
        out = eng.submit(np.arange(4).astype(np.int32),
                         max_new=3).result(timeout=T)
        assert out.tolist() == reference_greedy(model, np.arange(4), 3)
    finally:
        eng.close(timeout=10.0)


def _blocking(real, block):
    """A getter whose executables wait on ``block`` before running: "the
    device call never returns"."""
    def get(key):
        ex = real(key)

        def run(*args):
            block.wait(T)
            return ex(*args)

        return run

    return get


def test_wedge_probation_crashes_blocked_loop(model, monkeypatch):
    eng = _engine(model, slots=1, timeout_ms=100.0)
    block = threading.Event()
    monkeypatch.setattr(eng, "_get_step_exec",
                        _blocking(eng._get_step_exec, block))
    eng.start()
    try:
        stuck = eng.submit(np.arange(3).astype(np.int32), max_new=6)
        queued = eng.submit(np.arange(4).astype(np.int32), max_new=3)
        with pytest.raises(DeadlineExceeded, match="wedged"):
            stuck.result(timeout=T)
        with pytest.raises(MXNetError, match="decode loop crashed"):
            queued.result(timeout=T)
        assert ttel.value("serving.worker_crashes") == 1
        with pytest.raises(QueueFull, match="worker_crashed"):
            eng.submit(np.arange(3).astype(np.int32))
    finally:
        block.set()
        eng.close(timeout=10.0)


def test_prefill_failure_completes_the_popped_future(model, monkeypatch):
    acct = KVCacheAccountant(overcommit=10.0)
    eng = _engine(model, slots=1, accountant=acct)
    boom = {"on": True}
    real = eng._pred.predict_flat

    def flaky(*a, **k):
        if boom["on"]:
            raise RuntimeError("device burp")
        return real(*a, **k)

    monkeypatch.setattr(eng._pred, "predict_flat", flaky)
    fut = eng.submit(np.arange(3).astype(np.int32), max_new=3)
    with pytest.raises(RuntimeError, match="device burp"):
        eng.poll()
    assert fut.done()
    with pytest.raises(MXNetError, match="prefill failed"):
        fut.result(timeout=0)
    snap = acct.snapshot()["r0"]
    assert snap["queued"] == 0 and snap["live"] == 0, snap
    boom["on"] = False
    out = _run_all(eng, [eng.submit(np.arange(4).astype(np.int32),
                                    max_new=2)])[0]
    assert out.tolist() == reference_greedy(model, np.arange(4), 2)


def test_blocked_insert_dispatch_does_not_hold_the_lock(model, monkeypatch):
    eng = _engine(model, slots=2, timeout_ms=30000.0)
    block = threading.Event()
    monkeypatch.setattr(eng, "_get_insert_exec",
                        _blocking(eng._get_insert_exec, block))
    eng.start()
    try:
        first = eng.submit(np.arange(3).astype(np.int32), max_new=2)
        time.sleep(0.1)   # the loop is now blocked inside the insert
        t0 = time.perf_counter()
        second = eng.submit(np.arange(4).astype(np.int32), max_new=2)
        assert time.perf_counter() - t0 < 1.0
        assert eng._scan_wedges(eng._clock()) is None
        assert eng.drain(timeout=0.2) is False
        block.set()
        for f in (first, second):
            assert len(f.result(timeout=T)) == 2
    finally:
        block.set()
        eng.close(timeout=10.0)


def test_prefill_wedge_trips_and_sheds(model, monkeypatch):
    eng = _engine(model, slots=1, timeout_ms=100.0)
    block = threading.Event()
    monkeypatch.setattr(eng, "_get_insert_exec",
                        _blocking(eng._get_insert_exec, block))
    eng.start()
    try:
        stuck = eng.submit(np.arange(3).astype(np.int32), max_new=3)
        queued = eng.submit(np.arange(4).astype(np.int32), max_new=3)
        with pytest.raises(DeadlineExceeded, match="prefill dispatch"):
            stuck.result(timeout=T)
        assert ttel.value("serving.decode.wedges") == 1
        with pytest.raises(MXNetError, match="decode loop crashed"):
            queued.result(timeout=T)
        with pytest.raises(QueueFull, match="worker_crashed"):
            eng.submit(np.arange(3).astype(np.int32))
    finally:
        block.set()
        eng.close(timeout=10.0)


# ------------------------------------------------- the Predictor's snapshot
def test_decode_reads_the_snapshot_until_refresh_params(jmodel):
    """After warm-up a ``set_data`` on the block changes no decode answer
    (prefill or step) until ``refresh_params()`` copies it in."""
    net = port_model_of(jmodel)
    eng = _engine(net, slots=2)
    reqs = _reqs(8, 3)
    before, _ = run_tokens(eng, reqs)
    arrays = _jax_arrays(jmodel)
    key = [k for k in arrays if k.endswith("wout")][0]
    for p in net.collect_params().values():
        if p.name.endswith("wout"):
            p.set_data(-arrays[key])
    held, _ = run_tokens(eng, reqs)
    assert held == before
    eng.predictor.refresh_params()
    after, _ = run_tokens(eng, reqs)
    assert after != before
    assert after == [reference_greedy(net, p, m) for p, m in reqs]
    assert ttel.retrace_stats(eng._site)["compiles"] == 2 + 2


# ----------------------------------------------------------- bench workload
def test_bench_workload_and_builder_like_mxtpu(jmodel):
    """``decode_bench`` is the reference bench's copy: the same requests
    from the same seed, the same engine shape, the same parameter names."""
    for got, ref in zip(decode_bench.decode_workload(20, 256, 48, 32),
                        sb._decode_workload(20, 256, 48, 32)):
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
    net = decode_bench.build_decode_model(VOCAB, DIM, MAX_LEN, seed=3)
    assert [n.partition("_")[2] for n in net.collect_params()] == \
        [n.partition("_")[2] for n in jmodel.collect_params()]
    again = decode_bench.build_decode_model(VOCAB, DIM, MAX_LEN, seed=3)
    for a, b in zip(net.collect_params().values(),
                    again.collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())
    eng = decode_bench.build_decode_engine(net, slots=2, max_prompt=12,
                                           max_new=8, device="cpu")
    assert eng._prefill_spec.seq_lens == (6, 12) and eng._max_len == 20
    assert eng._decode_spec.decode_slots == (1, 2)


def test_bench_decode_gates_small(jmodel, model):
    """The bench's deterministic gates at a small size: continuous and
    restart give the reference's tokens, continuous in fewer steps, no
    build after warm-up, no read inside the span, int8 KV at most ~half
    f32's bytes."""
    reqs = decode_bench.decode_workload(12, VOCAB, 12, 8)
    res = {}
    for continuous in (True, False):
        acct = KVCacheAccountant(overcommit=12 * 64.0)
        eng = decode_bench.build_decode_engine(
            model, slots=2, max_prompt=12, max_new=8,
            continuous=continuous, accountant=acct, device="cpu")
        c0 = ttel.retrace_stats(eng._site)["compiles"]
        res[continuous] = run_tokens(eng, reqs, ttel)
        assert ttel.retrace_stats(eng._site)["compiles"] == c0
    assert res[True][0] == res[False][0]
    assert res[True][1] < res[False][1]
    ref, _ = run_tokens(jax_engine(jmodel, max_len=20), reqs)
    assert_tokens_like_mxtpu(res[True][0], ref)
    q = decode_bench.build_decode_engine(model, slots=2, max_prompt=12,
                                         max_new=8, int8=True, device="cpu")
    f = decode_bench.build_decode_engine(model, slots=2, max_prompt=12,
                                         max_new=8, device="cpu")
    assert q.per_slot_kv_bytes() <= 0.55 * f.per_slot_kv_bytes()
    assert ttel.value("serving.decode.d2h") == 0
