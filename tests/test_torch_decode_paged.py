"""The port's paged KV, prefix cache and speculative decoding
(``mxtpu_torch/serving/decode.py``) against the JAX package's on the CPU.

The model, weights and helpers are ``test_torch_decode``'s (vocab 48, dim
12, seed 7, prefill buckets 6/12, pages of 4 tokens). The port's paged
engine must give the reference paged engine's tokens, and the eager
greedy loop's: with joiners, eos and budget stops, prefix hits, a
speculative draft equal to the target or another model, and int8 KV
(int8 against int8); the pool's pages, the prefix cache's pins and the
speculative counters follow the reference's where both expose them. Then
the paged engine's contract on the port alone: page reuse and gauges,
exhaustion shed at admission and mid-decode with the survivor exact, LRU
eviction of cache-only pages under pressure, no build at ``serving.decode``
or ``serving.draft`` after warm-up, no read inside the step span, and the
teardown ledger balanced after a wedge, a crash and close()."""
import time

import numpy as np
import pytest

from mxtpu import telemetry as jtel
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.base import MXNetError
from mxtpu_torch.serving import (BucketSpec, DeadlineExceeded, DecodeEngine,
                                 KVCacheAccountant, QueueFull)

from test_torch_decode import (VOCAB, FakeClock, _fresh,  # noqa: F401
                               _pspec, _reqs, _run_all,
                               assert_tokens_like_mxtpu, jax_engine, jmodel,
                               model, port_model_of, reference_greedy,
                               run_tokens, sb, DIM, MAX_LEN)

PT = 4
TMPL = np.array([2, 9, 4, 11, 6, 1, 8, 3], np.int32)   # two full pages


def _pengine(model, slots=2, eos=None, int8=False, accountant=None,
             clock=time.monotonic, timeout_ms=10000.0, max_len=32,
             page_tokens=PT, pool_pages=None, prefix=False,
             draft_model=None, spec_k=0):
    return DecodeEngine(model, _pspec(), BucketSpec.pow2(decode_slots=slots),
                        max_len=max_len, eos_id=eos, int8=int8,
                        continuous=True, accountant=accountant, clock=clock,
                        dispatch_timeout_ms=timeout_ms,
                        page_tokens=page_tokens, pool_pages=pool_pages,
                        prefix_cache=prefix, draft_model=draft_model,
                        spec_k=spec_k, device="cpu", warmup=True,
                        start=False)


def _poll_all(eng, futs, limit=4000):
    """Drive to the end without reading results (some hold a shed)."""
    n = 0
    while not all(f.done() for f in futs) and n < limit:
        eng.poll()
        n += 1
    assert all(f.done() for f in futs)


def _outcome(f):
    try:
        return f.result(timeout=0).tolist()
    except Exception as e:  # noqa: BLE001 — either package's QueueFull
        assert type(e).__name__ == "QueueFull", e
        return "shed: %s" % str(e).split("(")[0].strip()


def _pool_balanced(eng):
    return (len(eng._free_pages) == eng._pool_pages
            and int(eng._page_ref[1:].sum()) == 0)


@pytest.fixture(scope="module")
def other(jmodel):
    """(JAX, port) draft models of another seed: a disagreeing proposer."""
    jo = sb.build_decode_model(vocab=VOCAB, dim=DIM, max_len=MAX_LEN,
                               seed=99)
    return jo, port_model_of(jo, seed=99)


# ----------------------------------------------------- parity with mxtpu
def test_paged_matches_mxtpu_and_eager(jmodel, model):
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    eng = _pengine(model)
    got, _ = run_tokens(eng, [(prompt, 9)])
    ref, _ = run_tokens(jax_engine(jmodel, page_tokens=PT), [(prompt, 9)])
    assert_tokens_like_mxtpu(got, ref)
    assert got[0] == reference_greedy(model, prompt, 9)
    assert _pool_balanced(eng)


def test_paged_equals_rowed_with_joiners_like_mxtpu(jmodel, model):
    """More requests than slots, joiners in freed slots, eos on one: the
    paged gather/scatter step gives the rowed engine's streams and the
    reference paged engine's, in its number of steps."""
    reqs = _reqs(3, 6, lo=2, hi=9)
    peng = DecodeEngine(model, _pspec(), BucketSpec.pow2(decode_slots=2),
                        max_len=32, eos_id=7, page_tokens=PT, device="cpu")
    paged, steps = run_tokens(peng, reqs, ttel)
    rowed, _ = run_tokens(DecodeEngine(
        model, _pspec(), BucketSpec.pow2(decode_slots=2), max_len=32,
        eos_id=7, device="cpu"), reqs)
    ref, jsteps = run_tokens(jax_engine(jmodel, eos=7, page_tokens=PT),
                             reqs, jtel)
    assert paged == rowed
    assert_tokens_like_mxtpu(paged, ref)
    assert steps == jsteps
    assert _pool_balanced(peng)


def test_paged_eos_and_budget_stopping(jmodel, model):
    prompt = np.arange(4).astype(np.int32)
    got, _ = run_tokens(_pengine(model, eos=5), [(prompt, 12)])
    ref, _ = run_tokens(jax_engine(jmodel, eos=5, page_tokens=PT),
                        [(prompt, 12)])
    assert_tokens_like_mxtpu(got, ref)
    assert got[0] == reference_greedy(model, prompt, 12, eos=5)
    if 5 in got[0]:
        assert got[0].index(5) == len(got[0]) - 1


def test_page_bytes_like_mxtpu(jmodel, model):
    for int8 in (False, True):
        eng = _pengine(model, int8=int8)
        jeng = jax_engine(jmodel, int8=int8, page_tokens=PT)
        assert eng.page_bytes() == jeng.page_bytes()
        assert eng.pool_pages == jeng.pool_pages == 2 * (32 // PT)
    with pytest.raises(MXNetError, match="rowed engine"):
        DecodeEngine(model, _pspec(), BucketSpec(decode_slots=[1]),
                     max_len=32, device="cpu").page_bytes()


# --------------------------------------------------------- page lifecycle
def test_page_free_and_reuse(model):
    eng = _pengine(model, slots=2)
    p0 = len(eng._free_pages)
    fut = eng.submit(np.arange(6).astype(np.int32), max_new=6)
    eng.poll()
    assert p0 - len(eng._free_pages) >= -(-6 // PT)
    first_pages = list(eng._slots[0].pages)
    _run_all(eng, [fut])
    assert len(eng._free_pages) == p0 and _pool_balanced(eng)
    fut2 = eng.submit(np.arange(6).astype(np.int32), max_new=6)
    eng.poll()
    assert set(eng._slots[0].pages) & set(first_pages)
    _run_all(eng, [fut2])
    assert _pool_balanced(eng)


def test_page_gauges_track_pool(model):
    eng = _pengine(model, slots=2)
    fut = eng.submit(np.arange(5).astype(np.int32), max_new=6)
    eng.poll()
    free = ttel.gauge_value("serving.kv_page_free")
    resident = ttel.gauge_value("serving.kv_page_resident")
    assert resident >= 2 and free + resident == eng._pool_pages
    assert ttel.gauge_value("serving.kv_resident_tokens") >= 5
    _run_all(eng, [fut])
    assert ttel.gauge_value("serving.kv_page_resident") == 0
    assert ttel.gauge_value("serving.kv_page_free") == eng._pool_pages
    assert ttel.gauge_value("serving.kv_resident_tokens") == 0


def test_paged_accountant_ledgers_pages(model):
    """A paged engine registers its page pool: admission reserves the
    prompt's pages, decode draws page by page, completion returns them."""
    acct = KVCacheAccountant(overcommit=1.0)
    eng = _pengine(model, slots=2, accountant=acct)
    snap = acct.snapshot()["r0"]
    assert snap["page_tokens"] == PT and snap["slots"] == eng.pool_pages
    assert snap["per_slot_bytes"] == eng.page_bytes()
    fut = eng.submit(np.arange(6).astype(np.int32), max_new=6)
    assert acct.snapshot()["r0"]["queued"] == -(-7 // PT)
    eng.poll()
    assert acct.snapshot()["r0"]["live"] == len(eng._slots[0].pages)
    _run_all(eng, [fut])
    snap = acct.snapshot()["r0"]
    assert snap["live"] == 0 and snap["queued"] == 0


# -------------------------------------------------------- pool exhaustion
def test_pool_exhaustion_sheds_at_admission(model):
    eng = _pengine(model, slots=2, pool_pages=32 // PT)
    hog = eng.submit(np.arange(12).astype(np.int32), max_new=18)
    eng.poll()
    n = 0
    while len(eng._free_pages) > 2 and n < 2000:
        eng.poll()
        n += 1
    shed = eng.submit(np.arange(12).astype(np.int32), max_new=4)
    _poll_all(eng, [hog, shed])
    with pytest.raises(QueueFull, match="kv_residency"):
        shed.result(timeout=0)
    assert ttel.value("serving.shed", tag="kv_residency") >= 1
    assert hog.result(timeout=0).tolist() == \
        reference_greedy(model, np.arange(12), 18)
    assert _pool_balanced(eng)


def test_pool_exhaustion_mid_decode_like_mxtpu(jmodel, model):
    """Two growing sequences against a pool that cannot hold both: the
    same one as in the reference sheds mid-decode, the survivor's stream
    is exact, and the ledger balances."""
    pa = np.arange(7).astype(np.int32)
    pb = (np.arange(7) + 9).astype(np.int32)
    eng = _pengine(model, slots=2, pool_pages=8)
    jeng = jax_engine(jmodel, page_tokens=PT, pool_pages=8)
    outcomes = []
    for e in (jeng, eng):
        futs = [e.submit(pa, max_new=12), e.submit(pb, max_new=12)]
        _poll_all(e, futs)
        outcomes.append([_outcome(f) for f in futs])
    assert outcomes[0] == outcomes[1]
    shed = [o for o in outcomes[1] if isinstance(o, str)]
    assert shed == ["shed: request shed: kv_residency"]
    assert ttel.value("serving.shed", tag="kv_residency") == 1
    for o, p in zip(outcomes[1], (pa, pb)):
        if not isinstance(o, str):
            assert o == reference_greedy(model, p, 12)
    assert _pool_balanced(eng)


# ----------------------------------------------------------- prefix cache
def test_prefix_hit_skips_and_matches_like_mxtpu(jmodel, model):
    eng = _pengine(model, slots=2, prefix=True)
    jeng = jax_engine(jmodel, page_tokens=PT, prefix=True)
    got = [run_tokens(eng, [(TMPL, 5)])[0][0] for _ in range(2)]
    assert ttel.value("serving.prefix.misses") == 1
    assert ttel.value("serving.prefix.hits") == 1
    ref = [run_tokens(jeng, [(TMPL, 5)])[0][0] for _ in range(2)]
    assert got == ref == [reference_greedy(model, TMPL, 5)] * 2
    # the cache's pins survive completion, as many as the reference's
    assert len(eng._free_pages) < eng._pool_pages
    assert int(eng._page_ref[1:].sum()) == len(eng._prefix) \
        == len(jeng._prefix)


def test_prefix_refcount_shared_then_diverging(jmodel, model):
    sfx_a = np.concatenate([TMPL, np.array([40, 41], np.int32)])
    sfx_b = np.concatenate([TMPL, np.array([42, 43, 44], np.int32)])
    eng = _pengine(model, slots=2, prefix=True)
    _run_all(eng, [eng.submit(TMPL, max_new=3)])
    fa = eng.submit(sfx_a, max_new=4)
    fb = eng.submit(sfx_b, max_new=4)
    eng.poll()
    eng.poll()
    assert (ttel.gauge_value("serving.kv_page_shared") or 0) >= 2
    assert int(np.sum(eng._page_ref[1:] >= 3)) >= 1
    outs = [o.tolist() for o in _run_all(eng, [fa, fb])]
    assert outs == [reference_greedy(model, sfx_a, 4),
                    reference_greedy(model, sfx_b, 4)]
    assert int(eng._page_ref[1:].sum()) == len(eng._prefix)
    jeng = jax_engine(jmodel, page_tokens=PT, prefix=True)
    ref, _ = run_tokens(jeng, [(sfx_a, 4), (sfx_b, 4)])
    assert_tokens_like_mxtpu(outs, ref)


def test_prefix_cache_evicts_under_pressure_not_shed(model):
    eng = _pengine(model, slots=1, prefix=True, pool_pages=8)
    _run_all(eng, [eng.submit(TMPL, max_new=3)])
    assert len(eng._prefix) >= 1
    stranger = (np.arange(12) + 20).astype(np.int32)
    # it grows to the whole pool: it completes only if the cache's pages
    # evict on demand
    out = _run_all(eng, [eng.submit(stranger, max_new=18)], limit=4000)[0]
    assert out.tolist() == reference_greedy(model, stranger, 18)
    assert ttel.value("serving.shed", tag="kv_residency") == 0
    assert int(eng._page_ref[1:].sum()) == len(eng._prefix)


# ---------------------------------------------------- speculative decoding
def test_spec_matches_greedy_in_fewer_steps_like_mxtpu(jmodel, model):
    reqs = [(p, 12) for p, _ in _reqs(5, 3, lo=2, hi=9)]
    plain, steps_plain = run_tokens(_pengine(model, slots=2), reqs, ttel)
    seng = _pengine(model, slots=2, draft_model=model, spec_k=3)
    spec, steps_spec = run_tokens(seng, reqs, ttel)
    ref, jsteps = run_tokens(jax_engine(jmodel, page_tokens=PT,
                                        draft=jmodel, spec_k=3), reqs, jtel)
    assert spec == plain
    assert_tokens_like_mxtpu(spec, ref)
    assert steps_spec < steps_plain and steps_spec == jsteps
    assert _pool_balanced(seng)


def test_spec_accept_counters_like_mxtpu(jmodel, model):
    prompt = np.array([1, 2, 3], np.int32)
    eng = _pengine(model, draft_model=model, spec_k=3)
    got, _ = run_tokens(eng, [(prompt, 17)])
    ref, _ = run_tokens(jax_engine(jmodel, page_tokens=PT, draft=jmodel,
                                   spec_k=3), [(prompt, 17)])
    assert_tokens_like_mxtpu(got, ref)
    assert got[0] == reference_greedy(model, prompt, 17)
    counts = [(m.value("serving.decode.spec_proposed"),
               m.value("serving.decode.spec_accepted")) for m in (jtel, ttel)]
    assert counts[0] == counts[1]
    proposed, accepted = counts[1]
    assert proposed > 0 and accepted / proposed >= 0.75
    assert _pool_balanced(eng)


def test_spec_divergent_draft_still_exact_like_mxtpu(jmodel, model, other):
    jo, to = other
    prompt = np.array([4, 4, 2, 7], np.int32)
    eng = _pengine(model, draft_model=to, spec_k=3)
    got, _ = run_tokens(eng, [(prompt, 10)])
    ref, _ = run_tokens(jax_engine(jmodel, page_tokens=PT, draft=jo,
                                   spec_k=3), [(prompt, 10)])
    assert_tokens_like_mxtpu(got, ref)
    assert got[0] == reference_greedy(model, prompt, 10)
    counts = [(m.value("serving.decode.spec_proposed"),
               m.value("serving.decode.spec_accepted")) for m in (jtel, ttel)]
    assert counts[0] == counts[1]
    assert 0 <= counts[1][1] < counts[1][0]
    assert _pool_balanced(eng)


def test_spec_int8_equals_int8_paged_like_mxtpu(jmodel, model):
    """int8 engines chain the verify through the step's quantize grid, so
    int8 with speculation equals int8 paged, and both the reference's."""
    prompt = np.array([6, 3, 9, 1], np.int32)
    plain, _ = run_tokens(_pengine(model, int8=True), [(prompt, 10)])
    spec, _ = run_tokens(_pengine(model, int8=True, draft_model=model,
                                  spec_k=3), [(prompt, 10)])
    ref, _ = run_tokens(jax_engine(jmodel, int8=True, page_tokens=PT),
                        [(prompt, 10)])
    assert plain == spec
    assert_tokens_like_mxtpu(plain, ref)


def test_paged_int8_tokens_like_mxtpu(jmodel, model):
    reqs = _reqs(9, 4)
    got, _ = run_tokens(_pengine(model, int8=True), reqs)
    ref, _ = run_tokens(jax_engine(jmodel, int8=True, page_tokens=PT), reqs)
    assert_tokens_like_mxtpu(got, ref)


def test_spec_requires_paged_and_draft(model):
    with pytest.raises(MXNetError, match="needs paged"):
        _pengine(model, page_tokens=0, draft_model=model, spec_k=3)
    with pytest.raises(MXNetError, match="draft_model"):
        _pengine(model, spec_k=3)
    with pytest.raises(MXNetError, match="power of two"):
        _pengine(model, page_tokens=3)
    with pytest.raises(MXNetError, match="one lever"):
        _pengine(model, prefix=True, draft_model=model, spec_k=2)
    with pytest.raises(MXNetError, match="needs paged"):
        _pengine(model, page_tokens=0, prefix=True)
    with pytest.raises(MXNetError, match="without page_tokens"):
        _pengine(model, page_tokens=0, pool_pages=8)
    with pytest.raises(MXNetError, match="cannot hold even one"):
        _pengine(model, pool_pages=3)


# ------------------------------------------------------- replay discipline
def test_zero_postwarmup_compiles_and_no_d2h_both_sites(model):
    eng = _pengine(model, slots=2, draft_model=model, spec_k=3)
    # a draft and a verify per cohort bucket, an insert per seq bucket;
    # the draft Predictor's probe bucket and the draft steps at its site
    assert ttel.retrace_stats(eng._site)["compiles"] == 2 + 2
    assert ttel.retrace_stats(eng._draft_site)["compiles"] == 1 + 2
    c0 = ttel.retrace_stats(eng._site)["compiles"]
    d0 = ttel.retrace_stats(eng._draft_site)["compiles"]
    rng = np.random.RandomState(11)
    futs = [eng.submit(rng.randint(0, VOCAB, size=rng.randint(2, 12))
                       .astype(np.int32), max_new=int(rng.randint(2, 11)))
            for _ in range(5)]
    _run_all(eng, futs)
    assert ttel.retrace_stats(eng._site)["compiles"] == c0
    assert ttel.retrace_stats(eng._draft_site)["compiles"] == d0
    assert ttel.value("serving.decode.d2h") == 0


def test_prefix_engine_builds_an_extend_per_bucket(model):
    eng = _pengine(model, slots=2, prefix=True)
    assert ttel.retrace_stats(eng._site)["compiles"] == 2 + 2 + 2
    _run_all(eng, [eng.submit(TMPL, max_new=3) for _ in range(2)])
    assert ttel.retrace_stats(eng._site)["compiles"] == 6
    assert ttel.value("serving.decode.d2h") == 0


# ------------------------------------------------- teardown ledger balance
def test_wedge_teardown_releases_pages(model):
    tres.set_faults("decode_wedge@1")
    clock = FakeClock()
    acct = KVCacheAccountant(overcommit=50.0)
    eng = _pengine(model, slots=2, clock=clock, timeout_ms=100.0,
                   accountant=acct)
    stuck = [eng.submit(np.arange(3).astype(np.int32), max_new=6)
             for _ in range(2)]
    eng.poll()
    eng.poll()
    clock.advance(0.2)
    eng.poll()
    for f in stuck:
        assert f.done()
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=0)
    assert _pool_balanced(eng)
    snap = acct.snapshot()["r0"]
    assert snap["live"] == 0 and snap["queued"] == 0
    assert acct.resident_bytes("r0") == 0
    out = _run_all(eng, [eng.submit(np.arange(4).astype(np.int32),
                                    max_new=3)])[0]
    assert out.tolist() == reference_greedy(model, np.arange(4), 3)
    assert _pool_balanced(eng)


def test_crash_barrier_releases_pages(model, monkeypatch):
    acct = KVCacheAccountant(overcommit=50.0)
    eng = _pengine(model, slots=1, accountant=acct)
    eng.start()
    try:
        monkeypatch.setattr(
            eng, "_harvest",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        fut = eng.submit(np.arange(3).astype(np.int32), max_new=4)
        with pytest.raises(MXNetError, match="decode loop crashed"):
            fut.result(timeout=30.0)
    finally:
        eng.close(timeout=5.0)
    assert _pool_balanced(eng)
    snap = acct.snapshot()["r0"]
    assert snap["live"] == 0 and snap["queued"] == 0
    assert acct.resident_bytes("r0") == 0


def test_close_releases_pages_and_prefix_pins(model):
    acct = KVCacheAccountant(overcommit=50.0)
    eng = _pengine(model, slots=2, prefix=True, accountant=acct)
    _run_all(eng, [eng.submit(TMPL, max_new=3)])
    assert len(eng._prefix) >= 1
    eng.submit(np.arange(5).astype(np.int32), max_new=6)
    eng.poll()
    eng.close(timeout=5.0)
    assert len(eng._prefix) == 0
    assert _pool_balanced(eng)
    assert acct.resident_bytes("r0") == 0


def test_page_tokens_argument(model):
    eng = DecodeEngine(model, _pspec(), BucketSpec.pow2(decode_slots=2),
                       max_len=32, page_tokens=8, device="cpu")
    assert eng.page_tokens == 8 and eng.pool_pages == 2 * 4
    prompt = np.arange(5).astype(np.int32)
    out = _run_all(eng, [eng.submit(prompt, max_new=6)])[0]
    assert out.tolist() == reference_greedy(model, prompt, 6)
    assert _pool_balanced(eng)
