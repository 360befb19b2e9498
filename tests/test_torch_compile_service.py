"""The port's compile service (``mxtpu_torch/compile_service.py``) held to
``mxtpu/compile_service.py`` on the CPU: the reference's in-memory cases
(a miss builds and reports once, the key's components, meta on the entry,
concurrent misses, the LRU bound), the same sequence of builds and lookups
giving the same eviction order and ``stats()`` in both packages, the same
pairs of keys colliding or differing in both (equal digests), warm-up,
every drop reason of the port's blobs, the runtime libraries under the
LRU bound and in the cache dir, the executor's entries, the levers (the
port reads no environment variable), and a warm start in a second
process, where the blobs seed the ledger and no FLOP pass runs. The
deliberate difference is pinned: a disk hit still builds (a CUDA graph
cannot be serialized), so the retrace count sees it."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from mxtpu import compile_service as jcs
from mxtpu import telemetry as jtel
import mxtpu_torch as mt
from mxtpu_torch import compile_service as cs
from mxtpu_torch import graphs, kernels, rtc, telemetry, xprof
from mxtpu_torch.ops.pallas import autotune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu:d0"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("MXTPU_COMPILE_CACHE_DIR", raising=False)
    for mod in (cs, jcs):
        mod.reset()
    cs.set_cache_dir(None)
    cs.set_cache_entries(1024)
    yield
    for mod in (cs, jcs):
        mod.reset()
    cs.set_cache_dir(None)
    cs.set_cache_entries(1024)
    cs.set_cache_threads(0)


def _key(mod=cs, site="executor", sig=((4,), "f32"), policy=("p0",),
         nonce=None, fn_id="svc-test", sharding=None, donation=None):
    return mod.canonical_key(site=site, fn_id=fn_id, signature=sig,
                             policy=policy, sharding=sharding,
                             donation=donation, device=DEV, nonce=nonce)


class Built:
    """What a stand-in build makes."""

    def __init__(self, tag):
        self.tag = tag


def _build(tag="x", calls=None):
    def build():
        if calls is not None:
            calls.append(tag)
        return Built(tag)
    return build


def _jbuild():
    return lambda: jax.jit(lambda x: x * 3.0)


# ----------------------------------------------------------------- basics
def test_miss_builds_and_reports_then_hits():
    k = _key()
    r0 = telemetry.value("retrace.executor")
    calls = []
    e1 = cs.get_or_build(k, _build(calls=calls), provenance={"t": 1})
    assert e1.origin == "built" and calls == ["x"]
    assert telemetry.value("retrace.executor") == r0 + 1
    e2 = cs.get_or_build(k, _build(calls=calls))
    assert e2.fn is e1.fn and calls == ["x"]
    assert telemetry.value("retrace.executor") == r0 + 1
    assert telemetry.retrace_stats("executor")["last"] == {"t": 1}


def test_companion_counts_no_retrace_and_provenance_may_be_a_thunk():
    r0 = telemetry.value("retrace.executor")
    cs.get_or_build(_key(), _build(), companion=True)
    assert telemetry.value("retrace.executor") == r0
    cs.get_or_build(_key(sig=((5,), "f32")), _build(),
                    provenance=lambda: {"lazy": True})
    assert telemetry.retrace_stats("executor")["last"] == {"lazy": True}


def test_distinct_key_components_are_distinct_entries_in_both():
    base = dict(site="executor", sig=((4,), "f32"))
    variants = [{}, {"policy": ("p1",)}, {"sharding": ("mesh", 8)},
                {"donation": (0,)}, {"nonce": "iface2"}]
    for v in variants:
        cs.get_or_build(_key(**dict(base, **v)), _build())
        jcs.get_or_build(_key(jcs, **dict(base, **v)), _jbuild())
    assert cs.stats()["entries"] == jcs.stats()["entries"] == len(variants)


def test_meta_rides_the_entry():
    e = cs.get_or_build(_key(), lambda: (Built("m"), {"in_fmt": [1, 0]}))
    assert e.meta == {"in_fmt": [1, 0]} and e.fn.tag == "m"


def test_concurrent_misses_build_once():
    k = _key()
    calls, results = [], []
    gate = threading.Barrier(4)

    def worker():
        gate.wait()
        results.append(cs.get_or_build(k, _build(calls=calls)))

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert calls == ["x"]
    assert all(r.fn is results[0].fn for r in results)


def test_a_waiter_holding_the_capture_lock_builds_its_own_copy():
    """The thread building first waits for CAPTURE_LOCK, which the second
    caller holds: the second builds its own copy instead of waiting (a
    wait would deadlock)."""
    k = _key()
    started, calls = threading.Event(), []

    def slow():
        started.set()
        with graphs.CAPTURE_LOCK:   # as a capture takes it
            calls.append("first")
        return Built("first")

    out = {}
    with graphs.CAPTURE_LOCK:
        t = threading.Thread(target=lambda: out.update(
            a=cs.get_or_build(k, slow)))
        t.start()
        assert started.wait(30)
        second = cs.get_or_build(k, _build("second", calls))
    t.join(timeout=60)
    assert not t.is_alive()
    assert second.fn.tag == "second" and sorted(calls) == ["first", "second"]


# -------------------------------------------------------------------- LRU
def test_lru_order_and_stats_equal_the_references(monkeypatch):
    monkeypatch.setenv("MXTPU_COMPILE_CACHE_ENTRIES", "3")
    cs.set_cache_entries(3)
    ops = [("b", 1), ("b", 2), ("b", 3), ("g", 1), ("b", 4), ("b", 2),
           ("g", 3), ("b", 5), ("b", 1), ("g", 4), ("b", 6)]
    for pkg, build in ((cs, _build), (jcs, lambda: _jbuild())):
        ev0 = (telemetry if pkg is cs else jtel).value(
            "compile.evictions", tag="executor")
        for op, i in ops:
            k = _key(pkg, sig=((i,), "f32"))
            if op == "b":
                pkg.get_or_build(k, build() if pkg is cs else build())
            else:
                pkg.get(k)
        order = [k.signature for k in pkg._STORE]
        st = pkg.stats()
        ev = (telemetry if pkg is cs else jtel).value(
            "compile.evictions", tag="executor") - ev0
        if pkg is cs:
            port = (order, st["entries"], st["per_site"], st["bound"], ev)
        else:
            ref = (order, st["entries"], st["per_site"], st["bound"], ev)
    assert port == ref
    assert port[0] == [((5,), "f32"), ((1,), "f32"), ((6,), "f32")]


def test_unbounded_when_the_bound_is_zero():
    cs.set_cache_entries(0)
    for i in range(40):
        cs.get_or_build(_key(sig=((i,), "f32")), _build())
    assert cs.stats()["entries"] == 40 and cs.stats()["bound"] == 0


def test_a_busy_pair_is_never_evicted_and_evictions_leave_the_view():
    cs.set_cache_entries(2)
    busy = Built("busy")
    busy.busy = True
    cs.get_or_build(_key(sig=("pair", 0), nonce="n1"), lambda: busy)
    view = cs.SiteTable(lambda k: k.nonce == "n1")
    for i in range(3):
        cs.get_or_build(_key(sig=("graph", i), nonce="n1"), _build(str(i)))
    assert ("pair", 0) in view and len(view) == 2
    assert [e.tag for e in view.values()] == ["busy", "2"]
    busy.busy = False
    cs.get_or_build(_key(sig=("graph", 9), nonce="n1"), _build("9"))
    assert ("pair", 0) not in view
    view.clear()
    assert len(view) == 0 and cs.stats()["entries"] == 0


def test_a_collected_instance_leaves_the_store():
    class Site:
        pass

    obj = Site()
    nonce = cs.release_on_collect(obj)
    cs.get_or_build(_key(nonce=nonce), _build())
    assert cs.stats()["entries"] == 1
    del obj
    import gc
    gc.collect()
    assert cs.stats()["entries"] == 0


# ----------------------------------------------------------------- digests
def test_digests_equal_the_references_and_collide_alike():
    variants = [dict(policy=("a",)), dict(policy=("b",)),
                dict(policy=("a",), sharding=("zero1", 8)),
                dict(policy=("a",), donation=(0, 2)),
                dict(policy=("a",), sig=((8,), "f32")),
                dict(policy=("a",), site="serving.predict.r9", nonce="iX"),
                dict(policy=("a",), fn_id="other")]
    port = [cs.digest_of(_key(**v)) for v in variants]
    ref = [jcs.digest_of(_key(jcs, **v)) for v in variants]
    assert port == ref
    same = [[a == b for b in port] for a in port]
    assert same == [[a == b for b in ref] for a in ref]
    assert port[0] == port[5] and len(set(port)) == 6   # site, nonce: out
    assert _key().digest_material() == _key(jcs).digest_material()


def test_policy_key_and_its_forward_and_update_parts():
    from mxtpu_torch import optimizer_fused, resilience
    from mxtpu_torch.ops.registry import policy_key
    base = policy_key()
    assert len(base) == 15 and base[-3:] == ("0", "0", "0")
    fwd = cs.forward_policy()
    resilience.set_guard(True)
    try:
        assert policy_key() != base and cs.forward_policy() == fwd
        assert cs.update_policy() == ("1",)
    finally:
        resilience.set_guard(False)
    prev = optimizer_fused.set_enabled(False)
    try:
        assert cs.forward_policy() == fwd and policy_key() != base
    finally:
        optimizer_fused.set_enabled(prev)
    autotune.set_enabled(True)
    try:
        assert cs.forward_policy() != fwd
    finally:
        autotune.set_enabled(False)
        autotune.reset()


# -------------------------------------------------------------------- disk
def _flops_build(flops=5.0, seen=None):
    """A build that reports one graph's FLOPs as a capture does, taking
    them from the service's seed when there is one."""
    def build():
        seed = cs.next_seed()
        if seen is not None:
            seen.append(seed)
        cs.note_flops("executor", flops if seed is None else seed)
        return Built("f")
    return build


def test_disk_roundtrip_seeds_the_flops_and_still_builds(tmp_path):
    cs.set_cache_dir(tmp_path)
    k = _key()
    seen = []
    cold = cs.get_or_build(k, _flops_build(7.0, seen), provenance={"p": 1})
    assert cold.origin == "built" and seen == [None]
    assert cold.record["flops"] == [7.0]
    assert os.path.exists(cs.disk_path_of(k))
    blob = json.load(open(cs.disk_path_of(k)))
    assert blob["magic"] == "MXTPU-CC" and blob["key"] == \
        k.digest_material() and blob["provenance"] == {"p": 1}
    cs.reset()
    h0 = telemetry.value("compile.disk.hits", tag="executor")
    r0 = telemetry.value("retrace.executor")
    warm = cs.get_or_build(k, _flops_build(99.0, seen))
    assert warm.origin == "disk" and seen == [None, 7.0]
    assert warm.record["flops"] == [7.0]
    assert telemetry.value("compile.disk.hits", tag="executor") == h0 + 1
    # the deliberate difference: the build (a capture) still runs and
    # counts at its site
    assert telemetry.value("retrace.executor") == r0 + 1


def test_manifest_and_annotate(tmp_path):
    cs.set_cache_dir(tmp_path)
    k = _key()
    cs.get_or_build(k, _flops_build())
    man = cs.manifest(str(tmp_path))
    assert man["format"] == cs.FORMAT_VERSION
    row = man["entries"][cs.digest_of(k)]
    assert row["site"] == "executor" and row["key"] == k.digest_material()
    assert cs.annotate(k, footprint=1234)
    assert cs.peek(k)["footprint"] == 1234
    assert cs.get(k).record["footprint"] == 1234
    assert cs.peek(_key(sig=((9,), "f32"))) is None


def test_no_dir_means_no_disk_traffic(tmp_path):
    w0 = telemetry.value("compile.disk.writes", tag="executor")
    e = cs.get_or_build(_key(), _flops_build())
    assert e.origin == "built" and not os.listdir(tmp_path)
    assert telemetry.value("compile.disk.writes", tag="executor") == w0
    assert cs.peek(_key()) is None


def _damage(path, how, k, other):
    if how == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    elif how == "garbage":
        open(path, "wb").write(b"\x80\x04garbage")
    elif how == "magic":
        rec = json.load(open(path))
        rec["magic"] = "NOPE"
        json.dump(rec, open(path, "w"))
    elif how == "env":
        rec = json.load(open(path))
        rec["env"]["torch"] = "0.0.0"
        json.dump(rec, open(path, "w"))
    elif how == "library":
        rec = json.load(open(path))
        rec["meta"]["libraries"] = {"fused_conv": "fused_conv-stale.so"}
        json.dump(rec, open(path, "w"))
    elif how == "forge":
        os.replace(path, cs.disk_path_of(other))


@pytest.mark.parametrize("how,reason", [
    ("truncate", "corrupt"), ("garbage", "corrupt"), ("magic", "corrupt"),
    ("env", "version_mismatch"), ("library", "version_mismatch"),
    ("forge", "key_mismatch")])
def test_every_drop_rebuilds_cold(tmp_path, how, reason):
    cs.set_cache_dir(tmp_path)
    k, other = _key(policy=("A",)), _key(policy=("B",))
    cs.get_or_build(k, _flops_build(3.0))
    _damage(cs.disk_path_of(k), how, k, other)
    cs.reset()
    probe = other if how == "forge" else k
    d0 = telemetry.value("compile.disk.drops", tag=reason)
    seen = []
    e = cs.get_or_build(probe, _flops_build(4.0, seen))
    assert e.origin == "built" and seen == [None]   # measured again
    assert telemetry.value("compile.disk.drops", tag=reason) == d0 + 1
    # the cold rebuild wrote a good blob again
    cs.reset()
    assert cs.get_or_build(probe, _flops_build()).origin == "disk"


def test_a_library_that_does_not_load_marks_the_blob(tmp_path, monkeypatch):
    cs.set_cache_dir(tmp_path)
    k = _key()

    def build():
        cs.note_library("fused_conv", kernels.library_file("fused_conv"))
        return Built("lib")

    cs.get_or_build(k, build)
    cs.reset()

    def broken(name):
        raise OSError("cannot open shared object file")

    monkeypatch.setattr(kernels, "library", broken)
    d0 = telemetry.value("compile.disk.drops", tag="load_error")
    assert cs.get_or_build(k, build).origin == "built"
    assert telemetry.value("compile.disk.drops", tag="load_error") == d0 + 1
    assert os.path.exists(cs.disk_path_of(k) + ".unloadable")
    cs.reset()
    u0 = telemetry.value("compile.disk.drops", tag="unloadable")
    assert cs.get_or_build(k, build).origin == "built"
    assert telemetry.value("compile.disk.drops", tag="unloadable") == u0 + 1


def test_an_unwritable_dir_counts_io_and_serves(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    cs.set_cache_dir(blocker / "sub")
    d0 = telemetry.value("compile.disk.drops", tag="io")
    e = cs.get_or_build(_key(), _flops_build())
    assert e.origin == "built"
    assert telemetry.value("compile.disk.drops", tag="io") == d0 + 1


# ------------------------------------------------------------------ warmup
def test_warmup_in_order_with_groups_sharing_the_flop_count():
    order = []

    def build(i):
        def b():
            seed = cs.next_seed()
            order.append((i, seed))
            cs.note_flops("serving.predict.r%d" % i,
                          11.0 if seed is None else seed)
            return Built(i)
        return b

    s0 = telemetry.value("compile.lowering_shares", tag="serving.predict.r1")
    entries = [cs.WarmupEntry(
        key=_key(site="serving.predict.r%d" % i, nonce="i%d" % i),
        build=build(i), example_args=None, provenance={"r": i},
        group=("g", "sig")) for i in range(3)]
    summary = cs.warmup(entries, threads=3)
    assert {k: summary[k] for k in ("entries", "built", "disk", "cached",
                                    "errors")} == {
        "entries": 3, "built": 3, "disk": 0, "cached": 0, "errors": 0}
    assert order == [(0, None), (1, 11.0), (2, 11.0)]
    assert telemetry.value("compile.lowering_shares",
                           tag="serving.predict.r1") == s0 + 1
    again = cs.warmup(entries)
    assert again["cached"] == 3


def test_warmup_reraises_the_first_error_in_both():
    def bad():
        raise RuntimeError("broken bucket")

    for pkg, good in ((cs, _build()), (jcs, _jbuild())):
        entries = [pkg.WarmupEntry(key=_key(pkg, sig=((1,), "f32")),
                                   build=good, example_args=None,
                                   provenance=None),
                   pkg.WarmupEntry(key=_key(pkg, sig=((2,), "f32")),
                                   build=bad, example_args=None,
                                   provenance=None)]
        with pytest.raises(RuntimeError, match="broken bucket"):
            pkg.warmup(entries)
        assert pkg.get(_key(pkg, sig=((1,), "f32"))) is not None


# -------------------------------------------------------- runtime libraries
@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc that copies a loadable shared library and counts."""
    import _ctypes
    calls = tmp_path / "calls"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!%s\nimport shutil, sys\nopen(%r, 'a').write('x')\n"
        "shutil.copy(%r, sys.argv[sys.argv.index('-o') + 1])\n"
        % (sys.executable, str(calls), _ctypes.__file__))
    script.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(script))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_LOADED", {})
    return lambda: len(calls.read_text()) if calls.exists() else 0


SRC = "__global__ void k%d(const float* x, float* y) { y[0] = x[0] + %d; }"


def test_runtime_libraries_ride_the_lru_bound(fake_nvcc):
    cs.set_cache_entries(4)
    ev0 = telemetry.value("compile.evictions", tag="rtc")
    mods = [rtc.CudaModule(SRC % (i, i)).build() for i in range(7)]
    assert all(m.build_how == "nvcc" for m in mods) and fake_nvcc() == 7
    assert cs.stats()["per_site"]["rtc"] == 4
    assert telemetry.value("compile.evictions", tag="rtc") == ev0 + 3
    # an evicted library stays loaded where a module holds it
    assert all(m._lib is not None for m in mods)


def test_runtime_libraries_come_from_the_cache_dir(fake_nvcc, tmp_path,
                                                   monkeypatch):
    cache = tmp_path / "cache"
    cs.set_cache_dir(cache)
    mod = rtc.CudaModule(SRC % (1, 1)).build()
    assert mod.build_how == "nvcc" and fake_nvcc() == 1
    assert (cache / "kernels" / (mod.digest + ".so")).exists()
    assert os.path.exists(cs.disk_path_of(cs.canonical_key(
        site="rtc", fn_id="rtc:" + mod.digest, signature=(),
        device=cs.device_token())))
    # a fresh process with an empty build directory
    cs.reset()
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "empty")
    h0 = telemetry.value("compile.disk.hits", tag="rtc")
    again = rtc.CudaModule(SRC % (1, 1)).build()
    assert again.build_how == "cache" and fake_nvcc() == 1
    assert telemetry.value("compile.disk.hits", tag="rtc") == h0 + 1
    # a library removed from the cache is built again, once
    cs.reset()
    os.unlink(cache / "kernels" / (mod.digest + ".so"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "empty2")
    assert rtc.CudaModule(SRC % (1, 1)).build().build_how == "nvcc"
    assert fake_nvcc() == 2 and kernels.nvcc_runs() >= 2


def test_executor_entries_live_in_the_service():
    s = mt.sym
    out = s.FullyConnected(data=s.var("data"), num_hidden=4, name="fc")
    with mt.cpu():
        exe = out.simple_bind(ctx=mt.cpu(), data=(2, 3))
        exe.forward(is_train=False, data=mt.nd.ones((2, 3)))
    # the CPU runs the graph eagerly; the captured path's entries are
    # compile-service entries (tests/test_torch_executor.py's captured)
    assert isinstance(exe._entries, cs.SiteTable)
    assert not isinstance(exe._entries, dict)


def test_subgraphs_parse_once_in_the_service():
    from mxtpu_torch.ops import subgraph_ops
    sym = mt.sym.relu(mt.sym.var("x"))
    js = sym.tojson()
    a = subgraph_ops._load_sym(js)
    b = subgraph_ops._load_sym(js)
    assert a is b and cs.stats()["per_site"]["subgraph_exec"] == 1
    assert not cs.manifest()


# ------------------------------------------------------------------ levers
@pytest.mark.parametrize("var,value", [
    ("MXTPU_COMPILE_CACHE_DIR", "/nonexistent/cache"),
    ("MXTPU_COMPILE_CACHE_ENTRIES", "2"),
    ("MXTPU_COMPILE_CACHE_THREADS", "7"),
    ("MXTPU_AUTOTUNE", "1"),
    ("MXTPU_AUTOTUNE_BUDGET_S", "0"),
    ("MXTPU_AUTOTUNE_ROUNDS", "9")])
def test_the_reference_levers_change_nothing_in_the_port(monkeypatch, var,
                                                         value):
    from mxtpu_torch.ops.registry import policy_key
    before = (cs.cache_dir(), cs.cache_entries(), cs.cache_threads(),
              autotune.enabled(), dict(autotune._LEVERS), policy_key())
    monkeypatch.setenv(var, value)
    after = (cs.cache_dir(), cs.cache_entries(), cs.cache_threads(),
             autotune.enabled(), dict(autotune._LEVERS), policy_key())
    assert after == before
    for i in range(3):
        cs.get_or_build(_key(sig=((i,), "f32")), _flops_build())
    assert cs.stats()["entries"] == 3 and not cs.manifest()


# -------------------------------------------------------------- warm start
WARM_CHILD = r"""
import json, sys
sys.path.insert(0, %r)
import numpy as np
import mxtpu_torch as mt
from mxtpu_torch import compile_service, convert, telemetry, xprof
from mxtpu_torch.gluon import nn
from mxtpu_torch.serving.engine import BucketSpec, Predictor
compile_service.set_cache_dir(sys.argv[1])
net = nn.HybridSequential(prefix="mlp_")
with net.name_scope():
    net.add(nn.Dense(16, activation="relu", in_units=8), nn.Dense(4, in_units=16))
net.initialize(ctx=mt.cpu())
shapes = {k: p.shape for k, p in net.collect_params().items()}
convert.load_mxtpu_params(net, convert.seeded_params(shapes, seed=3))
pred = Predictor(net, BucketSpec([1, 2, 4]), example=np.zeros((1, 8), np.float32),
                 device="cpu", site="serving.predict.warm")
pred.warmup()
y = pred.predict(np.ones((3, 8), np.float32)).asnumpy()
led = xprof.ledger("serving.predict.warm")
print(json.dumps({
    "hits": telemetry.value("compile.disk.hits"),
    "writes": telemetry.value("compile.disk.writes"),
    "drops": telemetry.tagged("compile.disk.drops"),
    "passes": telemetry.value("xprof.flop_passes"),
    "compiles": telemetry.retrace_stats("serving.predict.warm")["compiles"],
    "flops": sorted(e["flops"] for e in led),
    "y": y.tolist()}))
""" % REPO


def _child(cache_dir):
    out = subprocess.run([sys.executable, "-c", WARM_CHILD, str(cache_dir)],
                         capture_output=True, text=True, timeout=180,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_warm_start_in_a_second_process(tmp_path):
    cold = _child(tmp_path)
    assert cold["writes"] == 3 and cold["hits"] == 0 and cold["passes"] == 3
    assert all(f > 0 for f in cold["flops"]) and len(cold["flops"]) == 3
    warm = _child(tmp_path)
    assert warm["hits"] == 3 and warm["writes"] == 0 and warm["drops"] == {}
    assert warm["passes"] == 0                 # no FlopCounterMode pass
    assert warm["flops"] == cold["flops"]      # the blobs seed the ledger
    assert warm["compiles"] == cold["compiles"] == 3   # still one a bucket
    assert warm["y"] == cold["y"]
    man = json.load(open(tmp_path / "manifest.json"))
    assert len(man["entries"]) == 3
    assert {r["site"] for r in man["entries"].values()} == {
        "serving.predict.warm"}
    fp = [json.load(open(tmp_path / (d + ".mxc")))["meta"].get("footprint")
          for d in man["entries"]]
    assert sum(f is not None for f in fp) == 1   # the largest bucket's


def test_a_dropped_hybridized_block_takes_its_graphs_out_of_the_store(
        monkeypatch):
    """The store keeps a block's graphs and pairs, but not the block: once
    the block is collected its entries leave the store (on the card their
    memory pools go with them). The stand-in keeps, as a captured graph
    does, its static buffers and outputs and not the function."""
    import gc

    class Kept:
        launches = ()

        def __init__(self, fn, static_inputs, pool=None, device=None,
                     generators=()):
            self.static_inputs = list(static_inputs)
            graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
            try:
                self.outputs = list(fn(*self.static_inputs))
            finally:
                graphs._STATE.depth -= 1

        def replay(self):
            return self.outputs

    monkeypatch.setattr(graphs, "CapturedGraph", Kept)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(4, in_units=3), mt.gluon.nn.BatchNorm(
        in_channels=4))
    net.initialize(ctx=mt.cpu())
    net.hybridize()
    x = torch.ones(2, 3)
    net(x)
    with mt.autograd.record():
        y = net(x)
    y.sum().backward()
    assert cs.stats()["per_site"]["cached_op"] == 2
    del net, y
    gc.collect()
    assert "cached_op" not in cs.stats()["per_site"]


def test_cached_op_policy_flip_with_disk_never_stale(tmp_path, monkeypatch):
    """The reference's case: a flip of a lever in the forward policy under
    a live cache dir builds once more; flipping back finds the first
    entry in memory (no build); both directions answer as they did."""
    from test_torch_train_graph import FakeGraph
    from mxtpu_torch.parallel import set_ring_flash
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    cs.set_cache_dir(tmp_path)
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(4, in_units=3))
    net.initialize(ctx=mt.cpu())
    net.hybridize()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3).astype(
        np.float32))
    y_a = net(x)
    r0 = telemetry.value("retrace.cached_op")
    prev = set_ring_flash(True)
    try:
        y_b = net(x)
        assert telemetry.value("retrace.cached_op") == r0 + 1
        assert cs.stats()["per_site"]["cached_op"] == 2
    finally:
        set_ring_flash(prev)
    y_a2 = net(x)
    assert telemetry.value("retrace.cached_op") == r0 + 1
    assert torch.equal(y_a, y_a2) and torch.equal(y_a, y_b)
    assert telemetry.value("compile.disk.writes", tag="cached_op") >= 2
