"""The port's launch-plan autotuner (``mxtpu_torch/ops/pallas/autotune.py``)
held to ``mxtpu/ops/pallas/autotune.py`` on the CPU: the registry, class
tokens and plan ids (equal to the reference's for the same dicts), the
forced stack, the measured search with a stand-in runner and timer (only
improvements persist, the budget stops the sweep), the plan blobs with
their drop matrix, the policy token riding ``registry.policy_key``, the
warm-up's preload, a fresh process serving tuned plans with zero searches,
and B1's and B2's registrations: the default is what ``_launch_args``
picks without a plan (``sms=132``), every feasible plan's grid covers the
output. No kernel runs here: a plan is checked against the card by
``chip_smoke.py compile_phase``."""
import json
import os
import subprocess
import sys

import pytest
import torch

from mxtpu.ops.pallas import autotune as jat
from mxtpu_torch import compile_service, telemetry
from mxtpu_torch.ops import registry
from mxtpu_torch.ops.pallas import autotune
from mxtpu_torch.ops.pallas import conv as pc
import importlib
fa = importlib.import_module("mxtpu_torch.ops.pallas.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132


@pytest.fixture(autouse=True)
def _clean():
    autotune.reset()
    autotune.set_enabled(False)
    compile_service.set_cache_dir(None)
    yield
    autotune.reset()
    autotune.set_enabled(False)
    autotune.set_budget_s(30)
    autotune.set_rounds(3)
    compile_service.set_cache_dir(None)
    autotune._KERNELS.pop("standin", None)


def _ctr(name, tag=None):
    return telemetry.value(name, tag=tag)


def _conv_sc(n=8, h=56, cin=64, cout=64, k=3, s=1, p=1, dtype="bfloat16"):
    return {"n": n, "h": h, "w": h, "cin": cin, "kh": k, "kw": k,
            "cout": cout, "sh": s, "sw": s, "p0": p, "p1": p, "q0": p,
            "q1": p, "dtype": dtype}


# ----------------------------------------------------------- registrations
def test_both_kernels_registered_with_the_path_classes():
    ks = autotune.kernels()
    assert {"pallas_conv", "pallas_flash"} <= set(ks)
    conv = ks["pallas_conv"].classes()
    assert len(conv) == 10 and {c["n"] for c in conv} == {8, 128}
    assert all(c["dtype"] == "bfloat16" for c in conv)
    assert ks["pallas_flash"].classes() == [
        {"b": b, "h": 12, "t": 512, "tk": 512, "d": 64, "dtype": "bfloat16"}
        for b in (8, 16)]
    for tk in ks.values():
        for sc in tk.classes():
            ok, reason = tk.feasible(tk.default(sc), sc)
            assert ok, (tk.kernel_id, sc, reason)
            for plan in tk.space(sc):
                assert tk.feasible(plan, sc)[0], (tk.kernel_id, plan)


def test_conv_space_is_the_entry_points_instances():
    assert [autotune.plan_id_of(p) for p in pc._tune_space(_conv_sc())] == [
        "block_m=64,block_n=64", "block_m=64,block_n=128",
        "block_m=128,block_n=64", "block_m=128,block_n=128"]
    f32 = _conv_sc(dtype="float32")
    assert pc._tune_space(f32) == [{"block_m": 128, "block_n": 64},
                                   {"block_m": 64, "block_n": 128}]
    ok, reason = pc._tune_feasible({"block_m": 128, "block_n": 128}, f32)
    assert not ok and "instance" in reason
    ok, reason = pc._tune_feasible({"block_m": 32, "block_n": 64},
                                   _conv_sc())
    assert not ok and "instance" in reason


def test_conv_feasibility_mirrors_the_shared_memory_check(monkeypatch):
    # tc_smem_bytes: 1 KB + max(ring, output tile); 4 stages of 64-wide K
    assert pc._smem_bytes(128, 128, 64 * 9, "bfloat16") == \
        1024 + max(4 * 256 * 64 * 2, 128 * 136 * 4)
    assert pc._smem_bytes(64, 64, 16, "bfloat16") == \
        1024 + max(1 * 128 * 64 * 2, 64 * 72 * 4)
    assert pc._smem_bytes(128, 64, 147, "float32") == \
        4 * 3 * (128 * 36 + 32 * 68)
    monkeypatch.setattr(pc, "_SMEM_MAX", 60000)
    ok, reason = pc._tune_feasible({"block_m": 128, "block_n": 128},
                                   _conv_sc())
    assert not ok and "shared memory" in reason


def test_flash_space_and_feasibility():
    sc = {"b": 8, "h": 12, "t": 512, "tk": 512, "d": 64,
          "dtype": "bfloat16"}
    assert sorted(autotune.plan_id_of(p) for p in fa._tune_space(sc)) == [
        "d_tile=128,wgs=1", "d_tile=128,wgs=2", "d_tile=64,wgs=1",
        "d_tile=64,wgs=2"]
    assert not fa._tune_feasible({"d_tile": 32, "wgs": 1}, sc)[0]
    assert not fa._tune_feasible({"d_tile": 64, "wgs": 3}, sc)[0]
    f32 = dict(sc, dtype="float32")
    assert fa._tune_space(f32) == [{"d_tile": 64, "wgs": 1}]
    assert not fa._tune_feasible({"d_tile": 128, "wgs": 1}, f32)[0]
    wide = dict(sc, d=256)
    assert fa._tune_space(wide) == [{"d_tile": 128, "wgs": 1}]
    assert fa._tune_space(dict(sc, d=36)) == [
        {"d_tile": 64, "wgs": 1}, {"d_tile": 128, "wgs": 1},
        {"d_tile": 64, "wgs": 2}, {"d_tile": 128, "wgs": 2}]


def _old_conv_launch_args(x, w, strides, padding, sms):
    """``_launch_args`` as it was before plans (the rule, kept here)."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    (plo, phi), (qlo, qhi) = padding
    m = n * pc.out_hw(h, plo, phi, kh, strides[0]) * pc.out_hw(
        wd, qlo, qhi, kw, strides[1])
    es = x.element_size()
    dtype = pc._DTYPE_CODE[x.dtype]
    route = 1 if dtype == 1 else 0
    vec_a = (cin * es) % 16 == 0 and x.data_ptr() % 16 == 0
    vec_b = (cout * es) % 16 == 0 and w.data_ptr() % 16 == 0
    k_pad = -(-(kh * kw * cin) // 16) * 16
    block_n = 64 if cout <= 64 else 128
    grid_n = -(-cout // block_n)
    if route == 1:
        block_m = 128 if -(-m // 128) * grid_n >= 2 * sms else 64
        threads = block_m // 64 * 128
    else:
        block_m = 128 if block_n == 64 else 64
        threads = block_m * block_n // 64
    return pc.LaunchArgs(dtype, route, vec_a, vec_b, block_m, block_n,
                         threads, k_pad, (-(-m // block_m), grid_n))


CONV_SHAPES = [(n, hw, cin, cout, k, s, p)
               for n in (1, 2, 8, 128)
               for hw, cin, cout, k, s, p in pc.RESNET50_GATED] + [
    (8, 56, 64, 96, 3, 1, 1), (2, 17, 5, 7, 3, 2, 1), (1, 13, 3, 200, 1, 1, 0),
    (4, 28, 128, 32, 3, 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_launch_args_unchanged_with_autotune_off(dtype):
    for on in (False, True):   # on, but no plan in the table: the default
        autotune.set_enabled(on)
        for n, hw, cin, cout, k, s, p in CONV_SHAPES:
            x = torch.empty(n, hw, hw, cin, dtype=dtype, device="meta")
            w = torch.empty(k, k, cin, cout, dtype=dtype, device="meta")
            pad = ((p, p), (p, p))
            sc = pc.shape_class(x, w, (s, s), pad)
            plan = pc._plan_of(x, w, (s, s), pad)
            assert plan is None
            got = pc._launch_args(x, w, (s, s), pad, sms=SMS, plan=plan)
            assert got == _old_conv_launch_args(x, w, (s, s), pad, SMS)
            d = pc._tune_default(sc, sms=SMS)
            assert (d["block_m"], d["block_n"]) == (got.block_m,
                                                    got.block_n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_forced_conv_plan_covers_the_output(dtype):
    for n, hw, cin, cout, k, s, p in CONV_SHAPES:
        tdt = getattr(torch, dtype)
        x = torch.empty(n, hw, hw, cin, dtype=tdt, device="meta")
        w = torch.empty(k, k, cin, cout, dtype=tdt, device="meta")
        pad = ((p, p), (p, p))
        sc = pc.shape_class(x, w, (s, s), pad)
        m = pc._class_m(sc)
        for plan in pc._tune_space(sc):
            assert pc._tune_feasible(plan, sc)[0]
            with autotune.forced("pallas_conv", plan):
                got = pc._plan_of(x, w, (s, s), pad)
            la = pc._launch_args(x, w, (s, s), pad, plan=got)
            assert (la.block_m, la.block_n) == (plan["block_m"],
                                                plan["block_n"])
            assert la.grid[0] * la.block_m >= m > (la.grid[0] - 1) * la.block_m
            assert la.grid[1] * la.block_n >= cout > \
                (la.grid[1] - 1) * la.block_n
            want = la.block_m // 64 * 128 if dtype == "bfloat16" \
                else la.block_m * la.block_n // 64
            assert la.threads == want


FLASH_SHAPES = [(8, 12, 512, 64), (16, 12, 512, 64), (8, 12, 128, 64),
                (2, 3, 77, 32), (2, 3, 77, 36), (6, 12, 512, 128),
                (2, 4, 256, 160), (1, 2, 77, 300)]


def _old_flash_launch_args(q, sms):
    b, h, t, d = q.shape
    dtype = fa._DTYPE_CODE[q.dtype]
    d_tile = 32 if d <= 32 else 64 if d <= 64 else 128
    slices = -(-d // 128)
    if dtype == 0:
        wg, bq = 1, 128
    elif slices > 1:
        wg, bq = 1, 64
    else:
        wg = 2 if b * h * -(-t // 128) >= 2 * sms else 1
        bq = 64 * wg
    n_q = -(-t // bq)
    return d_tile, wg, bq, n_q, slices, b * h * n_q * slices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_args_unchanged_and_forced_plans_cover(dtype):
    for b, h, t, d in FLASH_SHAPES:
        q = torch.empty(b, h, t, d, dtype=dtype, device="meta")
        la = fa._launch_args(q, q, q, False, None, sms=SMS,
                             plan=fa._plan_of(q, q))
        assert (la.d_tile, la.warpgroups, la.block_q, la.n_q, la.slices,
                la.grid) == _old_flash_launch_args(q, SMS)
        sc = fa.shape_class(q, q)
        assert fa._tune_default(sc, sms=SMS) == {"d_tile": la.d_tile,
                                                "wgs": la.warpgroups}
        for plan in fa._tune_space(sc):
            with autotune.forced("pallas_flash", plan):
                got = fa._plan_of(q, q)
            la = fa._launch_args(q, q, q, False, None, plan=got)
            assert la.d_tile * la.slices >= d
            assert la.n_q * la.block_q >= t > (la.n_q - 1) * la.block_q
            assert la.grid == b * h * la.n_q * la.slices


# ------------------------------------------------------------- key material
@pytest.mark.parametrize("sc", [
    _conv_sc(), _conv_sc(n=128, h=224, cin=3, k=7, s=2, p=3),
    {"b": 8, "h": 12, "t": 512, "tk": 512, "d": 64, "dtype": "bfloat16"},
    {"z": 1, "a": "x", "m": 3}])
def test_class_token_and_plan_id_equal_the_references(sc):
    rev = dict(reversed(list(sc.items())))
    assert autotune.class_token(sc) == autotune.class_token(rev) == \
        jat.class_token(sc) == jat.class_token(rev)
    for plan in ({"block_m": 64, "block_n": 128}, {"wgs": 2, "d_tile": 64},
                 {"bo": 16}, {"block_q": 512, "block_k": 256}):
        assert autotune.plan_id_of(plan) == jat.plan_id_of(plan)
        assert autotune.plan_id_of(dict(reversed(list(plan.items())))) == \
            jat.plan_id_of(plan)


def test_forced_stack_wins_and_unwinds():
    sc = _conv_sc()
    a, b = {"block_m": 64, "block_n": 64}, {"block_m": 128, "block_n": 64}
    with autotune.forced("pallas_conv", a):
        assert autotune.lookup("pallas_conv", sc) == a
        with autotune.forced("pallas_conv", b):
            assert autotune.lookup("pallas_conv", sc) == b
        assert autotune.lookup("pallas_conv", sc) == a
    assert autotune.lookup("pallas_conv", sc) is None


def test_disabled_is_inert(tmp_path):
    compile_service.set_cache_dir(tmp_path)
    autotune.install_plan("pallas_conv", _conv_sc(),
                          {"block_m": 64, "block_n": 64})
    assert autotune.lookup("pallas_conv", _conv_sc()) is None
    assert autotune.policy_token() == "0"
    assert not autotune.consulted()


# ------------------------------------------------------------------ search
def _standin(times, default=None):
    """A registered stand-in kernel and timer: plan ``{"v": i}`` takes
    ``times[i]`` seconds; the runner runs on CPU tensors."""
    calls = []

    def runner(sc):
        def fn(x):
            calls.append(autotune.lookup("standin", sc))
            return x + 1
        return fn, (torch.zeros(4),)

    autotune.register_kernel(autotune.TunableKernel(
        kernel_id="standin",
        space=lambda sc: [{"v": i} for i in range(len(times))],
        default=lambda sc: {"v": 0 if default is None else default},
        feasible=lambda plan, sc: ((True, None) if plan["v"] >= 0
                                   else (False, "negative")),
        runner=runner, classes=lambda: [{"k": 1, "dtype": "float32"}]))
    return calls


def test_search_times_every_plan_and_persists_only_improvements(
        tmp_path, monkeypatch):
    compile_service.set_cache_dir(tmp_path)
    calls = _standin([0.0])
    monkeypatch.setattr(autotune, "_time_plan",
                        lambda kid, fn, plan, args, rounds:
                        [3.0, 1.0, 2.0][plan["v"]])
    autotune._KERNELS["standin"] = autotune._KERNELS["standin"]._replace(
        space=lambda sc: [{"v": 2}, {"v": 1}, {"v": 0}, {"v": 1}])
    s0 = _ctr("autotune.searches")
    res = autotune.search("standin", {"k": 1, "dtype": "float32"})
    assert _ctr("autotune.searches") == s0 + 1
    assert [t["plan_id"] for t in res["timings"]] == ["v=0", "v=2", "v=1"]
    assert res["best_plan_id"] == "v=1" and res["improved"]
    assert os.path.exists(res["persisted"])
    assert autotune.installed() == {("standin", "dtype=float32|k=1"): "v=1"}
    assert calls == []   # the stand-in timer ran nothing


def test_search_ties_keep_the_default(monkeypatch):
    _standin([0.0, 0.0])
    monkeypatch.setattr(autotune, "_time_plan", lambda *a: 1.0)
    res = autotune.search("standin", {"k": 1, "dtype": "float32"})
    assert not res["improved"] and res["persisted"] is None
    assert not autotune.installed()


def test_search_runs_the_runner_under_each_forced_plan():
    calls = _standin([0.0, 0.0, 0.0])
    autotune.set_rounds(2)
    res = autotune.search("standin", {"k": 1, "dtype": "float32"},
                          install=False)
    # one discarded warm-up and two timed runs a plan, each under it
    assert calls == [{"v": v} for v in (0, 1, 2) for _ in range(3)]
    assert res["rounds"] == 2 and res["timed"] == 3
    assert all(t["s"] >= 0 for t in res["timings"])


def test_search_budget_stops_with_best_so_far(monkeypatch):
    _standin([0.0] * 5)
    monkeypatch.setattr(autotune, "_time_plan", lambda *a: 0.5)
    autotune.set_budget_s(-1)
    res = autotune.search("standin", {"k": 1, "dtype": "float32"})
    assert res["timed"] == 1 and res["budget_exhausted"]


def test_search_prunes_infeasible_before_any_run(monkeypatch):
    calls = _standin([0.0])
    autotune._KERNELS["standin"] = autotune._KERNELS["standin"]._replace(
        space=lambda sc: [{"v": -1}, {"v": 0}])
    res = autotune.search("standin", {"k": 1, "dtype": "float32"})
    assert res["pruned"] == [{"plan_id": "v=-1", "reason": "negative"}]
    assert {"v": -1} not in calls


# ------------------------------------------------------------- persistence
def _saved(tmp_path, sc=None, plan=None):
    compile_service.set_cache_dir(tmp_path)
    sc = sc or _conv_sc()
    return sc, autotune.save_plan("pallas_conv", sc, plan or {
        "block_m": 128, "block_n": 128})


def test_plan_roundtrip_serves_from_disk(tmp_path):
    sc, path = _saved(tmp_path)
    assert os.path.basename(path).startswith("plan_")
    rec = json.load(open(path))
    assert rec["magic"] == "MXTPU-AT" and rec["key"].startswith(
        "pallas_conv|")
    assert rec["env"] == {"format": autotune.FORMAT_VERSION,
                          "device": autotune.device_kind()}
    autotune.set_enabled(True)
    h0, m0 = _ctr("autotune.plan_hits", tag="disk"), \
        _ctr("autotune.plan_misses")
    assert autotune.lookup("pallas_conv", sc) == {"block_m": 128,
                                                  "block_n": 128}
    assert _ctr("autotune.plan_hits", tag="disk") == h0 + 1
    assert autotune.active_plan("pallas_conv", sc) == (
        "block_m=128,block_n=128", "tuned")
    autotune.install_plan("pallas_conv", sc, pc._tune_default(sc),
                          source="disk")
    assert autotune.active_plan("pallas_conv", sc)[1] == "default"
    assert autotune.hits()[("pallas_conv", autotune.class_token(sc))] == 3
    assert autotune.lookup("pallas_conv", _conv_sc(n=2)) is None
    assert _ctr("autotune.plan_misses") == m0 + 1
    assert telemetry.gauge_value("pallas.plan", tag="pallas_conv") == 0


def _rewrite(path, fn):
    rec = json.load(open(path))
    fn(rec)
    json.dump(rec, open(path, "w"))


@pytest.mark.parametrize("damage,reason", [
    ("truncate", "corrupt"), ("garbage", "corrupt"),
    ("magic", "corrupt"), ("plan_type", "corrupt"),
    ("format", "version_mismatch"), ("device", "version_mismatch"),
    ("forge", "key_mismatch")])
def test_drop_matrix_degrades_to_the_default(tmp_path, damage, reason):
    sc, path = _saved(tmp_path)
    other = _conv_sc(n=2)
    if damage == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    elif damage == "garbage":
        open(path, "wb").write(b"\x00not json")
    elif damage == "magic":
        _rewrite(path, lambda r: r.update(magic="NOPE"))
    elif damage == "plan_type":
        _rewrite(path, lambda r: r.update(plan=[64, 64]))
    elif damage == "format":
        _rewrite(path, lambda r: r["env"].update(format=99))
    elif damage == "device":   # a blob written on another device kind
        _rewrite(path, lambda r: r["env"].update(device="cuda/other"))
    else:   # a rename under another class's digest
        os.replace(path, autotune.plan_path("pallas_conv", other))
        sc = other
    autotune.set_enabled(True)
    d0 = _ctr("autotune.drops", tag=reason)
    assert autotune.lookup("pallas_conv", sc) is None
    assert _ctr("autotune.drops", tag=reason) == d0 + 1


def test_io_failure_counts_and_returns_none(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    compile_service.set_cache_dir(blocker / "sub")
    d0 = _ctr("autotune.drops", tag="io")
    assert autotune.save_plan("pallas_conv", _conv_sc(),
                              {"block_m": 64, "block_n": 64}) is None
    assert _ctr("autotune.drops", tag="io") == d0 + 1


def test_infeasible_served_plan_degrades_at_consult():
    autotune.set_enabled(True)
    sc = _conv_sc(dtype="float32")
    autotune.install_plan("pallas_conv", sc, {"block_m": 128,
                                              "block_n": 128})
    x = torch.empty(8, 56, 56, 64, device="meta")
    w = torch.empty(3, 3, 64, 64, device="meta")
    d0 = _ctr("autotune.drops", tag="infeasible")
    assert pc._plan_of(x, w, (1, 1), ((1, 1), (1, 1))) is None
    assert _ctr("autotune.drops", tag="infeasible") == d0 + 1


def test_policy_token_rides_policy_key():
    autotune.set_enabled(True)
    key_empty = registry.policy_key()
    assert autotune.policy_token() == "0" and key_empty[-1] == "0"
    autotune.install_plan("pallas_conv", _conv_sc(),
                          {"block_m": 64, "block_n": 64})
    t1 = autotune.policy_token()
    assert t1 != "0" and registry.policy_key()[-1] == t1
    assert registry.policy_key() != key_empty
    autotune.install_plan("pallas_conv", _conv_sc(),
                          {"block_m": 128, "block_n": 64})
    assert autotune.policy_token() not in ("0", t1)
    autotune.set_enabled(False)
    assert registry.policy_key()[-3:] == ("0", "0", "0")


def test_warmup_preloads_the_plan_table(tmp_path):
    sc, _ = _saved(tmp_path)
    autotune.set_enabled(True)
    assert not autotune.installed()
    compile_service.warmup([])
    assert autotune.installed() == {
        ("pallas_conv", autotune.class_token(sc)): "block_m=128,block_n=128"}


def test_fresh_process_serves_tuned_plans_with_zero_searches(tmp_path):
    sc, _ = _saved(tmp_path)
    script = r"""
import json, sys
sys.path.insert(0, %r)
from mxtpu_torch import compile_service, telemetry
from mxtpu_torch.ops.pallas import autotune
compile_service.set_cache_dir(sys.argv[1])
autotune.set_enabled(True)
sc = json.loads(sys.argv[2])
plan = autotune.lookup("pallas_conv", sc)
print(json.dumps({"plan": plan,
                  "searches": telemetry.value("autotune.searches"),
                  "hits_disk": telemetry.value("autotune.plan_hits",
                                               tag="disk"),
                  "drops": telemetry.tagged("autotune.drops")}))
""" % REPO
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path),
                          json.dumps(sc)], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r == {"plan": {"block_m": 128, "block_n": 128}, "searches": 0,
                 "hits_disk": 1, "drops": {}}
