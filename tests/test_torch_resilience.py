"""The port's resilience runtime against the JAX package's, on the CPU:
the loss scaler's schedule over a scripted run of good and bad steps and
its state round trip, ``with_retries`` (same seeded generator, same
waits), the training fault kinds, the step watchdog on a fake clock, the
divergence sentinel, ``TrainSupervisor`` (injected spawns, and a child
script on the CPU that crashes once and then twice at one step), and the
reference's ``MXTPU_*`` levers: setting each changes nothing in the port.
The JAX side's levers are set with ``monkeypatch.setenv`` only, the
port's with its setters."""
import json
import random
import sys

import numpy as np
import pytest
import torch

from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
import mxtpu_torch as mt
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch import xprof as txprof

LEVERS = ("MXTPU_FAULT_INJECT", "MXTPU_FLIGHT_DIR", "MXTPU_LOSS_SCALE",
          "MXTPU_TRAIN_STEP_TIMEOUT_X", "MXTPU_SUPERVISOR_RESTARTS",
          "MXTPU_SUPERVISOR_BACKOFF_S", "MXTPU_CKPT_RETRIES")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in LEVERS:
        monkeypatch.delenv(var, raising=False)
    for mod in (jres, tres):
        mod.reset_faults()
    for tel in (jtel, ttel):
        tel.reset()
    yield
    for mod in (jres, tres):
        mod.reset_faults()
    ttel.set_flight_dir(None)
    ttel.reset()


# ------------------------------------------------------------ loss scaler
SCRIPT = [True, True, True, False, True, True, False, False, True, True,
          True, True, True]


@pytest.mark.parametrize("cfg", [
    dict(init_scale=2.0 ** 10, growth_interval=3),
    dict(init_scale=4.0, growth_interval=2, backoff_factor=0.25,
         min_scale=1.0, max_scale=16.0)])
def test_scaler_schedule_matches_mxtpu(cfg):
    js = jres.DynamicLossScaler(**cfg)
    with mt.cpu():
        ts = tres.DynamicLossScaler(**cfg)
        assert ts.config() == js.config()
        for ok in SCRIPT:
            js.host_update(ok)
            ts.host_update(ok)
            assert ts.scale_value() == js.scale_value()
            assert int(ts._streak) == int(js._streak)
        state = ts.state_dict()
        ref = js.state_dict()
    assert float(state["scale"]) == float(ref["scale"])
    assert int(state["streak"]) == int(ref["streak"])
    assert tuple(state["config"]) == tuple(ref["config"])
    back = tres.DynamicLossScaler.from_state_dict(state)
    assert back.config() == ts.config()
    with mt.cpu():
        assert back.scale_value() == ts.scale_value()


def test_scaler_state_loads_in_place_and_before_first_use():
    with mt.cpu():
        ts = tres.DynamicLossScaler(init_scale=8.0)
        storage = ts.scale_array()
        ts.load_state_dict({"scale": 2.0, "streak": 5})
        assert ts.scale_array() is storage and ts.scale_value() == 2.0
        late = tres.DynamicLossScaler()
        late.load_state_dict({"scale": 64.0, "streak": 1})
        assert late.state_dict()["scale"] == 64.0
        assert late.scale_value() == 64.0 and int(late._streak) == 1
        loss = mt.nd.array(np.ones(3, np.float32)).astype("bfloat16")
        scaled = late.scale(loss)
        assert scaled.dtype == np.float32
        np.testing.assert_array_equal(scaled.asnumpy(), 64.0)


# ---------------------------------------------------------------- retries
def _flaky(n_fail):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n_fail:
            raise OSError("transient")
        return "ok"
    return fn, calls


@pytest.mark.parametrize("seed,n_fail", [(7, 5), (8, 3), (0, 0)])
def test_with_retries_waits_like_mxtpu(seed, n_fail):
    waits = {}
    for name, mod in (("jax", jres), ("port", tres)):
        delays = []
        fn, calls = _flaky(n_fail)
        assert mod.with_retries(fn, "t", retries=n_fail, backoff=0.25,
                                sleeper=delays.append,
                                rng=random.Random(seed)) == "ok"
        waits[name] = (delays, calls["n"])
    assert waits["port"] == waits["jax"]
    fn, _ = _flaky(10)
    with pytest.raises(OSError):
        tres.with_retries(fn, "t", retries=1, backoff=0.0,
                          sleeper=lambda s: None)
    assert ttel.value("retry.total") == 1 + n_fail


def test_training_fault_kinds_consume_once_like_mxtpu(monkeypatch):
    spec = ("train_wedge@2;ckpt_corrupt@0;divergence@1;supervisor_crash@0;"
            "nan_grad@3,5;ckpt_io@0;sigterm@4")
    monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
    tres.set_faults(spec)
    calls = [("train_wedge", 1), ("train_wedge", 2), ("train_wedge", 2),
             ("ckpt_corrupt", None), ("ckpt_corrupt", None),
             ("divergence", 0), ("divergence", 1), ("divergence", 1),
             ("supervisor_crash", 0), ("supervisor_crash", 0),
             ("nan_grad", 3), ("nan_grad", 4), ("nan_grad", 5),
             ("ckpt_io", None), ("ckpt_io", None), ("sigterm", 4)]
    got = [tres.inject(k, i) for k, i in calls]
    want = [jres.inject(k, i) for k, i in calls]
    assert got == want
    assert tres.FAULT_STATS["fired"] == jres.FAULT_STATS["fired"]
    assert ttel.tagged("faults.injected") == jtel.tagged("faults.injected")


def test_each_fault_dumps_a_flight_artifact(tmp_path):
    ttel.set_flight_dir(str(tmp_path))
    tres.set_faults("nan_grad@0")
    with ttel.span("trainer.step", new_trace=True):
        assert tres.inject("nan_grad", 0)
        trace = ttel.current_trace().trace_id
    (art,) = tmp_path.iterdir()
    rec = json.loads(art.read_text())
    assert rec["reason"] == "fault" and rec["trace_ids"] == [trace]
    assert rec["extra"] == {"kind": "nan_grad", "index": 0}


# ---------------------------------------------------------------- watchdog
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(mod, tmp_flight, monkeypatch):
    """The reference's watchdog matrix on a fake clock: three 1 s steps,
    a held step (``train_wedge@4``), the scan past its 5 s deadline."""
    clock = _Clock()
    wd = mod.TrainStepWatchdog(timeout_x=5.0, min_timeout_s=2.0,
                               clock=clock)
    out = []
    for step in range(1, 5):
        e = wd.arm(step, trace_id="t%d" % step)
        out.append((e["deadline"], e["bound_s"]))
        clock.t += 1.0
        wd.disarm(e)
    out.append(wd.baseline())
    clock.t += 4.0
    wd.poll()   # within the deadline: nothing
    clock.t += 1.5
    with pytest.raises(mod.TrainWedgeError) as err:
        wd.poll()
    out.append(str(err.value).split(":")[0])
    with pytest.raises(mod.TrainWedgeError):
        wd.arm(6)   # poisoned
    return out


def test_step_watchdog_trips_like_mxtpu(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "train_wedge@4")
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "jax"))
    tres.set_faults("train_wedge@4")
    ttel.set_flight_dir(str(tmp_path / "port"))
    got = _drive(tres, tmp_path / "port", monkeypatch)
    want = _drive(jres, tmp_path / "jax", monkeypatch)
    assert got == want
    assert ttel.value("train.wedges") == jtel.value("train.wedges") == 1
    for side in ("port", "jax"):
        names = sorted(p.name.split("_")[1] for p in
                       (tmp_path / side).iterdir())
        assert names == ["fault", "train"], side   # fault, train_wedge
    art = next(p for p in (tmp_path / "port").iterdir()
               if "train_wedge" in p.name)
    extra = json.loads(art.read_text())["extra"]
    assert extra["step"] == 4 and extra["bound_s"] == 5.0


def test_step_watchdog_monitor_thread_trips_in_real_time(tmp_path):
    ttel.set_flight_dir(str(tmp_path))
    tres.set_faults("train_wedge@4")
    wd = tres.TrainStepWatchdog(timeout_x=2.0, min_timeout_s=0.02)
    wd.start_monitor(0.005)
    try:
        for step in range(1, 5):
            wd.disarm(wd.arm(step))
        import time
        deadline = time.time() + 5.0
        while wd._tripped is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(tres.TrainWedgeError):
            wd.arm(5)
    finally:
        wd.stop_monitor()
    assert any("train_wedge" in p.name for p in tmp_path.iterdir())


# ---------------------------------------------------- divergence sentinel
def test_divergence_sentinel_like_mxtpu(tmp_path, monkeypatch):
    import jax.numpy as jnp
    ttel.set_flight_dir(str(tmp_path))
    fp_t = (torch.tensor(1.5), torch.tensor(7, dtype=torch.int64))
    fp_j = (jnp.float32(1.5), jnp.int32(7))
    js, ts = jres.DivergenceSentinel(), tres.DivergenceSentinel()
    assert ts.check(None) is True and js.check(None) is True
    assert ts.check(fp_t, step=1) is True and js.check(fp_j, step=1) is True
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "divergence@0")
    tres.set_faults("divergence@0")
    for s, fp in ((ts, fp_t), (js, fp_j)):
        with pytest.raises((tres.DivergenceError, jres.DivergenceError),
                           match="cross-replica divergence"):
            s.check(fp, step=2, trace_ids=["x"])
    assert ts.checks == js.checks == 2
    (art,) = [p for p in tmp_path.iterdir() if "divergence" in p.name]
    rec = json.loads(art.read_text())
    assert rec["trace_ids"] == ["x"] and rec["extra"]["step"] == 2
    assert len(rec["extra"]["fingerprints"][-1]) == 2   # the planted copy


# -------------------------------------------------------------- supervisor
def _supervise(mod, codes, latest, **kw):
    """Drive a supervisor with scripted exit codes and checkpoint steps
    (the view its ``_latest`` reads); returns (result, history,
    sleeps)."""
    it = iter(codes)
    steps = iter(latest)
    sleeps = []
    sup = mod.TrainSupervisor(["child"], spawn=lambda argv: next(it),
                              sleeper=sleeps.append,
                              rng=random.Random(3), **kw)
    sup._latest = lambda: next(steps)
    try:
        res = sup.run()
    except mod.SupervisorRefusal as e:
        res = "refused: " + str(e).split(" ")[3]
    return res, sup.history, sleeps, sup.restarts


@pytest.mark.parametrize("codes,latest,kw", [
    ([1, 1, 0], [None, 3, 3, 5, 5], {}),          # progress: respawns
    ([1, 1], [None, 3, 3, 3], {}),                 # same step twice: poison
    ([1, 1, 1], [None, None, None, None, None, None, None],
     {"max_restarts": 2}),                          # the budget
    ([0], [None], {}),
])
def test_supervisor_matrix_like_mxtpu(codes, latest, kw):
    got = _supervise(tres, codes, latest, **kw)
    want = _supervise(jres, codes, latest, **kw)
    assert got == want
    assert ttel.tagged("supervisor.restarts") == \
        jtel.tagged("supervisor.restarts")


def test_supervisor_injected_crash_like_mxtpu(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "supervisor_crash@0")
    tres.set_faults("supervisor_crash@0")
    got = _supervise(tres, [0, 0], [None, None, None], backoff_s=0.5)
    want = _supervise(jres, [0, 0], [None, None, None], backoff_s=0.5)
    assert got == want and got[0] == 0 and got[3] == 1
    assert ttel.tagged("supervisor.restarts") == {"injected": 1}


CHILD = r"""
import json, os, sys
ckpt, mode = sys.argv[1], sys.argv[2]
count_file = os.path.join(ckpt, "attempts")
n = int(open(count_file).read()) if os.path.exists(count_file) else 0
open(count_file, "w").write(str(n + 1))
step = n + 1 if mode == "progress" else 1
os.makedirs(os.path.join(ckpt, "step_%d" % step), exist_ok=True)
with open(os.path.join(ckpt, "latest.json"), "w") as f:
    json.dump({"step": step}, f)
sys.exit(0 if (mode == "progress" and n >= 1) else 3)
"""


@pytest.mark.parametrize("mode", ["progress", "poison"])
def test_supervisor_respawns_a_child_process(tmp_path, mode):
    """A child on the CPU that crashes once and then succeeds (with a
    new checkpoint step between), and one that crashes twice at one
    step: the port respawns the first and refuses the second with the
    artifact."""
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    ttel.set_flight_dir(str(tmp_path / "flight"))
    sup = tres.TrainSupervisor(
        [sys.executable, str(script), str(ckpt), mode], ckpt_dir=str(ckpt),
        backoff_s=0.0, max_backoff_s=0.0)
    if mode == "progress":
        assert sup.run() == 0
        assert sup.restarts == 1 and [h[2] for h in sup.history] == [1]
    else:
        with pytest.raises(tres.SupervisorRefusal, match="crashed twice"):
            sup.run()
        assert [h[2] for h in sup.history] == [1, 1]
        assert any("supervisor_refusal" in p.name
                   for p in (tmp_path / "flight").iterdir())


# ------------------------------------------------------------------ levers
LEVER_VALUES = {
    "MXTPU_NUMERICS_GUARD": "1", "MXTPU_LOSS_SCALE": "8",
    "MXTPU_DIVERGENCE_EVERY": "1", "MXTPU_POISON_STREAK": "1",
    "MXTPU_TRAIN_STEP_TIMEOUT_X": "2", "MXTPU_CKPT_RETRIES": "0",
    "MXTPU_CKPT_KEEP": "1", "MXTPU_TELEMETRY": "0",
    "MXTPU_TELEMETRY_FLUSH_S": "0.01", "MXTPU_TRACE_RING": "2",
    "MXTPU_FLIGHT_DIR": "FLIGHT", "MXTPU_FLIGHT_MAX": "0",
    "MXTPU_XPROF": "0", "MXTPU_MEMWATCH_S": "0.01",
    "MXTPU_PEAK_TFLOPS": "1", "MXTPU_SUPERVISOR_RESTARTS": "0",
    "MXTPU_SUPERVISOR_BACKOFF_S": "9"}


def _port_behaviour(tmp_path):
    """What the port does with its defaults: a guarded-or-not Trainer
    step's verdict, the levers' reads, a supervisor's budget and a
    flight dump, telemetry's spans and the ledger's meter."""
    from mxtpu_torch import perf_model
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    with mt.autograd.record():
        loss = net(mt.nd.array(np.ones((2, 3), np.float32),
                               ctx=mt.cpu())).sum()
    loss.backward()
    verdict = tr.step(2)
    ttel.flight_record("lever_probe")
    with ttel.span("probe"):
        pass
    sup = tres.TrainSupervisor(["x"], spawn=lambda a: 1,
                               sleeper=lambda s: None)
    try:
        sup.run()
    except tres.SupervisorRefusal:
        pass
    return dict(
        verdict=verdict, watchdog=tr._step_watchdog,
        guard=tres.guard_enabled(), scale=tres.default_loss_scale(),
        reads=(tres.ckpt_retries(), tres.ckpt_keep(),
               tres.divergence_every(), tres.train_step_timeout_x(),
               tres.poison_streak()),
        restarts=sup.restarts, backoff=sup.backoff_s,
        flight=ttel.flight_dir(), spans=ttel.snapshot()["histograms"].get(
            "probe", {}).get("count"),
        sink=ttel.jsonl_path(), xprof=txprof.enabled(),
        memwatch=txprof.memwatch_interval(),
        peak=perf_model.peak_flops("cpu"), mfu=tr._mfu is not None)


@pytest.mark.parametrize("lever", sorted(LEVER_VALUES))
def test_reference_levers_change_nothing_in_the_port(lever, monkeypatch,
                                                     tmp_path):
    ttel.reset()
    base = _port_behaviour(tmp_path)
    monkeypatch.setenv(lever, LEVER_VALUES[lever].replace(
        "FLIGHT", str(tmp_path / "flight")))
    ttel.reset()
    tres.reset_faults()
    got = _port_behaviour(tmp_path)
    assert got == base
    assert not (tmp_path / "flight").exists()
    assert base["verdict"] is None and base["guard"] is False
    assert base["reads"] == (3, 0, 0, 0.0, 0) and base["restarts"] == 8
