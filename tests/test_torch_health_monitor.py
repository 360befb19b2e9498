"""``monitor.TrainingHealthMonitor`` of the port against the JAX
package's, on the CPU: a guarded Trainer (``resilience.set_guard``; the
reference's ``MXTPU_NUMERICS_GUARD=1``) over three parameters takes five
steps with scheduled NaN gradients in both packages, the monitor flushing
every step; the verdicts it drains, the skipped steps it logs, the
poison-batch quarantine (its ring, its flight artifact with the steps'
trace ids, ``PoisonBatchError`` or ``"continue"``), the counters and the
gauges are held equal, and the divergence check runs at its cadence."""
import json

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.gluon.parameter import Parameter as JParameter
from mxtpu.monitor import TrainingHealthMonitor as JMonitor
import mxtpu_torch as mt
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.monitor import TrainingHealthMonitor as TMonitor


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_FAULT_INJECT", "MXTPU_NUMERICS_GUARD",
                "MXTPU_FLIGHT_DIR", "MXTPU_DIVERGENCE_EVERY",
                "MXTPU_POISON_STREAK"):
        monkeypatch.delenv(var, raising=False)
    for mod in (jres, tres):
        mod.reset_faults()
    for tel in (jtel, ttel):
        tel.reset()
    yield
    tres.set_guard(False)
    tres.set_divergence_every(0)
    ttel.set_flight_dir(None)
    for mod in (jres, tres):
        mod.reset_faults()


def _trainer(pkg):
    rng = np.random.RandomState(0)
    params = []
    for j in range(3):
        vals = rng.uniform(-1, 1, 5).astype(np.float32)
        if pkg is mx:
            p = JParameter("rp%d" % j, shape=(5,), dtype="float32")
            p.initialize()
            p.data()._set_data(mx.nd.array(vals)._data)
        else:
            p = mt.gluon.Parameter("rp%d" % j, shape=(5,), dtype="float32")
            p.initialize(ctx=mt.cpu())
            p.set_data(vals)
        params.append(p)
    tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                           "momentum": 0.9}, kvstore=None)
    return tr, params


def _run(pkg, monitor_cls, monkeypatch, tmp_path, spec, **kw):
    """Five guarded steps with the faults of ``spec``; returns what the
    monitor saw and whether it raised."""
    if pkg is mx:
        monkeypatch.setenv("MXTPU_NUMERICS_GUARD", "1")
        monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
        monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "jax"))
    else:
        tres.set_guard(True)
        tres.set_faults(spec)
        ttel.set_flight_dir(str(tmp_path / "port"))
    tr, params = _trainer(pkg)
    mon = monitor_cls(interval=1, **kw).install(tr)
    rng = np.random.RandomState(17)
    records, raised = [], None
    try:
        for _ in range(5):
            for p in params:
                g = rng.randn(5).astype(np.float32)
                if pkg is mx:
                    p.grad()[:] = mx.nd.array(g)
                else:
                    p.grad()._set_data(torch.from_numpy(g))
            with (jtel if pkg is mx else ttel).span(
                    "trainer.loop", new_trace=True):
                tr.step(1)
            records += [(s, ok) for s, ok, _ in mon.after_step()]
    except (jres.PoisonBatchError, tres.PoisonBatchError) as e:
        raised = str(e).split(";")[0].split(" — ")[0]
    tel = jtel if pkg is mx else ttel
    out = dict(records=records, raised=raised,
               skipped=[s for s, _ in mon.skipped],
               quarantined=[q["steps"] for q in mon.quarantined],
               ok=tel.value("resilience.steps_ok"),
               bad=tel.value("resilience.steps_skipped"),
               quarantines=tel.value("resilience.poison_quarantines"))
    monkeypatch.delenv("MXTPU_NUMERICS_GUARD", raising=False)
    tres.set_guard(False)
    return out, mon, tr


@pytest.mark.parametrize("spec,kw", [
    ("nan_grad@2,3", dict(poison_streak=2)),
    ("nan_grad@1,2", dict(poison_streak=2, on_poison="continue")),
    ("nan_grad@1,3", dict(poison_streak=2)),
    ("nan_grad@0,1,2", dict(poison_streak=0)),
], ids=["raise", "continue", "streak_broken", "off"])
def test_monitor_matches_mxtpu(monkeypatch, tmp_path, spec, kw):
    got, tmon, ttr = _run(mt, TMonitor, monkeypatch, tmp_path, spec, **kw)
    want, _, _ = _run(mx, JMonitor, monkeypatch, tmp_path, spec, **kw)
    assert got == want
    if got["quarantined"]:
        arts = sorted((tmp_path / "port").glob("flight_poison_batch_*"))
        assert len(arts) == 1
        rec = json.loads(arts[0].read_text())
        traces = ttr._updaters[0]._step_traces
        assert rec["trace_ids"] == [traces[s] for s in
                                    got["quarantined"][0]]
        assert rec["extra"]["steps"] == got["quarantined"][0]
        assert tmon.quarantined[0]["trace_ids"] == rec["trace_ids"]


def test_monitor_gauges_and_divergence_cadence(tmp_path):
    tres.set_divergence_every(2)
    ttel.set_flight_dir(str(tmp_path))
    with mt.cpu():
        sc = tres.DynamicLossScaler(init_scale=8.0)
        tr, params = _trainer(mt)
        tr = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.05},
                              kvstore=None, loss_scaler=sc)
        mon = TMonitor(interval=2, divergence_every=2,
                       poison_streak=0).install(tr)
        rng = np.random.RandomState(1)
        for step in range(4):
            for p in params:
                p.grad()._set_data(torch.from_numpy(
                    rng.randn(5).astype(np.float32)))
            if step == 3:
                tres.set_faults("divergence@0")
                with pytest.raises(tres.DivergenceError):
                    tr.step(1)
                    mon.after_step()
            else:
                tr.step(1)
                mon.after_step()
    assert mon._sentinel.checks == 2
    assert ttel.gauge_value("resilience.loss_scale") == 8.0
    assert ttel.gauge_value("resilience.grad_norm") > 0
    assert len(list(tmp_path.glob("flight_divergence_*"))) == 1
