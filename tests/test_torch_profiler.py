"""``profiler`` of the port against the JAX package's, on the CPU: the same
imperative program profiled in both gives chrome-trace JSON of the same
shape (one ``operator`` event per op dispatched, the telemetry spans of
the window, the trace ring's flow events) and the same aggregate table's
rows; the scopes record only inside a window; the op hook costs one
attribute read when the profiler is off. ``log`` and ``engine`` hold the
reference's return values."""
import json
import logging

import numpy as np
import pytest

import mxtpu as mx
from mxtpu import engine as jengine
from mxtpu import log as jlog
from mxtpu import profiler as jprof
from mxtpu import telemetry as jtel
import mxtpu_torch as mt
from mxtpu_torch import engine as tengine
from mxtpu_torch import log as tlog
from mxtpu_torch import profiler as tprof
from mxtpu_torch import telemetry as ttel


@pytest.fixture(autouse=True)
def _fresh():
    for prof, tel in ((jprof, jtel), (tprof, ttel)):
        prof.stop()
        prof.dumps(reset=True)
        tel.reset()
    yield
    for prof in (jprof, tprof):
        prof.stop()
        prof.dumps(reset=True)


def _program(pkg, prof, tel, path):
    prof.set_config(filename=str(path), aggregate_stats=True)
    ctx = mt.cpu() if pkg is mt else None
    arr = (lambda a: pkg.nd.array(a, ctx=ctx)) if pkg is mt \
        else pkg.nd.array
    x = arr(np.arange(6, dtype=np.float32).reshape(2, 3))
    prof.start()
    with tel.span("outer", new_trace=True):
        with tel.span("inner"):
            y = pkg.nd.relu(x) + 1
            z = (y * y).sum()
    with prof.ProfileTask("load", domain=None):
        pass
    with prof.ProfileFrame("frame"):
        pass
    with prof.ProfileEvent("event"):
        pass
    prof.stop()
    with prof.scope("after_stop"):   # outside the window: nothing
        pass
    prof.dump()
    with open(path) as f:
        trace = json.load(f)
    return trace, prof.dumps(), float(z.asnumpy())


def _shape(trace):
    ev = trace["traceEvents"]
    ops = sorted(e["name"] for e in ev if e.get("cat") == "operator")
    return dict(
        cats=sorted({e.get("cat") for e in ev if e["ph"] == "X"}),
        scopes=sorted(e["name"] for e in ev
                      if e.get("cat") in ("task", "frame", "event")),
        spans=sorted(e["name"] for e in ev if e.get("cat") == "phase"),
        flows=sorted((e["ph"], e["cat"], e["name"]) for e in ev
                     if e["ph"] in ("s", "f")),
        keys=sorted({k for e in ev if e["ph"] == "X" for k in e}),
        n_ops=len(ops))


def test_chrome_trace_and_table_like_mxtpu(tmp_path):
    ttrace, ttable, tz = _program(mt, tprof, ttel, tmp_path / "t.json")
    jtrace, jtable, jz = _program(mx, jprof, jtel, tmp_path / "j.json")
    assert tz == jz
    got, want = _shape(ttrace), _shape(jtrace)
    assert got["scopes"] == want["scopes"] == ["event", "frame", "load"]
    assert got["spans"] == want["spans"] == ["inner", "outer"]
    assert got["flows"] == want["flows"]
    assert got["keys"] == want["keys"]
    assert got["cats"] == want["cats"]
    assert got["n_ops"] >= 3 and want["n_ops"] >= 3
    assert ttable.splitlines()[0] == jtable.splitlines()[0]
    names = {line.split()[0] for line in ttable.splitlines()[1:]}
    assert {"event", "frame", "load"} <= names


def test_hook_records_only_while_active_and_reset_clears():
    x = mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu())
    mt.nd.relu(x)
    assert tprof._PROF.events == []
    tprof.start()
    mt.nd.relu(x)
    tprof.pause()
    mt.nd.relu(x)
    tprof.resume()
    mt.nd.relu(x)
    tprof.stop()
    ops = [e for e in tprof._PROF.events if e[1] == "operator"]
    assert len(ops) == 2
    assert "Name" in tprof.dumps(reset=True)
    assert tprof._PROF.events == []


def test_device_capture_keeps_its_rows(tmp_path):
    """The device capture (``profile_xla``/``profile_device``) runs
    ``torch.profiler``; on the CPU its rows hold no device time."""
    tprof.set_config(filename=str(tmp_path / "p.json"), profile_xla=True)
    assert tprof._PROF.profile_device
    tprof.start()
    mt.nd.relu(mt.nd.array(np.ones(4, np.float32), ctx=mt.cpu()))
    tprof.stop()
    assert (tmp_path / "p.json.device.json").exists()
    assert tprof.device_summary() == {}
    tprof.set_config(filename=str(tmp_path / "p.json"))


def test_log_and_engine_like_mxtpu(tmp_path):
    for mod in (tlog, jlog):
        lg = mod.get_logger("mxtpu_torch_test_%s" % mod.__name__,
                            filename=str(tmp_path / "log.txt"),
                            level=mod.INFO)
        assert mod.get_logger("mxtpu_torch_test_%s" % mod.__name__) is lg
        assert lg.level == logging.INFO and len(lg.handlers) == 1
        assert mod.getLogger is mod.get_logger
        assert mod.get_logger() is logging.getLogger()
        lg.info("hello")
    lines = (tmp_path / "log.txt").read_text().splitlines()
    assert [ln[0] for ln in lines] == ["I", "I"]
    assert [ln.split("] ")[1] for ln in lines] == ["hello", "hello"]
    for eng in (tengine, jengine):
        prev = eng.set_bulk_size(0)
        assert eng.set_bulk_size(15) == 0
        with eng.bulk(4):
            assert eng.set_bulk_size(4) == 4
        assert eng.set_bulk_size(prev) == 15
