"""The port's telemetry and fault points against the JAX package's: the same
call sequence through ``mxtpu.telemetry`` and ``mxtpu_torch.telemetry``
gives the same snapshot, report table and Prometheus text; spans, d2h
attribution, request traces, the retrace watchdog and ``inject`` behave
alike. The JAX package's levers are set with ``monkeypatch.setenv`` only,
the port's with its setters (``set_tracing``, ``set_retrace_budget``,
``resilience.set_faults``). Histograms fed by explicit ``observe`` calls
compare exactly; span durations are wall times, so only their counts and
keys compare."""
import json
import threading

import pytest

from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.base import MXNetError as JMXNetError
import mxtpu_torch as mt
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel

LEVERS = ("MXTPU_TELEMETRY", "MXTPU_TRACE", "MXTPU_RETRACE_BUDGET",
          "MXTPU_FAULT_INJECT", "MXTPU_TELEMETRY_FLUSH_S")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in LEVERS:
        monkeypatch.delenv(var, raising=False)
    for tel in (jtel, ttel):
        tel.reset()
    jres.reset_faults()
    tres.reset_faults()
    yield
    for tel in (jtel, ttel):
        tel.reset()
    ttel.set_enabled(True)
    ttel.set_tracing(True)
    ttel.set_retrace_budget(64)
    jres.reset_faults()
    tres.reset_faults()


def _sequence(tel):
    """A serving-shaped call sequence of explicit values only."""
    tel.inc("serving.requests")
    tel.inc("serving.requests", 4)
    tel.inc("serving.shed", tag="queue_full")
    tel.inc("serving.shed", 2, tag="draining")
    tel.inc("mixed")
    tel.inc("mixed", tag="a")
    tel.gauge("serving.queue_depth", 7)
    tel.gauge("memory.bytes", 5, tag="cuda:0")
    tel.gauge("memory.bytes", 6, tag="cuda:1")
    for v in (0.25, 0.5, 0.75, 1.0, 0.125):
        tel.observe("serving.batch_fill", v)
    tel.observe("serving.latency_s", 0.003)
    tel.record_retrace("serving.predict", {"bucket": [1, 4]})
    tel.record_retrace("serving.predict", {"bucket": [2, 4]})
    tel.inc("gone", 3)
    tel.reset_metric("gone")


def _snap(tel):
    snap = tel.snapshot()
    snap.pop("ledger", None)
    return snap


def test_snapshot_report_and_prometheus_equal_mxtpu():
    _sequence(jtel)
    _sequence(ttel)
    assert _snap(ttel) == _snap(jtel)
    assert ttel.report() == jtel.report()
    assert ttel.prometheus() == jtel.prometheus()
    assert "mxtpu_serving_shed{tag=\"queue_full\"} 1" in ttel.prometheus()


def test_reads_equal_mxtpu():
    _sequence(jtel)
    _sequence(ttel)
    for name, tag in (("serving.requests", None), ("serving.shed", None),
                      ("serving.shed", "draining"), ("mixed", None),
                      ("mixed", "a"), ("never", None), ("gone", None)):
        assert ttel.value(name, tag) == jtel.value(name, tag)
    assert ttel.tagged("serving.shed") == jtel.tagged("serving.shed")
    assert ttel.gauge_value("memory.bytes", "cuda:1") == \
        jtel.gauge_value("memory.bytes", "cuda:1") == 6
    assert ttel.gauge_value("never") is jtel.gauge_value("never") is None
    assert ttel.retrace_stats("serving.predict") == \
        jtel.retrace_stats("serving.predict")
    assert ttel.retrace_stats("nowhere") is jtel.retrace_stats("nowhere")
    ttel.reset()
    jtel.reset()
    assert ttel.report() == jtel.report() == "(telemetry registry empty)"


def test_spans_and_thread_local_d2h_match_mxtpu():
    for tel in (jtel, ttel):
        with tel.span("serving.predict", d2h=True):
            pass
        with tel.span("serving.fetch", d2h=True):
            tel.record_d2h()
            tel.record_d2h(2)

        def other():
            tel.record_d2h(5)   # another thread: not this span's syncs

        with tel.span("quiet", d2h=True):
            t = threading.Thread(target=other)
            t.start()
            t.join(10)
    js, ts = _snap(jtel), _snap(ttel)
    assert ts["counters"] == js["counters"]
    assert ts["counters"]["serving.fetch.d2h"] == 3
    assert "quiet.d2h" not in ts["counters"]
    assert ttel.d2h_count() == jtel.d2h_count() == 8
    assert {k: v["count"] for k, v in ts["histograms"].items()} == \
        {k: v["count"] for k, v in js["histograms"].items()}


def test_ndarray_asnumpy_counts_one_d2h():
    a = mt.nd.array([1.0, 2.0], ctx=mt.cpu())
    with ttel.span("fetch", d2h=True):
        a.asnumpy()
    assert ttel.value("fetch.d2h") == 1 and ttel.d2h_count() == 1


def test_span_lever_off_matches_mxtpu(monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY", "0")
    ttel.set_enabled(False)
    for tel in (jtel, ttel):
        with tel.span("off"):
            pass
        tel.inc("still.counted")
        assert tel.new_trace() is None
    assert _snap(ttel) == _snap(jtel)
    assert "off" not in _snap(ttel)["histograms"]


def _traced(tel):
    """A request trace handed to a worker thread, as the batcher does:
    returns (breakdown, [(kind, name, parent is root)])."""
    root = tel.new_trace()
    with tel.trace_handoff(root), tel.span("serving.submit"):
        pass
    tel.add_stage(root, "serving.submit", 0.001)
    other = tel.new_trace()
    box = {}

    def worker():
        assert tel.current_trace() is None
        tel.add_stage(root, "serving.queue_wait", 0.004, event=True)
        with tel.trace_handoff(root):
            tel.link(other, "serving.cohort")
            with tel.span("serving.predict"):
                tel.trace_mark(tel.current_trace(), "serving.redispatch")
        tel.add_stage(root, "serving.predict", 0.002)
        tel.add_stage(root, "serving.predict", 0.003)
        box["current"] = tel.current_trace()

    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    assert box["current"] is None and tel.current_trace() is None
    events = [(e["kind"], e["name"], e["parent"] == 0)
              for e in tel.trace_events(root.trace_id)]
    return tel.trace_breakdown(root), events


def test_request_traces_match_mxtpu():
    jb, je = _traced(jtel)
    tb, te = _traced(ttel)
    assert tb == jb == pytest.approx({"serving.submit": 0.001,
                                      "serving.queue_wait": 0.004,
                                      "serving.predict": 0.005})
    assert te == je
    assert [k for k, _, _ in te] == ["span", "span", "link", "mark", "span"]
    assert ttel.trace_breakdown(None) == jtel.trace_breakdown(None) == {}


def test_tracing_lever_off_matches_mxtpu(monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE", "0")
    ttel.set_tracing(False)
    for tel in (jtel, ttel):
        assert tel.new_trace() is None
        with tel.span("x", new_trace=True) as sp:
            assert sp.ctx is None
        tel.add_stage(None, "y", 1.0)
        tel.trace_mark(None, "z")
    assert ttel.trace_events() == jtel.trace_events() == []


def test_retrace_budget_trips_like_mxtpu(monkeypatch):
    monkeypatch.setenv("MXTPU_RETRACE_BUDGET", "2")
    ttel.set_retrace_budget(2)
    for tel in (jtel, ttel):
        for i in range(5):
            tel.record_retrace("site", {"i": i})
    assert ttel.retrace_stats() == jtel.retrace_stats() == {
        "site": {"compiles": 5, "trips": 3, "last": {"i": 4}}}
    assert ttel.value("retrace.watchdog_trips") == \
        jtel.value("retrace.watchdog_trips") == 3


@pytest.mark.parametrize("spec,calls", [
    ("serve_overload@1", [("serve_overload", None)] * 4),
    ("replica_fail@0,2;replica_wedge@1",
     [("replica_fail", 0), ("replica_wedge", 1), ("replica_fail", 0),
      ("replica_fail", 2), ("replica_wedge", 1), ("replica_fail", 1)]),
    ("serve_timeout@3; serve_timeout@5",
     [("serve_timeout", i) for i in range(7)]),
])
def test_inject_fires_like_mxtpu(monkeypatch, spec, calls):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
    tres.set_faults(spec)
    fired_j = [jres.inject(k, i) for k, i in calls]
    fired_t = [tres.inject(k, i) for k, i in calls]
    assert fired_t == fired_j and any(fired_t)
    assert tres.FAULT_STATS["fired"] == jres.FAULT_STATS["fired"]
    assert ttel.tagged("faults.injected") == jtel.tagged("faults.injected")


def test_fault_spec_errors_and_oom_match_mxtpu(monkeypatch):
    for bad in ("serve_overload", "oom@x"):
        monkeypatch.setenv("MXTPU_FAULT_INJECT", bad)
        jres.reset_faults()
        with pytest.raises(JMXNetError):
            jres.inject("oom")
        with pytest.raises(mt.MXNetError):
            tres.set_faults(bad)
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "oom@1")
    jres.reset_faults()
    tres.set_faults("oom@1")
    for res in (jres, tres):
        res.maybe_oom()          # occurrence 0 passes
        with pytest.raises(res.ResourceExhausted, match="RESOURCE_EXHAUSTED"):
            res.maybe_oom()
        res.maybe_oom()          # consumed: fires once
    tres.reset_faults()
    assert not tres.inject("oom", 1) and tres.FAULT_STATS["fired"] == []


# ------------------------------------------- the rest of telemetry (A9)
def _flows(tel):
    """A loader's hand-over linked into the next step's trace, a nested
    span, a link from a root: the events and flows both packages record."""
    with tel.span("data.h2d", new_trace=True):
        tel.pend_link("data.h2d", tel.current_trace())
    with tel.span("trainer.step", new_trace=True):
        linked = tel.link_pending()
        with tel.span("trainer.step.update"):
            pass
    assert tel.link_pending() == 0   # drained
    root = tel.new_trace()
    with tel.trace_handoff(root):
        with tel.span("serving.predict"):
            tel.link(root, "cohort")
    evs = tel.trace_events()
    kinds = [(e["kind"], e["name"]) for e in evs]
    flows = sorted((f["ph"], f["cat"], f["name"]) for f in tel.trace_flows())
    spans = sorted(e[0] for e in tel.events())
    return linked, kinds, flows, spans


def test_pend_link_trace_flows_and_events_like_mxtpu():
    assert _flows(ttel) == _flows(jtel)
    linked, kinds, flows, spans = _flows(ttel)
    assert linked == 1 and ("link", "data.h2d") in kinds
    assert ("s", "trace.link", "data.h2d") in flows
    assert spans == sorted(["data.h2d", "trainer.step",
                            "trainer.step.update", "serving.predict"] * 2)
    ttel.reset()
    assert ttel.events() == [] and ttel.trace_flows() == []


def test_flight_record_like_mxtpu(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("MXTPU_FLIGHT_MAX", "2")
    ttel.set_flight_dir(str(tmp_path / "port"))
    ttel.set_flight_max(2)
    try:
        assert ttel.flight_dir() == str(tmp_path / "port")
        out = {}
        for name, tel in (("jax", jtel), ("port", ttel)):
            tel.inc("serving.requests", 3)
            paths = [tel.flight_record("breaker_open", trace_ids=["t1"],
                                       extra={"replica": 1})
                     for _ in range(3)]
            assert paths[2] is None   # the cap
            rec = json.loads(open(paths[0]).read())
            out[name] = (sorted(rec), rec["reason"], rec["trace_ids"],
                         rec["extra"], rec["registry"]["counters"],
                         bool(rec["threads"]), [p is None for p in paths])
        assert out["port"] == out["jax"]
        assert ttel.tagged("flight.dumps") == {"breaker_open": 2}
    finally:
        ttel.set_flight_dir(None)
        ttel.set_flight_max(16)
    assert ttel.flight_record("x") is None   # no directory: no file
    snap = ttel.flight_snapshot("x", extra={"k": 1})
    assert snap["reason"] == "x" and snap["extra"] == {"k": 1}


def test_jsonl_sink_flushes_off_the_step_path_like_mxtpu(tmp_path,
                                                         monkeypatch):
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY", str(jpath))
    ttel.set_jsonl_path(str(tpath))
    hooks = []
    ttel.on_flush(lambda: hooks.append(threading.current_thread().name))
    try:
        for tel in (jtel, ttel):
            with tel.span("trainer.step", new_trace=True):
                pass
            tel.inc("steps", 2)
            tel.gauge("perf.mfu", 0.25)
        assert not tpath.exists()   # the step path only queues
        jtel.flush()
        ttel.flush()
        recs = {}
        for name, path in (("jax", jpath), ("port", tpath)):
            lines = [json.loads(x) for x in open(path)]
            recs[name] = sorted((r["kind"], r["metric"], r.get("value")
                                 if r["kind"] != "obs" else None,
                                 "trace" in r) for r in lines
                                if r["kind"] != "ledger")
        assert recs["port"] == recs["jax"]
        assert hooks == ["MainThread"]
        # the flush thread: queued lines reach the file off this thread
        ttel.set_flush_interval(0.01)
        with ttel.span("later"):
            pass
        import time
        deadline = time.time() + 5
        while "mxtpu-torch-telemetry" not in hooks and \
                time.time() < deadline:
            time.sleep(0.01)
        assert "mxtpu-torch-telemetry" in hooks
        assert any('"later"' in x for x in open(tpath))
    finally:
        ttel.set_flush_interval(0)
        ttel.set_jsonl_path(None)


def test_prometheus_extras_like_mxtpu():
    def extra():
        return "# TYPE fleet_up gauge\nfleet_up 1\n"

    def broken():
        raise RuntimeError("down")
    for tel in (jtel, ttel):
        tel.inc("a")
        assert tel.register_prometheus_extra(extra) is extra
        tel.register_prometheus_extra(extra)
        tel.register_prometheus_extra(broken)
    assert ttel.prometheus() == jtel.prometheus()
    assert ttel.prometheus().count("fleet_up 1") == 1
    ttel.reset()
    assert "fleet_up" not in ttel.prometheus()


def test_flash_dispatch_stats_count_the_plain_version():
    import torch
    from mxtpu_torch.ops.pallas import flash_attention as tfa
    tfa.reset_dispatch_stats()
    q = torch.randn(1, 2, 8, 4)
    tfa.flash_attention(q, q, q)
    assert dict(tfa.DISPATCH_STATS.items()) == {
        "pallas": 0, "xla": 1, "fallback_reasons": {}}
    assert tfa.DISPATCH_STATS.keys() == ["pallas", "xla", "fallback_reasons"]


def test_prefetched_batch_links_into_the_next_trainer_step():
    import numpy as np
    x = np.ones((2, 3), np.float32)
    pf = mt.io.DevicePrefetcher(iter([(x, x)]), sharding=mt.cpu())
    bx, _ = next(iter(pf))
    pf.close()
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    with mt.autograd.record():
        loss = net(bx).sum()
    loss.backward()
    tr.step(2)
    links = sorted(e["name"] for e in ttel.trace_events(tr.last_step_trace)
                   if e["kind"] == "link")
    assert links == ["data.h2d", "data.wait"]
