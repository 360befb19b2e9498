"""The port's telemetry and fault points against the JAX package's: the same
call sequence through ``mxtpu.telemetry`` and ``mxtpu_torch.telemetry``
gives the same snapshot, report table and Prometheus text; spans, d2h
attribution, request traces, the retrace watchdog and ``inject`` behave
alike. The JAX package's levers are set with ``monkeypatch.setenv`` only,
the port's with its setters (``set_tracing``, ``set_retrace_budget``,
``resilience.set_faults``). Histograms fed by explicit ``observe`` calls
compare exactly; span durations are wall times, so only their counts and
keys compare."""
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
