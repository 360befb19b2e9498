"""The port's fleet observability plane (``mxtpu_torch.fleet_obs``)
against the JAX package's ``mxtpu.fleet_obs``, on the CPU, case by case
with the reference's ``tests/test_fleet_obs.py`` (its three
``telemetry_report`` cases drive the reference's tool and have no
counterpart):

* each host's blob: bounded, atomic, on a fake-clock cadence, riding the
  flush hook; a blob the port writes merged by the reference's
  observatory and the reference's by the port's;
* the observatory's merged view equal to the reference's over the same
  blobs and heartbeats; FLOP-weighted ``fleet.mfu``, the step quantiles,
  heartbeat ages, the host-labelled Prometheus text; a torn blob;
* the straggler and regression sentinels fed the same payload sequences
  in both packages: the same trips at the same steps, naming the same
  rank and dominant stage; one bounded profiler window a trip reason;
* ``step_barrier``'s stitched payloads, and ``step_traces``;
* the Trainer's stage breakdown; the JSONL sink's last window on a clean
  exit and under SIGTERM (child processes);
* ONE two-host run of the MLP worker with the plane on: both blobs on
  the board, merged, and the stitched payload behind every step barrier.

The reference's levers are environment variables (``monkeypatch``), the
port's arguments. All but the child processes run on fake clocks."""
import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from mxtpu import fleet as jfleet
from mxtpu import fleet_obs as jobs
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu_torch import fleet, fleet_obs
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.fleet import Fleet, FleetMembership, FleetSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_FLEET_DIR", "MXTPU_FLEET_OBS_S", "MXTPU_STRAGGLER_X",
                "MXTPU_PROFILE_ON_TRIP", "MXTPU_FLIGHT_DIR",
                "MXTPU_FLIGHT_MAX", "MXTPU_FAULT_INJECT", "MXTPU_TELEMETRY",
                "MXTPU_TELEMETRY_FLUSH_S", "MXTPU_FLEET_BRINGUP_TIMEOUT_S",
                "MXTPU_FLEET_HEARTBEAT_S",
                "MXTPU_FLEET_COLLECTIVE_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    for tel in (jtel, ttel):
        tel.reset()
    for res in (jres, tres):
        res.reset_faults()
    for mod in (jobs, fleet_obs):
        mod._PROFILE_DONE.clear()
    yield
    ttel.set_flight_dir(None)
    for tel in (jtel, ttel):
        tel.reset()
    for res in (jres, tres):
        res.reset_faults()
    for mod in (jobs, fleet_obs):
        mod._PROFILE_DONE.clear()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _counter(name, tel=ttel):
    v = tel.snapshot()["counters"].get(name, 0)
    return sum(v.values()) if isinstance(v, dict) else v


def _payloads(fast, slow=None, slow_rank=1, t0=100.0):
    """A 2-host barrier payload map: per-rank stage dicts."""
    out = {}
    for r in (0, 1):
        s = slow if (slow is not None and r == slow_rank) else fast
        out[r] = {"fp": [1.0], "trace": "aaaa-%d" % r,
                  "t": t0 + (s if r == slow_rank and slow else 0.0),
                  "stages": {"trainer.step.allreduce": s * 0.25,
                             "trainer.step.update": s * 0.25,
                             "data.wait": s * 0.5}}
    return out


def _flight(monkeypatch, path):
    os.makedirs(str(path), exist_ok=True)
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(path))
    ttel.set_flight_dir(str(path))


# --------------------------------------------------- per-host publication
def test_publish_obs_blob_bounded(tmp_path):
    ttel.inc("train.batches", 5)
    ttel.gauge("perf.mfu", 0.42)
    for _ in range(10):
        ttel.observe("trainer.step", 0.01)
    for k in range(100):
        with ttel.span("s%d" % k, new_trace=True):
            pass
    path = fleet_obs.publish_obs(str(tmp_path), 3, step=7, t=123.0)
    blob = json.load(open(path))
    assert os.path.basename(path) == "obs_3.json"
    assert blob["rank"] == 3 and blob["step"] == 7 and blob["t"] == 123.0
    assert blob["counters"]["train.batches"] == 5
    assert blob["gauges"]["perf.mfu"] == 0.42
    assert blob["histograms"]["trainer.step"]["count"] == 10
    assert 0 < len(blob["trace_tail"]) <= fleet_obs.TRACE_TAIL
    assert set(blob) == {"rank", "pid", "step", "t", "counters", "gauges",
                         "histograms", "retrace", "ledger", "trace_tail"}
    assert _counter("fleet.obs.publishes") == 1
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_publisher_cadence_fake_clock(tmp_path):
    clk = FakeClock()
    pub = fleet_obs.HostObsPublisher(str(tmp_path), 0, interval_s=5.0,
                                     clock=clk)
    assert pub.maybe_publish(step=0)
    assert pub.maybe_publish(step=1) is None
    clk.advance(5.1)
    assert pub.maybe_publish(step=2)
    assert json.load(open(pub.path))["step"] == 2
    assert _counter("fleet.obs.publishes") == 2
    assert pub.publish(step=3)
    assert json.load(open(pub.path))["step"] == 3


def test_publisher_disabled_without_interval(tmp_path):
    """Off by default, as the reference's MXTPU_FLEET_OBS_S."""
    for pub in (fleet_obs.HostObsPublisher(str(tmp_path), 0),
                fleet_obs.HostObsPublisher(str(tmp_path), 0, interval_s=0)):
        assert pub.maybe_publish(step=0) is None
    assert not os.path.exists(os.path.join(str(tmp_path), "obs_0.json"))


def test_publisher_rides_final_flush(tmp_path):
    pub = fleet_obs.HostObsPublisher(str(tmp_path), 1,
                                     interval_s=1e9).install()
    ttel.inc("late.counter", 9)
    ttel.flush()
    assert json.load(open(pub.path))["counters"]["late.counter"] == 9


# ------------------------------------------------------ coordinator merge
def _write_host_blob(board, rank, mfu, flops, step_p50, t=1000.0, step=5,
                     mod=fleet):
    os.makedirs(str(board), exist_ok=True)
    mod._atomic_write(
        os.path.join(str(board), "obs_%d.json" % rank),
        json.dumps({"rank": rank, "pid": 100 + rank, "step": step, "t": t,
                    "counters": {"train.batches": 10 * (rank + 1),
                                 "faults.injected": {"oom": rank + 1}},
                    "gauges": {"perf.mfu": mfu},
                    "histograms": {"trainer.step": {
                        "count": 5, "sum": step_p50 * 5,
                        "mean": step_p50, "min": step_p50,
                        "max": step_p50 * 2, "p50": step_p50,
                        "p99": step_p50 * 2}},
                    "ledger": {"executed_flops": flops},
                    "trace_tail": []}))


def _board(tmp_path, writer):
    mod = fleet if writer == "port" else jfleet
    _write_host_blob(tmp_path, 0, mfu=0.5, flops=100.0, step_p50=0.1,
                     mod=mod)
    _write_host_blob(tmp_path, 1, mfu=0.3, flops=300.0, step_p50=0.3,
                     mod=mod)
    mk = FleetMembership if writer == "port" else jfleet.FleetMembership
    mk(tmp_path, 0, 2, clock=lambda: 1008.0).write("up")
    mk(tmp_path, 1, 2, clock=lambda: 1004.0).write("up")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_observatory_merges_hosts_and_aggregates(tmp_path, writer):
    """The merged view over one board, written by either package, is the
    reference's, key for key."""
    _board(tmp_path, writer)
    clk = FakeClock(1010.0)
    m = fleet_obs.FleetObservatory(str(tmp_path), 2, clock=clk).merged()
    ref = jobs.FleetObservatory(str(tmp_path), 2, clock=clk).merged()
    for r in (0, 1):   # the heartbeat's pid is each writer's own
        for h in (m["hosts"][r], ref["hosts"][r]):
            assert h.pop("pid") == 100 + r
    assert m == ref
    assert sorted(m["hosts"]) == [0, 1]
    assert m["hosts"][1]["mfu"] == 0.3
    assert m["hosts"][0]["heartbeat_age_s"] == pytest.approx(2.0)
    assert m["hosts"][1]["heartbeat_age_s"] == pytest.approx(6.0)
    assert m["fleet"]["mfu"] == pytest.approx(0.35)
    assert m["fleet"]["step_s"]["p50"] == pytest.approx(0.2)
    assert m["fleet"]["hosts_up"] == 2
    assert m["fleet"]["executed_flops"] == pytest.approx(400.0)


def test_port_blob_merged_by_the_reference(tmp_path):
    """A blob the port publishes is one the reference's observatory
    reads."""
    ttel.gauge("perf.mfu", 0.25)
    ttel.observe("trainer.step", 0.2)
    fleet_obs.publish_obs(str(tmp_path), 0, step=3, t=1000.0)
    FleetMembership(tmp_path, 0, 1, clock=lambda: 999.0).write("up")
    ref = jobs.FleetObservatory(str(tmp_path), 1,
                                clock=FakeClock(1000.0)).merged()
    assert ref["hosts"][0]["mfu"] == 0.25 and ref["hosts"][0]["step"] == 3
    assert ref["hosts"][0]["step_s"]["count"] == 1
    assert ref["hosts"][0]["heartbeat_age_s"] == pytest.approx(1.0)


def test_observatory_refresh_lands_registry_gauges(tmp_path):
    _write_host_blob(tmp_path, 0, mfu=0.4, flops=100.0, step_p50=0.1)
    FleetMembership(tmp_path, 0, 1, clock=lambda: 999.0).write("up")
    obs = fleet_obs.FleetObservatory(str(tmp_path), 1,
                                     clock=FakeClock(1000.0))
    obs.refresh()
    g = ttel.snapshot()["gauges"]
    assert g["fleet.mfu"] == pytest.approx(0.4)
    assert g["fleet.step_s"]["p50"] == pytest.approx(0.1)
    assert g["fleet.heartbeat_age_s"]["host0"] == pytest.approx(1.0)
    assert g["fleet.hosts_up"] == 1


def test_observatory_prometheus_host_labels(tmp_path):
    _write_host_blob(tmp_path, 0, mfu=0.5, flops=100.0, step_p50=0.1)
    _write_host_blob(tmp_path, 1, mfu=0.3, flops=300.0, step_p50=0.3)
    obs = fleet_obs.FleetObservatory(str(tmp_path), 2,
                                     clock=FakeClock()).install()
    out = ttel.prometheus()
    assert 'mxtpu_train_batches{host="0"} 10' in out
    assert 'mxtpu_train_batches{host="1"} 20' in out
    assert 'mxtpu_faults_injected{host="1",tag="oom"} 2' in out
    assert 'mxtpu_trainer_step{host="0",quantile="50"} 0.1' in out
    assert "mxtpu_fleet_mfu 0.35" in out
    # the host-labelled lines are the reference's, line for line
    ref = jobs.FleetObservatory(str(tmp_path), 2, clock=FakeClock())
    assert obs.prometheus() == ref.prometheus()


def test_observatory_degrades_to_surviving_hosts(tmp_path):
    _write_host_blob(tmp_path, 0, mfu=0.5, flops=100.0, step_p50=0.1)
    with open(os.path.join(str(tmp_path), "obs_1.json"), "w") as f:
        f.write("{torn")
    m = fleet_obs.FleetObservatory(str(tmp_path), 2,
                                   clock=FakeClock()).merged()
    assert sorted(m["hosts"]) == [0]
    assert m["fleet"]["mfu"] == pytest.approx(0.5)


# ------------------------------------------------------- straggler matrix
def _both_sentinels(factor, streak=3):
    return (fleet_obs.StragglerSentinel(factor=factor, streak=streak),
            jobs.StragglerSentinel(factor=factor, streak=streak))


def _trips(sentinel, seq):
    return [(step, None if t is None else (t["rank"], t["dominant_stage"]))
            for step, t in ((s, sentinel.observe(s, p)) for s, p in seq)]


def test_straggler_uniform_fleet_no_trip(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path)
    seq = [(step, _payloads(0.1)) for step in range(8)]
    port, ref = _both_sentinels(1.5)
    assert _trips(port, seq) == _trips(ref, seq) == \
        [(s, None) for s in range(8)]
    assert _counter("fleet.straggler_trips") == 0
    assert not glob.glob(str(tmp_path / "flight_straggler_*"))


def test_straggler_slow_rank_named_with_dominant_stage(tmp_path,
                                                       monkeypatch):
    _flight(monkeypatch, tmp_path / "port")
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "jax"))
    seq = [(step, _payloads(0.1, slow=0.5)) for step in range(4)]
    port, ref = _both_sentinels(1.5)
    got = _trips(port, seq)
    assert got == _trips(ref, seq)
    assert got == [(0, None), (1, None), (2, (1, "data.wait")), (3, None)]
    trip = port.trips[0]
    assert trip["rank"] == 1 and trip["step"] == 2
    assert trip["ratio"] > 1.5
    assert _counter("fleet.straggler_trips") == 1
    assert ttel.tagged("fleet.straggler_trips") == {"host1": 1}
    arts = glob.glob(str(tmp_path / "port" / "flight_straggler_*"))
    assert len(arts) == 1
    extra = json.load(open(arts[0]))["extra"]
    assert extra["rank"] == 1
    assert extra["stages"]["data.wait"] == pytest.approx(0.25)
    skew = ttel.snapshot()["gauges"]["fleet.arrival_skew_s"]
    assert skew["host1"] > skew["host0"] == 0.0


def test_straggler_recovered_rank_counter_flat():
    seq = ([(s, _payloads(0.1, slow=0.5)) for s in range(2)]
           + [(s, _payloads(0.1)) for s in range(2, 8)]
           + [(s, _payloads(0.1, slow=0.5)) for s in range(8, 10)])
    port, ref = _both_sentinels(1.5, streak=2)
    got = _trips(port, seq)
    assert got == _trips(ref, seq)
    assert [s for s, t in got if t] == [1, 9]
    assert _counter("fleet.straggler_trips") == 2


def test_straggler_disabled_without_factor():
    for s in (fleet_obs.StragglerSentinel(), fleet_obs.StragglerSentinel(0)):
        for step in range(6):
            assert s.observe(step, _payloads(0.1, slow=9.0)) is None
    assert _counter("fleet.straggler_trips") == 0


def test_straggler_ignores_legacy_list_payloads():
    for s in _both_sentinels(1.5, streak=1):
        assert s.observe(0, {0: [1.0, 2.0], 1: [1.0, 2.0]}) is None


def test_regression_sentinel_trips_on_drift(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path)
    durs = [0.1] * 6 + [0.3] * 3 + [0.1] * 21 + [0.4] * 10
    port = fleet_obs.RegressionSentinel(factor=1.5, baseline_n=4,
                                        recent_n=2)
    ref = jobs.RegressionSentinel(factor=1.5, baseline_n=4, recent_n=2)
    trips = [[s for s, d in enumerate(durs) if r.observe(s, d)]
             for r in (port, ref)]
    assert trips[0] == trips[1] and len(trips[0]) == 2
    assert port.trips[0]["ratio"] > 1.5
    assert _counter("fleet.step_regressions") == 2
    assert len(glob.glob(str(tmp_path / "flight_step_regression_*"))) == 2


def test_profile_on_trip_one_capture_per_reason(tmp_path, monkeypatch):
    """One bounded torch.profiler window a trip reason, beside the flight
    records (the reference's MXTPU_PROFILE_ON_TRIP is an argument)."""
    from mxtpu_torch import profiler
    _flight(monkeypatch, tmp_path)
    monkeypatch.setattr(fleet_obs, "PROFILE_WINDOW_S", 0.05)
    s = fleet_obs.StragglerSentinel(factor=1.5, streak=1,
                                    profile_on_trip=True)
    s.observe(0, _payloads(0.1, slow=0.5))
    caps = glob.glob(str(tmp_path / "profile_straggler_*"))
    assert len(caps) == 1
    assert _counter("fleet.profile_captures") == 1
    s.observe(1, _payloads(0.1))
    s.observe(2, _payloads(0.1, slow=0.5))
    assert _counter("fleet.straggler_trips") == 2
    assert _counter("fleet.profile_captures") == 1
    assert profiler.is_active()   # closed by an observation past it
    time.sleep(0.1)
    s.observe(3, _payloads(0.1))
    assert not profiler.is_active()
    assert os.path.exists(os.path.join(caps[0], "profile.json"))
    assert not fleet_obs.close_profile(force=True)
    # off by default: no window
    fleet_obs._PROFILE_DONE.clear()
    fleet_obs.StragglerSentinel(factor=1.5, streak=1).observe(
        4, _payloads(0.1, slow=0.5))
    assert _counter("fleet.profile_captures") == 1


# ------------------------------------------------- step_barrier stitching
def _peer_barrier_file(board, name, rank, payload, mod=fleet):
    bdir = os.path.join(str(board), "barrier_%s" % name)
    os.makedirs(bdir, exist_ok=True)
    mod._atomic_write(os.path.join(bdir, "host_%d" % rank),
                      json.dumps({"rank": rank, "payload": payload}))


def _fleet(board, clk):
    m0 = FleetMembership(board, 0, 2, clock=clk)
    FleetMembership(board, 1, 2, clock=clk).write("up")
    return Fleet(0, 2, membership=m0, fleet_dir=str(board))


def test_step_barrier_obs_payload_round_trip(tmp_path):
    clk = FakeClock()
    board = tmp_path / "b"
    f = _fleet(board, clk)
    peer = {"fp": [1.5, 2.0], "trace": "beef-7",
            "stages": {"trainer.step.update": 0.2}, "t": 999.0}
    _peer_barrier_file(board, "step_3", 1, peer, jfleet)
    fps = f.step_barrier(3, fingerprint=[1.5, 2.0],
                         obs={"trace": "cafe-3",
                              "stages": {"trainer.step.update": 0.1}})
    assert fps[1] == peer
    assert fps[0]["fp"] == [1.5, 2.0]
    assert fps[0]["trace"] == "cafe-3"
    assert fps[0]["t"] == clk.t
    assert _counter("resilience.divergence_checks") == 1
    # the reference's step_traces reads the port's stitched payloads
    rows = jobs.step_traces(str(board))
    assert rows == fleet_obs.step_traces(str(board))
    assert rows[0]["last_rank"] == 0 and rows[0]["trace"] == "cafe-3"


def test_step_barrier_obs_divergence_still_trips(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path / "flight")
    clk = FakeClock()
    board = tmp_path / "b"
    f = _fleet(board, clk)
    _peer_barrier_file(board, "step_4", 1, {"fp": [1.5, 999.0],
                                            "stages": {}})
    with pytest.raises(tres.DivergenceError, match="step 4"):
        f.step_barrier(4, fingerprint=[1.5, 2.0], obs={"stages": {}})
    assert len(glob.glob(str(tmp_path / "flight" /
                             "flight_fleet_divergence_*"))) == 1


def test_step_barrier_obs_interops_with_legacy_list_peer(tmp_path):
    clk = FakeClock()
    board = tmp_path / "b"
    f = _fleet(board, clk)
    _peer_barrier_file(board, "step_5", 1, [1.5, 2.0])
    fps = f.step_barrier(5, fingerprint=[1.5, 2.0], obs={"stages": {}})
    assert fps[1] == [1.5, 2.0]
    assert fps[0]["fp"] == [1.5, 2.0]


def test_step_traces_names_last_rank_and_stage(tmp_path):
    for step, (t0, t1) in enumerate([(10.0, 10.3), (20.4, 20.0)]):
        _peer_barrier_file(tmp_path, "step_%d" % step, 0,
                           {"fp": None, "t": t0, "trace": "aa-%d" % step,
                            "stages": {"trainer.step.update": 0.01,
                                       "data.wait": 0.35 if step == 1
                                       else 0.0}})
        _peer_barrier_file(tmp_path, "step_%d" % step, 1,
                           {"fp": None, "t": t1, "trace": "bb-%d" % step,
                            "stages": {"trainer.step.update": 0.4
                                       if step == 1 else 0.01}})
    rows = fleet_obs.step_traces(str(tmp_path))
    assert rows == jobs.step_traces(str(tmp_path))
    assert [r["step"] for r in rows] == [0, 1]
    assert rows[0]["last_rank"] == 1
    assert rows[0]["skew_s"] == pytest.approx(0.3)
    assert rows[1]["last_rank"] == 0
    assert rows[1]["dominant_stage"] == "data.wait"
    assert rows[1]["trace"] == "aa-1"


# -------------------------------------------- trainer stage wiring + pins
def test_trainer_stage_capture_d2h_zero():
    """Three real steps: the stage breakdown and trace id land on the
    Trainer, and the step fetches nothing from the device."""
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.gluon.parameter import Parameter
    from mxtpu_torch.gluon.trainer import Trainer
    rng = np.random.RandomState(0)
    with mt.cpu():
        params = []
        for j in range(3):
            p = Parameter("sp%d" % j, shape=(5,), dtype="float32")
            p.initialize()
            params.append(p)
        trainer = Trainer(params, "sgd", {"learning_rate": 0.05,
                                          "momentum": 0.9}, kvstore=None)
        assert trainer.last_step_trace is None
        for _ in range(3):
            for p in params:
                p.grad()[:] = mt.nd.array(
                    rng.randn(*p.shape).astype(np.float32))
            trainer.step(1)
    stages = trainer.last_step_stages
    assert set(stages) == {"trainer.step.allreduce", "trainer.step.update"}
    assert all(v >= 0 for v in stages.values())
    assert trainer.last_step_trace is not None
    assert ttel.value("trainer.step.d2h") == 0


# ------------------------------------------------- sink final-flush fixes
_CLEAN_CHILD = """
import sys
sys.path.insert(0, %(repo)r)
from mxtpu_torch import telemetry
telemetry.set_jsonl_path(%(sink)r)
telemetry.set_flush_interval(3600)
telemetry.inc("child.counter", 7)
"""

_SIGTERM_CHILD = """
import os, sys, time
sys.path.insert(0, %(repo)r)
from mxtpu_torch import resilience, telemetry
telemetry.set_jsonl_path(%(sink)r)
telemetry.set_flush_interval(3600)
loop = resilience.ResilientLoop(None, None).install()
telemetry.inc("child.counter", 7)
print("READY", flush=True)
deadline = time.time() + 60
while not loop.preempted and time.time() < deadline:
    time.sleep(0.02)
time.sleep(1.0)
os._exit(0)
"""


def _counter_lines(sink, metric):
    if not os.path.exists(sink):
        return []
    out = []
    with open(sink) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "counter" and rec.get("metric") == metric:
                out.append(rec)
    return out


def test_sink_clean_exit_counters_only_flushes(tmp_path):
    sink = str(tmp_path / "clean.jsonl")
    proc = subprocess.run(
        [sys.executable, "-c", _CLEAN_CHILD % {"repo": REPO, "sink": sink}],
        timeout=120, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = _counter_lines(sink, "child.counter")
    assert lines and lines[-1]["value"] == 7


def test_sink_sigterm_flushes_final_window(tmp_path):
    sink = str(tmp_path / "killed.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD % {"repo": REPO,
                                                 "sink": sink}],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    lines = _counter_lines(sink, "child.counter")
    assert lines and lines[-1]["value"] == 7


# ------------------------------------------- 2-process board-merge run
@pytest.mark.multidevice
def test_fleet_obs_two_host_board_merge_acceptance(tmp_path):
    """Two gloo hosts of the MLP worker with the plane on: both publish
    blobs, every step barrier carries the stitched stage payload, and the
    port's and the reference's observatories merge the board alike."""
    steps = 2

    def command_for(rank, world, generation, boot):
        return [sys.executable, "-m", "mxtpu_torch.fleet_worker",
                *fleet.bootstrap_argv(boot), "--steps", str(steps),
                "--device", "cpu", "--backend", "gloo",
                "--collective-timeout", "30", "--obs-s", "0.05",
                "--straggler-x", "1.5"]

    sup = FleetSupervisor(
        command_for=command_for, num_hosts=2, fleet_dir=str(tmp_path / "b"),
        ckpt_dir=str(tmp_path / "ckpt"), timeout_s=240.0,
        env_for=lambda r, w, g: {"PYTHONPATH": REPO})
    results = sup.launch_round(2, 0)
    for rank in (0, 1):
        rc, tail = results[rank]
        assert rc == 0, tail[-2000:]
    board = str(tmp_path / "b" / "gen_0")
    blobs = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(board, "obs_*.json")))
    assert blobs == ["obs_0.json", "obs_1.json"]
    m = fleet_obs.FleetObservatory(board, 2).merged()
    assert sorted(m["hosts"]) == [0, 1]
    for rank in (0, 1):
        assert m["hosts"][rank]["step_s"]["count"] == steps
        assert m["hosts"][rank]["status"] == "left"
    ref = jobs.FleetObservatory(board, 2).merged()
    assert {r: h["step_s"] for r, h in ref["hosts"].items()} == \
        {r: h["step_s"] for r, h in m["hosts"].items()}
    rows = fleet_obs.step_traces(board)
    assert [r["step"] for r in rows] == list(range(steps))
    assert all(r["ranks"] == 2 and r["stages"] for r in rows)
    assert rows == jobs.step_traces(board)
