"""The port's elastic fleet (``mxtpu_torch.fleet``, ``fleet_worker``)
against the JAX package's ``mxtpu.fleet``, on the CPU, case by case with
the reference's ``tests/test_fleet.py``:

* the membership board: the staleness matrix, read by both packages from
  the same files; a board written by either package read by the other
  (heartbeats and barrier payloads); the dead coordinator's loud check;
* the board barrier's payloads, deadline and early failure on a stale
  peer; ``_run_with_deadline``; ``init``'s deadline and connect retries
  with injected clocks and sleepers, and its join of the process group
  on the CPU (the reference's CPU tier stays board-only: a deliberate
  difference); exits 41 and 43;
* the collective watchdog's trip, poison, off and monitor; ``step_barrier``
  green, divergent and with a dead peer; a collective that raised on a
  dead peer (``Fleet.collective_failed``); the replicated fingerprint;
* the supervisor's matrix with stand-in launches (both packages' histories
  equal), ``launch_round`` with real children, and the bootstrap passed
  as arguments (the reference exports it to the environment: a
  deliberate difference);
* ONE real acceptance run: two gloo processes of ``python -m
  mxtpu_torch.fleet_worker --model mlp``, ``host_loss@3`` on rank 1: the
  survivor exits 42 with the artifact naming rank 1, one host restores,
  the fleet grows back to two with disk hits, and all six losses hold to
  the reference MLP's whole-batch trajectory, computed here, within 1e-5
  relative.

The JAX side's levers are environment variables (``monkeypatch``), the
port's are arguments and setters. Everything but the child processes is
sleep-free on fake clocks."""
import glob
import json
import os
import random
import sys
import threading
import time

import numpy as np
import pytest

from mxtpu import fleet as jfleet
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu_torch import distributed as tdist
from mxtpu_torch import fleet
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.fleet import (EXIT_FLEET_WEDGE, EXIT_HOST_LOSS,
                               EXIT_REJOIN_STALL, Fleet, FleetBringupError,
                               FleetCollectiveWatchdog, FleetMembership,
                               FleetSupervisor, FleetWedgeError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVERS = ("MXTPU_FLEET_DIR", "MXTPU_FLEET_CONNECT_RETRIES",
          "MXTPU_FLEET_CONNECT_BACKOFF_S", "MXTPU_FLEET_BRINGUP_TIMEOUT_S",
          "MXTPU_FLEET_HEARTBEAT_S", "MXTPU_FLEET_HEARTBEAT_MISS",
          "MXTPU_FLEET_COLLECTIVE_TIMEOUT_S", "MXTPU_FLEET_CHILD_TIMEOUT_S",
          "MXTPU_FAULT_INJECT", "MXTPU_FLIGHT_DIR", "MXTPU_FLIGHT_MAX",
          "MXTPU_COORDINATOR", "MXTPU_NUM_PROCESSES", "MXTPU_PROCESS_ID",
          "MXTPU_SUPERVISOR_RESTARTS", "MXTPU_SUPERVISOR_BACKOFF_S")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in LEVERS:
        monkeypatch.delenv(var, raising=False)
    for tel in (jtel, ttel):
        tel.reset()
    for res in (jres, tres):
        res.reset_faults()
    yield
    ttel.set_flight_dir(None)
    for tel in (jtel, ttel):
        tel.reset()
    for res in (jres, tres):
        res.reset_faults()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt

    def sleeper(self, s):
        # a fake sleep and a real yield, so a polled worker thread runs
        self.t += s
        time.sleep(0.0005)


class _Exit(Exception):
    def __init__(self, code):
        self.code = code


def _counter(name):
    v = ttel.snapshot()["counters"].get(name, 0)
    return sum(v.values()) if isinstance(v, dict) else v


def _artifacts(root, reason):
    return sorted(glob.glob(os.path.join(str(root), "flight_%s_*" % reason)))


def _flight(monkeypatch, path):
    """Both packages' flight directory."""
    os.makedirs(str(path), exist_ok=True)
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(path))
    ttel.set_flight_dir(str(path))


# ------------------------------------------------------- membership board
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_membership_staleness_matrix(tmp_path, writer):
    """Never-seen and stale hosts are dead, fresh and cleanly-left ones
    are not; a board written by either package reads the same in both."""
    clk = FakeClock()
    mk = FleetMembership if writer == "port" else jfleet.FleetMembership
    m0, m1, m2 = (mk(tmp_path, r, 4, clock=clk) for r in range(3))
    for m in (m0, m1, m2):
        m.write("up")
    readers = [FleetMembership(tmp_path, 0, 4, clock=clk),
               jfleet.FleetMembership(tmp_path, 0, 4, clock=clk)]
    assert [r.dead_hosts() for r in readers] == [[3], [3]]
    clk.advance(4.0)
    m2.write("left")
    clk.advance(100.0)
    m0.write("up")
    for r in readers:
        assert r.dead_hosts() == [1, 3]
        assert r.coordinator_alive()
        desc = r.describe()
        assert "host 3: NEVER SEEN" in desc and "host 2: left" in desc
        view = r.view()
        assert sorted(view) == [0, 1, 2] and view[1]["status"] == "up"
    assert readers[0].describe() == readers[1].describe()
    assert set(json.load(open(tmp_path / "host_0.json"))) == \
        {"rank", "status", "t", "pid", "step"}


def test_status_writes_from_two_threads_never_collide(tmp_path):
    """A host's heartbeat thread and its training thread rewrite one
    status file: their temporary files must differ (the reference names
    them by the pid alone, and a host died on the card of the
    ``FileNotFoundError`` the race raises)."""
    m = FleetMembership(tmp_path, 0, 1)
    errors = []

    def hammer():
        try:
            for _ in range(300):
                m.write("up")
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    ts = [threading.Thread(target=hammer) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert errors == [] and m.view()[0]["status"] == "up"
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_membership_bound_is_an_argument(tmp_path):
    """The reference's MXTPU_FLEET_HEARTBEAT_S/_MISS are arguments here."""
    clk = FakeClock()
    FleetMembership(tmp_path, 1, 2, clock=clk).write("up")
    m0 = FleetMembership(tmp_path, 0, 2, clock=clk, heartbeat_s=0.5,
                         heartbeat_miss=2)
    m0.write("up")
    clk.advance(0.9)
    assert m0.dead_hosts() == []
    clk.advance(0.2)
    m0.write("up")
    assert m0.dead_hosts() == [1]
    assert FleetMembership(tmp_path, 0, 2, clock=clk).dead_hosts() == []


def test_dead_coordinator_check_raises_loud(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path / "flight")
    clk = FakeClock()
    board = tmp_path / "board"
    m0 = FleetMembership(board, 0, 2, clock=clk)
    m1 = FleetMembership(board, 1, 2, clock=clk)
    m0.write("up")
    assert m1.check(step=3) == []
    clk.advance(50.0)
    with pytest.raises(FleetWedgeError, match="coordinator"):
        m1.check(step=4)
    arts = _artifacts(tmp_path / "flight", "coordinator_loss")
    assert len(arts) == 1
    snap = json.load(open(arts[0]))
    assert snap["extra"]["rank"] == 1 and 0 in snap["extra"]["dead"]
    clk.advance(50.0)
    assert m0.check(step=4) == [1]   # host 0 reports, never raises
    # the reference diagnoses the same board the same way
    clk.advance(50.0)
    jm1 = jfleet.FleetMembership(board, 1, 2, clock=clk)
    with pytest.raises(jfleet.FleetWedgeError, match="coordinator"):
        jm1.check(step=5)


def test_coordinator_loss_fault_injection(tmp_path, monkeypatch):
    tres.set_faults("coordinator_loss@0")
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "coordinator_loss@0")
    clk = FakeClock()
    for mod in (fleet, jfleet):
        board = tmp_path / mod.__name__
        mod.FleetMembership(board, 0, 2, clock=clk).write("up")
        with pytest.raises(mod.FleetWedgeError, match="coordinator"):
            mod.FleetMembership(board, 1, 2, clock=clk).check(step=0)


@pytest.mark.parametrize("peer", ["port", "jax"])
def test_board_barrier_payload_exchange(tmp_path, peer):
    """A peer's barrier file written by either package is read here, and
    this host's by the reference."""
    clk = FakeClock()
    m0 = FleetMembership(tmp_path, 0, 2, clock=clk)
    FleetMembership(tmp_path, 1, 2, clock=clk).write("up")
    os.makedirs(os.path.join(str(tmp_path), "barrier_x"), exist_ok=True)
    write = fleet._atomic_write if peer == "port" else jfleet._atomic_write
    write(os.path.join(str(tmp_path), "barrier_x", "host_1"),
          json.dumps({"rank": 1, "payload": [1.0, 2.0]}))
    got = m0.barrier("x", 10.0, payload=[3.0], clock=clk,
                     sleeper=clk.advance)
    assert got == {0: [3.0], 1: [1.0, 2.0]}
    jm1 = jfleet.FleetMembership(tmp_path, 1, 2, clock=clk)
    assert jm1.barrier("x", 10.0, payload=[1.0, 2.0], clock=clk,
                       sleeper=clk.advance) == got


def test_board_barrier_deadline_names_missing_hosts(tmp_path):
    clk = FakeClock()
    m0 = FleetMembership(tmp_path, 0, 3, clock=clk)
    m0.write("up")
    with pytest.raises(FleetWedgeError, match=r"missing \[1, 2\]"):
        m0.barrier("b", 10.0, clock=clk, sleeper=clk.advance,
                   fail_on_dead=False)
    assert clk.t > 10.0


def test_board_barrier_stale_peer_fails_early(tmp_path):
    clk = FakeClock()
    m0 = FleetMembership(tmp_path, 0, 2, clock=clk)
    FleetMembership(tmp_path, 1, 2, clock=clk).write("up")
    clk.advance(50.0)
    m0.write("up")
    with pytest.raises(FleetWedgeError, match="died while the fleet"):
        m0.barrier("b", 1000.0, clock=clk, sleeper=clk.advance)
    assert clk.t < 60.0


# ---------------------------------------------------- deadline bring-up
def test_run_with_deadline_paths():
    clk = FakeClock()
    assert fleet._run_with_deadline(lambda: 42, 1000.0, AssertionError,
                                    clock=clk, sleeper=clk.sleeper) == 42

    def boom():
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        fleet._run_with_deadline(boom, 1000.0, AssertionError,
                                 clock=clk, sleeper=clk.sleeper)
    gate = threading.Event()
    t0 = clk.t
    try:
        with pytest.raises(FleetBringupError, match="stuck"):
            fleet._run_with_deadline(
                gate.wait, 5.0, lambda: FleetBringupError("stuck"),
                clock=clk, sleeper=clk.sleeper)
    finally:
        gate.set()
    assert clk.t - t0 > 5.0


def test_bringup_deadline_fails_loud_with_board(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path / "flight")
    gate = threading.Event()
    monkeypatch.setattr(tdist, "init", lambda **kw: (gate.wait(), (0, 2))[1])
    clk = FakeClock()
    board = tmp_path / "board"
    try:
        with pytest.raises(FleetBringupError, match="never joined"):
            fleet.init(fleet_dir=str(board), num_processes=2, process_id=0,
                       timeout_s=5.0, clock=clk, sleeper=clk.sleeper,
                       heartbeat=False, backend="gloo")
    finally:
        gate.set()
    err = _artifacts(tmp_path / "flight", "fleet_bringup_timeout")
    assert len(err) == 1
    snap = json.load(open(err[0]))
    assert snap["extra"]["rank"] == 0 and snap["extra"]["world"] == 2
    view = jfleet.FleetMembership(board, 0, 2, clock=clk).view()
    assert view[0]["status"] == "connecting" and 1 not in view


def test_bringup_connect_retries_counted(tmp_path, monkeypatch):
    calls = []

    def flaky_init(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise RuntimeError("coordinator not up yet")
        return (0, 1)
    monkeypatch.setattr(tdist, "init", flaky_init)
    monkeypatch.setattr(tdist, "adopt_card", lambda ids=None: None)
    clk = FakeClock()
    f = fleet.init(fleet_dir=str(tmp_path / "b"), num_processes=1,
                   process_id=0, timeout_s=300.0, clock=clk,
                   sleeper=clk.sleeper, rng=random.Random(0),
                   heartbeat=False, backend="gloo", connect_retries=4,
                   collective_timeout_s=30.0)
    assert (f.rank, f.num_hosts) == (0, 1) and len(calls) == 3
    assert _counter("retry.fleet_connect") == 2
    assert f.membership.view()[0]["status"] == "up"
    # the fleet's collective bound is the process group's timeout
    assert calls[-1]["timeout"] == 30.0 and calls[-1]["backend"] == "gloo"
    assert f.collective_timeout_s == 30.0
    # a spent budget fails the bring-up with the join's own error
    calls.clear()
    monkeypatch.setattr(tdist, "init", lambda **kw: (_ for _ in ()).throw(
        RuntimeError("refused")))
    with pytest.raises(RuntimeError, match="refused"):
        fleet.init(fleet_dir=str(tmp_path / "c"), num_processes=1,
                   process_id=0, clock=clk, sleeper=clk.sleeper,
                   rng=random.Random(0), heartbeat=False, backend="gloo",
                   connect_retries=1)
    assert _counter("retry.fleet_connect") == 3


def test_bringup_joins_the_process_group_on_the_cpu(tmp_path, monkeypatch):
    """A deliberate difference (ROADMAP §C): the reference's CPU tier is
    board-only (XLA:CPU cannot span processes); a port host joins the
    process group there too (gloo), so its mesh spans the fleet. Two hosts
    in threads, the join stood in for: both join, then meet on the
    board; their data shards are a disjoint union; a clean leave reads
    ``left`` on the peer's board."""
    joined = []

    def join(**kw):
        joined.append(kw)
        return kw["process_id"], kw["num_processes"]
    monkeypatch.setattr(tdist, "init", join)
    monkeypatch.setattr(tdist, "adopt_card", lambda ids=None: None)
    monkeypatch.setattr(tdist, "shutdown", lambda timeout_s=None: None)
    board = str(tmp_path / "b")
    out = {}

    def bring(r):
        out[r] = fleet.init(fleet_dir=board, coordinator_address="h:1",
                            num_processes=2, process_id=r, timeout_s=60.0,
                            heartbeat=False, backend="gloo")
    ts = [threading.Thread(target=bring, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
    assert sorted(out) == [0, 1]
    assert sorted(kw["process_id"] for kw in joined) == [0, 1]
    assert all(kw["backend"] == "gloo" and kw["coordinator_address"] == "h:1"
               for kw in joined)
    f0, f1 = out[0], out[1]
    assert (f0.rank, f0.num_hosts) == (0, 2)
    keys = list(range(10))
    s0 = f0.data_shard(keys, shuffle=False)
    s1 = f1.data_shard(keys, shuffle=False)
    assert sorted(s0 + s1) == keys and not set(s0) & set(s1)
    f1.leave()
    assert f0.membership.view()[1]["status"] == "left"
    f0.leave()


def test_entry_points_default_to_nccl_and_raise_without_a_card(
        tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="NCCL needs a CUDA device"):
        fleet.init(fleet_dir=str(tmp_path), coordinator_address="h:1",
                   num_processes=1, process_id=0, timeout_s=10.0,
                   heartbeat=False, connect_retries=0)


def test_rejoin_stall_fault_exits_dedicated_code(tmp_path, monkeypatch):
    tres.set_faults("rejoin_stall@1")

    def fake_exit(code):
        raise _Exit(code)
    monkeypatch.setattr(os, "_exit", fake_exit)
    with pytest.raises(_Exit) as ei:
        fleet.init(fleet_dir=str(tmp_path), num_processes=2, process_id=1,
                   timeout_s=1.0, _stall=lambda: None, heartbeat=False)
    assert ei.value.code == EXIT_REJOIN_STALL
    # the stalled host's status, read by the reference
    assert jfleet.FleetMembership(tmp_path, 1, 2).view()[1]["status"] == \
        "stalled"
    # its peer's bring-up deadline names it
    gate = threading.Event()
    monkeypatch.setattr(tdist, "init", lambda **kw: (gate.wait(), (0, 2))[1])
    clk = FakeClock()
    try:
        with pytest.raises(FleetBringupError, match="host 1: stalled"):
            fleet.init(fleet_dir=str(tmp_path), num_processes=2,
                       process_id=0, timeout_s=5.0, clock=clk,
                       sleeper=clk.sleeper, heartbeat=False)
    finally:
        gate.set()


def test_maybe_host_loss_exits_41(monkeypatch):
    tres.set_faults("host_loss@2")

    def fake_exit(code):
        raise _Exit(code)
    monkeypatch.setattr(os, "_exit", fake_exit)
    fleet.maybe_host_loss(0)
    fleet.maybe_host_loss(1)
    with pytest.raises(_Exit) as ei:
        fleet.maybe_host_loss(2)
    assert ei.value.code == EXIT_HOST_LOSS == jfleet.EXIT_HOST_LOSS
    assert (EXIT_FLEET_WEDGE, EXIT_REJOIN_STALL) == \
        (jfleet.EXIT_FLEET_WEDGE, jfleet.EXIT_REJOIN_STALL)


# ------------------------------------------------- collective watchdog
def test_fleet_watchdog_trip_diagnoses_and_poisons(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path / "flight")
    clk = FakeClock()
    m0 = FleetMembership(tmp_path / "b", 0, 2, clock=clk)
    FleetMembership(tmp_path / "b", 1, 2, clock=clk).write("up")
    exits = []
    wd = FleetCollectiveWatchdog(membership=m0, timeout_s=10.0, clock=clk,
                                 exit_on_trip=True, exit_fn=exits.append)
    e = wd.arm(7, what="step barrier")
    clk.advance(5.0)
    wd.disarm(e)
    wd.arm(8, what="step barrier")
    clk.advance(60.0)
    m0.write("up")
    with pytest.raises(FleetWedgeError, match="step 8 wedged"):
        wd.poll()
    assert exits == [EXIT_FLEET_WEDGE]
    assert _counter("fleet.wedges") == 1
    arts = _artifacts(tmp_path / "flight", "fleet_collective_wedge")
    assert len(arts) == 1
    snap = json.load(open(arts[0]))
    assert snap["extra"]["step"] == 8
    assert snap["extra"]["diagnosis"]["dead"] == [1]
    with pytest.raises(FleetWedgeError):
        wd.arm(9)


def test_fleet_watchdog_disabled_at_zero_timeout():
    wd = FleetCollectiveWatchdog(timeout_s=0)
    assert FleetCollectiveWatchdog().timeout_s == 0.0   # off by default
    assert wd.arm(0) is None
    wd.disarm(None)
    wd.poll()
    assert wd.start_monitor() is wd
    assert wd._monitor is None


def test_fleet_watchdog_monitor_lifecycle():
    wd = FleetCollectiveWatchdog(timeout_s=100.0)
    assert wd.start_monitor(0.01) is wd
    assert wd.start_monitor(0.01) is wd
    assert wd._monitor is not None and wd._monitor.is_alive()
    wd.stop_monitor()
    assert wd._monitor is None


# ----------------------------------------------------------- step barrier
def _peer_barrier_file(board, name, rank, payload, mod=fleet):
    bdir = os.path.join(str(board), "barrier_%s" % name)
    os.makedirs(bdir, exist_ok=True)
    mod._atomic_write(os.path.join(bdir, "host_%d" % rank),
                      json.dumps({"rank": rank, "payload": payload}))


def test_step_barrier_fingerprint_green_and_divergent(tmp_path,
                                                      monkeypatch):
    """The same fingerprint payloads give the same verdicts in both
    packages; the planted fault (a perturbed fingerprint on one host)
    trips ``fleet_divergence``."""
    _flight(monkeypatch, tmp_path / "flight")
    clk = FakeClock()
    verdicts = {}
    for mod, res in ((fleet, tres), (jfleet, jres)):
        board = tmp_path / mod.__name__
        if mod is jfleet:   # its artifacts apart from the port's
            monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(board))
        m0 = mod.FleetMembership(board, 0, 2, clock=clk)
        mod.FleetMembership(board, 1, 2, clock=clk).write("up")
        f = mod.Fleet(0, 2, membership=m0, fleet_dir=str(board))
        _peer_barrier_file(board, "step_3", 1, [1.5, 2.0], mod)
        green = f.step_barrier(3, fingerprint=[1.5, 2.0])
        _peer_barrier_file(board, "step_4", 1, [1.5, 999.0], mod)
        with pytest.raises(res.DivergenceError, match="step 4"):
            f.step_barrier(4, fingerprint=[1.5, 2.0])
        verdicts[mod.__name__] = green
    assert verdicts["mxtpu_torch.fleet"] == verdicts["mxtpu.fleet"] == \
        {0: [1.5, 2.0], 1: [1.5, 2.0]}
    assert _counter("resilience.divergence_checks") == 2 == \
        jtel.value("resilience.divergence_checks")
    arts = _artifacts(tmp_path / "flight", "fleet_divergence")
    assert len(arts) == 1
    snap = json.load(open(arts[0]))
    assert snap["extra"]["fingerprints"]["1"] == [1.5, 999.0]


def test_step_barrier_dead_peer_wedges_loud(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path / "flight")
    clk = FakeClock()
    board = tmp_path / "b"
    m0 = FleetMembership(board, 0, 2, clock=clk)
    FleetMembership(board, 1, 2, clock=clk).write("up")
    clk.advance(50.0)
    m0.write("up")
    f = Fleet(0, 2, membership=m0, fleet_dir=str(board))
    with pytest.raises(FleetWedgeError, match="died while the fleet"):
        f.step_barrier(5, fingerprint=[1.0])
    assert _counter("fleet.wedges") == 1
    assert len(_artifacts(tmp_path / "flight", "fleet_collective_wedge")) == 1


def test_collective_failed_names_the_dead_peer(tmp_path, monkeypatch):
    """A collective that raised (gloo on a closed connection): the
    survivor waits for the board to go stale, then dumps the wedge
    artifact naming the dead rank; with every host alive the error is the
    program's own (None: the caller re-raises it)."""
    _flight(monkeypatch, tmp_path / "flight")
    clk = FakeClock()
    board = tmp_path / "b"
    m0 = FleetMembership(board, 0, 2, clock=clk, heartbeat_s=1.0)
    m1 = FleetMembership(board, 1, 2, clock=clk)
    m1.write("up")
    m0.write("up")
    f = Fleet(0, 2, membership=m0, fleet_dir=str(board))
    boom = RuntimeError("Connection closed by peer")

    def beating(s):   # rank 1 keeps heartbeating while rank 0 waits
        clk.advance(s)
        m1.write("up")
    err = f.collective_failed(4, boom, clock=clk, sleeper=beating)
    assert err is None   # rank 1 stayed fresh: not a death
    assert clk.t > 4.0   # it waited out one staleness bound and a beat
    assert _artifacts(tmp_path / "flight", "fleet_collective_wedge") == []
    clk.advance(1.0)
    m1.write("up")       # alive until it dies here
    err = f.collective_failed(5, boom, clock=clk, sleeper=clk.advance)
    assert isinstance(err, FleetWedgeError) and "[1]" in str(err)
    arts = _artifacts(tmp_path / "flight", "fleet_collective_wedge")
    snap = json.load(open(arts[0]))["extra"]
    assert snap["diagnosis"]["dead"] == [1] and snap["step"] == 5
    assert "Connection closed" in snap["error"]
    assert _counter("fleet.wedges") == 1


def test_replica_fingerprint_is_the_replicated_weights():
    import torch
    import mxtpu_torch as mt
    a = [mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                     ctx=mt.cpu()), mt.nd.array(np.ones(3), ctx=mt.cpu())]
    b = [mt.nd.NDArray(t._data.clone()) for t in a]
    assert fleet.replica_fingerprint(a) == fleet.replica_fingerprint(b)
    b[1]._data[0] = torch.nextafter(b[1]._data[0], torch.tensor(2.0))
    fa, fb = fleet.replica_fingerprint(a), fleet.replica_fingerprint(b)
    assert fa != fb and fa[0] == pytest.approx(fb[0])   # the fold sees it


# ------------------------------------------------------- fleet supervisor
def _supervisors(script, worlds, latest, **kw):
    """Both packages' supervisors on the same stand-in launches and
    checkpoint sequence."""
    out = []
    for mod in (fleet, jfleet):
        latest_it = iter(latest)

        def launch(world, generation, extra_env, mod=mod):
            assert world == worlds[generation], (mod, world, generation)
            return dict(script[generation])
        cmd = (lambda r, w, g, b: ["unused"]) if mod is fleet \
            else (lambda r, w, g: ["unused"])
        out.append(mod.FleetSupervisor(
            command_for=cmd, launch=launch, clock=FakeClock(),
            sleeper=lambda s: None, rng=random.Random(0),
            latest_fn=lambda it=latest_it: next(it), **kw))
    return out


def test_supervisor_elastic_loss_then_warm_rejoin():
    sups = _supervisors(
        {0: {0: (EXIT_FLEET_WEDGE, ""), 1: (EXIT_HOST_LOSS, "")},
         1: {0: (EXIT_HOST_LOSS, "")},
         2: {0: (0, "ok"), 1: (0, "ok")}},
        worlds={0: 2, 1: 1, 2: 2}, latest=[None, 5, 5, 7, 7],
        num_hosts=2, min_hosts=1)
    results = [s.run() for s in sups]
    assert results[0] == results[1] == {0: (0, "ok"), 1: (0, "ok")}
    port, ref = sups
    assert port.history == ref.history
    assert [h["event"] for h in port.history] == [
        "launch", "crash", "host_loss", "launch", "crash",
        "rejoin_attempt", "launch", "clean_exit"]
    loss = next(h for h in port.history if h["event"] == "host_loss")
    assert loss["ranks"] == [1] and loss["world"] == 1
    assert port.restarts == ref.restarts == 2
    assert _counter("supervisor.restarts") == 2


def test_supervisor_all_victims_still_shrinks():
    sups = _supervisors(
        {0: {0: (EXIT_FLEET_WEDGE, ""), 1: ("timeout", "")},
         1: {0: (0, "")}},
        worlds={0: 2, 1: 1}, latest=[None, 3, 3], num_hosts=2, min_hosts=1)
    for s in sups:
        s.run()
    assert sups[0].history == sups[1].history
    crash = next(h for h in sups[0].history if h["event"] == "crash")
    assert crash["victims"] == [0] and crash["lost"] == [1]


def test_supervisor_poison_crash_refuses_with_artifact(tmp_path,
                                                       monkeypatch):
    _flight(monkeypatch, tmp_path / "port")
    monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(tmp_path / "jax"))
    port, ref = _supervisors({0: {0: (1, "")}, 1: {0: (1, "")}},
                             worlds={0: 1, 1: 1}, latest=[3, 3, 3, 3],
                             num_hosts=1)
    with pytest.raises(tres.SupervisorRefusal, match="poison-crash"):
        port.run()
    with pytest.raises(jres.SupervisorRefusal, match="poison-crash"):
        ref.run()
    assert port.history == ref.history
    arts = [a for d in ("port", "jax")
            for a in _artifacts(tmp_path / d, "supervisor_refusal")]
    assert len(arts) == 2
    for a in arts:
        snap = json.load(open(a))
        assert [h["event"] for h in snap["extra"]["history"]] == [
            "launch", "crash", "launch", "crash"]
        assert "poison-crash" in snap["extra"]["diagnosis"]


def test_supervisor_crash_loop_budget_refuses(tmp_path, monkeypatch):
    _flight(monkeypatch, tmp_path)
    port, ref = _supervisors({g: {0: (1, "")} for g in range(4)},
                             worlds={g: 1 for g in range(4)},
                             latest=[1, 2, 2, 3, 3, 4, 4], num_hosts=1,
                             max_restarts=2)
    with pytest.raises(tres.SupervisorRefusal, match="crash-loop"):
        port.run()
    with pytest.raises(jres.SupervisorRefusal, match="crash-loop"):
        ref.run()
    assert port.restarts == ref.restarts == 2
    assert port.history == ref.history
    # the budget and backoff are TrainSupervisor's
    d = FleetSupervisor(lambda r, w, g, b: [], 1)
    assert (d.max_restarts, d.backoff_s, d.timeout_s) == (8, 2.0, 600.0)
    t = tres.TrainSupervisor(["x"])
    assert (t.max_restarts, t.backoff_s) == (d.max_restarts, d.backoff_s)


def test_launch_round_surfaces_exit_codes_and_timeouts():
    sup = FleetSupervisor(
        command_for=lambda r, w, g, b: [
            sys.executable, "-c",
            "import sys; print('tail-marker'); sys.exit(7)"],
        num_hosts=1, timeout_s=30.0)
    out = sup.launch_round(1, 0)
    assert out[0][0] == 7 and "tail-marker" in out[0][1]
    assert sup.rounds[-1]["exits"][0]["rc"] == 7
    sup2 = FleetSupervisor(
        command_for=lambda r, w, g, b: [
            sys.executable, "-c", "import time; time.sleep(60)"],
        num_hosts=1, timeout_s=1.5)
    out2 = sup2.launch_round(1, 0)
    assert out2[0][0] == "timeout"
    # a chatty child never blocks on a full pipe while another is reaped
    sup3 = FleetSupervisor(
        command_for=lambda r, w, g, b: [
            sys.executable, "-c",
            "import sys, time; sys.stdout.write('x' * 300000); "
            "sys.stdout.flush(); print('end'); sys.exit(%d)" % r],
        num_hosts=2, timeout_s=30.0)
    out3 = sup3.launch_round(2, 0)
    assert [out3[r][0] for r in (0, 1)] == [0, 1]
    assert out3[1][1].endswith("end\n") and len(out3[1][1]) == 4000


def test_launch_round_passes_the_bootstrap_as_arguments(tmp_path):
    """A deliberate difference (ROADMAP §C): the reference exports
    MXTPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID/MXTPU_FLEET_DIR to each
    child; here ``command_for`` receives the bootstrap and
    ``bootstrap_argv`` spells it as the worker's flags, with a fresh
    rendezvous port and a fresh board a generation, the faults and the
    compile-cache dir."""
    prog = "import json, sys; print('ARGV ' + json.dumps(sys.argv[1:]))"
    boots = []

    def command_for(r, w, g, boot):
        boots.append(boot)
        return [sys.executable, "-c", prog] + fleet.bootstrap_argv(boot)
    sup = FleetSupervisor(
        command_for=command_for, num_hosts=2,
        fleet_dir=str(tmp_path / "board"), ckpt_dir=str(tmp_path / "ck"),
        compile_cache_dir=str(tmp_path / "cc"), timeout_s=30.0,
        faults_for=lambda r, w, g: "host_loss@3" if r == 1 else None,
        env_for=lambda r, w, g: {"EXTRA_MARK": "r%d" % r})
    out = sup.launch_round(2, 3)
    argv = {}
    for rank, (rc, tail) in out.items():
        assert rc == 0, tail
        line = [ln for ln in tail.splitlines() if ln.startswith("ARGV ")]
        a = json.loads(line[0][5:])
        argv[rank] = dict(zip(a[::2], a[1::2]))
    assert argv[0]["--rank"] == "0" and argv[1]["--rank"] == "1"
    assert argv[0]["--world"] == argv[1]["--world"] == "2"
    assert argv[0]["--coordinator"] == argv[1]["--coordinator"]
    assert argv[0]["--coordinator"].startswith("127.0.0.1:")
    assert argv[0]["--fleet-dir"].endswith("gen_3")
    assert argv[1]["--faults"] == "host_loss@3" and "--faults" not in argv[0]
    assert argv[0]["--compile-cache-dir"] == str(tmp_path / "cc")
    assert argv[0]["--ckpt-dir"] == str(tmp_path / "ck")
    assert all(b["generation"] == 3 for b in boots)
    # the worker parses exactly these flags
    from mxtpu_torch import fleet_worker
    ns = fleet_worker._args(fleet.bootstrap_argv(boots[1]))
    assert (ns.rank, ns.world, ns.faults) == (1, 2, "host_loss@3")
    sup.launch_round(2, 4)
    assert sup.bootstrap(0, 2, 4, 1)["fleet_dir"].endswith("gen_4")


def test_shutdown_gives_up_on_a_blocked_teardown(monkeypatch):
    """``Fleet.leave`` after a peer died must not hang in the group's
    teardown."""
    import torch.distributed as dist
    gate = threading.Event()
    monkeypatch.setattr(tdist, "_OWNED", [True])
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "destroy_process_group", gate.wait)
    t0 = time.monotonic()
    try:
        tdist.shutdown(timeout_s=0.2)
    finally:
        gate.set()
    assert time.monotonic() - t0 < 5.0 and tdist._OWNED == [False]


def test_kvstore_refusals_point_at_fleet_init():
    import mxtpu_torch as mt
    from mxtpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match=r"fleet\.init\(\)"):
        mt.kv.create("dist_sync")
    with pytest.raises(MXNetError, match=r"fleet\.init\(\)"):
        mt.kv.create("dist_async")
    with pytest.raises(MXNetError, match=r"fleet\.init\(\)"):
        mt.kvstore_server.KVStoreServer().run()


# --------------------------------------- bounded multi-process acceptance
def _reference_mlp_losses(steps, batch=8, seed=7, features=4, hidden=8):
    """The reference MLP's whole-batch trajectory in the JAX package, from
    the worker's seeded weights and data."""
    import mxtpu as mx
    from mxtpu import autograd
    from mxtpu.gluon import nn
    from mxtpu_torch import fleet_worker
    net = nn.HybridSequential()
    net.add(nn.Dense(hidden, activation="relu", in_units=features))
    net.add(nn.Dense(1, in_units=hidden))
    net.initialize()
    for p, w in zip(net.collect_params().values(),
                    fleet_worker.mlp_weights(seed, features, hidden)):
        p.set_data(mx.nd.array(w))
    x, y = fleet_worker.mlp_data(seed, features)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9},
                               kvstore=None)
    loss_fn = mx.gluon.loss.L2Loss()
    out = []
    for step in range(steps):
        idx = [(step * batch + i) % x.shape[0] for i in range(batch)]
        xb, yb = mx.nd.array(x[idx]), mx.nd.array(y[idx])
        with autograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        trainer.step(batch)
        out.append(float(np.mean(loss.asnumpy())))
    return out


def _step_losses(rounds):
    """{step: loss} from every generation's ``STEP`` lines."""
    got = {}
    for rnd in rounds:
        for rc, tail in rnd["results"].values():
            for ln in tail.splitlines():
                if ln.startswith("STEP "):
                    _, s, v = ln.split()[:3]
                    got.setdefault(int(s), []).append(float(v))
    return got


@pytest.mark.multidevice
def test_fleet_kill_one_host_restore_rejoin_acceptance(tmp_path):
    """Two gloo hosts of the MLP worker lose rank 1 at step 3 (exit 41);
    rank 0 exits 42 within the bound with the wedge artifact naming rank
    1; one host restores step 2 onto a one-rank mesh and checkpoints step
    3, then dies (``host_loss@4``); the fleet grows back to two hosts,
    which restore step 3, serve the restored weights warm from the disk
    cache (hits, no drops) and finish clean; a fourth generation of two
    restores step 5 (saved by two) and runs two more steps. Every step's
    global loss, whichever generation ran it, within 1e-5 relative of
    the reference's whole-batch trajectory: a ZeRO-1 step saved by two
    ranks restores onto one and onto two, and one saved by one onto two."""
    ckpt, board = str(tmp_path / "ckpt"), tmp_path / "board"
    bound = 30.0

    def command_for(rank, world, generation, boot, steps=6):
        return [sys.executable, "-m", "mxtpu_torch.fleet_worker",
                *fleet.bootstrap_argv(boot), "--device", "cpu",
                "--backend", "gloo", "--collective-timeout", str(bound),
                "--heartbeat-s", "0.5", "--eval-rows", "8", "--obs-s",
                "0.05", "--steps", str(steps)]

    def faults_for(rank, world, generation):
        return {(0, 1): "host_loss@3", (1, 0): "host_loss@4"}.get(
            (generation, rank))

    sup = FleetSupervisor(
        command_for=command_for, num_hosts=2, min_hosts=1, ckpt_dir=ckpt,
        fleet_dir=str(board), compile_cache_dir=str(tmp_path / "cache"),
        timeout_s=240.0, faults_for=faults_for,
        env_for=lambda r, w, g: {"PYTHONPATH": REPO},
        sleeper=lambda s: None, rng=random.Random(0))
    results = sup.run()
    events = [h["event"] for h in sup.history]
    assert events == ["launch", "crash", "host_loss", "launch", "crash",
                      "rejoin_attempt", "launch", "clean_exit"], sup.history
    crash = next(h for h in sup.history if h["event"] == "crash")
    assert crash["exit_codes"] == {"0": EXIT_FLEET_WEDGE,
                                   "1": EXIT_HOST_LOSS}, sup.rounds[0]
    gen0 = sup.rounds[0]["exits"]
    assert gen0[0]["exit_s"] - gen0[1]["exit_s"] < bound
    arts = _artifacts(board / "gen_0", "fleet_collective_wedge")
    assert len(arts) == 1
    diag = json.load(open(arts[0]))["extra"]["diagnosis"]
    assert diag["dead"] == [1]
    assert sup.rounds[1]["world"] == 1
    recs = {}
    for rank, (rc, tail) in results.items():
        assert rc == 0, tail
        recs[rank] = json.loads([ln for ln in tail.splitlines()
                                 if ln.startswith("RESULT ")][0][7:])
    assert sorted(recs) == [0, 1]
    for rec in recs.values():
        assert rec["world"] == 2 and rec["start"] == 4
        assert rec["divergence_checks"] == 2
        assert rec["disk_hits"].get("serving.predict", 0) >= 1, rec
        assert not rec["disk_drops"] and rec["nvcc"] == 0
    assert recs[0]["restore_eval"] == recs[1]["restore_eval"]
    # one more generation of two hosts restores step 5, which two hosts
    # saved, and runs on to step 8
    more = FleetSupervisor(
        command_for=lambda r, w, g, b: command_for(r, w, g, b, steps=8),
        num_hosts=2, ckpt_dir=ckpt, fleet_dir=str(board),
        compile_cache_dir=str(tmp_path / "cache"), timeout_s=240.0,
        env_for=lambda r, w, g: {"PYTHONPATH": REPO})
    last = more.launch_round(2, 3)
    assert [last[r][0] for r in (0, 1)] == [0, 0], last
    for r in (0, 1):
        restore = [ln for ln in last[r][1].splitlines()
                   if ln.startswith("RESTORE ")]
        assert restore and restore[0].endswith("start 6"), last[r][1]
    got = _step_losses(sup.rounds + more.rounds)
    assert sorted(got) == list(range(8))
    ref = _reference_mlp_losses(8)
    for step, vals in got.items():
        for v in vals:
            assert abs(v - ref[step]) <= 1e-5 * abs(ref[step]), \
                (step, v, ref[step])


# ------------------------------- the chip phase's gates, planted faults
def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_fleet_gates", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _green_fleet_run(cs):
    """What a healthy fleet phase leaves, in the shapes ``_fleet_gates``
    reads (the configuration's steps, kill and checkpoint cadence)."""
    cfg = dict(cs.FLEET)
    ref = [6.9 - 0.01 * s for s in range(cfg["steps"])]

    def kid(steps, start, result=None):
        return {"steps": {s: {"loss": ref[s], "s": 0.1, "peak": 1,
                              "b1": 11} for s in steps},
                "start": start, "result": result, "bringup_s": 1.0,
                "restore_s": 1.0, "b1": 11}
    warm = {"nvcc": 0, "searches": 0, "disk_drops": {},
            "captures": {"cached_op": 2, "fused_optimizer": 1,
                         "serving.predict": 1},
            "disk_hits": {"cached_op": 2, "fused_optimizer": 1,
                          "serving.predict": 1}}
    kill, again = cfg["kill_at"], cfg["survivor_kill_at"]
    kids = {0: {0: kid(range(kill), 0), 1: kid(range(kill), 0)},
            1: {0: kid(range(kill, again), kill)},
            2: {0: kid(range(again, cfg["steps"]), again,
                       dict(warm, straggler=1, straggler_stage="data.wait")),
                1: kid(range(again, cfg["steps"]), again, dict(warm))}}
    rounds = [{"generation": 0, "world": 2,
               "exits": {0: {"rc": 42, "exit_s": 9.0},
                         1: {"rc": 41, "exit_s": 5.0}}},
              {"generation": 1, "world": 1,
               "exits": {0: {"rc": 41, "exit_s": 8.0}}},
              {"generation": 2, "world": 2,
               "exits": {0: {"rc": 0, "exit_s": 9.0},
                         1: {"rc": 0, "exit_s": 9.0}}}]
    merged = {"fleet": {"mfu": 0.2, "step_s": {"p50": 0.1, "p99": 0.2}},
              "hosts": {0: {"heartbeat_age_s": 1.0},
                        1: {"heartbeat_age_s": 1.0}}}
    prom = 'mxtpu_a{host="0"} 1\nmxtpu_a{host="1"} 1'
    history = [{"event": e} for e in cs.FLEET_EVENTS]
    return dict(cfg=cfg, ref=ref, history=history, rounds=rounds,
                kids=kids, obs=(merged, prom), wedge_dead=[[1]])


def _plant(name, run):
    kids, rounds = run["kids"], run["rounds"]
    if name == "survivor_not_42":
        rounds[0]["exits"][0]["rc"] = 1
    elif name == "survivor_past_the_bound":
        rounds[0]["exits"][0]["exit_s"] = 500.0
    elif name == "wedge_names_nobody":
        run["wedge_dead"] = [[]]
    elif name == "restore_made_no_progress":
        del kids[1][0]["steps"][max(kids[1][0]["steps"])]
    elif name == "rejoin_ran_nvcc":
        kids[2][1]["result"]["nvcc"] = 1
    elif name == "rejoin_searched":
        kids[2][0]["result"]["searches"] = 2
    elif name == "rejoin_dropped_a_blob":
        kids[2][1]["result"]["disk_drops"] = {"corrupt": 1}
    elif name == "rejoin_cold_site":
        kids[2][0]["result"]["disk_hits"] = {"cached_op": 2}
    elif name == "straggler_unnamed":
        kids[2][0]["result"].pop("straggler")
    elif name == "loss_off_the_trajectory":
        kids[2][0]["steps"][7]["loss"] *= 1.03
    elif name == "a_step_missing":
        del kids[0][0]["steps"][2], kids[0][1]["steps"][2]
    elif name == "host_unlabelled":
        run["obs"] = (run["obs"][0], 'mxtpu_a{host="0"} 1')
    elif name == "no_fleet_mfu":
        run["obs"][0]["fleet"]["mfu"] = None
    elif name == "no_rejoin":
        run["history"] = run["history"][:5] + [{"event": "launch"},
                                                {"event": "clean_exit"}]


@pytest.mark.parametrize("plant", [
    None, "survivor_not_42", "survivor_past_the_bound",
    "wedge_names_nobody", "restore_made_no_progress", "rejoin_ran_nvcc",
    "rejoin_searched", "rejoin_dropped_a_blob", "rejoin_cold_site",
    "straggler_unnamed", "loss_off_the_trajectory", "a_step_missing",
    "host_unlabelled", "no_fleet_mfu", "no_rejoin"])
def test_chip_fleet_gates_fail_on_planted_faults(plant):
    """Every gate of ``chip_smoke.py:fleet_phase`` passes a healthy run's
    record and fails the planted fault that breaks it."""
    cs = _chip_smoke()
    run = _green_fleet_run(cs)
    if plant is None:
        assert cs._fleet_gates(**run) == 0.0
        return
    _plant(plant, run)
    with pytest.raises(AssertionError, match="fleet gate"):
        cs._fleet_gates(**run)


def test_chip_fleet_child_output_is_parsed():
    cs = _chip_smoke()
    tail = ("junk\nBRINGUP 1.500\nRESTORE 2.250 start 4\n"
            "STEP 4 6.5 0.8 1024 22\nSTEP 5 6.4 0.1 2048 33\n"
            'RESULT {"b1_launches": 44, "world": 1}\n')
    kid = cs._fleet_child(tail)
    assert (kid["bringup_s"], kid["restore_s"], kid["start"]) == \
        (1.5, 2.25, 4)
    assert kid["steps"][5] == {"loss": 6.4, "s": 0.1, "peak": 2048,
                               "b1": 33}
    assert kid["b1"] == 44 and kid["result"]["world"] == 1
    assert cs._fleet_child("STEP 0 1.0 0.1 0 11\n")["b1"] == 11
