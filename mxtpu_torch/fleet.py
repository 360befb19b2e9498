"""Elastic multi-host fleet training: bring-up, failure detection, restore
and rejoin (counterpart of ``mxtpu/fleet.py``).

One process a host, joined over ``torch.distributed`` (NCCL between
cards; gloo where the caller asks, as the CPU tests and several hosts
sharing one card do), with a status board of files on a shared fleet
directory beside it:

* **Coordinated bring-up** -- :func:`init` wraps
  ``mxtpu_torch.distributed.init`` in ``resilience.with_retries``
  (``retry.fleet_connect``, decorrelated jitter) and runs it and the
  board's rendezvous barrier under ONE deadline: a host that never shows
  up fails the bring-up loud with :class:`FleetBringupError` and the
  per-host status read off the board, instead of every healthy host
  hanging in the rendezvous. Every host joins the process group, the CPU
  too (the reference's CPU tier stays board-only because XLA:CPU cannot
  span processes; gloo can), so :meth:`Fleet.mesh` spans the fleet and
  each host takes its rows of the global batch. :meth:`Fleet.data_shard`
  rides ``io.stream.shard_keys``.
* **Failure detection** -- :class:`FleetMembership` keeps one heartbeat
  file a host (``host_<rank>.json``, rewritten atomically). A host whose
  heartbeat goes stale is diagnosed dead; a dead coordinator (host 0,
  where the process group's store lives) raises :class:`FleetWedgeError`
  with the board. :class:`FleetCollectiveWatchdog` brackets each step
  with a fixed deadline; a trip dumps ``flight_record(
  "fleet_collective_wedge")`` with the board's diagnosis and, with
  ``exit_on_trip``, exits ``EXIT_FLEET_WEDGE`` (only ``os._exit`` frees a
  thread blocked in a collective). A collective that raises instead (gloo
  on a closed connection) goes through :meth:`Fleet.collective_failed`:
  the same artifact and exit once the board names the dead peer.
* **Tiered restore and warm rejoin** -- :class:`FleetSupervisor` runs one
  child a host a generation, with a hard timeout and exit-code
  surfacing, membership events in ``history`` and the refusal discipline
  of ``resilience.TrainSupervisor`` (whose restart budget and backoff it
  shares). After a lost host the next generation runs on the survivors
  and restores the newest intact checkpoint onto the reshaped mesh (the
  ``MeshPlan`` cuts the whole ZeRO-1 states to each rank's rows); once a
  reshaped generation shows checkpoint progress the fleet grows back,
  and the replacement starts warm off the compile service's disk cache.

The reference reads ``MXTPU_FLEET_CONNECT_RETRIES`` (4),
``_CONNECT_BACKOFF_S`` (1.0), ``_BRINGUP_TIMEOUT_S`` (300),
``_HEARTBEAT_S`` (2.0), ``_HEARTBEAT_MISS`` (3),
``_COLLECTIVE_TIMEOUT_S`` (0: off), ``_CHILD_TIMEOUT_S`` (600) and
``MXTPU_FLEET_DIR``; here each is an argument with that default. Its
supervisor exports the bootstrap to each child's environment; here
``command_for(rank, world, generation, bootstrap)`` receives it and
:func:`bootstrap_argv` spells it as the flags ``python -m
mxtpu_torch.fleet_worker`` parses.

Fault kinds ``host_loss@step`` (:func:`maybe_host_loss`: ``os._exit(41)``
before that step's collectives), ``coordinator_loss`` (membership-check
index) and ``rejoin_stall@rank`` (that host stalls in bring-up, then
exits 43) ride ``resilience.inject``.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time

from .base import MXNetError

__all__ = ["Fleet", "FleetBringupError", "FleetWedgeError",
           "FleetMembership", "FleetCollectiveWatchdog", "FleetSupervisor",
           "init", "maybe_host_loss", "replica_fingerprint",
           "bootstrap_argv", "EXIT_HOST_LOSS",
           "EXIT_FLEET_WEDGE", "EXIT_REJOIN_STALL"]

_log = logging.getLogger("mxtpu_torch.fleet")

# Exit codes the supervisor reads: a sudden host death, a collective
# wedge's loud exit, a bring-up stall.
EXIT_HOST_LOSS = 41
EXIT_FLEET_WEDGE = 42
EXIT_REJOIN_STALL = 43

# ---------------------------------------------------------------- policies
CONNECT_RETRIES = 4          # re-attempts of the join before bring-up fails
CONNECT_BACKOFF_S = 1.0      # the first retry's wait; then jitter
BRINGUP_TIMEOUT_S = 300.0    # deadline on the join and the board barrier
HEARTBEAT_S = 2.0            # heartbeat cadence on the board
HEARTBEAT_MISS = 3           # stale past miss x cadence: dead
COLLECTIVE_TIMEOUT_S = 0.0   # fixed bound on a fleet step (0: off)
CHILD_TIMEOUT_S = 600.0      # the supervisor's hard bound on a child
POLL_S = 0.05                # the board's poll while waiting
TAIL_CHARS = 4000            # the end of a child's output kept


class FleetBringupError(MXNetError):
    """The bring-up missed its deadline or spent its connect retries: a
    host never joined. The message carries the board's per-host status."""


class FleetWedgeError(MXNetError):
    """A fleet step wedged or failed on a dead peer, or the coordinator
    stopped heartbeating; the flight artifact is on disk by then."""


# ------------------------------------------------------------ status board
def _atomic_write(path, payload):
    # the temporary name is the thread's too: a host's heartbeat thread and
    # its training thread both rewrite its status file
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class FleetMembership:
    """One host's view of the heartbeat board on the fleet directory.

    Each host owns ``host_<rank>.json`` (``{"rank", "status", "t", "pid",
    "step"}``, the reference's fields, so either package reads the other's
    board): status ``connecting`` -> ``up`` -> ``left`` (or ``stalled``).
    Liveness is the record's age; ``clock`` (default ``time.time``) stamps
    and reads it, so fake-clock tests drive both sides. A host is dead when
    never seen, or when its heartbeat is older than ``heartbeat_s *
    heartbeat_miss`` without a clean ``left``."""

    def __init__(self, fleet_dir, rank, num_hosts, clock=None,
                 heartbeat_s=HEARTBEAT_S, heartbeat_miss=HEARTBEAT_MISS):
        self.fleet_dir = str(fleet_dir)
        self.rank = int(rank)
        self.num_hosts = int(num_hosts)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_miss = int(heartbeat_miss)
        self._clock = time.time if clock is None else clock
        self._hb_thread = None
        self._hb_stop = None
        self.step = None
        os.makedirs(self.fleet_dir, exist_ok=True)

    def _path(self, rank):
        return os.path.join(self.fleet_dir, "host_%d.json" % rank)

    def write(self, status, step=None):
        """Publish this host's status (an atomic rewrite of its file)."""
        if step is not None:
            self.step = int(step)
        _atomic_write(self._path(self.rank), json.dumps(
            {"rank": self.rank, "status": status, "t": self._clock(),
             "pid": os.getpid(), "step": self.step}))

    def view(self):
        """``{rank: record}`` of every host file present and readable."""
        out = {}
        for r in range(self.num_hosts):
            try:
                with open(self._path(r)) as f:
                    out[r] = json.load(f)
            except Exception:  # noqa: BLE001 - absent or torn: not seen
                continue
        return out

    def describe(self, view=None):
        """One status line a host: the diagnosis the errors carry."""
        view = self.view() if view is None else view
        now = self._clock()
        lines = []
        for r in range(self.num_hosts):
            rec = view.get(r)
            if rec is None:
                lines.append("host %d: NEVER SEEN (no status file)" % r)
            else:
                lines.append(
                    "host %d: %s, heartbeat %.1fs ago (pid %s, step %s)"
                    % (r, rec.get("status"), now - rec.get("t", 0.0),
                       rec.get("pid"), rec.get("step")))
        return "; ".join(lines)

    def dead_hosts(self):
        """Ranks diagnosed dead (class docstring)."""
        bound = self.heartbeat_s * self.heartbeat_miss
        now = self._clock()
        view = self.view()
        dead = []
        for r in range(self.num_hosts):
            rec = view.get(r)
            if rec is None:
                dead.append(r)
            elif rec.get("status") != "left" and \
                    now - rec.get("t", 0.0) > bound:
                dead.append(r)
        return dead

    def coordinator_alive(self):
        return 0 not in self.dead_hosts()

    def check(self, step=None):
        """Write this host's heartbeat and return the dead hosts. A dead
        coordinator raises :class:`FleetWedgeError` on the other hosts
        after a ``coordinator_loss`` artifact: the process group's store
        lives in host 0, so the next collective would hang, not error.
        Fault kind ``coordinator_loss`` forces that diagnosis."""
        from . import resilience, telemetry
        self.write("up", step=step)
        dead = self.dead_hosts()
        if resilience.inject("coordinator_loss") and 0 not in dead:
            dead.insert(0, 0)
        if 0 in dead and self.rank != 0:
            view = self.view()
            telemetry.flight_record(
                "coordinator_loss",
                extra={"rank": self.rank, "step": step, "dead": dead,
                       "view": view})
            raise FleetWedgeError(
                "fleet coordinator (host 0) stopped heartbeating: the "
                "process group's store lives in that process, so "
                "collectives would hang, not error. Board: %s. Flight "
                "artifact dumped (reason=coordinator_loss); the supervisor "
                "restores onto a re-coordinated fleet." % self.describe(view))
        return dead

    # -------------------------------------------------------------- barrier
    def barrier(self, name, timeout_s, payload=None, clock=None,
                sleeper=None, poll_s=POLL_S, fail_on_dead=True):
        """Rendezvous on the board: each host writes
        ``barrier_<name>/host_<rank>`` (``{"rank", "payload"}``) and polls
        for the full set under the deadline. A peer seen before whose
        heartbeat went stale fails the wait as soon as it is diagnosed
        (``fail_on_dead``); a host never seen fails it only at the
        deadline. Returns ``{rank: payload}``."""
        clock = self._clock if clock is None else clock
        bdir = os.path.join(self.fleet_dir, "barrier_%s" % name)
        os.makedirs(bdir, exist_ok=True)
        _atomic_write(os.path.join(bdir, "host_%d" % self.rank),
                      json.dumps({"rank": self.rank, "payload": payload}))
        deadline = clock() + float(timeout_s)
        while True:
            seen = {}
            for r in range(self.num_hosts):
                try:
                    with open(os.path.join(bdir, "host_%d" % r)) as f:
                        seen[r] = json.load(f).get("payload")
                except Exception:  # noqa: BLE001 - absent or torn
                    continue
            if len(seen) == self.num_hosts:
                return seen
            if fail_on_dead:
                view = self.view()
                stale = [r for r in self.dead_hosts()
                         if r in view and r not in seen]
                if stale:
                    raise FleetWedgeError(
                        "fleet barrier %r: host(s) %s died while the fleet "
                        "waited (%d/%d arrived). Board: %s"
                        % (name, stale, len(seen), self.num_hosts,
                           self.describe(view)))
            if clock() > deadline:
                raise FleetWedgeError(
                    "fleet barrier %r missed its %.0fs deadline: %d/%d "
                    "hosts arrived (missing %s). Board: %s"
                    % (name, float(timeout_s), len(seen), self.num_hosts,
                       sorted(set(range(self.num_hosts)) - set(seen)),
                       self.describe()))
            (time.sleep if sleeper is None else sleeper)(poll_s)

    # ------------------------------------------------------------ heartbeat
    def start_heartbeat(self, interval_s=None):
        """Write ``up`` every ``interval_s`` (default ``heartbeat_s``) on a
        daemon thread (idempotent)."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return self
        interval_s = self.heartbeat_s if interval_s is None else interval_s
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.write("up")
                except Exception:  # noqa: BLE001 - a flaky disk must not
                    pass           # kill the heartbeat
        t = threading.Thread(target=loop, daemon=True,
                             name="mxtpu-torch-fleet-heartbeat")
        self._hb_thread, self._hb_stop = t, stop
        t.start()
        return self

    def stop_heartbeat(self):
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        self._hb_thread = self._hb_stop = None


# ------------------------------------------------------- deadline bring-up
def _run_with_deadline(fn, timeout_s, on_timeout, clock=None, sleeper=None,
                       poll_s=0.05, thread_name="mxtpu-torch-fleet-bringup"):
    """``fn()`` on a daemon thread under a deadline; past it
    ``on_timeout()`` builds the error raised (the stuck thread, blocked in
    a rendezvous nothing interrupts, is abandoned). ``fn``'s own error
    re-raises."""
    clock = time.monotonic if clock is None else clock
    done = threading.Event()
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            box["err"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name=thread_name)
    t.start()
    deadline = clock() + timeout_s
    while not done.is_set():
        if clock() > deadline:
            raise on_timeout()
        if sleeper is None:
            done.wait(poll_s)
        else:
            sleeper(poll_s)
    if "err" in box:
        raise box["err"]
    return box.get("out")


class Fleet:
    """What :func:`init` returns: identity, membership, data sharding and
    the mesh of one joined host."""

    def __init__(self, rank, num_hosts, membership=None, fleet_dir=None,
                 collective_timeout_s=COLLECTIVE_TIMEOUT_S,
                 bringup_timeout_s=BRINGUP_TIMEOUT_S):
        self.rank = int(rank)
        self.num_hosts = int(num_hosts)
        self.membership = membership
        self.fleet_dir = fleet_dir
        self.collective_timeout_s = float(collective_timeout_s or 0.0)
        self.bringup_timeout_s = float(bringup_timeout_s)

    def _bound(self):
        return self.collective_timeout_s or self.bringup_timeout_s

    def mesh(self, axes=None, devices=None):
        """A mesh of the fleet's ranks for ``gluon.Trainer(mesh=...)``
        (default: data parallel over every rank of the process group)."""
        from .parallel import make_mesh
        return make_mesh({"data": -1} if axes is None else axes, devices)

    def data_shard(self, keys, epoch=0, seed=0, shuffle=True):
        """This host's deterministic slice of ``keys``
        (``io.stream.shard_keys``: disjoint shards whose union is
        ``keys``, a function of seed, epoch, rank and world alone)."""
        from .io.stream import shard_keys
        return shard_keys(keys, num_shards=self.num_hosts,
                          shard_index=self.rank, epoch=epoch, seed=seed,
                          shuffle=shuffle)

    def reader(self, rec_path, **kwargs):
        """A ``ShardedRecordReader`` over this host's shard."""
        from .io.stream import ShardedRecordReader
        return ShardedRecordReader(rec_path, num_shards=self.num_hosts,
                                   shard_index=self.rank, **kwargs)

    def watchdog(self, timeout_s=None, clock=None, exit_on_trip=False,
                 exit_fn=None):
        """A :class:`FleetCollectiveWatchdog` on this fleet's board, bound
        ``timeout_s`` (default the fleet's collective bound)."""
        return FleetCollectiveWatchdog(
            membership=self.membership,
            timeout_s=self.collective_timeout_s if timeout_s is None
            else timeout_s,
            clock=clock, exit_on_trip=exit_on_trip, exit_fn=exit_fn)

    def check(self, step=None):
        """Heartbeat and membership probe; no-op without a board."""
        if self.membership is None:
            return []
        return self.membership.check(step=step)

    def barrier(self, name="mxtpu_fleet", timeout_s=None, payload=None):
        """Fleet-wide rendezvous: the board's barrier (deadline-bounded,
        returns ``{rank: payload}``), or the process group's barrier
        without a board (returns None)."""
        if self.membership is not None:
            return self.membership.barrier(
                name, self._bound() if timeout_s is None else timeout_s,
                payload=payload)
        from . import distributed
        distributed.barrier(name)
        return None

    def step_barrier(self, step, fingerprint=None, obs=None):
        """Per-step coupling on the board within the fleet bound: a dead
        peer fails the survivors loud (``fleet_collective_wedge``), and
        the fingerprints riding the payloads must agree
        (``fleet_divergence``, ``resilience.DivergenceError``). The
        fingerprint must be one every host holds the same: the replicated
        weights' (``replica_fingerprint``), not a rank's ZeRO-1 rows.
        ``obs`` (a dict: ``trace``, ``stages``) makes the payload the
        stitched form the straggler sentinel reads, with the fingerprint
        under ``fp`` and the arrival time ``t``; without it the payload is
        the bare fingerprint list. No-op without a board."""
        if self.membership is None:
            return None
        from . import telemetry
        payload = None if fingerprint is None else list(fingerprint)
        if obs is not None:
            payload = dict(obs)
            payload["fp"] = None if fingerprint is None else list(fingerprint)
            payload.setdefault("t", self.membership._clock())
        try:
            fps = self.membership.barrier("step_%d" % int(step),
                                          self._bound(), payload=payload)
        except FleetWedgeError:
            telemetry.inc("fleet.wedges")
            telemetry.flight_record(
                "fleet_collective_wedge",
                extra={"step": int(step), "what": "step barrier",
                       "diagnosis": {
                           "dead": self.membership.dead_hosts(),
                           "board": self.membership.describe()}})
            raise
        got = {}
        for r, p in fps.items():
            fp = p.get("fp") if isinstance(p, dict) else p
            if fp is not None:
                got[r] = fp
        if got:
            telemetry.inc("resilience.divergence_checks")
        if len(set(map(tuple, got.values()))) > 1:
            telemetry.flight_record(
                "fleet_divergence",
                extra={"step": int(step), "fingerprints": {
                    str(r): p for r, p in got.items()}})
            from .resilience import DivergenceError
            raise DivergenceError(
                "cross-host divergence at step %d: update fingerprints "
                "disagree across hosts (%s): replicated state is no longer "
                "replicated. Flight artifact dumped (reason="
                "fleet_divergence)." % (int(step), got))
        return fps

    def collective_failed(self, step, exc, clock=None, sleeper=None):
        """A collective of step ``step`` raised ``exc`` (gloo on a closed
        connection). Waits up to one staleness bound and a heartbeat for
        the board to name a dead host; with one, dumps
        ``fleet_collective_wedge`` with the diagnosis, counts
        ``fleet.wedges`` and returns the :class:`FleetWedgeError` to raise
        (the caller exits ``EXIT_FLEET_WEDGE``). With every host alive the
        error is the program's own: returns None and the caller re-raises
        it."""
        from . import telemetry
        mem = self.membership
        if mem is None:
            return None
        clock = time.monotonic if clock is None else clock
        wait = mem.heartbeat_s * (mem.heartbeat_miss + 1)
        deadline = clock() + wait
        dead = [r for r in mem.dead_hosts() if r != self.rank]
        while not dead and clock() <= deadline:
            (time.sleep if sleeper is None else sleeper)(POLL_S)
            dead = [r for r in mem.dead_hosts() if r != self.rank]
        if not dead:
            return None
        telemetry.inc("fleet.wedges")
        diag = {"dead": dead, "coordinator_dead": 0 in dead,
                "board": mem.describe()}
        telemetry.flight_record(
            "fleet_collective_wedge",
            extra={"step": int(step), "what": "collective",
                   "error": "%s: %s" % (type(exc).__name__, exc),
                   "diagnosis": diag})
        return FleetWedgeError(
            "fleet collective at step %d failed (%s: %s); dead hosts: %s "
            "- %s. Flight artifact dumped (reason=fleet_collective_wedge)."
            % (int(step), type(exc).__name__, exc, dead, diag["board"]))

    def leave(self):
        """Clean departure: publish ``left`` (peers read a planned exit,
        not a death), stop the heartbeat, leave the process group (given
        up after 10 s: a group whose peer died may block there)."""
        from . import distributed
        if self.membership is not None:
            self.membership.stop_heartbeat()
            try:
                self.membership.write("left")
            except Exception:  # noqa: BLE001 - a board on a dying disk
                pass
        distributed.shutdown(timeout_s=10.0)


def init(fleet_dir=None, coordinator_address=None, num_processes=None,
         process_id=None, local_device_ids=None, timeout_s=None,
         clock=None, sleeper=None, rng=None, heartbeat=True, _stall=None,
         backend=None, connect_retries=CONNECT_RETRIES,
         connect_backoff_s=CONNECT_BACKOFF_S, heartbeat_s=HEARTBEAT_S,
         heartbeat_miss=HEARTBEAT_MISS,
         collective_timeout_s=COLLECTIVE_TIMEOUT_S):
    """Coordinated multi-host bring-up; returns a :class:`Fleet`.

    The join (``distributed.init`` with ``backend`` -- NCCL by default,
    which needs a card -- under ``connect_retries`` retries from
    ``connect_backoff_s``) and the board's ``bringup`` barrier run under
    one deadline ``timeout_s`` (default 300 s): a missing host fails with
    :class:`FleetBringupError` and the board, after a
    ``fleet_bringup_timeout`` artifact. With ``fleet_dir`` each host
    publishes ``connecting`` before the join and ``up`` after it, then
    heartbeats every ``heartbeat_s``. A positive ``collective_timeout_s``
    is the fleet's step bound and the process group's timeout.
    ``clock``/``sleeper``/``rng`` may be injected.

    Fault kind ``rejoin_stall@rank``: this host publishes ``stalled``,
    holds past every peer's deadline (``_stall`` replaces the hold) and
    exits ``EXIT_REJOIN_STALL``."""
    from . import distributed, resilience, telemetry
    timeout_s = BRINGUP_TIMEOUT_S if timeout_s is None else float(timeout_s)
    world, rank_hint = num_processes, process_id

    def board(rank, n):
        return FleetMembership(fleet_dir, rank, n, clock=clock,
                               heartbeat_s=heartbeat_s,
                               heartbeat_miss=heartbeat_miss)

    mem = None
    if fleet_dir is not None and world is not None and rank_hint is not None:
        mem = board(rank_hint, world)
        mem.write("connecting")

    if resilience.inject("rejoin_stall", rank_hint):
        if mem is not None:
            mem.write("stalled")
        hold = _stall if _stall is not None else (
            lambda: time.sleep(2.0 * timeout_s))
        hold()
        os._exit(EXIT_REJOIN_STALL)

    def on_timeout():
        board_txt = mem.describe() if mem is not None else \
            "no fleet_dir: per-host status unavailable (pass fleet_dir= " \
            "for a shared status board)"
        telemetry.flight_record(
            "fleet_bringup_timeout",
            extra={"rank": rank_hint, "world": world,
                   "timeout_s": timeout_s,
                   "view": mem.view() if mem is not None else None})
        return FleetBringupError(
            "fleet bring-up missed its %.0fs deadline: at least one host "
            "never joined the rendezvous. Board: %s. Flight artifact "
            "dumped (reason=fleet_bringup_timeout)." % (timeout_s, board_txt))

    def join():
        return resilience.with_retries(
            lambda: distributed.init(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id,
                local_device_ids=local_device_ids, backend=backend,
                timeout=collective_timeout_s or None),
            "fleet join (rank %s)" % rank_hint,
            retries=connect_retries, backoff=connect_backoff_s,
            metric="retry.fleet_connect", sleeper=sleeper, rng=rng,
            logger=_log)

    rank, world = _run_with_deadline(join, timeout_s, on_timeout,
                                     clock=clock, sleeper=sleeper)
    distributed.adopt_card(local_device_ids)   # the join ran on a thread
    if mem is None and fleet_dir is not None:
        mem = board(rank, world)
    if mem is not None:
        mem.rank, mem.num_hosts = rank, world   # the group's identity wins
        mem.write("up")
        try:
            mem.barrier("bringup", timeout_s, clock=clock, sleeper=sleeper,
                        fail_on_dead=False)
        except FleetWedgeError:
            raise on_timeout() from None
        if heartbeat:
            mem.start_heartbeat()
    else:
        _run_with_deadline(
            lambda: distributed.barrier("mxtpu_fleet_bringup"),
            timeout_s, on_timeout, clock=clock, sleeper=sleeper,
            thread_name="mxtpu-torch-fleet-barrier")
    _log.info("fleet up: rank %d of %d hosts", rank, world)
    return Fleet(rank, world, membership=mem, fleet_dir=fleet_dir,
                 collective_timeout_s=collective_timeout_s,
                 bringup_timeout_s=timeout_s)


def maybe_host_loss(step):
    """Fault point for sudden host death (``host_loss@step``):
    ``os._exit(EXIT_HOST_LOSS)``, no cleanup and no ``left``. Call at the
    top of the step, before its collectives."""
    from . import resilience
    if resilience.inject("host_loss", step):
        _log.error("injected host_loss at step %d: exiting %d",
                   step, EXIT_HOST_LOSS)
        os._exit(EXIT_HOST_LOSS)


def replica_fingerprint(params):
    """The divergence fingerprint of the replicated weights (``params``,
    Parameters or NDArrays): ``[float32 sum, int fold]`` of their values,
    the same on every host of a healthy fleet (a ZeRO-1 rank's own rows
    and states would differ by design). One transfer."""
    from .optimizer_fused import _fingerprint
    ts = [(p.data() if hasattr(p, "data") and callable(p.data) else p)._data
          for p in params]
    fsum, fold = _fingerprint([t.detach() for t in ts])
    return [float(fsum), float(fold)]


# ------------------------------------------------ fleet collective watchdog
class FleetCollectiveWatchdog:
    """The step-wedge watchdog with a FIXED deadline ``timeout_s`` (0:
    off): after a host loss the first collective wedges before any rolling
    baseline exists. ``arm`` before the step, ``disarm`` in its finally; a
    trip reads the board's diagnosis, dumps
    ``flight_record("fleet_collective_wedge")``, counts ``fleet.wedges``
    and with ``exit_on_trip`` calls ``exit_fn(EXIT_FLEET_WEDGE)`` (default
    ``os._exit``) from the scanning thread. A tripped watchdog refuses the
    next ``arm``. ``poll()`` scans now (fake-clock tests)."""

    def __init__(self, membership=None, timeout_s=COLLECTIVE_TIMEOUT_S,
                 clock=None, exit_on_trip=False, exit_fn=None):
        self.membership = membership
        self.timeout_s = float(timeout_s or 0.0)
        self._clock = time.monotonic if clock is None else clock
        self._exit_on_trip = bool(exit_on_trip)
        self._exit_fn = exit_fn if exit_fn is not None else os._exit
        self._lock = threading.Lock()
        self._entries = []
        self._tripped = None
        self._monitor = None
        self._monitor_stop = None

    def arm(self, step, what="collective"):
        self._check_poisoned()
        if self.timeout_s <= 0:
            return None
        now = self._clock()
        entry = {"step": int(step), "what": what, "t0": now,
                 "deadline": now + self.timeout_s}
        with self._lock:
            self._entries.append(entry)
        return entry

    def disarm(self, entry):
        if entry is None:
            return
        with self._lock:
            if entry in self._entries:
                self._entries.remove(entry)
        self._check_poisoned()

    def poll(self):
        """Scan now; raises :class:`FleetWedgeError` on a trip."""
        tripped = self._scan()
        if tripped:
            raise FleetWedgeError(self._describe(tripped[0]))

    def _check_poisoned(self):
        if self._tripped is not None:
            raise FleetWedgeError(self._describe(self._tripped))

    def _diagnosis(self):
        if self.membership is None:
            return {"dead": None, "board": "no membership view attached"}
        try:
            dead = self.membership.dead_hosts()
            return {"dead": dead, "coordinator_dead": 0 in dead,
                    "board": self.membership.describe()}
        except Exception as e:  # noqa: BLE001 - a dead disk still trips
            return {"dead": None, "board": "membership read failed: %s" % e}

    def _describe(self, e):
        diag = self._diagnosis()
        return ("fleet %s at step %d wedged: no completion within %.1fs "
                "(the fleet's collective bound); dead hosts: %s - %s. "
                "Flight artifact dumped (reason=fleet_collective_wedge)."
                % (e["what"], e["step"], self.timeout_s, diag.get("dead"),
                   diag.get("board")))

    def _scan(self):
        now = self._clock()
        with self._lock:
            tripped = [e for e in self._entries if now > e["deadline"]]
            for e in tripped:
                self._entries.remove(e)
        for e in tripped:
            self._trip(e, now)
        return tripped

    def _trip(self, e, now):
        from . import telemetry
        self._tripped = e
        telemetry.inc("fleet.wedges")
        telemetry.flight_record(
            "fleet_collective_wedge",
            extra={"step": e["step"], "what": e["what"],
                   "elapsed_s": now - e["t0"], "bound_s": self.timeout_s,
                   "diagnosis": self._diagnosis()})
        _log.error("%s", self._describe(e))
        if self._exit_on_trip:
            self._exit_fn(EXIT_FLEET_WEDGE)

    def start_monitor(self, interval_s=0.25):
        """Scan on a daemon thread every ``interval_s`` (idempotent; none
        when off)."""
        if self.timeout_s <= 0:
            return self
        if self._monitor is not None and self._monitor.is_alive():
            return self
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self._scan()
                except Exception:  # noqa: BLE001 - the scan must never die
                    _log.exception("fleet wedge monitor scan failed")
        t = threading.Thread(target=loop, daemon=True,
                             name="mxtpu-torch-fleet-wedge-monitor")
        self._monitor, self._monitor_stop = t, stop
        t.start()
        return self

    def stop_monitor(self):
        if self._monitor_stop is not None:
            self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        self._monitor = self._monitor_stop = None


# ------------------------------------------------------- fleet supervisor
def bootstrap_argv(bootstrap):
    """The flags of ``python -m mxtpu_torch.fleet_worker`` that carry a
    child's bootstrap (``--coordinator``, ``--world``, ``--rank``,
    ``--fleet-dir``, ``--ckpt-dir``, ``--compile-cache-dir``,
    ``--faults``); keys that are None are left out."""
    flags = (("coordinator", "--coordinator"), ("world", "--world"),
             ("rank", "--rank"), ("fleet_dir", "--fleet-dir"),
             ("ckpt_dir", "--ckpt-dir"),
             ("compile_cache_dir", "--compile-cache-dir"),
             ("faults", "--faults"))
    argv = []
    for key, flag in flags:
        if bootstrap.get(key) is not None:
            argv += [flag, str(bootstrap[key])]
    return argv


class FleetSupervisor:
    """``resilience.TrainSupervisor``'s fleet mode: N children a
    generation, one a host.

    ``command_for(rank, world, generation, bootstrap)`` returns a child's
    argv; ``bootstrap`` is ``{"coordinator": "127.0.0.1:<fresh port>",
    "world", "rank", "generation", "fleet_dir": <fleet_dir>/gen_<g>,
    "ckpt_dir", "compile_cache_dir", "faults": faults_for(rank, world,
    generation)}`` (:func:`bootstrap_argv` spells it as the worker's
    flags). ``env_for`` adds to a child's environment. :meth:`launch_round`
    reaps every child under the hard ``timeout_s`` (600 s).

    :meth:`run` is the elastic loop: a generation where a child died with
    a host-level code (``LOST_CODES``) relaunches on the survivors
    (``host_loss``); a reshaped generation that crashes WITH checkpoint
    progress grows back to full size (``rejoin_attempt``); two failed
    generations at the same checkpoint step (poison) or a spent
    ``max_restarts`` (crash loop) refuse with ``SupervisorRefusal`` after a
    ``supervisor_refusal`` artifact. The budget and backoff defaults are
    ``TrainSupervisor``'s. ``launch``/``clock``/``sleeper``/``rng``/
    ``latest_fn`` may be injected."""

    # this child's host is gone (the next world shrinks by these) vs. a
    # healthy victim of another's death (it relaunches)
    LOST_CODES = (EXIT_HOST_LOSS, EXIT_REJOIN_STALL, -9, -15)
    VICTIM_CODES = (EXIT_FLEET_WEDGE, "timeout")

    def __init__(self, command_for, num_hosts, ckpt_dir=None, fleet_dir=None,
                 max_restarts=None, backoff_s=None, max_backoff_s=60.0,
                 timeout_s=None, min_hosts=1, rejoin=True, env_for=None,
                 launch=None, clock=None, sleeper=None, rng=None,
                 latest_fn=None, logger=None, faults_for=None,
                 compile_cache_dir=None):
        from .resilience import TrainSupervisor
        if num_hosts < 1:
            raise MXNetError("FleetSupervisor needs num_hosts >= 1")
        self.command_for = command_for
        self.num_hosts = int(num_hosts)
        self.min_hosts = int(min_hosts)
        self.rejoin = bool(rejoin)
        self.ckpt_dir = ckpt_dir
        self.fleet_dir = fleet_dir
        self.compile_cache_dir = compile_cache_dir
        self.faults_for = faults_for
        self.max_restarts = TrainSupervisor.MAX_RESTARTS \
            if max_restarts is None else int(max_restarts)
        self.backoff_s = TrainSupervisor.BACKOFF_S if backoff_s is None \
            else float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.timeout_s = CHILD_TIMEOUT_S if timeout_s is None \
            else float(timeout_s)
        self.env_for = env_for
        self._launch = self.launch_round if launch is None else launch
        self._clock = time.monotonic if clock is None else clock
        self._sleeper = time.sleep if sleeper is None else sleeper
        self._rng = rng
        self._latest_fn = latest_fn
        self._log = logger or _log
        self.restarts = 0
        self.history = []   # membership events
        self.rounds = []    # launch_round's timings, one a generation

    def _event(self, event, **detail):
        rec = {"event": event, **detail}
        self.history.append(rec)
        self._log.info("fleet supervisor: %s %s", event, detail)
        return rec

    def _latest(self):
        if self._latest_fn is not None:
            return self._latest_fn()
        if self.ckpt_dir is None:
            return None
        from .contrib import async_checkpoint as ackpt
        try:
            return ackpt.latest_step(self.ckpt_dir)
        except Exception:  # noqa: BLE001 - a broken dir reads as fresh
            return None

    # --------------------------------------------------------------- launch
    @staticmethod
    def _free_port():
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def bootstrap(self, rank, world, generation, port):
        return {"coordinator": "127.0.0.1:%d" % port, "world": int(world),
                "rank": int(rank), "generation": int(generation),
                "fleet_dir": None if self.fleet_dir is None else
                os.path.join(str(self.fleet_dir), "gen_%d" % generation),
                "ckpt_dir": self.ckpt_dir,
                "compile_cache_dir": self.compile_cache_dir,
                "faults": None if self.faults_for is None
                else self.faults_for(rank, world, generation)}

    def launch_round(self, world, generation, extra_env=None):
        """Launch one generation on a fresh rendezvous port and reap every
        child under the hard deadline. Returns ``{rank: (rc, tail)}``, rc
        the exit code or ``"timeout"`` for a child killed at the deadline,
        tail the end of its output (stdout and stderr, through a file, so
        a chatty child never blocks on a full pipe). ``rounds[-1]`` keeps
        the round: each child's exit time from the launch and the
        results."""
        import subprocess
        port = self._free_port()
        procs, files = {}, {}
        t0 = time.monotonic()
        try:
            for rank in range(world):
                env = dict(os.environ)
                if extra_env:
                    env.update(extra_env)
                if self.env_for is not None:
                    env.update(self.env_for(rank, world, generation) or {})
                boot = self.bootstrap(rank, world, generation, port)
                files[rank] = tempfile.TemporaryFile(mode="w+")
                procs[rank] = subprocess.Popen(
                    self.command_for(rank, world, generation, boot), env=env,
                    stdout=files[rank], stderr=subprocess.STDOUT, text=True)
            exits = {}
            deadline = t0 + self.timeout_s
            while len(exits) < len(procs) and time.monotonic() < deadline:
                for rank, p in procs.items():
                    if rank not in exits and p.poll() is not None:
                        exits[rank] = (p.returncode, time.monotonic() - t0)
                time.sleep(0.02)
            out = {}
            for rank, p in procs.items():
                if rank not in exits:
                    p.kill()
                    p.wait()
                    exits[rank] = ("timeout", time.monotonic() - t0)
                    self._log.error(
                        "fleet child rank %d/%d (gen %d) hit the %.0fs hard "
                        "timeout and was killed", rank, world, generation,
                        self.timeout_s)
                f = files[rank]
                f.seek(0)
                out[rank] = (exits[rank][0], f.read()[-TAIL_CHARS:])
        finally:
            for p in procs.values():   # never leave a child running
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files.values():
                f.close()
        self.rounds.append({"generation": int(generation),
                            "world": int(world),
                            "wall_s": time.monotonic() - t0,
                            "exits": {r: {"rc": rc, "exit_s": s}
                                      for r, (rc, s) in exits.items()},
                            "results": out})
        return out

    # ------------------------------------------------------------------ run
    def run(self, extra_env=None):
        """Drive generations until one exits clean everywhere (returns its
        per-rank results) or a refusal raises."""
        from . import telemetry
        from .resilience import _next_backoff, _process_rng, _refuse
        delay = self.backoff_s
        prev_crash_step = ()   # sentinel: no failed generation yet
        generation = 0
        world = self.num_hosts
        while True:
            resume_step = self._latest()
            self._event("launch", generation=generation, world=world,
                        resume_step=resume_step)
            results = self._launch(world, generation, extra_env)
            rcs = {r: (v[0] if isinstance(v, tuple) else v)
                   for r, v in results.items()}
            failed = {r: rc for r, rc in rcs.items() if rc != 0}
            if not failed:
                self._event("clean_exit", generation=generation, world=world)
                return results
            crash_step = self._latest()
            lost = sorted(r for r, rc in failed.items()
                          if rc in self.LOST_CODES)
            victims = sorted(r for r, rc in failed.items()
                             if rc in self.VICTIM_CODES)
            if not lost and victims:
                # a wedge means a peer stopped answering, but none owned
                # up: the highest-ranked victim counts as lost, so the
                # fleet shrinks instead of flapping at a size that fails
                lost = [victims[-1]]
                victims = victims[:-1]
            self._event("crash", generation=generation, world=world,
                        exit_codes={str(r): rc for r, rc in rcs.items()},
                        ckpt_step=crash_step, lost=lost, victims=victims)
            if crash_step is not None and crash_step == prev_crash_step:
                raise _refuse(
                    "the fleet crashed twice at checkpoint step %s with "
                    "ZERO progress in between (exit codes %s): a "
                    "deterministic poison-crash; respawning replays it "
                    "forever. Inspect the flight artifacts before "
                    "restarting by hand." % (crash_step, failed),
                    self.history, self._log)
            if self.restarts >= self.max_restarts:
                raise _refuse(
                    "crash-loop budget spent: %d fleet restarts with "
                    "children still dying (last exit codes %s, last "
                    "checkpoint step %s); refusing to flap further"
                    % (self.restarts, failed, crash_step),
                    self.history, self._log)
            progressed = crash_step is not None and (
                prev_crash_step == () or crash_step != prev_crash_step)
            prev_crash_step = crash_step
            self.restarts += 1
            generation += 1
            telemetry.inc("supervisor.restarts", tag="fleet")
            if lost and world - len(lost) >= self.min_hosts:
                world = world - len(lost)
                self._event("host_loss", ranks=lost, world=world,
                            ckpt_step=crash_step)
            elif self.rejoin and progressed and world < self.num_hosts:
                world = self.num_hosts
                self._event("rejoin_attempt", world=world,
                            ckpt_step=crash_step)
            self._sleeper(delay)
            delay = _next_backoff(self._rng or _process_rng(),
                                  self.backoff_s, delay, self.max_backoff_s)
