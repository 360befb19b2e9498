"""Checkpoints of a block, a Trainer or a ShardedTrainStep, optionally
written on a thread while training goes on (counterpart of
``mxtpu/contrib/async_checkpoint.py``).

The reference writes orbax OCDBT. The card's machine has no orbax, so the
port writes a format of its own; it cannot read the JAX package's orbax
directories, nor the JAX package its (ROADMAP §C). A step is a directory
``<dir>/step_<n>`` holding, per rank ``r``, ``rank<r>.npz`` (host copies
of the arrays, keyed positionally: ``p<j>`` the parameters in order,
``s<j>_<k>`` the k-th leaf of parameter j's optimizer state, ``g<k>``
the guard's scalars) and ``rank<r>.json``, the manifest: the CRC32 of
every array's bytes, the dtypes (bfloat16 is stored as its 16-bit
pattern), the state structure and the pickled host state (the optimizer
with its update counts, the scaler's configuration, the generators'
states). The directory is written under a temporary name and renamed
into place, so a present ``step_<n>`` is always whole. The reference's
rules hold:

* ``force`` guards an overwrite of a finalized step;
* a restore verifies every array against the manifest before it writes
  anything; on a mismatch the step gets a tombstone
  (``step_<n>.corrupt.json``) and ``CheckpointCorrupt`` raises;
* ``save_trainer`` deletes finalized steps older than the newest
  ``resilience.ckpt_keep()`` intact ones (0: keep all); tombstoned steps
  never count as keepers;
* ``latest_step`` reads ``latest.json`` when its step is finalized and
  intact, else the newest finalized intact step;
  ``load_trainer_fallback`` walks back from the newest intact step.

``async_save=True`` copies the device arrays into pinned host buffers on
a side CUDA stream, records an event, makes the current stream wait for
it (training writes no parameter before its copy is taken; the host does
not wait) and writes on a thread; the next save, or
``wait_until_finished()``, waits for the write and re-raises its error.
Fault kinds: ``ckpt_io`` (a save attempt raises ``OSError``) and
``ckpt_corrupt`` (the saved updater state's first byte flips after the
manifest is made).
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save_block", "load_block", "save_train_step",
           "load_train_step", "save_trainer", "load_trainer",
           "load_trainer_fallback", "latest_step",
           "load_trainer_params_into_block", "CheckpointCorrupt"]

_log = logging.getLogger("mxtpu_torch.resilience")


class CheckpointCorrupt(MXNetError):
    """A step's bytes disagree with its manifest; the step is tombstoned
    on raise, so later scans skip it."""


# ------------------------------------------------------------- the writer
class _Writer:
    """One save: the host copies (pinned, filled on a side stream on the
    card) and the thread that writes them. ``wait_until_finished``
    re-raises the write's error."""

    def __init__(self):
        self._thread = None
        self._error = None
        self.snapshot_s = None
        self.write_s = None

    def wait_until_finished(self):
        t = self._thread
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise err
        return self


_ASYNC = {"last": None, "lock": threading.Lock()}
_SIDE = {}   # device -> the copy stream


def _pending():
    """Wait for the previous asynchronous save and re-raise its error."""
    with _ASYNC["lock"]:
        last, _ASYNC["last"] = _ASYNC["last"], None
    if last is not None:
        last.wait_until_finished()


def _host_copies(tensors, async_save):
    """(host arrays or pinned tensors, event or None): a copy of each
    tensor taken in stream order. On the card with ``async_save`` the
    copies run on a side stream after the current one's work, and the
    current stream waits for them (no host sync)."""
    cuda = [t for t in tensors if t is not None and t.is_cuda]
    if not cuda or not async_save:
        return [None if t is None else t.detach().cpu() for t in tensors], \
            None
    dev = cuda[0].device
    side = _SIDE.get(dev)
    if side is None:
        side = _SIDE[dev] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    out = []
    with torch.cuda.stream(side):
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t.detach(), non_blocking=True)
            t.record_stream(side)
            out.append(h)
    event = torch.cuda.Event()
    event.record(side)
    cur.wait_event(event)   # nothing later on the step's stream writes first
    return out, event


def _to_numpy(t):
    """(numpy array, dtype name) of a host tensor; bfloat16 as its
    16-bit pattern."""
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), name
    return t.numpy(), name


def _from_numpy(a, name):
    t = torch.from_numpy(np.array(a, copy=True))
    if name == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def _crc(a):
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _step_dir(directory, step):
    return os.path.join(os.path.abspath(str(directory)), "step_%d" % step)


def _tombstone_path(step_dir):
    return step_dir + ".corrupt.json"


def _is_tombstoned(step_dir):
    return os.path.exists(_tombstone_path(step_dir))


def _write_tombstone(step_dir, reason):
    try:
        with open(_tombstone_path(step_dir), "w") as f:
            json.dump({"reason": str(reason), "t": time.time()}, f)
    except OSError:
        pass


def _clear_tombstone(step_dir):
    try:
        os.remove(_tombstone_path(step_dir))
    except OSError:
        pass


def _finalized_steps(directory):
    """Ascending steps with a finalized directory (tombstoned or not)."""
    try:
        names = os.listdir(str(directory))
    except OSError:
        return []
    steps = []
    for n in names:
        if n.startswith("step_") and \
                os.path.isdir(os.path.join(str(directory), n)):
            try:
                steps.append(int(n[5:]))
            except ValueError:
                pass
    return sorted(steps)


def _guard_overwrite(step_dir, force):
    if not force and os.path.exists(step_dir):
        raise MXNetError("checkpoint step directory %s already exists; pass "
                         "force=True to overwrite it" % step_dir)


def _rank():
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _write_rank(staging, rank, arrays, meta, corrupt):
    """Write one rank's arrays and manifest into ``staging`` (CRCs from
    the host copies, the ``ckpt_corrupt`` flip after them)."""
    host = {}
    crc, dtypes = {}, {}
    for k, t in arrays.items():
        a, name = _to_numpy(t)
        host[k] = a
        crc[k] = _crc(a)
        dtypes[k] = name
    if corrupt and corrupt in host:
        a = host[corrupt].copy()
        a.view(np.uint8).reshape(-1)[:1] ^= 0xFF
        host[corrupt] = a
    np.savez(os.path.join(staging, "rank%d.npz" % rank), **host)
    with open(os.path.join(staging, "rank%d.json" % rank), "w") as f:
        json.dump(dict(meta, crc=crc, dtypes=dtypes), f)


def _finalize(staging, step_dir):
    """The atomic rename that makes a step visible (an old one of the same
    step goes first)."""
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir, ignore_errors=True)
    os.replace(staging, step_dir)


def _save(directory, step, arrays_fn, meta, async_save, force,
          corrupt=None, world=1, barrier=None):
    """Snapshot ``arrays_fn()`` (``{key: tensor}``) and write it as step
    ``step`` (module docstring). Returns the writer."""
    _pending()
    sd = _step_dir(directory, step)
    rank = _rank()
    if rank and barrier is None:   # one writer: the ranks' copies agree
        # (the writer alone guards: it may have finalized the step before
        # this rank got here)
        return _Writer()
    _guard_overwrite(sd, force)
    os.makedirs(os.path.dirname(sd), exist_ok=True)
    staging = sd + ".partial"
    if rank == 0:
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    keys_tensors = arrays_fn()
    keys = list(keys_tensors)
    copies, event = _host_copies([keys_tensors[k] for k in keys],
                                 async_save)
    w = _Writer()
    w.snapshot_s = time.perf_counter() - t0

    def write():
        t1 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            _write_rank(staging, rank, dict(zip(keys, copies)), meta,
                        corrupt)
            if barrier is not None:
                barrier()
            if rank == 0:
                _finalize(staging, sd)
                _clear_tombstone(sd)
        except BaseException as e:  # noqa: BLE001 - re-raised at the wait
            w._error = e
        w.write_s = time.perf_counter() - t1

    if async_save and barrier is None:
        w._thread = threading.Thread(target=write, daemon=True,
                                     name="mxtpu-torch-ckpt-write")
        w._thread.start()
        with _ASYNC["lock"]:
            _ASYNC["last"] = w
    else:
        write()
        w.wait_until_finished()
    return w


def _read_rank(step_dir, rank=0, verify=True):
    """(arrays as tensors, manifest) of one rank of a finalized step,
    verified against the manifest (a mismatch tombstones and raises)."""
    with open(os.path.join(step_dir, "rank%d.json" % rank)) as f:
        meta = json.load(f)
    with np.load(os.path.join(step_dir, "rank%d.npz" % rank)) as z:
        host = {k: z[k] for k in z.files}
    if verify:
        bad = [k for k, c in meta["crc"].items()
               if k not in host or _crc(host[k]) != c]
        if bad:
            _write_tombstone(step_dir, "checksum mismatch: %s"
                             % ",".join(bad))
            raise CheckpointCorrupt(
                "checkpoint %s failed integrity verification: the bytes of "
                "%s disagree with the save-time checksum manifest (disk "
                "corruption or a torn write); the step is tombstoned, "
                "restore falls back to the next-newest intact step"
                % (step_dir, ", ".join(bad)))
    return {k: _from_numpy(a, meta["dtypes"][k]) for k, a in host.items()}, \
        meta


def _gc_steps(directory, keep):
    """Delete finalized steps older than the newest ``keep`` intact ones
    (nothing without an intact keeper). Returns the deleted steps."""
    if not keep or keep <= 0 or _rank() != 0:
        return []
    steps = _finalized_steps(directory)
    intact = [s for s in steps
              if not _is_tombstoned(_step_dir(directory, s))]
    keepers = intact[-int(keep):]
    if not keepers:
        return []
    deleted = []
    for s in steps:
        if s >= keepers[0]:
            continue
        sd = _step_dir(directory, s)
        shutil.rmtree(sd, ignore_errors=True)
        _clear_tombstone(sd)
        deleted.append(s)
    if deleted:
        _log.info("checkpoint GC: deleted steps %s (keep=%d, newest intact "
                  "%s)", deleted, keep, keepers[-1])
    return deleted


def latest_step(directory):
    """Newest resumable step (module docstring), or None."""
    d = str(directory)
    try:
        with open(os.path.join(d, "latest.json")) as f:
            candidate = int(json.load(f)["step"])
    except (OSError, ValueError, KeyError, TypeError):
        candidate = None
    if candidate is not None and os.path.isdir(_step_dir(d, candidate)) \
            and not _is_tombstoned(_step_dir(d, candidate)):
        return candidate
    steps = [s for s in _finalized_steps(d)
             if not _is_tombstoned(_step_dir(d, s))]
    return max(steps) if steps else None


# ------------------------------------------------------------------ blocks
def _block_params(block, who):
    params = list(block.collect_params().values())
    if not params or any(not p.initialized for p in params):
        raise MXNetError("initialize the block (and settle deferred shapes "
                         "with one forward) before %s" % who)
    return params


def _put_params(params, arrays):
    with torch.no_grad():
        for j, p in enumerate(params):
            t = p.data()._data
            src = arrays["p%d" % j]
            if tuple(src.shape) != tuple(t.shape):
                raise MXNetError("checkpoint parameter %d has shape %s, the "
                                 "live one %s" % (j, tuple(src.shape),
                                                  tuple(t.shape)))
            t.copy_(src.to(device=t.device, dtype=t.dtype))


def save_block(block, directory, step=0, async_save=False, force=False):
    """Write the block's parameters; returns the writer (call
    ``wait_until_finished()`` on an asynchronous save)."""
    params = _block_params(block, "checkpointing")
    return _save(directory, step,
                 lambda: {"p%d" % j: p.data()._data
                          for j, p in enumerate(params)},
                 {"kind": "block", "n_params": len(params)}, async_save,
                 force)


def load_block(block, directory, step=0):
    """Restore the parameters in place (positional keys)."""
    params = _block_params(block, "load_block")
    arrays, _ = _read_rank(_step_dir(directory, step))
    _put_params(params, arrays)
    return block


# ------------------------------------------------------------ gluon Trainer
def _trainer_updater(trainer):
    if not trainer._kv_initialized:
        trainer._init_kvstore()
    if trainer._update_on_kvstore:
        return trainer._kvstore._updater
    return trainer._updaters[0]


def _flat_state(state, key, out):
    """Flatten an optimizer state into ``out`` (``key_k`` -> tensor);
    returns its nesting with the keys in place of the leaves."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_flat_state(s, key, out) for s in state)
    k = "%s_%d" % (key, len(out.get(key + "#", [])))
    out.setdefault(key + "#", []).append(k)
    out[k] = state._data
    return k


def _rng_states():
    from .. import random as _random
    return {"seed": _random._STATE.seed,
            "gens": [(str(dev), gen.get_state().numpy().tobytes().hex())
                     for dev, gen in _random._STATE.gens.items()]}


def _set_rng_states(saved):
    from .. import random as _random
    _random._STATE.seed = int(saved["seed"])
    for dev, hexstate in saved["gens"]:
        if dev.startswith("cuda") and not torch.cuda.is_available():
            continue
        _random.generator(dev).set_state(torch.frombuffer(
            bytearray.fromhex(hexstate), dtype=torch.uint8))


def _trainer_arrays(trainer, upd, params):
    """({key: tensor}, host meta) of a Trainer: its parameters, its
    updater's states, the guard's scalars, and the pickled optimizer."""
    arrays = {"p%d" % j: p.data()._data for j, p in enumerate(params)}
    structure = {}
    flat = {}
    states = upd.states
    if getattr(upd, "_plan", None) is not None and upd._views:
        blob = upd.get_states(dump_optimizer=False)   # whole ZeRO-1 states
        host_states = pickle.loads(blob)
        if isinstance(host_states, tuple):
            host_states = pickle.loads(host_states[1]["base"])
        from ..optimizer import _state_from_numpy
        states = {i: _state_from_numpy(v) for i, v in host_states.items()}
    for i, st in states.items():
        structure[str(i)] = _flat_state(st, "s%d" % i, flat)
    arrays.update({k: v for k, v in flat.items() if not k.endswith("#")})
    guard = {}
    if upd._t_good is not None:
        arrays["g_t"] = upd._t_good
        guard["t"] = True
    if upd.scaler is not None:
        arrays["g_scale"] = upd.scaler._ensure()
        arrays["g_streak"] = upd.scaler._streak
        guard["scaler"] = [upd.scaler._init] + list(upd.scaler.config())
    pd, upd.optimizer.param_dict = upd.optimizer.param_dict, {}
    try:
        opt_blob = pickle.dumps(upd.optimizer).hex()
    finally:
        upd.optimizer.param_dict = pd
    meta = {"kind": "trainer", "n_params": len(params),
            "structure": structure, "guard": guard, "optimizer": opt_blob,
            "rng": _rng_states()}
    return arrays, meta


def save_trainer(trainer, directory, step=0, async_save=False, force=False):
    """Checkpoint a gluon Trainer: parameters, optimizer states and
    optimizer (update counts, schedules), the loss scaler and the guard's
    ``t``, and the generators: everything a bit-exact resume needs.
    Returns the writer; finalized steps past ``resilience.ckpt_keep()``
    are deleted after the save (an asynchronous one's own step is not
    finalized yet, so it never counts). On a mesh every rank calls it
    (a ZeRO-1 state is gathered whole, a collective) and the first rank
    writes."""
    from .. import telemetry
    from ..resilience import ckpt_keep, inject
    if inject("ckpt_io"):
        raise OSError("injected checkpoint IO failure (fault kind ckpt_io)")
    upd = _trainer_updater(trainer)
    params = [p for p in trainer._params if p.initialized]
    if not params:
        raise MXNetError("initialize the parameters before checkpointing")
    t0 = time.perf_counter()
    arrays, meta = _trainer_arrays(trainer, upd, params)
    corrupt = None
    if inject("ckpt_corrupt"):
        corrupt = next((k for k in arrays if k.startswith("s")), "p0")
    w = _save(directory, step, lambda: arrays, meta, async_save, force,
              corrupt)
    telemetry.observe("checkpoint.save_s", time.perf_counter() - t0)
    telemetry.inc("checkpoint.saves")
    _gc_steps(directory, ckpt_keep())
    return w


def _unflat(key_struct, arrays):
    from ..ndarray import NDArray
    if key_struct is None:
        return None
    if isinstance(key_struct, (list, tuple)):
        return tuple(_unflat(k, arrays) for k in key_struct)
    return NDArray(arrays[key_struct])


def _check_trainer_meta(meta, params, who, sd):
    if meta.get("n_params") not in (None, len(params)):
        raise MXNetError(
            "trainer checkpoint at %s holds %s parameters, this %s has %d; "
            "the model that saved must match the one restoring (positional "
            "keys)" % (sd, meta.get("n_params"), who, len(params)))


def load_trainer(trainer, directory, step=0):
    """Restore a gluon Trainer in place from ``save_trainer``'s step:
    parameters (copied into their storage), optimizer states and
    optimizer, the scaler and ``t``, the generators. Verified first: a
    corrupt step restores nothing. The states are whole (a ZeRO-1 save
    gathers them), so a mesh of any size restores them: each rank's
    ``MeshPlan`` cuts its rows at their first use
    (``FusedUpdater._state``), whatever mesh saved them."""
    upd = _trainer_updater(trainer)
    params = [p for p in trainer._params if p.initialized]
    sd = _step_dir(directory, step)
    with open(os.path.join(sd, "rank0.json")) as f:
        _check_trainer_meta(json.load(f), params, "trainer", sd)
    arrays, meta = _read_rank(sd)
    _put_params(params, arrays)
    opt = pickle.loads(bytes.fromhex(meta["optimizer"]))
    states = {int(i): _unflat(ks, arrays)
              for i, ks in meta["structure"].items()}
    upd.optimizer = opt
    upd.states = states
    upd.states_synced = {k: False for k in states}
    trainer._optimizer = opt
    opt.param_dict = dict(enumerate(trainer._params))
    for u in trainer._updaters:
        u.optimizer = opt
    guard = meta.get("guard") or {}
    if guard.get("t"):
        t = int(arrays["g_t"])
        if upd._t_good is not None:
            upd._t_good.fill_(t)
        else:
            upd._t_restored = t
    if guard.get("scaler"):
        if upd.scaler is None:
            _log.warning("checkpoint carries DynamicLossScaler state but no "
                         "loss scaler is attached; continuing UNSCALED")
        else:
            upd.scaler.load_state_dict({"scale": arrays["g_scale"],
                                        "streak": arrays["g_streak"]})
    _set_rng_states(meta["rng"])
    return trainer


def load_trainer_fallback(trainer, directory, logger=None):
    """Try the finalized intact steps newest first; a corrupt step (or one
    that fails to read) falls back one tier, counted in
    ``checkpoint.restore_fallbacks{reason}``. Returns the step restored,
    or None. A structure mismatch raises."""
    from .. import telemetry
    log = logger or _log
    steps = [s for s in _finalized_steps(directory)
             if not _is_tombstoned(_step_dir(directory, s))]
    for step in reversed(steps):
        try:
            load_trainer(trainer, directory, step=step)
            return step
        except CheckpointCorrupt as e:
            telemetry.inc("checkpoint.restore_fallbacks", tag="checksum")
            log.warning("checkpoint step %d failed integrity verification; "
                        "falling back one tier (%s)", step, e)
        except MXNetError:
            raise
        except Exception as e:  # noqa: BLE001 - a garbled step directory
            telemetry.inc("checkpoint.restore_fallbacks", tag="error")
            log.warning("checkpoint step %d failed to restore (%s: %s); "
                        "falling back one tier", step, type(e).__name__, e)
    return None


def load_trainer_params_into_block(block, directory, step=None):
    """Restore only the parameters of a ``save_trainer`` step (the newest
    when ``step`` is None) into ``block`` (the serving restore; the
    optimizer state and generators stay on disk). Returns the step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise MXNetError("no finalized checkpoint step under %s"
                             % directory)
    params = _block_params(block, "load_trainer_params_into_block")
    sd = _step_dir(directory, step)
    arrays, meta = _read_rank(sd)
    _check_trainer_meta(meta, params, "block", sd)
    _put_params(params, arrays)
    return step


# ------------------------------------------------------- ShardedTrainStep
def save_train_step(train_step, directory, step=0, async_save=False,
                    force=False):
    """Checkpoint a ``parallel.ShardedTrainStep``: each rank writes its
    own parameters (a sharded parameter's shard) and optimizer states
    (under ZeRO-1 its rows) as ``rank<r>.npz``; the first rank renames
    the step into place after every rank has written (a barrier on the
    mesh's process group)."""
    upd = train_step._updater
    params = train_step._params
    barrier = None
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        barrier = torch.distributed.barrier

    def arrays_fn():
        arrays = {"p%d" % j: p.data()._data for j, p in enumerate(params)}
        flat = {}
        for i, st in upd.states.items():
            _flat_state(st, "s%d" % i, flat)
        arrays.update({k: v for k, v in flat.items()
                       if not k.endswith("#")})
        return arrays

    flat = {}
    structure = {str(i): _flat_state(st, "s%d" % i, flat)
                 for i, st in upd.states.items()}
    meta = {"kind": "train_step", "n_params": len(params),
            "structure": structure, "num_update": train_step._num_update,
            "counts": {str(k): v for k, v in
                       train_step._opt._index_update_count.items()},
            "world": 1 if barrier is None
            else torch.distributed.get_world_size()}
    return _save(directory, step, arrays_fn, meta, async_save, force,
                 barrier=barrier)


def load_train_step(train_step, directory, step=0):
    """Restore a ``ShardedTrainStep`` in place from this rank's file."""
    upd = train_step._updater
    sd = _step_dir(directory, step)
    arrays, meta = _read_rank(sd, _rank())
    live = {str(i): _flat_state(st, "s%d" % i, {})
            for i, st in upd.states.items()}
    if {k: json.dumps(v) for k, v in live.items()} != \
            {k: json.dumps(v) for k, v in meta["structure"].items()} \
            and live:
        raise MXNetError(
            "optimizer state structure mismatch: the checkpoint's states "
            "are %s, this step's %s; momentum/optimizer settings must match "
            "the run that saved" % (meta["structure"], live))
    _put_params(train_step._params, arrays)
    states = {int(i): _unflat(ks, arrays)
              for i, ks in meta["structure"].items()}
    with torch.no_grad():
        for i, st in states.items():
            cur = upd.states.get(i)
            if cur is None:
                upd.states[i] = st
                continue
            for a, b in zip(_leaves(cur), _leaves(st)):
                a._data.copy_(b._data.to(a._data.device, a._data.dtype))
    train_step._num_update = int(meta["num_update"])
    train_step._opt._index_update_count = {
        int(k): v for k, v in meta["counts"].items()}
    train_step._opt.num_update = max(
        train_step._opt._index_update_count.values(), default=0)
    return train_step


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [state]
