"""Deterministic fault injection (counterpart of the fault-injection points
of ``mxtpu/resilience.py``).

``set_faults(spec)`` takes the spec string the JAX package reads from
``MXTPU_FAULT_INJECT``: ``kind@idx[,idx...]`` entries separated by ``;``.
``inject(kind, index)`` is True exactly once per scheduled (kind, index),
so a retry loop converges by construction; with ``index=None`` a per-kind
call counter supplies the index. The serving plane's kinds:
``serve_overload`` (submit index: that submit sheds), ``serve_timeout``
(batch index: that batch expires), ``replica_fail`` (dispatch index: the
replica raises), ``replica_wedge`` (dispatch index: the dispatch never
answers), ``decode_wedge`` (decode step index: that step never answers),
``oom`` (``maybe_oom``: the Predictor's dispatch or the decode loop raises
``ResourceExhausted``), ``zoo_cold`` (call count: that zoo submit sheds as
if its model were cold and unpageable) and ``canary_rollback`` (call
count: that canary gate evaluation rules a regression).

The training half of the reference's module (numerics sentinel, loss
scaling, preemption-safe checkpoints, watchdogs) is not ported yet.
"""
from __future__ import annotations

import logging

from . import telemetry
from .base import MXNetError

__all__ = ["set_faults", "inject", "reset_faults", "FAULT_STATS",
           "ResourceExhausted", "maybe_oom"]

_log = logging.getLogger("mxtpu_torch.resilience")

FAULT_STATS = {"fired": []}
_FAULTS = {"spec": "", "faults": {}}
_FAULT_COUNTERS = {}


def _parse_faults(spec):
    """``{kind: {indices}}`` from a spec string (the reference's parser)."""
    faults = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise MXNetError(
                "MXTPU_FAULT_INJECT entry %r: expected kind@idx[,idx...]"
                % part)
        kind, idxs = part.split("@", 1)
        try:
            where = {int(s) for s in idxs.split(",") if s.strip()}
        except ValueError:
            raise MXNetError(
                "MXTPU_FAULT_INJECT entry %r: indices must be ints" % part)
        faults.setdefault(kind.strip(), set()).update(where)
    return faults


def set_faults(spec):
    """Schedule the faults of ``spec`` (empty or None: none) and restart
    the per-kind call counters, as a changed ``MXTPU_FAULT_INJECT`` does in
    the JAX package. A malformed spec raises here."""
    spec = spec or ""
    _FAULTS["faults"] = _parse_faults(spec)
    _FAULTS["spec"] = spec
    _FAULT_COUNTERS.clear()


def inject(kind, index=None):
    """True exactly once per scheduled (``kind``, ``index``)."""
    faults = _FAULTS["faults"]
    if index is None:
        index = _FAULT_COUNTERS.get(kind, 0)
        _FAULT_COUNTERS[kind] = index + 1
    where = faults.get(kind)
    if not where or index not in where:
        return False
    where.discard(index)
    FAULT_STATS["fired"].append((kind, index))
    telemetry.inc("faults.injected", tag=kind)
    _log.warning("fault injected: %s@%d", kind, index)
    return True


def reset_faults():
    """Test hook: forget the schedule, its consumed faults and counters."""
    set_faults("")
    FAULT_STATS["fired"] = []


class ResourceExhausted(RuntimeError):
    """Injected device out-of-memory (fault kind ``oom``); the message
    carries the ``RESOURCE_EXHAUSTED`` prefix of the reference's."""


def maybe_oom(index=None):
    """Raise ``ResourceExhausted`` when the ``oom`` fault names this
    occurrence."""
    if inject("oom", index):
        raise ResourceExhausted(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            "(injected fault kind 'oom')")
