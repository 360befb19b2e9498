"""Device memory views and the serving footprint ledger (the part of
``mxtpu/xprof.py`` that the model zoo reads; the rest of the module is
ROADMAP A9).

* ``device_memory(device)`` -- ``bytes_in_use``, ``bytes_limit``,
  ``peak_bytes_in_use`` and ``bytes_free`` of a device: the card's from
  ``torch.cuda`` (its total memory is the limit), and ``CPU_BYTES_LIMIT``
  as the host's limit.
* ``record_footprint(site, nbytes)`` / ``site_footprint(site, family)`` --
  the bytes a Predictor holds at its retrace site once it has warmed up:
  its parameter snapshot and static inputs, plus on the card the segments
  of its graphs' private memory pool and on the CPU its buckets' outputs.
  The reference prices a site from its XLA executables' ledger (donated
  arguments, temporaries, outputs), so the two packages' numbers differ by
  design; placement decisions are what the tests compare.
* ``preflight(site, ...)`` -- will-it-fit: the site's footprint (or a
  caller's estimate) plus the bytes its co-residents hold, against the
  device's limit; past it ``memory.overcommit{site}`` counts and a warning
  is logged, before the Predictor captures.
* ``drop(site)`` forgets a site's record (a zoo eviction, as the
  reference's ``compile_service.drop`` releases its executables).
"""
from __future__ import annotations

import logging
import threading

import torch

from . import telemetry
from .context import resolve_device

__all__ = ["device_memory", "record_footprint", "site_footprint", "drop",
           "preflight", "CPU_BYTES_LIMIT"]

_log = logging.getLogger("mxtpu_torch.xprof")

# the limit reported for the host: large enough that the count cap, not
# bytes, decides placement on the CPU unless a budget is given
CPU_BYTES_LIMIT = 1 << 40

_LOCK = threading.Lock()
_FOOTPRINTS = {}   # site -> bytes held after warm-up


def device_memory(device=None):
    """``{bytes_in_use, bytes_limit, peak_bytes_in_use, bytes_free}`` of a
    device (a ``torch.device``, a string or a CUDA index; None is
    ``cuda:0``)."""
    if device is None or isinstance(device, int):
        device = torch.device("cuda", device or 0)
    device = resolve_device(device)
    if device.type != "cuda":
        return {"bytes_in_use": 0, "bytes_limit": CPU_BYTES_LIMIT,
                "peak_bytes_in_use": 0, "bytes_free": CPU_BYTES_LIMIT}
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_free": int(free)}


def record_footprint(site, nbytes):
    """Record the bytes the Predictor at ``site`` holds after warm-up."""
    with _LOCK:
        _FOOTPRINTS[site] = int(nbytes)
    telemetry.gauge("memory.site_footprint_bytes", int(nbytes), tag=site)


def site_footprint(site, family=False):
    """The recorded bytes of ``site`` (0 when none); ``family=True`` adds
    its dotted sub-sites (``serving.predict.zoo.m`` covers its
    ``.canary``)."""
    with _LOCK:
        return sum(b for s, b in _FOOTPRINTS.items()
                   if s == site or (family and s.startswith(site + ".")))


def drop(site, family=True):
    """Forget ``site``'s record (and its sub-sites'); returns how many."""
    with _LOCK:
        gone = [s for s in _FOOTPRINTS
                if s == site or (family and s.startswith(site + "."))]
        for s in gone:
            del _FOOTPRINTS[s]
    return len(gone)


def preflight(site, device=None, limit=None, extra_bytes=0, need=None):
    """Will-it-fit: ``need`` (default: the site's recorded footprint) plus
    ``extra_bytes`` already held by co-residents against ``limit``
    (default: the device's). Past the limit it counts
    ``memory.overcommit{site}`` and warns. Returns ``(need_bytes,
    limit_bytes)``."""
    if limit is None:
        limit = device_memory(device)["bytes_limit"]
    need = (site_footprint(site) if need is None else int(need)) + \
        int(extra_bytes or 0)
    telemetry.gauge("memory.preflight_bytes", need, tag=site)
    if need > limit:
        telemetry.inc("memory.overcommit", tag=site)
        _log.warning(
            "memory pre-flight: site %r needs ~%.0f MiB (co-residents' %.0f "
            "MiB included) against the device's %.0f MiB: evict a "
            "co-resident model, shrink the buckets or store int8 weights",
            site, need / 2**20, (extra_bytes or 0) / 2**20, limit / 2**20)
    return need, limit
