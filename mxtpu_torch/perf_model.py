"""Shared performance model: data-sheet peaks, the one MFU convention and
the roofline verdict (counterpart of ``mxtpu/perf_model.py``).

The table is keyed by ``torch.cuda.get_device_name`` (matched by
substring) and holds an H100 SXM's data-sheet figures, the peaks that
``PERF.md``'s bound column uses: 989 TFLOP/s bfloat16 dense on the tensor
cores, 67 TFLOP/s float32 on the CUDA cores (TF32 is off by the port's
precision policy) and 3.35 TB/s of HBM3. FLOPs count a multiply-add as 2.

``cost_dict``, ``flops_of`` and ``bytes_accessed_of`` read the entries of
the port's executable ledger (``xprof.ledger``: a dict with ``flops``
and, where known, ``bytes accessed``) where the reference reads XLA's
cost analysis; ``memory_dict`` reads ``torch.cuda.memory_stats()``.

The reference reads ``MXTPU_PEAK_TFLOPS``/``MXTPU_PEAK_GBPS``; the port
reads no environment variable: ``peak_flops(peak_tflops=)`` and
``peak_bandwidth(peak_gbps=)`` take the same override as an argument, and
``set_peak(tflops=, gbps=)`` sets it for the process. On the CPU, or on a
card the table lacks, the peaks are None unless set.
"""
from __future__ import annotations

__all__ = ["NOMINAL_PEAK_TFLOPS", "HBM_BANDWIDTH_GBPS",
           "nominal_tflops", "peak_flops", "peak_bandwidth",
           "critical_intensity", "mfu", "cost_dict", "flops_of",
           "bytes_accessed_of", "memory_dict", "roofline_verdict",
           "set_peak"]

# data-sheet dense peak per card, TFLOP/s, by compute type, matched by
# substring against the lower-cased device name
NOMINAL_PEAK_TFLOPS = {
    "h100": {"bfloat16": 989.0, "float16": 989.0, "float32": 67.0},
}

# data-sheet HBM bandwidth per card, GB/s
HBM_BANDWIDTH_GBPS = {
    "h100": 3350.0,
}

_OVERRIDE = {"tflops": None, "gbps": None}


def set_peak(tflops=None, gbps=None):
    """The reference's ``MXTPU_PEAK_TFLOPS``/``MXTPU_PEAK_GBPS`` for the
    process (None clears); returns the previous ``(tflops, gbps)``."""
    prev = (_OVERRIDE["tflops"], _OVERRIDE["gbps"])
    _OVERRIDE["tflops"] = None if tflops is None else float(tflops)
    _OVERRIDE["gbps"] = None if gbps is None else float(gbps)
    return prev


def _device_kind(device):
    """(type, lower-cased name) of ``device``: a ``torch.device``, a CUDA
    index, a device-name string (offline use) or None (``cuda:0``).
    ("cpu", "") off the card."""
    if isinstance(device, str) and ":" not in device \
            and device not in ("cuda", "cpu"):
        return ("cuda", device.lower())
    try:
        import torch
        if device is None or isinstance(device, int):
            if not torch.cuda.is_available():
                return ("cpu", "")
            device = torch.device("cuda", device or 0)
        device = torch.device(device)
        if device.type != "cuda":
            return (device.type, "")
        return ("cuda", torch.cuda.get_device_name(device).lower())
    except Exception:  # noqa: BLE001 - no CUDA runtime answers
        return ("unknown", "")


def _lookup(table, kind):
    for sub, v in table.items():
        if sub in kind:
            return v
    return None


def nominal_tflops(device=None, dtype="bfloat16"):
    """Data-sheet dense peak TFLOP/s of ``device`` for ``dtype``, or None
    off the card or for a card the table lacks."""
    platform, kind = _device_kind(device)
    if platform != "cuda":
        return None
    row = _lookup(NOMINAL_PEAK_TFLOPS, kind)
    if row is None:
        return None
    return row.get(str(dtype).replace("torch.", ""), row["bfloat16"])


def peak_flops(device=None, dtype="bfloat16", peak_tflops=None):
    """Peak FLOP/s for the MFU denominator: ``peak_tflops`` (or the
    process's ``set_peak``) first, else the table. None when MFU means
    nothing (the CPU, no override)."""
    over = peak_tflops if peak_tflops is not None else _OVERRIDE["tflops"]
    if over:
        return float(over) * 1e12
    t = nominal_tflops(device, dtype)
    return t * 1e12 if t else None


def peak_bandwidth(device=None, peak_gbps=None):
    """Data-sheet HBM bandwidth in bytes/s (``peak_gbps`` or ``set_peak``
    first), or None off the card."""
    over = peak_gbps if peak_gbps is not None else _OVERRIDE["gbps"]
    if over:
        return float(over) * 1e9
    platform, kind = _device_kind(device)
    if platform != "cuda":
        return None
    bw = _lookup(HBM_BANDWIDTH_GBPS, kind)
    return bw * 1e9 if bw else None


def critical_intensity(device=None, dtype="bfloat16"):
    """The roofline's ridge point, FLOPs a byte (None when a peak is
    unknown)."""
    pf, bw = peak_flops(device, dtype), peak_bandwidth(device)
    if not pf or not bw:
        return None
    return pf / bw


def mfu(flops_per_s, device=None, n_devices=1, dtype="bfloat16",
        peak_tflops=None):
    """Achieved FLOP/s as a share of the peak over ``n_devices`` cards;
    None when the peak is unknown."""
    pf = peak_flops(device, dtype, peak_tflops)
    if not pf or not flops_per_s:
        return None
    return float(flops_per_s) / (pf * max(int(n_devices), 1))


# ------------------------------------------------------ ledger accessors
def cost_dict(cost):
    """A ledger entry (or None, or a one-element list of one) as a plain
    dict; {} when absent."""
    if cost is None:
        return {}
    if isinstance(cost, (list, tuple)):
        if not cost:
            return {}
        cost = cost[0]
    if cost is None:
        return {}
    try:
        return dict(cost)
    except (TypeError, ValueError):
        return {}


def flops_of(entry):
    """The FLOPs of one ledger entry, or None when unknown (a count of
    0 or less reads as unknown)."""
    v = cost_dict(entry).get("flops")
    if v is None or float(v) <= 0:
        return None
    return float(v)


def bytes_accessed_of(entry):
    """The bytes a ledger entry moves, or None when unknown."""
    v = cost_dict(entry).get("bytes accessed")
    if v is None or float(v) <= 0:
        return None
    return float(v)


_MEM_FIELDS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "reserved_bytes": "reserved_bytes.all.current",
    "peak_reserved_bytes": "reserved_bytes.all.peak",
    "alloc_retries": "num_alloc_retries",
    "ooms": "num_ooms",
}


def memory_dict(mem_stats):
    """``torch.cuda.memory_stats()`` as a plain int dict with stable keys;
    {} for None or an empty dict (the CPU)."""
    if not mem_stats:
        return {}
    out = {}
    for key, stat in _MEM_FIELDS.items():
        v = mem_stats.get(stat)
        if v is not None:
            out[key] = int(v)
    return out


def roofline_verdict(flops, bytes_accessed, ridge):
    """"compute" or "memory" bound from the arithmetic intensity and the
    ridge point; None when either side is unknown."""
    if not flops or not bytes_accessed or not ridge:
        return None
    return "memory" if (flops / bytes_accessed) < ridge else "compute"
