"""Engine controls (counterpart of ``mxtpu/engine.py``; ref:
python/mxnet/engine.py, bulk-execution scoping).

The reference batches consecutive engine ops into bulks
(``MXEngineSetBulkSize``). Here a captured CUDA graph (a hybridized
block's pair, a fused optimizer step) already issues a whole step as one
replay, so the API is kept for code that tunes it: ``set_bulk_size``
returns the previous size and changes nothing else, and ``bulk`` restores
it on exit.
"""
from __future__ import annotations

from contextlib import contextmanager

__all__ = ["bulk", "set_bulk_size"]

_bulk_size = 0


def set_bulk_size(size):
    """Set the engine bulk size; returns the previous value."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


@contextmanager
def bulk(size):
    """Bulk-execution scope (ref: engine.py:bulk)."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
