"""Legacy multi-device executor helpers (counterpart of
``mxtpu/executor_manager.py``; ref: python/mxnet/executor_manager.py,
DataParallelExecutorManager behind mx.model FeedForward).

The port runs one executor a process: on one device, or on a
``parallel.Mesh`` this rank's rows of the batch (``symbol/executor.py``).
Only ``_split_input_slice``, the public batch-slicing helper some
reference training scripts import directly, is provided.
"""
from .base import MXNetError

__all__ = ["_split_input_slice"]


def _split_input_slice(batch_size, work_load_list):
    """Split batch_size into per-worker slices proportional to work_load_list
    (ref: executor_manager.py:_split_input_slice). Raises when the batch is
    too small to give every worker at least one sample, like the reference."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        end = (batch_size * sum(work_load_list[:i + 1]) + total - 1) // total
        end = min(end, batch_size)
        if end <= start:
            raise MXNetError("too many slices: batch %d over %d workers"
                             % (batch_size, len(work_load_list)))
        slices.append(slice(start, end))
        start = end
    return slices
