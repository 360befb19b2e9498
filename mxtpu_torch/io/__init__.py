"""mx.io: data iterators (counterpart of ``mxtpu/io``; ref:
``python/mxnet/io/io.py`` and the C++ iterator chain of src/io/: source ->
augmenter -> batch loader -> prefetcher). The prefetcher stage is
``io/stream.py``: the sharded streaming reader and the prefetch to the card
over pinned buffers and a side CUDA stream.
"""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter, MNISTIter,
                 ImageRecordIter)
from .stream import (DevicePrefetcher, ShardedRecordReader, StreamRecordIter,
                     shard_keys)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "MNISTIter",
           "ImageRecordIter", "DevicePrefetcher", "ShardedRecordReader",
           "StreamRecordIter", "shard_keys"]
