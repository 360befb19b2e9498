"""Dataset abstractions (counterpart of ``mxtpu/gluon/data/dataset.py``;
ref: python/mxnet/gluon/data/dataset.py)."""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__ (ref: dataset.py:Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """Return a dataset with fn applied to each sample
        (ref: dataset.py:transform)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Apply fn to only the first element of each sample
        (ref: dataset.py:transform_first)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (ref: dataset.py:ArrayDataset)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("needs at least 1 array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise MXNetError(
                    "all arrays must have the same length; %d != %d"
                    % (len(data), self._length))
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Each sample is one raw record from a RecordIO file
    (ref: dataset.py:RecordFileDataset over MXIndexedRecordIO)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
