"""Gluon data API (counterpart of ``mxtpu/gluon/data``; ref:
python/mxnet/gluon/data/)."""
from .dataset import (ArrayDataset, Dataset, RecordFileDataset, SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler, SequentialSampler)
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
