"""Vision datasets and transforms (counterpart of
``mxtpu/gluon/data/vision``; ref: python/mxnet/gluon/data/vision/)."""
from .datasets import (MNIST, CIFAR10, CIFAR100, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
