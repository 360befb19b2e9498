"""Vision datasets (counterpart of ``mxtpu/gluon/data/vision/datasets.py``;
ref: python/mxnet/gluon/data/vision/datasets.py).

Datasets read the standard files from ``root`` (the gzip and pickle
layouts the reference downloads) and raise when they are absent: nothing
is downloaded. Images are NDArrays on the current context (``cuda:0``
outside a ``with ctx:`` scope), as ``array`` places them.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ....base import MXNetError
from ....ndarray import array
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            raise MXNetError(
                "dataset root %s does not exist (no network access: place "
                "the standard dataset files there)" % self._root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from the standard idx-ubyte.gz files (ref: datasets.py:MNIST)."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img_file, lbl_file = self._train_files if self._train \
            else self._test_files
        img_path = os.path.join(self._root, img_file)
        lbl_path = os.path.join(self._root, lbl_file)
        for p in (img_path, lbl_path):
            if not os.path.exists(p):
                raise MXNetError("missing dataset file %s" % p)
        with gzip.open(lbl_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        with gzip.open(img_path, "rb") as f:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                num, rows, cols, 1)
        self._data = array(data)
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches (cifar-10-batches-py)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._classes = 10
        super().__init__(root, train, transform)

    def _batches(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        if self._train:
            return [os.path.join(base, "data_batch_%d" % i)
                    for i in range(1, 6)]
        return [os.path.join(base, "test_batch")]

    def _get_data(self):
        # auto-extract the tarball if only it is present
        base = os.path.join(self._root, "cifar-10-batches-py")
        tar = os.path.join(self._root, "cifar-10-python.tar.gz")
        if not os.path.isdir(base) and os.path.exists(tar):
            with tarfile.open(tar) as t:
                t.extractall(self._root)
        data, labels = [], []
        for path in self._batches():
            if not os.path.exists(path):
                raise MXNetError("missing dataset file %s" % path)
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            data.append(batch["data"].reshape(-1, 3, 32, 32))
            labels.extend(batch.get("labels", batch.get("fine_labels")))
        data = np.concatenate(data).transpose(0, 2, 3, 1)  # NHWC like ref
        self._data = array(data)
        self._label = np.asarray(labels, dtype=np.int32)


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100",
                 fine_label=False, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)
        self._classes = 100

    def _batches(self):
        base = os.path.join(self._root, "cifar-100-python")
        return [os.path.join(base, "train" if self._train else "test")]

    def _get_data(self):
        base = os.path.join(self._root, "cifar-100-python")
        tar = os.path.join(self._root, "cifar-100-python.tar.gz")
        if not os.path.isdir(base) and os.path.exists(tar):
            with tarfile.open(tar) as t:
                t.extractall(self._root)
        path = self._batches()[0]
        if not os.path.exists(path):
            raise MXNetError("missing dataset file %s" % path)
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        data = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = "fine_labels" if self._fine else "coarse_labels"
        self._data = array(data)
        self._label = np.asarray(batch[key], dtype=np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a RecordIO pack (ref: datasets.py:
    ImageRecordDataset over image/recordio decode)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = super().__getitem__(idx)
        header, img = unpack_img(record, iscolor=self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """label = subfolder index (ref: datasets.py:ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png", ".bmp", ".npy"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = array(np.load(path))
        else:
            img = imread(path, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
