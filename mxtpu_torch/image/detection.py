"""Detection image pipeline: box-aware augmenters + ImageDetIter
(counterpart of ``mxtpu/image/detection.py``).

Reference: python/mxnet/image/detection.py (DetAugmenter zoo +
ImageDetIter) and the C++ twin src/io/iter_image_det_recordio.cc with
image_det_aug_default.cc. Its labels feed the SSD multibox ops.

Label wire format parity: a sample's raw label vector is
``[header_width A, object_width B, <extra header A-2>, obj0 ... objN]``
where each object is ``[class_id, xmin, ymin, xmax, ymax, ...]`` with
coordinates normalized to [0, 1] — exactly the reference's
``ImageDetIter._parse_label``. Batches pad the object list with -1 rows
(the convention multibox_target stops at).
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc
from ..ndarray import array
from .image import (CastAug, ColorNormalizeAug, ImageIter,
                    imresize, _as_np)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Image+label augmenter base (ref: detection.py:DetAugmenter)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter; label passes through
    (ref: detection.py:DetBorrowAug)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Random horizontal flip mirroring the boxes
    (ref: detection.py:DetHorizontalFlipAug)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _as_np(src)[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x0 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x0
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping objects whose centers survive; boxes are clipped
    and renormalized (simplified from detection.py:DetRandomCropAug — the
    reference's min-IoU candidate sampling reduces to center-keep for the
    common SSD recipe)."""

    def __init__(self, min_crop_scale=0.5, max_attempts=10, p=0.5):
        self.min_crop_scale = float(min_crop_scale)
        self.max_attempts = int(max_attempts)
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() > self.p:
            return src, label
        img = _as_np(src)
        h, w = img.shape[:2]
        for _ in range(self.max_attempts):
            s = _pyrandom.uniform(self.min_crop_scale, 1.0)
            cw, ch = int(w * s), int(h * s)
            x0 = _pyrandom.randint(0, w - cw)
            y0 = _pyrandom.randint(0, h - ch)
            new = label.copy()
            valid = new[:, 0] >= 0
            if not valid.any():
                break
            cx = (new[:, 1] + new[:, 3]) / 2 * w
            cy = (new[:, 2] + new[:, 4]) / 2 * h
            keep = valid & (cx >= x0) & (cx < x0 + cw) \
                & (cy >= y0) & (cy < y0 + ch)
            if not keep.any():
                continue
            # renormalize surviving boxes to the crop, clip to [0, 1]
            new[:, 1] = np.clip((new[:, 1] * w - x0) / cw, 0, 1)
            new[:, 3] = np.clip((new[:, 3] * w - x0) / cw, 0, 1)
            new[:, 2] = np.clip((new[:, 2] * h - y0) / ch, 0, 1)
            new[:, 4] = np.clip((new[:, 4] * h - y0) / ch, 0, 1)
            new[~keep] = -1.0
            return img[y0:y0 + ch, x0:x0 + cw], new
        return src, label


class _DetResizeAug(DetAugmenter):
    """Force resize to the network input; normalized boxes are unchanged."""

    def __init__(self, size, interp=1):
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        w, h = self.size
        return _as_np(imresize(src, w, h, self.interp)), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, min_crop_scale=0.5,
                       inter_method=1):
    """Detection augmenter chain (ref: detection.py:CreateDetAugmenter).
    Geometry first (resize-short/crop/flip), then the forced resize, then
    color."""
    from .image import ResizeAug

    auglist = []
    if resize > 0:
        # resize-short preserves aspect ratio; normalized boxes unchanged
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(min_crop_scale=min_crop_scale,
                                        p=rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(_DetResizeAug((data_shape[2], data_shape[1]),
                                 inter_method))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        # either side may be absent: normalize with identity for that side
        # (np.asarray(None) is NaN — never pass None through)
        mean = np.zeros(3) if mean is None else mean
        std = np.ones(3) if std is None else std
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: image batches + padded object-list labels
    (ref: detection.py:ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", imglist=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 data_name="data", label_name="label", label_shape=None,
                 **kwargs):
        # split kwargs: CreateDetAugmenter params vs parent-iterator params
        # (e.g. last_batch_handle) — mirroring ImageIter's own aug_keys split
        det_aug_keys = ("resize", "rand_crop", "rand_mirror", "mean", "std",
                        "min_crop_scale", "inter_method")
        det_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in det_aug_keys}
        if aug_list is not None and det_kwargs:
            raise MXNetError("aug_list given; augmenter kwargs %s would be "
                             "ignored" % sorted(det_kwargs))
        if int(kwargs.pop("preprocess_threads", 0) or 0) > 1:
            # loud, not silent: the det iterator's box-aware batch loop is
            # serial; accepting the knob would quietly drop the parallelism
            raise MXNetError(
                "ImageDetIter does not support preprocess_threads; wrap it "
                "in mx.io.PrefetchingIter for decode-ahead instead")
        aug = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **det_kwargs)
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, imglist=imglist,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[],
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        self._det_auglist = aug
        self._obj_width = None
        if label_shape is not None:
            # explicit (max_objs, obj_width) — REQUIRED for num_parts > 1:
            # inferring from this shard would give each worker a different
            # label shape, and inferring at all costs a full dataset pass
            self._max_objs = int(label_shape[0])
            self._obj_width = int(label_shape[1])
        else:
            if num_parts > 1:
                raise MXNetError(
                    "ImageDetIter with num_parts > 1 needs an explicit "
                    "label_shape=(max_objs, obj_width): shard-local "
                    "inference would give workers different label shapes")
            max_objs = 1
            for key in self._seq:
                objs = self._parse_label(self._raw_label(key))
                max_objs = max(max_objs, objs.shape[0])
            self._max_objs = max_objs

    # ------------------------------------------------------------- labels
    def _raw_label(self, key):
        if self._record is not None:
            from ..recordio import unpack
            header, _ = unpack(self._record.read_idx(key))
            return np.asarray(header.label, np.float32).reshape(-1)
        _, label = self._imglist[key]
        return np.asarray(label, np.float32).reshape(-1)

    def _parse_label(self, raw):
        """[A, B, header..., objects...] -> (num_objs, B) array
        (ref: ImageDetIter._parse_label)."""
        raw = np.asarray(raw, np.float32).reshape(-1)
        if raw.size < 2:
            raise MXNetError("det label must start with [header_width, "
                             "object_width]")
        a, b = int(raw[0]), int(raw[1])
        if b < 5:
            raise MXNetError("object_width must be >= 5 (id + 4 coords)")
        body = raw[a:]
        n = body.size // b
        objs = body[:n * b].reshape(n, b)
        if self._obj_width is None:
            self._obj_width = b
        elif b != self._obj_width:
            raise MXNetError("inconsistent object_width across samples")
        return objs

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size, self._max_objs,
                          self._obj_width or 5))]

    # ------------------------------------------------------------ batching
    def next(self):
        if self._cursor >= len(self._seq):
            raise StopIteration
        bw = self._obj_width or 5
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              np.float32)
        batch_label = np.full((self.batch_size, self._max_objs, bw), -1.0,
                              np.float32)
        i = 0
        pad = 0
        while i < self.batch_size:
            if self._cursor < len(self._seq):
                key = self._seq[self._cursor]
                raw, img = self._read_record(key)
                objs = self._parse_label(raw)
                for aug in self._det_auglist:
                    img, objs = aug(img, objs)
                img = _as_np(img)
                if img.ndim == 3 and img.shape[2] in (1, 3):
                    img = img.transpose(2, 0, 1)
                batch_data[i] = img.astype(np.float32)
                batch_label[i, :objs.shape[0]] = objs[:self._max_objs]
                self._cursor += 1
            else:
                pad += 1
            i += 1
        if pad == self.batch_size:
            raise StopIteration
        return DataBatch(data=[array(batch_data)],
                         label=[array(batch_label)], pad=pad)
