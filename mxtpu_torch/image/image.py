"""Image IO, augmenters and ImageIter (counterpart of
``mxtpu/image/image.py``).

Reference: ``python/mxnet/image/image.py`` -- cv2-backed decode/resize/crop,
the Augmenter stack (CreateAugmenter), and ImageIter reading RecordIO packs
or .lst files.

Decode and augmentation stay on the host (numpy, cv2), as the reference's
C++ decode threads do; the augmented batch crosses to the device once per
step, as an NDArray on the current context. ``cv2`` is imported when a
decode, an encode or a resize needs it, and its absence raises
``MXNetError`` naming it. The augmenters draw from Python's ``random``, as
the reference's, so a seeded pipeline draws the same boxes and flips.
Tensor-side transforms (``mx.nd.image.*``) run on the device.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as np

from ..base import MXNetError
from ..context import _scopes
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray, array

__all__ = ["imread", "imdecode", "imresize", "ImageIter"]


def _cv2():
    from ..recordio import _cv2 as cv2
    return cv2()


def imread(filename, flag=1, to_rgb=True):
    """Read an image file to an NDArray, HWC (ref: image.py:imread)."""
    cv2 = _cv2()
    img = cv2.imread(filename, flag)
    if img is None:
        raise MXNetError("cannot read image %s" % filename)
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return array(img)


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image buffer (ref: image.py:imdecode)."""
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(bytes(buf), dtype=np.uint8), flag)
    if img is None:
        raise MXNetError("cannot decode image buffer")
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return array(img)


def _as_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def imresize(src, w, h, interp=1):
    cv2 = _cv2()
    interp_map = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
                  2: cv2.INTER_CUBIC, 3: cv2.INTER_AREA,
                  4: cv2.INTER_LANCZOS4}
    out = cv2.resize(_as_np(src), (w, h),
                     interpolation=interp_map.get(interp, cv2.INTER_LINEAR))
    return array(out)


def resize_short(src, size, interp=2):
    """Resize shorter edge to size (ref: image.py:resize_short)."""
    img = _as_np(src)
    h, w = img.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(img, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    img = _as_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(img, size[0], size[1], interp)
    return array(img)


def random_crop(src, size, interp=2):
    """(ref: image.py:random_crop) returns (cropped, (x0, y0, w, h))."""
    img = _as_np(src)
    h, w = img.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    img = _as_np(src)
    h, w = img.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(img, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = _as_np(src).astype(np.float32)
    out = src - _as_np(mean)
    if std is not None:
        out = out / _as_np(std)
    return array(out)


# ------------------------------------------------------------- augmenters
class Augmenter:
    """(ref: image.py:Augmenter)"""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return array(np.flip(_as_np(src), axis=1))
        return array(_as_np(src))


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return array(_as_np(src).astype(self.typ))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean, self.std = np.asarray(mean, np.float32), \
            np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return array(_as_np(src).astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        img = _as_np(src).astype(np.float32)
        coef = np.asarray([[[0.299, 0.587, 0.114]]], np.float32)
        gray = (img * coef).sum(axis=2, keepdims=True)
        return array(img * alpha + gray.mean() * (1 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        img = _as_np(src).astype(np.float32)
        coef = np.asarray([[[0.299, 0.587, 0.114]]], np.float32)
        gray = (img * coef).sum(axis=2, keepdims=True)
        return array(img * alpha + gray * (1 - alpha))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmenter stack (ref: image.py:CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if mean is True:
        mean = np.asarray([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.asarray([58.395, 57.12, 57.375], np.float32)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# --------------------------------------------------------------- ImageIter
class ImageIter(DataIter):
    """Image iterator over RecordIO packs or .lst files
    (ref: image.py:ImageIter; C++ twin src/io/iter_image_recordio_2.cc)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", last_batch_handle="pad",
                 preprocess_threads=0, **kwargs):
        super().__init__(batch_size)
        # decode+augment worker threads (ref: ImageRecordIter's
        # preprocess_threads, src/io/iter_image_recordio_2.cc:672 — its
        # fused multithreaded pipeline). cv2's decode releases the GIL, so
        # threads genuinely parallelize the hot per-image work; RecordIO
        # reads stay serialized (the underlying reader seeks one file).
        # Combine with mx.io.PrefetchingIter for the reference's full
        # decode-ahead double buffering.
        self._threads = max(0, int(preprocess_threads))
        self._pool = None
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise MXNetError("data_shape must be (3, H, W)")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self._shuffle = shuffle
        aug_keys = ("resize", "rand_crop", "rand_resize", "rand_mirror",
                    "mean", "std", "brightness", "contrast", "saturation",
                    "hue", "pca_noise", "rand_gray", "inter_method")
        unknown = set(kwargs) - set(aug_keys)
        if unknown:
            # loud, not silent: a misspelled augmenter option must not
            # train with the augmentation quietly missing
            raise MXNetError("ImageIter: unknown options %s (augmenter "
                             "options: %s)" % (sorted(unknown),
                                               ", ".join(aug_keys)))
        if aug_list is not None and kwargs:
            raise MXNetError("aug_list given; augmenter kwargs %s would be "
                             "ignored" % sorted(kwargs))
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in aug_keys})
        self._record = None
        self._imglist = None
        if path_imgrec is not None:
            from ..recordio import MXIndexedRecordIO
            idx = path_imgidx if path_imgidx is not None \
                else path_imgrec[:path_imgrec.rfind(".")] + ".idx"
            self._record = MXIndexedRecordIO(idx, path_imgrec, "r")
            self._seq = list(self._record.keys)
        elif path_imglist is not None or imglist is not None:
            entries = []
            if path_imglist is not None:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = np.asarray(parts[1:-1], np.float32)
                        entries.append((parts[-1], label))
            else:
                for item in imglist:
                    entries.append((item[-1],
                                    np.asarray(item[:-1], np.float32)))
            self._imglist = entries
            self._path_root = path_root
            self._seq = list(range(len(entries)))
        else:
            raise MXNetError("needs path_imgrec, path_imglist or imglist")
        # distributed sharding (ref: part_index/num_parts shard reads)
        n = len(self._seq)
        per = n // num_parts
        self._seq = self._seq[part_index * per:
                              (part_index + 1) * per if num_parts > 1 else n]
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        if self._shuffle:
            _pyrandom.shuffle(self._seq)
        self._cursor = 0

    def _decode_blob(self, blob):
        """RecordIO blob -> (label vector, RGB HWC image). Thread-safe
        (no iterator state)."""
        from ..recordio import unpack_img
        header, img = unpack_img(blob)
        # BGR -> RGB like the reference decode
        return (np.asarray(header.label, np.float32).reshape(-1),
                img[..., ::-1])

    def _read_record(self, key):
        """ONE read+decode of a sample -> (label vector, RGB HWC image).
        Shared with ImageDetIter; the RecordIO blob is read and unpacked
        exactly once per sample (the hot IO path)."""
        if self._record is not None:
            return self._decode_blob(self._record.read_idx(key))
        path, label = self._imglist[key]
        return (np.asarray(label, np.float32).reshape(-1),
                imread(os.path.join(self._path_root, path)).asnumpy())

    def _read_image(self, key):
        """Decode one sample's image only (compat shim; prefer
        _read_record when the label is also needed)."""
        return self._read_record(key)[1]

    def _augment_sample(self, label, img):
        """The ONE copy of the augment/layout pipeline — serial and
        threaded paths both come through here, so the TRANSFORM code
        cannot diverge. (Random augmenters draw from the shared RNG in
        thread-interleaving order, so seeded reproducibility holds only
        for serial/deterministic pipelines — same property as the
        reference's decode threads.)"""
        for aug in self.auglist:
            img = aug(img)
        img = _as_np(img)
        if img.ndim == 3 and img.shape[2] in (1, 3):
            img = img.transpose(2, 0, 1)  # HWC -> CHW
        label = np.asarray(label, np.float32).reshape(-1)[:self.label_width]
        return img.astype(np.float32), label

    def _read_sample(self, key):
        label, img = self._read_record(key)
        return self._augment_sample(label, img)

    def _batch_samples(self, keys):
        """Decode+augment the batch's samples — threaded when
        preprocess_threads > 1 (the v2 iterator's parallel decode stage)."""
        if self._threads > 1 and len(keys) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self._threads)
            # the pool's threads place arrays in the caller's `with ctx:`
            scope = _scopes()[-1] if _scopes() else None

            def in_scope(fn, arg):
                if scope is None:
                    return fn(arg)
                with scope:
                    return fn(arg)
            if self._record is not None:
                # reads stay serialized on THIS thread (the RecordIO
                # reader seeks one file); submitting each blob as it is
                # read overlaps blob i's decode with blob i+1's read
                futs = [self._pool.submit(in_scope, self._process_blob,
                                          self._record.read_idx(k))
                        for k in keys]
                return [f.result() for f in futs]
            return [f.result() for f in [
                self._pool.submit(in_scope, self._read_sample, k)
                for k in keys]]
        return [self._read_sample(k) for k in keys]

    def _process_blob(self, blob):
        """decode+augment one already-read RecordIO blob (thread-safe)."""
        return self._augment_sample(*self._decode_blob(blob))

    def close(self):
        """Release the decode pool AND the RecordIO file handle
        (idempotent; the iterator is done after this)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._record is not None:
            self._record.close()
            self._record = None

    def __del__(self):  # pragma: no cover - interpreter-exit timing
        try:
            self.close()
        except Exception:
            pass

    def next(self):
        if self._cursor >= len(self._seq):
            raise StopIteration
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              np.float32)
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        batch_label = np.zeros(shape, np.float32)
        take = min(self.batch_size, len(self._seq) - self._cursor)
        keys = [self._seq[self._cursor + j] for j in range(take)]
        samples = self._batch_samples(keys)
        # advance only after the batch decoded: a caller that catches a
        # corrupt-record error and retries resumes at this batch rather
        # than silently skipping its good samples
        self._cursor += take
        for i, (img, label) in enumerate(samples):
            batch_data[i] = img
            batch_label[i] = label if self.label_width > 1 else label[0]
        # take >= 1 here (the cursor check above raised otherwise), so a
        # batch is never all-pad
        pad = self.batch_size - take
        return DataBatch(data=[array(batch_data)],
                         label=[array(batch_label)], pad=pad)
