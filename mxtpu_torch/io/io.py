"""Data iterators (counterpart of ``mxtpu/io/io.py``; ref:
python/mxnet/io/io.py).

Batches of ``NDArrayIter``, ``CSVIter`` and ``ImageRecordIter`` are NDArrays
on the current context (``cuda:0`` outside a ``with ctx:`` scope), as
``array`` places them. ``PrefetchingIter`` delegates its double buffering to
``io.stream.DevicePrefetcher``: pinned host buffers copied to the card on a
side CUDA stream while the consumer computes on the previous batch.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "MNISTIter", "ImageRecordIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Data description: name/shape/dtype/layout (ref: io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One mini-batch (ref: io.py:DataBatch)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (ref: io.py:DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, np.ndarray) (ref: io.py:_init_data)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("data cannot be empty")
        data = {(default_name if len(data) == 1 else "_%d_%s" %
                 (i, default_name)): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    out = []
    for k, v in data.items():
        v = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py:NDArrayIter) with pad /
    discard / roll_over last-batch handling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise MXNetError("all data must have the same length")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self._order = np.arange(self.num_data)
        self._leftover = np.array([], dtype=np.int64)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        base = np.arange(self.num_data)
        if self.shuffle:
            np.random.shuffle(base)
        if self.last_batch_handle == "roll_over":
            # reference semantics: the incomplete tail batch is NOT
            # emitted this epoch — it rolls over and leads the next
            # epoch's stream (io.py NDArrayIter roll_over; what
            # BucketSentenceIter round_batch relies on). The tail only
            # carries if the previous epoch was fully consumed: a
            # mid-epoch reset abandons its PLANNED tail rather than
            # rolling samples from an epoch that never finished
            # (the reference caches the tail only when iteration
            # actually reached it).
            if not getattr(self, "_exhausted", False):
                self._leftover = np.array([], dtype=np.int64)
            eff = np.concatenate([self._leftover, base])
            n_full = len(eff) // self.batch_size
            self.num_batches = n_full
            self._leftover = eff[n_full * self.batch_size:]
            self._order = eff[:n_full * self.batch_size]
        else:
            self._order = base
        self._cursor = -1
        self._exhausted = False

    def iter_next(self):
        self._cursor += 1
        if self._cursor >= self.num_batches - 1:
            # serving the FINAL batch counts as full consumption: consumers
            # that read exactly num_batches batches (for _ in range(n))
            # never make the extra failing call, and the roll_over tail
            # must still carry for them
            self._exhausted = True
        return self._cursor < self.num_batches

    def _slice(self, arrays):
        start = self._cursor * self.batch_size
        end = start + self.batch_size
        out = []
        for _, v in arrays:
            idx = self._order[start:end]
            chunk = v[idx]
            if chunk.shape[0] < self.batch_size:
                # pad policy (roll_over never reaches here: its epoch
                # holds only full batches). Fill by WRAPPING from the
                # epoch's start — the reference pads with real leading
                # samples, not zeros; DataBatch.pad tells consumers how
                # many trailing rows to ignore either way
                wrap = self._order[:self.batch_size - chunk.shape[0]]
                chunk = np.concatenate([chunk, v[wrap]], axis=0)
            out.append(array(chunk))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        """Trailing rows of this batch that are filler, not real samples.

        As in the JAX package, which differs here: under roll_over MXNet
        reports a nonzero pad (-cursor) on the first batch after an epoch
        boundary even though that batch holds only real samples (cached
        tail + new ones). Here roll_over epochs contain full batches of
        real samples exclusively, so pad is honestly 0 — consumers that
        mask `batch[:-pad]` drop nothing real."""
        start = self._cursor * self.batch_size
        remaining = self.num_data - start
        if self.last_batch_handle == "pad" and remaining < self.batch_size:
            return self.batch_size - remaining
        return 0

    def getindex(self):
        start = self._cursor * self.batch_size
        return self._order[start:start + self.batch_size]


class ResizeIter(DataIter):
    """Resize (truncate/loop) another iterator to a fixed number of batches
    per epoch (ref: io.py:ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        return self.cur < self.size

    def next(self):
        if not self.iter_next():
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()


class PrefetchingIter(DataIter):
    """Double-buffering over one or more iterators (ref:
    io.py:PrefetchingIter ~ the C++ PrefetcherIter, src/io/
    iter_prefetcher.h), delegating to :class:`mxtpu_torch.io.stream.
    DevicePrefetcher`: prefetch to the device (numpy leaves are copied
    while the consumer computes; ``prefetch_to_device=`` names the device
    or Context, the current context by default), ``depth`` batches ahead
    (2 by default), worker errors re-raised at the consumer, and a
    ``reset()`` that joins the worker with a timeout and re-raises its
    pending exception."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_to_device=None, depth=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._sharding_spec = prefetch_to_device
        self._depth = depth
        self._pending = None
        self._prefetcher = None
        self._start()

    @staticmethod
    def _pull(it):
        while True:
            try:
                yield it.next()
            except StopIteration:
                return

    def _merged(self, sources):
        while True:
            batches = []
            for src in sources:
                try:
                    batches.append(next(src))
                except StopIteration:
                    return
            data = sum((b.data for b in batches), [])
            label = sum((b.label or [] for b in batches), [])
            yield DataBatch(data=data, label=label or None,
                            pad=batches[0].pad, index=batches[0].index)

    def _start(self):
        from .stream import DevicePrefetcher
        self._pending = None
        # cross-iterator parallelism (the old implementation's
        # thread-per-iter, kept): with multiple sub-iterators each gets
        # its own producer stage decoding ahead, so per-batch source
        # latency is the MAX across iterators, not the SUM; the outer
        # stage merges, owns the target-sharding placement, and carries
        # the data.* telemetry
        # to_device=False: sub stages buffer on the HOST — the one H2D
        # copy (onto the target sharding) belongs to the outer stage, or
        # numpy batches would upload to the default device here and then
        # transfer AGAIN when the outer stage re-places them
        self._sub = [DevicePrefetcher(self._pull(it), depth=self._depth,
                                      site="data.sub", to_device=False)
                     for it in self.iters] if len(self.iters) > 1 else None
        self._prefetcher = DevicePrefetcher(
            self._merged(self._sub or [self._pull(self.iters[0])]),
            depth=self._depth, sharding=self._sharding_spec)

    @property
    def provide_data(self):
        out = []
        for i, it in enumerate(self.iters):
            descs = it.provide_data
            if self.rename_data:
                descs = [DataDesc(self.rename_data[i].get(d.name, d.name),
                                  d.shape, d.dtype) for d in descs]
            out.extend(descs)
        return out

    @property
    def provide_label(self):
        out = []
        for i, it in enumerate(self.iters):
            descs = it.provide_label
            if self.rename_label:
                descs = [DataDesc(self.rename_label[i].get(d.name, d.name),
                                  d.shape, d.dtype) for d in descs]
            out.extend(descs)
        return out

    def reset(self):
        # bounded join + reraise: an exhausted or raising underlying iter
        # must never deadlock the reset path (the old event-pair bug); a
        # worker error surfaces HERE rather than being dropped (sub-stage
        # errors propagate through the outer producer, so the outer close
        # carries them)
        try:
            self._prefetcher.close(timeout=5.0, reraise=True)
        finally:
            # even when the outer close raises, the sub producers must
            # die: a leaked sub keeps pulling its iterator in the
            # background (corrupting its cursor for any retry) and pins
            # its buffered batches — and with them gone, a retried
            # reset() starts from a clean slate
            for sub in self._sub or ():
                try:
                    sub.close(timeout=5.0)
                except Exception:  # noqa: BLE001 — teardown must not mask
                    pass
        for it in self.iters:
            it.reset()
        self._start()

    def next(self):
        if self._pending is not None:
            batch, self._pending = self._pending, None
            return batch
        return next(self._prefetcher)

    def iter_next(self):
        if self._pending is not None:
            return True
        try:
            self._pending = next(self._prefetcher)
        except StopIteration:
            return False
        return True

    def close(self, timeout=5.0):
        if self._prefetcher is not None:
            self._prefetcher.close(timeout=timeout)
        for sub in self._sub or ():
            sub.close(timeout=timeout)

    def __del__(self):  # pragma: no cover - interpreter-exit timing
        try:
            self.close(timeout=0.5)
        except Exception:  # noqa: BLE001
            pass


class CSVIter(DataIter):
    """CSV file iterator (ref: src/io/iter_csv.cc). Loads host-side with
    numpy; shapes must be given like the reference's data_shape param."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="roll_over" if round_batch else "pad")
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """Batched reader for LibSVM-format text (``label idx:val idx:val ...``)
    producing CSR data batches (ref: src/io/iter_libsvm.cc +
    iter_sparse_batchloader.h).

    Each batch is a ``CSRNDArray`` whose (data, indptr, indices) are dense
    arrays on the current context. Sharded reads via
    ``num_parts``/``part_index`` keep multi-host loading symmetrical.
    """

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, num_parts=1, part_index=0,
                 round_batch=True, data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.data_name = data_name
        self.label_name = label_name
        self.round_batch = round_batch
        labels, rows = self._parse(data_libsvm, num_parts, part_index,
                                   want_label=label_libsvm is None)
        if label_libsvm is not None:
            labels, _ = self._parse(label_libsvm, num_parts, part_index,
                                    want_label=True)
        self.labels = np.asarray(labels, np.float32)
        self.rows = rows  # list of (indices int32[], values float32[])
        max_idx = max((int(r[0].max()) for r in rows if len(r[0])),
                      default=-1)
        if max_idx >= self.data_shape[0]:
            raise MXNetError(
                "LibSVMIter: feature index %d >= data_shape[0]=%d. LibSVM "
                "files are often 1-based — pass data_shape=(max_index+1,) "
                "(the reference uses zero-based indexing, iter_libsvm.cc)"
                % (max_idx, self.data_shape[0]))
        self.num_data = len(rows)
        if self.num_data < batch_size:
            raise MXNetError("LibSVMIter: fewer rows (%d) than batch_size"
                             % self.num_data)
        self.reset()

    @staticmethod
    def _parse(path, num_parts, part_index, want_label):
        labels = []
        rows = []
        with open(path) as f:
            for i, line in enumerate(f):
                if num_parts > 1 and i % num_parts != part_index:
                    continue
                parts = line.split()
                if not parts:
                    continue
                start = 0
                if want_label:
                    labels.append(float(parts[0]))
                    start = 1
                idx = []
                val = []
                for tok in parts[start:]:
                    k, _, v = tok.partition(":")
                    idx.append(int(k))
                    val.append(float(v))
                rows.append((np.asarray(idx, np.int32),
                             np.asarray(val, np.float32)))
        return labels, rows

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape, np.float32)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size,), np.float32)]

    def reset(self):
        self._cursor = -1
        self.num_batches = (self.num_data // self.batch_size
                            if not self.round_batch else
                            (self.num_data + self.batch_size - 1)
                            // self.batch_size)

    def iter_next(self):
        self._cursor += 1
        return self._cursor < self.num_batches

    def _batch_ids(self):
        start = self._cursor * self.batch_size
        # round_batch: the last partial batch wraps to the front
        return [(start + i) % self.num_data for i in range(self.batch_size)]

    def getdata(self):
        from ..ndarray.sparse import CSRNDArray

        ids = self._batch_ids()
        indptr = np.zeros(self.batch_size + 1, np.int32)
        idx_parts = []
        val_parts = []
        for i, r in enumerate(ids):
            indices, values = self.rows[r]
            indptr[i + 1] = indptr[i] + len(indices)
            idx_parts.append(indices)
            val_parts.append(values)
        indices = np.concatenate(idx_parts) if idx_parts else \
            np.zeros(0, np.int32)
        values = np.concatenate(val_parts) if val_parts else \
            np.zeros(0, np.float32)
        return [CSRNDArray(values, indptr, indices,
                           (self.batch_size,) + self.data_shape)]

    def getlabel(self):
        ids = self._batch_ids()
        return [array(self.labels[ids])]

    def getpad(self):
        start = self._cursor * self.batch_size
        remaining = self.num_data - start
        if remaining < self.batch_size:
            return self.batch_size - remaining
        return 0


class MNISTIter(NDArrayIter):
    """MNIST idx-ubyte iterator (ref: src/io/iter_mnist.cc:43-190).

    Reads the standard ``*-images-idx3-ubyte`` / ``*-labels-idx1-ubyte``
    files (gzipped accepted), normalizes pixels to [0, 1) by 1/256 like
    the reference (:184), emits (batch, 1, 28, 28) float32 — or
    (batch, 784) with ``flat=True`` — and supports the reference's
    shuffle/seed/part sharding params. Incomplete tail batches are
    dropped (the reference's Next() only serves full batches)."""

    def __init__(self, image="./train-images-idx3-ubyte",
                 label="./train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, data_name="data",
                 label_name="softmax_label", **kwargs):
        # loud, not silent (same policy as ImageIter's option check): a
        # misspelled option must not quietly train with defaults
        allowed = {"prefetch_buffer", "dtype"}  # reference-compat no-ops
        unknown = set(kwargs) - allowed
        if unknown:
            raise MXNetError("MNISTIter: unknown options %s"
                             % sorted(unknown))
        import gzip
        import struct

        def _open(path):
            return gzip.open(path, "rb") if path.endswith(".gz") \
                else open(path, "rb")

        with _open(label) as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8) \
                .astype(np.float32)
        with _open(image) as f:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8) \
                .reshape(num, 1, rows, cols).astype(np.float32) / 256.0
        if flat:
            images = images.reshape(num, rows * cols)
        if shuffle:
            order = np.random.RandomState(seed).permutation(num)
            images, labels = images[order], labels[order]
        per = num // num_parts
        lo = part_index * per
        hi = lo + per if num_parts > 1 else num
        images, labels = images[lo:hi], labels[lo:hi]
        if not silent:
            import logging
            logging.info("MNISTIter: load %d images, shuffle=%s, shape=%s",
                         images.shape[0], shuffle, images.shape)
        super().__init__(images, labels, batch_size, shuffle=False,
                         last_batch_handle="discard", data_name=data_name,
                         label_name=label_name)


def ImageRecordIter(path_imgrec=None, path_imgidx=None, data_shape=None,
                    batch_size=1, shuffle=False, preprocess_threads=0,
                    part_index=0, num_parts=1, label_width=1,
                    rand_crop=False, rand_mirror=False, resize=0,
                    mean_r=0.0, mean_g=0.0, mean_b=0.0,
                    std_r=0.0, std_g=0.0, std_b=0.0,
                    mean_img=None, data_name="data",
                    label_name="softmax_label", **kwargs):
    """The reference's registered ImageRecordIter spelling
    (src/io/iter_image_recordio_2.cc:736) as a thin constructor over
    :class:`mxtpu_torch.image.ImageIter` — RecordIO shards + threaded
    decode/augment + part sharding, with the C++ iterator's flat
    per-channel mean/std params mapped onto the augmenter stack."""
    from ..image import ImageIter
    if mean_img is not None:
        raise MXNetError("mean_img binary files are not supported: pass "
                         "mean_r/mean_g/mean_b (or use mx.image.ImageIter "
                         "with a mean array)")
    aug_kwargs = {}
    if any((mean_r, mean_g, mean_b)):
        aug_kwargs["mean"] = np.array([mean_r, mean_g, mean_b], np.float32)
    if any((std_r, std_g, std_b)):
        aug_kwargs["std"] = np.array([std_r or 1.0, std_g or 1.0,
                                      std_b or 1.0], np.float32)
        # the normalize augmenter is keyed on mean; std alone must not
        # be silently dropped
        aug_kwargs.setdefault("mean", np.zeros(3, np.float32))
    if resize:
        aug_kwargs["resize"] = int(resize)
    if rand_crop:
        aug_kwargs["rand_crop"] = True
    if rand_mirror:
        aug_kwargs["rand_mirror"] = True
    aug_kwargs.update(kwargs)  # remaining augmenter options pass through
    return ImageIter(batch_size=batch_size, data_shape=data_shape,
                     label_width=label_width, path_imgrec=path_imgrec,
                     path_imgidx=path_imgidx, shuffle=shuffle,
                     part_index=part_index, num_parts=num_parts,
                     preprocess_threads=preprocess_threads,
                     data_name=data_name, label_name=label_name,
                     **aug_kwargs)
