"""Bucketed inference (counterpart of ``mxtpu/serving/engine.py``).

``BucketSpec`` declares the batch buckets a ``Predictor`` serves and,
optionally, sequence buckets (``seq_lens``) for inputs with a sequence
axis. A request of n items runs at the smallest batch bucket >= n and, with
sequence buckets, at the smallest one >= its length: ``pad_nd`` pads every
input with ``pad_value`` up to the bucket on the batch axis and on
``seq_axis`` (where the input has that axis), the block's forward runs
under ``torch.inference_mode()``, and the outputs are sliced back to n rows
on the batch axis only (their sequence axis stays at the bucket's length,
as in the JAX package). A request larger than the largest batch bucket goes
through it in chunks whose outputs are concatenated; a sequence longer than
the largest sequence bucket raises, since a sequence cannot be chunked
without changing what the model computes.

The predictor's device is ``cuda:0`` unless the caller names one; with no
card and no device it raises. Not in this slice: int8 weights, replicas,
decode slots, the compile service and telemetry spans. Buckets are eager
PyTorch runs; CUDA-graph capture of each bucket comes later.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["BucketSpec", "Predictor", "pad_nd"]


def pad_nd(t, batch, seq_len=None, seq_axis=1, pad_value=0):
    """``t`` padded with ``pad_value`` up to ``batch`` rows on axis 0 and,
    when ``seq_len`` is given and ``t`` has a ``seq_axis`` dimension, up
    to ``seq_len`` on that axis; ``t`` itself when nothing is padded."""
    shape = list(t.shape)
    if shape[0] > batch:
        raise MXNetError("pad_nd: batch %d exceeds bucket %d"
                         % (shape[0], batch))
    shape[0] = batch
    if seq_len is not None and t.ndim > seq_axis:
        if t.shape[seq_axis] > seq_len:
            raise MXNetError("pad_nd: axis %d size %d exceeds bucket %d"
                             % (seq_axis, t.shape[seq_axis], seq_len))
        shape[seq_axis] = seq_len
    if tuple(shape) == tuple(t.shape):
        return t
    out = t.new_full(shape, pad_value)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


class BucketSpec:
    """The closed set of shapes a Predictor runs: batch sizes (ascending)
    and, optionally, sequence lengths along ``seq_axis`` of every input
    that has it."""

    def __init__(self, batch_sizes, seq_lens=None, seq_axis=1, pad_value=0):
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise MXNetError("BucketSpec: batch_sizes must be >= 1, got %r"
                             % (batch_sizes,))
        self.batch_sizes = tuple(sizes)
        self.seq_lens = (tuple(sorted({int(s) for s in seq_lens}))
                         if seq_lens else None)
        self.seq_axis = int(seq_axis)
        self.pad_value = pad_value

    @classmethod
    def pow2(cls, max_batch, seq_lens=None, seq_axis=1):
        """1, 2, 4, ... up to and including ``max_batch``."""
        top, sizes, b = int(max_batch), [], 1
        while b < top:
            sizes.append(b)
            b *= 2
        sizes.append(top)
        return cls(sizes, seq_lens=seq_lens, seq_axis=seq_axis)

    @property
    def max_batch(self):
        return self.batch_sizes[-1]

    def batch_bucket(self, n):
        """Smallest bucket >= n, or None when n exceeds the largest (the
        caller chunks)."""
        for b in self.batch_sizes:
            if n <= b:
                return b
        return None

    def seq_bucket(self, s):
        """Smallest sequence bucket >= s (None without sequence buckets);
        raises when s exceeds the largest."""
        if self.seq_lens is None:
            return None
        for n in self.seq_lens:
            if s <= n:
                return n
        raise MXNetError(
            "request seq length %d exceeds the largest declared bucket %d "
            "(BucketSpec.seq_lens=%s): sequences cannot be chunked"
            % (s, self.seq_lens[-1], list(self.seq_lens)))

    def buckets(self):
        """Every (batch, seq or None) pair: the set ``warmup()`` runs."""
        seqs = self.seq_lens or (None,)
        return [(b, s) for b in self.batch_sizes for s in seqs]

    def __len__(self):
        return len(self.batch_sizes) * len(self.seq_lens or (None,))

    def __repr__(self):
        return "BucketSpec(batch=%s%s)" % (
            list(self.batch_sizes),
            ", seq=%s@axis%d" % (list(self.seq_lens), self.seq_axis)
            if self.seq_lens else "")


class Predictor:
    """Bucketed inference over a HybridBlock, pinned to one device.

    ``example`` (one input, or a tuple of inputs, with a batch axis) records
    each input's trailing shape and dtype, the templates ``warmup()`` runs
    every bucket with, and settles any deferred parameter shapes. Without
    it the first ``predict`` does both.
    """

    def __init__(self, block, spec, example=None, warmup=False, device=None):
        if not hasattr(block, "collect_params"):
            raise MXNetError("Predictor serves HybridBlock-family models "
                             "(got %s)" % type(block).__name__)
        self._block = block
        self._spec = spec
        self._device = resolve_device(device)
        self._templates = None
        block.collect_params().reset_ctx(self._device)
        if example is not None:
            self._settle(example if isinstance(example, (tuple, list))
                         else (example,))
        if warmup:
            self.warmup()

    @property
    def input_templates(self):
        """[(trailing_shape, dtype)] per input (None before settle)."""
        return self._templates

    def _to_device(self, a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self._device)

    def _settle(self, args):
        datas = [self._to_device(a) for a in args]
        params = list(self._block.collect_params().values())
        if any(not p.initialized for p in params):
            with torch.no_grad():   # deferred shapes settle on first forward
                self._block(*datas)
        if any(not p.initialized for p in params):
            raise MXNetError("Predictor: parameters still uninitialized "
                             "after the example forward")
        self._templates = [(tuple(d.shape[1:]), d.dtype) for d in datas]

    def warmup(self):
        """Run every bucket once on zero inputs (the first launch of each
        kernel builds its library); returns self."""
        if self._templates is None:
            raise MXNetError("Predictor.warmup needs input templates: pass "
                             "example= at construction")
        for b, s in self._spec.buckets():
            self._run([torch.zeros((b,) + self._bucket_trailing(t, s),
                                   dtype=dt, device=self._device)
                       for t, dt in self._templates])
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    def _bucket_trailing(self, trailing, seq):
        ax = self._spec.seq_axis - 1   # the trailing shape has no batch axis
        if seq is None or ax >= len(trailing):
            return trailing
        return trailing[:ax] + (seq,) + trailing[ax + 1:]

    def _run(self, datas):
        with torch.inference_mode():
            out = self._block(*datas)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def _dispatch_one(self, datas, seq, bucket):
        n = int(datas[0].shape[0])
        spec = self._spec
        datas = [pad_nd(d, bucket, seq_len=seq, seq_axis=spec.seq_axis,
                        pad_value=spec.pad_value) for d in datas]
        return [o[:n] for o in self._run(datas)]

    def predict_flat(self, args):
        """The block's outputs as a list: ``args`` padded to their bucket
        (batch, and sequence where declared), run, and sliced back to the
        request's batch, chunked through the largest batch bucket when the
        request exceeds it. Outputs stay on the device."""
        if self._templates is None:
            self._settle(args)
        datas = [self._to_device(a) for a in args]
        n = int(datas[0].shape[0])
        if n == 0:
            raise MXNetError("predict on an empty batch")
        spec = self._spec
        seq = None
        if spec.seq_lens is not None:
            seq = spec.seq_bucket(int(datas[0].shape[spec.seq_axis])
                                  if datas[0].ndim > spec.seq_axis else 0)
        b = spec.batch_bucket(n)
        if b is not None:
            return self._dispatch_one(datas, seq, b)
        bucket = spec.max_batch   # the tail pads to it too
        chunks = [self._dispatch_one([d[lo:lo + bucket] for d in datas], seq,
                                     bucket)
                  for lo in range(0, n, bucket)]
        return [torch.cat([c[i] for c in chunks]) for i in
                range(len(chunks[0]))]

    def predict(self, *args):
        """The user-facing call: numpy arrays or tensors in, the block's
        output (one tensor or a tuple) for the request's batch out."""
        flat = self.predict_flat(args)
        return flat[0] if len(flat) == 1 else tuple(flat)
