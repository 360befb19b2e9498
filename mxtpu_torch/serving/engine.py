"""Bucketed inference (counterpart of ``mxtpu/serving/engine.py``).

``BucketSpec`` declares the batch buckets a ``Predictor`` serves. A request
of n items runs at the smallest bucket >= n: it is padded with zeros up to
the bucket, the block's forward runs under ``torch.inference_mode()``, and
the output is sliced back to n rows. A request larger than the largest
bucket goes through it in chunks whose outputs are concatenated.

The predictor's device is ``cuda:0`` unless the caller names one; with no
card and no device it raises. Not in this slice: int8 weights, replicas,
the compile service and telemetry spans. Buckets are eager PyTorch runs;
CUDA-graph capture of each bucket comes later.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["BucketSpec", "Predictor"]


class BucketSpec:
    """The closed set of batch sizes a Predictor runs (ascending)."""

    def __init__(self, batch_sizes):
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise MXNetError("BucketSpec: batch_sizes must be >= 1, got %r"
                             % (batch_sizes,))
        self.batch_sizes = tuple(sizes)

    @classmethod
    def pow2(cls, max_batch):
        """1, 2, 4, ... up to and including ``max_batch``."""
        top, sizes, b = int(max_batch), [], 1
        while b < top:
            sizes.append(b)
            b *= 2
        sizes.append(top)
        return cls(sizes)

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

    def buckets(self):
        return list(self.batch_sizes)

    def __repr__(self):
        return "BucketSpec(batch=%s)" % (list(self.batch_sizes),)


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
        for b in self._spec.buckets():
            self._run([torch.zeros((b,) + t, dtype=dt, device=self._device)
                       for t, dt in self._templates])
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    def _run(self, datas):
        with torch.inference_mode():
            out = self._block(*datas)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def _dispatch_one(self, datas, bucket):
        n = int(datas[0].shape[0])
        if n != bucket:
            datas = [torch.cat([d, d.new_zeros((bucket - n,) + d.shape[1:])])
                     for d in datas]
        return [o[:n] for o in self._run(datas)]

    def predict_flat(self, args):
        """The block's outputs as a list: ``args`` padded to their bucket,
        run, and sliced back to the request's batch, chunked through the
        largest bucket when the request exceeds it. Outputs stay on the
        device."""
        if self._templates is None:
            self._settle(args)
        datas = [self._to_device(a) for a in args]
        n = int(datas[0].shape[0])
        if n == 0:
            raise MXNetError("predict on an empty batch")
        b = self._spec.batch_bucket(n)
        if b is not None:
            return self._dispatch_one(datas, b)
        bucket = self._spec.max_batch   # the tail pads to it too
        chunks = [self._dispatch_one([d[lo:lo + bucket] for d in datas],
                                     bucket)
                  for lo in range(0, n, bucket)]
        return [torch.cat([c[i] for c in chunks]) for i in
                range(len(chunks[0]))]

    def predict(self, *args):
        """The user-facing call: numpy arrays or tensors in, the block's
        output (one tensor or a tuple) for the request's batch out."""
        flat = self.predict_flat(args)
        return flat[0] if len(flat) == 1 else tuple(flat)
