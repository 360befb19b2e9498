"""Gluon utilities (counterpart of ``mxtpu/gluon/utils.py``): split a
batch over contexts, clip gradients by their global norm, check a file's
sha1. ``download`` raises, as the reference's does: nothing here reaches a
network."""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``, the last one
    taking the remainder (ref: utils.py:split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's a multiple of %d or set "
            "even_split=False."
            % (str(tuple(data.shape)), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis``, one slice on each context of
    ``ctx_list`` (ref: utils.py:split_and_load)."""
    from ..ndarray import array
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (NDArrays, gradients as a rule) in place so that
    the 2-norm of all of them together is at most ``max_norm``; returns
    that norm before scaling as a Python float (ref:
    utils.py:clip_global_norm). The norm is read back to the host, as the
    reference reads it, so a call waits for the device once."""
    if not arrays:
        raise MXNetError("arrays must not be empty")
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    total = torch.sqrt(sum(torch.sum(torch.square(t.float()))
                           for t in tensors))
    total_f = float(total)
    if check_isfinite and not math.isfinite(total_f):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_f + 1e-8)
    if scale < 1.0:
        for a, t in zip(arrays, tensors):
            scaled = t * scale
            if isinstance(a, NDArray):
                a._set_data(scaled)
            else:
                with torch.no_grad():
                    t.copy_(scaled)
    return total_f


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s sha1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """Raises, as the reference's does: there is no network path."""
    raise MXNetError("download() requires network access, which is "
                     "unavailable in this environment")
