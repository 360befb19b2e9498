"""Flash attention (counterpart of ``mxtpu/ops/pallas/flash_attention.py``).

``flash_attention(q, k, v)`` takes ``[B, H, T, D]`` q and ``[B, H, Tk, D]``
k and v and returns softmax(q k^T * scale) v; ``flash_attention_with_lse``
also returns the float32 log-sum-exp ``[B, H, T]``. On a CUDA tensor they
launch the hand-written kernel of ``mxtpu_torch/csrc/flash_attention.cu``
(which replaces the TPU's ``_fa_kernel``) or raise; on a CPU tensor they
run the plain PyTorch version ``flash_attention_reference``, which repeats
the JAX package's ``_xla_attention_lse``.

The kernel takes any T and Tk (it masks the ragged tails itself) and any
D <= 128, so the port has none of the TPU's XLA fallback paths or head-dim
padding; a larger D raises on every device. q, k and v may be strided
views whose last dim is contiguous. ``block_q``/``block_k`` are the TPU
kernel's block wants, kept for the reference's signature: the CUDA
kernel's tiles are 64 x 64 whatever they say.

Forward only: the backward (``_fa_backward_blockwise`` in the JAX package)
comes with training, so the kernel refuses a tensor that needs a gradient
while grad mode is on (the plain version on the CPU is differentiable as
it is). ``flash_attention.launches`` counts kernel launches of both entry
points; it never counts a call that ran the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference"]

_NEG_INF = -1e30   # mask value: the online rescale never sees -inf - -inf
_MAX_HEAD_DIM = 128   # the kernel's largest tile width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(q, scale):
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """The plain version, ``(out, lse)``: scores in float32, ``-1e30``
    where causal masks, ``lse = logsumexp``, ``exp(s - lse) @ v`` in
    float32, out cast to q's type (``_xla_attention_lse``)."""
    scale = _scale(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2:]
        mask = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise MXNetError("flash_attention: %s must be [B, H, T, D], got "
                             "%s" % (name, tuple(t.shape)))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k and v must all be float32 or "
                         "all bfloat16, got %s, %s and %s"
                         % (q.dtype, k.dtype, v.dtype))
    b, h, t, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or tuple(k.shape[:2]) != (b, h) \
            or k.shape[3] != d:
        raise MXNetError("flash_attention: k and v must be [%d, %d, Tk, %d], "
                         "got %s and %s" % (b, h, d, tuple(k.shape),
                                            tuple(v.shape)))
    if min(b, h, t, d, k.shape[2]) < 1:
        raise MXNetError("flash_attention: empty input %s" % (tuple(q.shape),))
    if d > _MAX_HEAD_DIM:
        raise MXNetError("flash_attention: head dim %d exceeds the kernel's "
                         "%d" % (d, _MAX_HEAD_DIM))
    if k.device != q.device or v.device != q.device:
        raise MXNetError("flash_attention: q, k and v must share a device, "
                         "got %s, %s and %s" % (q.device, k.device, v.device))


def _launch(q, k, v, causal, scale):
    from ... import kernels
    fn = kernels.library("flash_attention").mxtpu_flash_attention_fwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, h, t, d = q.shape
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, h, t, k.shape[2], d, int(bool(causal)), scale,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise MXNetError("flash_attention kernel launch failed: CUDA error %d"
                         % rc)
    flash_attention.launches += 1
    return out, lse


def flash_attention_with_lse(q, k, v, causal=False, scale=None, block_q=512,
                             block_k=512):
    """``(out, lse)``: attention ``[B, H, T, D]`` in q's type and the
    float32 per-row log-sum-exp ``[B, H, T]`` (the quantity that merges
    partial attention over disjoint key sets exactly)."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise MXNetError("the flash_attention kernel is forward-only: its "
                         "backward comes with the training port; run under "
                         "torch.no_grad()/inference_mode()")
    if q.device.type != "cuda":
        raise MXNetError("flash_attention: no kernel for device %s"
                         % q.device)
    return _launch(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=False, scale=None, block_q=512,
                    block_k=512):
    """Fused attention ``[B, H, T, D] -> [B, H, T, D]``; ``scale`` defaults
    to ``1/sqrt(D)``."""
    return flash_attention_with_lse(q, k, v, causal, scale, block_q,
                                    block_k)[0]


flash_attention.launches = 0
