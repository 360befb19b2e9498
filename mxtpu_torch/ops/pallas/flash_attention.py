"""Flash attention (counterpart of ``mxtpu/ops/pallas/flash_attention.py``).

``flash_attention(q, k, v)`` takes ``[B, H, T, D]`` q and ``[B, H, Tk, D]``
k and v and returns softmax(q k^T * scale) v; ``flash_attention_with_lse``
also returns the float32 log-sum-exp ``[B, H, T]``. On a CUDA tensor they
launch the hand-written kernel of ``mxtpu_torch/csrc/flash_attention.cu``
(which replaces the TPU's ``_fa_kernel``) or raise; on a CPU tensor they
run the plain PyTorch version ``flash_attention_reference``, which repeats
the JAX package's ``_xla_attention_lse``.

The kernel takes any T and Tk (it masks the ragged tails itself) and any
D >= 1 (past 128 in 128-column slices of out, each recomputing the scores
over all of D), so the port has none of the TPU's XLA fallback paths or
head-dim padding. q, k and v may be strided views whose last dim is
contiguous. ``block_q``/``block_k`` are the TPU
kernel's block wants, kept for the reference's signature: the CUDA
kernel picks its own tiles and grid (``_launch_args``) whatever they say.

Differentiable in q, k and v through both outputs: where grad mode is on
and an input needs a gradient, the call runs as ``_Flash``, a
``torch.autograd.Function`` whose forward is the kernel (the plain version
on a CPU tensor) and saves q, k, v, out and lse, and whose backward is
``flash_attention_backward``, one port of the JAX package's
``_fa_backward_blockwise`` that runs on both devices (plain array code
there too): P recomputed from lse in float32 blocks of ``block_k`` keys,
so no [B, H, T, Tk] matrix is held at long T, and the lse cotangent folded
into the row constant. The gradients flow back to strided q/k/v views as
to any tensor. A meta tensor (the symbol layer's shape inference) gives
meta outputs (out and lse) and counts no launch; off the CPU, the card and
meta the call raises "no kernel for device", with or without a gradient. ``flash_attention.launches`` counts
forward kernel launches of both entry points; it never counts a call that
ran the plain version, nor a backward.

Autotune (``autotune``, kernel id ``pallas_flash``): in bfloat16 up to
D 128 the plans are ``wgs`` (warpgroups a block) 1 or 2 times ``d_tile``,
the smallest tile that holds D or 128 (the instances of
``csrc/flash_attention.cu``); float32 and the sliced kernels have one
plan, the default. The default is what ``_launch_args`` picks without a
plan; with one served (``autotune.lookup`` on the shape class B, H, T,
Tk, D and dtype), ``_launch_args`` takes its ``wgs`` and ``d_tile`` and
recomputes the rows a block, the row blocks and the grid from them. The
classes swept are BERT-base's attention at [8, 12, 512, 64] and [16, 12,
512, 64] in bfloat16.

``DISPATCH_STATS`` is the reference's view over the telemetry counters
``pallas_flash.{pallas,xla,fallback}``: ``pallas`` counts a kernel launch
on the card and ``xla`` a call of the plain version on the CPU; the port
has no fallback, so ``fallback_reasons`` stays empty. Like B1's, the
counters count each eager call and a graph's capture pass once
(``graphs.counts_dispatch``), never a replay.

``shape_class_of`` is the reference's name for ``shape_class``: the same
dict.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...base import MXNetError
from ... import telemetry, xprof
from ...graphs import counts_dispatch, launched
from . import autotune

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "flash_attention_backward",
           "DISPATCH_STATS", "reset_dispatch_stats", "shape_class_of"]

_NEG_INF = -1e30   # mask value: the online rescale never sees -inf - -inf
_SLICE = 128   # columns of out per block past D 128 (the sliced kernels)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BWD_BLOCK_K = 512   # keys per block of the backward (the JAX default)


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
    if k.device != q.device or v.device != q.device:
        raise MXNetError("flash_attention: q, k and v must share a device, "
                         "got %s, %s and %s" % (q.device, k.device, v.device))


LaunchArgs = collections.namedtuple(
    "LaunchArgs", "dtype d_tile vec warpgroups block_q n_q slices grid")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned16(t):
    """The 16-byte async copy can read ``t``: base address and the byte
    stride of every dim of more than one element are multiples of 16 (a
    dim of one element never advances its stride)."""
    es, n, st = t.element_size(), t.shape, t.stride()
    return (t.data_ptr() % 16 == 0 and (n[0] == 1 or st[0] * es % 16 == 0)
            and (n[1] == 1 or st[1] * es % 16 == 0)
            and (n[2] == 1 or st[2] * es % 16 == 0))


def _launch_args(q, k, v, causal, scale, sms=None, plan=None):
    """What ``_launch`` hands the kernel for these views; the C entry point
    only refuses what would take it out of bounds. It reads only shapes,
    strides, dtypes and ``data_ptr``, so CPU tensors do, given ``sms``:

    * ``dtype``: 0 float32, 1 bfloat16; ``d_tile``: the tile width of out
      that D is zero-filled to, 32, 64 or 128; ``slices``: 1 up to D 128,
      past it ``ceil(D / 128)`` blocks of 128 columns of out per row block
      (the sliced kernels: each computes the scores over all of D in
      64-column chunks, then P V for its own slice; bfloat16 runs one
      warpgroup of 64 rows, float32 128 rows);
    * ``vec``: the 16-byte async-copy staging takes the views (every row
      starts 16-byte aligned and D fills whole 16-byte chunks); otherwise
      the kernel stages element by element;
    * ``warpgroups``: bfloat16 runs 64 query rows per warpgroup and puts two
      in a block (128 rows sharing one k/v ring) where ``B*H*ceil(T/128)``
      fills the ``sms`` SMs (default: those of q's card) at least twice
      over, else one; float32 runs one 128-thread group over 128 rows;
    * ``block_q`` rows per block, ``n_q`` row blocks per (batch, head),
      ``grid`` blocks in all (128 threads a warpgroup).

    A ``plan`` (``{"wgs", "d_tile"}``, from autotune) gives the
    warpgroups and the tile instead; the rows a block, the row blocks and
    the grid follow from them. ``causal`` and ``scale`` do not change the
    launch; they go to the kernel as arguments.
    """
    b, h, t, d = q.shape
    dtype = _DTYPE_CODE[q.dtype]
    slices = -(-d // _SLICE)
    vec = (d * q.element_size()) % 16 == 0 and _aligned16(q) \
        and _aligned16(k) and _aligned16(v)
    if plan is not None:
        d_tile, warpgroups = int(plan["d_tile"]), int(plan["wgs"])
    else:
        if sms is None and dtype == 1 and slices == 1:
            sms = _sm_count(q.device.index or 0)
        d_tile, warpgroups = _pick(b, h, t, d, dtype, sms)
    block_q = 128 if dtype == 0 else 64 * warpgroups
    n_q = -(-t // block_q)
    return LaunchArgs(dtype, d_tile, vec, warpgroups, block_q, n_q, slices,
                      b * h * n_q * slices)


def _pick(b, h, t, d, dtype, sms):
    """(d_tile, warpgroups) without a plan: ``_launch_args``'s rule."""
    d_tile = 32 if d <= 32 else 64 if d <= 64 else _SLICE
    if dtype == 0 or d > _SLICE:
        return d_tile, 1
    return d_tile, 2 if b * h * -(-t // 128) >= 2 * sms else 1


# ----------------------------------------------------- autotune descriptor
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def shape_class(q, k):
    """The autotune shape class of a launch."""
    b, h, t, d = q.shape
    return {"b": int(b), "h": int(h), "t": int(t), "tk": int(k.shape[2]),
            "d": int(d), "dtype": _DTYPE_NAME[q.dtype]}


shape_class_of = shape_class


def _default_sms():
    return _sm_count(0) if torch.cuda.is_available() else 132


def _tune_default(sc, sms=None):
    d_tile, wgs = _pick(sc["b"], sc["h"], sc["t"], sc["d"],
                        _DTYPE_CODE[getattr(torch, sc["dtype"])],
                        _default_sms() if sms is None else sms)
    return {"d_tile": d_tile, "wgs": wgs}


def _tune_space(sc):
    if sc["dtype"] != "bfloat16" or sc["d"] > _SLICE:
        return [_tune_default(sc)]
    small = 32 if sc["d"] <= 32 else 64 if sc["d"] <= 64 else _SLICE
    return [{"d_tile": dt, "wgs": wgs} for wgs in (1, 2)
            for dt in sorted({small, _SLICE})]


def _tune_feasible(plan, sc):
    dt, wgs = int(plan.get("d_tile", 0)), int(plan.get("wgs", 0))
    if sc["dtype"] != "bfloat16" or sc["d"] > _SLICE:
        default = _tune_default(sc, sms=1 << 30)
        if (dt, wgs) != (default["d_tile"], default["wgs"]):
            return False, "one plan for float32 and the sliced kernels"
        return True, None
    if dt not in (32, 64, _SLICE) or dt < sc["d"]:
        return False, "d_tile=%d does not hold D=%d" % (dt, sc["d"])
    if wgs not in (1, 2):
        return False, "no instance with %d warpgroups" % wgs
    return True, None   # every bf16 instance fits a block's shared memory


def _tune_runner(sc):
    """Seeded q, k, v on the card (the CPU without one) and a call through
    ``flash_attention``, not causal (the plan also serves the causal
    variant of the class)."""
    gen = torch.Generator().manual_seed(0)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    dt = getattr(torch, sc["dtype"])
    q = torch.randn(sc["b"], sc["h"], sc["t"], sc["d"], generator=gen)
    k = torch.randn(sc["b"], sc["h"], sc["tk"], sc["d"], generator=gen)
    v = torch.randn(sc["b"], sc["h"], sc["tk"], sc["d"], generator=gen)

    def fn(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=False)
    return fn, (q.to(dev, dt), k.to(dev, dt), v.to(dev, dt))


def _tune_classes():
    """BERT-base's attention at b8 and b16 x 12 heads x 512, D 64, bf16."""
    return [{"b": b, "h": 12, "t": 512, "tk": 512, "d": 64,
             "dtype": "bfloat16"} for b in (8, 16)]


def _plan_of(q, k):
    """The autotune plan of this launch (None: the default)."""
    if not autotune.consulted():
        return None
    sc = shape_class(q, k)
    plan = autotune.lookup("pallas_flash", sc)
    if plan is not None and not _tune_feasible(plan, sc)[0]:
        autotune.plan_infeasible("pallas_flash")
        return None
    return plan


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, its ctypes signature set once."""
    from ... import kernels
    fn = kernels.library("flash_attention").mxtpu_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(q, k, v, causal, scale):
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    la = _launch_args(q, k, v, causal, scale, plan=_plan_of(q, k))
    b, h, t, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    args = (la.dtype, la.d_tile, la.vec, la.warpgroups, la.n_q, la.slices,
            q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, h, t,
            k.shape[2], d, bool(causal), _scale(q, scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if q.device.index == torch.cuda.current_device():
        rc = _entry()(*args)
    else:   # the kernel launches on the current device
        with torch.cuda.device(q.device):
            rc = _entry()(*args)
    if rc != 0:
        raise MXNetError("flash_attention kernel launch failed: CUDA error %d"
                         % rc)
    launched(flash_attention)
    if counts_dispatch():
        telemetry.inc("pallas_flash.pallas")
    # the FLOP ledger's count of the launch: QK^T and PV, a multiply-add a
    # product, half the scores under a causal mask
    xprof.add_flops(4.0 * b * h * t * k.shape[2] * d
                    * (0.5 if causal else 1.0))
    return out, lse


def flash_attention_backward(q, k, v, out, lse, g, causal, scale,
                             g_lse=None, block_k=_BWD_BLOCK_K):
    """(dq, dk, dv) from the cotangents of out (``g``, None for zero) and
    of lse (``g_lse``, None for zero): the JAX package's
    ``_fa_backward_blockwise`` in float32, over blocks of ``block_k``
    keys: P = exp(S - lse), dv = P^T g, ds = P (g v^T - delta) scale with
    delta = sum(out g) - g_lse, dq += ds k, dk = ds^T q. Masked scores
    are -1e30, as in the forward. Each gradient comes back in its input's
    type."""
    f32 = torch.float32
    q32, k32, v32 = q.to(f32), k.to(f32), v.to(f32)
    g32 = torch.zeros_like(q32) if g is None else g.to(f32)
    delta = (out.to(f32) * g32).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.to(f32)
    t, tk = q.shape[2], k.shape[2]
    dq = torch.zeros_like(q32)
    dk = torch.empty(k.shape, dtype=f32, device=k.device)
    dv = torch.empty(v.shape, dtype=f32, device=v.device)
    q_pos = torch.arange(t, device=q.device)[:, None]
    for j in range(0, tk, block_k):
        ks, vs = k32[:, :, j:j + block_k], v32[:, :, j:j + block_k]
        s = torch.matmul(q32, ks.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(j, j + ks.shape[2], device=q.device)
            s = torch.where(q_pos >= k_pos[None, :], s, _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dv[:, :, j:j + block_k] = torch.matmul(p.transpose(-1, -2), g32)
        dp = torch.matmul(g32, vs.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.matmul(ds, ks)
        dk[:, :, j:j + block_k] = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """``flash_attention_with_lse`` with its backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cuda":
            out, lse = _launch(q, k, v, causal, scale)
        else:
            telemetry.inc("pallas_flash.xla")
            out, lse = flash_attention_reference(q, k, v, causal, scale)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g,
                                              ctx.causal, ctx.scale, g_lse)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None, block_q=512,
                             block_k=512):
    """``(out, lse)``: attention ``[B, H, T, D]`` in q's type and the
    float32 per-row log-sum-exp ``[B, H, T]`` (the quantity that merges
    partial attention over disjoint key sets exactly)."""
    _check(q, k, v)
    if q.device.type == "meta":   # shape inference: no kernel, no count
        return (torch.empty(q.shape, dtype=q.dtype, device="meta"),
                torch.empty(q.shape[:3], dtype=torch.float32, device="meta"))
    if q.device.type not in ("cuda", "cpu"):
        raise MXNetError("flash_attention: no kernel for device %s"
                         % q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, bool(causal), _scale(q, scale))
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    telemetry.inc("pallas_flash.xla")
    return flash_attention_reference(q, k, v, causal, _scale(q, scale))


def flash_attention(q, k, v, causal=False, scale=None, block_q=512,
                    block_k=512):
    """Fused attention ``[B, H, T, D] -> [B, H, T, D]``; ``scale`` defaults
    to ``1/sqrt(D)``."""
    return flash_attention_with_lse(q, k, v, causal, scale, block_q,
                                    block_k)[0]


flash_attention.launches = 0
flash_attention.library = "flash_attention"   # what a capture needs

autotune.register_kernel(autotune.TunableKernel(
    kernel_id="pallas_flash", space=_tune_space, default=_tune_default,
    feasible=_tune_feasible, runner=_tune_runner, classes=_tune_classes))


class _DispatchStatsView:
    """Read-only dict-shaped view over the ``pallas_flash.*`` counters
    (the reference's ``DISPATCH_STATS``)."""

    _KEYS = ("pallas", "xla", "fallback_reasons")

    def __getitem__(self, key):
        if key == "fallback_reasons":
            return telemetry.tagged("pallas_flash.fallback")
        if key not in self._KEYS:
            raise KeyError(key)
        return int(telemetry.value("pallas_flash." + key))

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def keys(self):
        return list(self._KEYS)

    def items(self):
        return [(k, self[k]) for k in self._KEYS]

    def __repr__(self):
        return repr(dict(self.items()))


DISPATCH_STATS = _DispatchStatsView()


def reset_dispatch_stats():
    for name in ("pallas_flash.pallas", "pallas_flash.xla",
                 "pallas_flash.fallback"):
        telemetry.reset_metric(name)
