"""Fused implicit-GEMM convolution (counterpart of ``mxtpu/ops/pallas/conv.py``).

``fused_conv`` computes ``relu(conv(x, w) * scale + bias + residual)`` for
NHWC x and HWIO w in one pass. On a CUDA tensor it launches the hand-written
kernel of ``mxtpu_torch/csrc/fused_conv.cu`` (which replaces the TPU's
``_conv_kernel``) or raises; on a CPU tensor it runs the plain PyTorch
version ``fused_conv_reference``, which repeats the kernel's arithmetic.

``pallas_applicable`` is the JAX package's gate, with the same decisions
and reasons: ``conv_acc.conv_fast`` routes a conv here when the gate admits
it. The gate keeps the TPU's 128-lane rule for now, so the port runs the
same convs through its kernel as the JAX package does.

Differentiable in x, w, scale, bias and residual: where grad mode is on
and an input needs a gradient, the call runs as ``_FusedConv``, a
``torch.autograd.Function`` whose forward is the kernel (the plain version
on a CPU tensor) and whose backward is ``fused_conv_backward``, one port of
the JAX package's ``_core_bwd`` and ``_conv_grads_blockwise`` that runs on
both devices (plain array code there too, no Pallas kernel): the ReLU
mask, ``d_residual`` in the residual's type, ``d_bias = sum g``,
``d_scale = sum g * craw``, and ``dz = g * scale`` cast to the operands'
type before the two gradient convolutions (``convolution_backward`` on
channels-last views; f32 accumulation, TF32 off by the precision policy).
The forward saves what ``_core_fwd_impl`` saves: x, w, scale, bias, out
only under ``relu`` and craw only with ``scale``. A meta tensor (the
symbol layer's shape inference) gives meta outputs of the right shape and
dtype and counts no launch; off the CPU, the card and meta the call raises
"no kernel for device", with or without a gradient.
``fused_conv.launches`` counts forward kernel launches; it never counts
a call that ran the plain version, nor a backward.

The kernel's launch (bfloat16 on the tensor cores, float32 on the CUDA
cores; 16-byte or element-wise staging; tiles, padded K and grid) is
decided by the pure ``_launch_args`` alone; the C entry point only
refuses what would go out of bounds.

Autotune (``autotune``, kernel id ``pallas_conv``): the plans are the
output tiles the entry point has instances for (``block_m`` x ``block_n``:
64 or 128 each in bfloat16; 128 x 64 and 64 x 128 in float32), the
default is what ``_launch_args`` picks without one, and a plan that would
take more shared memory than a block may have is infeasible
(``tc_smem_bytes``/``f32_smem_bytes`` against ``SMEM_MAX``, as the entry
point checks). With a plan served (``autotune.lookup`` on the launch's
shape class: N, H, W, C_in, kh, kw, C_out, strides, padding and dtype),
``_launch_args`` takes its tiles and recomputes the threads and the grid
from them. The shape classes swept are ResNet-50 v1's five gated convs at
batch 8 and 128 in bfloat16.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from ...base import MXNetError
from ... import xprof
from ...graphs import launched
from ..precision_util import promote
from . import autotune

__all__ = ["fused_conv", "fused_conv_with_raw", "fused_conv_reference",
           "fused_conv_backward", "pallas_applicable", "out_hw"]

_MXU_LANES = 128
_LOW = (torch.bfloat16, torch.float32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CUDA_CORES, TENSOR_CORES = 0, 1   # the kernel's two routes


def out_hw(size, lo, hi, k, s):
    return (size + lo + hi - k) // s + 1


def pallas_applicable(x, w, strides, padding, lhs_dilation, rhs_dilation,
                      dims, groups):
    """(True, None) when the conv is in the kernel's domain AND its shape
    underfills the 128-wide contraction on one side (im2col K =
    kh*kw*C_in < 128 or C_out < 128), else (False, reason). Decisions and
    reasons equal ``mxtpu.ops.pallas.conv.pallas_applicable``."""
    if tuple(dims) != ("NHWC", "HWIO", "NHWC"):
        return False, "layout not NHWC/HWIO"
    if x.ndim != 4:
        return False, "not a 2D conv"
    if int(groups) != 1:
        return False, "grouped conv"
    if tuple(lhs_dilation) != (1, 1):
        return False, "lhs dilation (transposed conv)"
    if tuple(rhs_dilation) != (1, 1):
        return False, "rhs dilation"
    if x.dtype not in _LOW or w.dtype not in _LOW:
        return False, "dtype not f32/bf16"
    if x.dtype != w.dtype:
        return False, "mixed operand dtypes"
    if any(p < 0 for pair in padding for p in pair):
        return False, "negative padding"
    kh, kw, cin, cout = w.shape
    k_im2col = kh * kw * cin
    if k_im2col >= _MXU_LANES and cout >= _MXU_LANES:
        return False, ("MXU-filled shape (K=%d, C_out=%d): XLA path is "
                       "already near ceiling" % (k_im2col, cout))
    sh, sw = tuple(strides)
    (plo, phi), (qlo, qhi) = (tuple(p) for p in padding)
    oh = out_hw(x.shape[1], plo, phi, kh, sh)
    ow = out_hw(x.shape[2], qlo, qhi, kw, sw)
    if oh < 1 or ow < 1:
        return False, "degenerate output"
    return True, None


def fused_conv_reference(x, w, strides=(1, 1), padding=((0, 0), (0, 0)),
                         scale=None, bias=None, residual=None, relu=False):
    """The plain version: the kernel's arithmetic in PyTorch ops.

    Upcasts to float32, sums the kh*kw strided-slice products
    ``[M, C_in] @ [C_in, C_out]``, applies the epilogue in float32 and casts
    to the operands' type. Returns ``(out, craw)``, ``craw`` the float32
    raw conv when ``scale`` is given, else None."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    sh, sw = strides
    (plo, phi), (qlo, qhi) = padding
    oh, ow = out_hw(h, plo, phi, kh, sh), out_hw(wd, qlo, qhi, kw, sw)
    xp = torch.nn.functional.pad(x.float(), (0, 0, qlo, qhi, plo, phi))
    wf = w.float()
    acc = torch.zeros(n * oh * ow, cout, dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[:, dy:dy + sh * (oh - 1) + 1:sh,
                       dx:dx + sw * (ow - 1) + 1:sw, :]
            acc += patch.reshape(-1, cin) @ wf[dy, dx]
    acc = acc.reshape(n, oh, ow, cout)
    pre, craw = acc, None
    if scale is not None:
        craw = acc
        pre = pre * scale.float()
    if bias is not None:
        pre = pre + bias.float()
    if residual is not None:
        pre = pre + residual.float()
    if relu:
        pre = torch.where(pre < 0, torch.zeros_like(pre), pre)
    return pre.to(x.dtype), craw


def _check(x, w, strides, padding, scale, bias, residual):
    """Validate what the kernel takes; returns (oh, ow)."""
    if x.ndim != 4 or w.ndim != 4:
        raise MXNetError("fused_conv: x must be NHWC [N,H,W,C] and w HWIO "
                         "[kh,kw,C_in,C_out], got %s and %s"
                         % (tuple(x.shape), tuple(w.shape)))
    if x.dtype not in _LOW or x.dtype != w.dtype:
        raise MXNetError("fused_conv: x and w must both be float32 or both "
                         "bfloat16, got %s and %s" % (x.dtype, w.dtype))
    n, h, wd, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin:
        raise MXNetError("fused_conv: w has C_in=%d, x has C=%d" % (wcin, cin))
    (plo, phi), (qlo, qhi) = padding
    if min(plo, phi, qlo, qhi) < 0 or min(strides) < 1:
        raise MXNetError("fused_conv: padding must be >= 0 and strides >= 1")
    oh, ow = out_hw(h, plo, phi, kh, strides[0]), out_hw(wd, qlo, qhi, kw,
                                                        strides[1])
    if oh < 1 or ow < 1:
        raise MXNetError("fused_conv: degenerate output %dx%d" % (oh, ow))
    for name, v, shape in (("scale", scale, (cout,)), ("bias", bias, (cout,)),
                           ("residual", residual, (n, oh, ow, cout))):
        if v is None:
            continue
        if tuple(v.shape) != shape:
            raise MXNetError("fused_conv: %s must have shape %s, got %s"
                             % (name, shape, tuple(v.shape)))
        if v.device != x.device:
            raise MXNetError("fused_conv: %s is on %s, x on %s"
                             % (name, v.device, x.device))
    if w.device != x.device:
        raise MXNetError("fused_conv: w is on %s, x on %s"
                         % (w.device, x.device))
    return oh, ow


LaunchArgs = collections.namedtuple(
    "LaunchArgs", "dtype route vec_a vec_b block_m block_n threads k_pad grid")


def _launch_args(x, w, strides, padding, sms=None, plan=None):
    """What ``_launch`` hands the kernel for these operands; the C entry
    point only refuses what would take it out of bounds. It reads only
    shapes, dtypes and ``data_ptr``, so CPU tensors do, given ``sms``:

    * ``dtype``: 0 float32, 1 bfloat16; ``route``: ``TENSOR_CORES`` (1,
      bfloat16: ``wgmma``, 64 pixels per warpgroup) or ``CUDA_CORES`` (0,
      float32, TF32 off: 8 x 8 register micro-tiles);
    * ``vec_a`` / ``vec_b``: A (x's pixel rows) / B (w's rows) are staged
      by 16-byte copies when their rows fill whole 16-byte pieces
      (``C_in * size % 16 == 0``, resp. ``C_out * size % 16 == 0``) and
      the tensor starts 16-byte aligned; otherwise element by element;
    * ``block_n`` output channels a block: 64 up to C_out 64, else 128;
      ``block_m`` pixels a block: in bfloat16 128 where 128-pixel blocks
      fill the ``sms`` SMs (default: those of x's card) at least twice
      over, else 64; in float32 128 with ``block_n`` 64, else 64 (128
      threads either way); ``threads`` a block; a ``plan``
      (``{"block_m", "block_n"}``, from autotune) gives the two tiles
      instead, and the threads and the grid follow from them;
    * ``k_pad``: K = kh*kw*C_in rounded up to 16 (the kernel zero-fills
      past K); ``grid``: (blocks over the pixels, blocks over C_out).
    """
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    (plo, phi), (qlo, qhi) = padding
    m = n * out_hw(h, plo, phi, kh, strides[0]) * out_hw(wd, qlo, qhi, kw,
                                                        strides[1])
    es = x.element_size()
    dtype = _DTYPE_CODE[x.dtype]
    route = TENSOR_CORES if dtype == 1 else CUDA_CORES
    vec_a = (cin * es) % 16 == 0 and x.data_ptr() % 16 == 0
    vec_b = (cout * es) % 16 == 0 and w.data_ptr() % 16 == 0
    if sms is None and plan is None:
        from .flash_attention import _sm_count
        sms = _sm_count(x.device.index or 0)
    k_pad = -(-(kh * kw * cin) // 16) * 16
    block_m, block_n = _tiles(m, cout, route, sms, plan)
    threads = block_m // 64 * 128 if route == TENSOR_CORES \
        else block_m * block_n // 64
    return LaunchArgs(dtype, route, vec_a, vec_b, block_m, block_n, threads,
                      k_pad, (-(-m // block_m), -(-cout // block_n)))


def _tiles(m, cout, route, sms, plan=None):
    """(block_m, block_n): the plan's, else ``_launch_args``'s rule."""
    if plan is not None:
        return int(plan["block_m"]), int(plan["block_n"])
    block_n = 64 if cout <= 64 else 128
    if route == TENSOR_CORES:
        grid_n = -(-cout // block_n)
        return (128 if -(-m // 128) * grid_n >= 2 * sms else 64), block_n
    return (128 if block_n == 64 else 64), block_n


# ----------------------------------------------------- autotune descriptor
_SMEM_MAX = 232448 - 3072   # csrc/fused_conv.cu's SMEM_MAX
_TC_BK, _TC_STAGES, _F32_BK, _F32_STAGES = 64, 4, 32, 3
_PLANS = {"bfloat16": [(64, 64), (64, 128), (128, 64), (128, 128)],
          "float32": [(128, 64), (64, 128)]}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _smem_bytes(block_m, block_n, k, dtype):
    """The entry point's shared memory for these tiles (its
    ``tc_smem_bytes`` / ``f32_smem_bytes``)."""
    k_pad = -(-k // 16) * 16
    if dtype == "bfloat16":
        chunks = -(-k_pad // _TC_BK)
        ring = min(chunks, _TC_STAGES) * (block_m + block_n) * _TC_BK * 2
        return 1024 + max(ring, block_m * (block_n + 8) * 4)
    chunks = -(-k_pad // _F32_BK)
    return 4 * min(chunks, _F32_STAGES) * (
        block_m * (_F32_BK + 4) + _F32_BK * (block_n + 4))


def shape_class(x, w, strides, padding):
    """The autotune shape class of a launch."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    return {"n": int(n), "h": int(h), "w": int(wd), "cin": int(cin),
            "kh": int(kh), "kw": int(kw), "cout": int(cout),
            "sh": int(strides[0]), "sw": int(strides[1]),
            "p0": int(padding[0][0]), "p1": int(padding[0][1]),
            "q0": int(padding[1][0]), "q1": int(padding[1][1]),
            "dtype": _DTYPE_NAME[x.dtype]}


def _class_m(sc):
    return sc["n"] * out_hw(sc["h"], sc["p0"], sc["p1"], sc["kh"],
                            sc["sh"]) * out_hw(sc["w"], sc["q0"], sc["q1"],
                                               sc["kw"], sc["sw"])


def _default_sms():
    if torch.cuda.is_available():
        from .flash_attention import _sm_count
        return _sm_count(0)
    return 132   # the H100 SXM's, where no card answers


def _tune_space(sc):
    return [{"block_m": bm, "block_n": bn} for bm, bn in _PLANS[sc["dtype"]]]


def _tune_default(sc, sms=None):
    route = TENSOR_CORES if sc["dtype"] == "bfloat16" else CUDA_CORES
    bm, bn = _tiles(_class_m(sc), sc["cout"], route,
                    _default_sms() if sms is None else sms)
    return {"block_m": bm, "block_n": bn}


def _tune_feasible(plan, sc):
    tiles = (int(plan.get("block_m", 0)), int(plan.get("block_n", 0)))
    if tiles not in _PLANS[sc["dtype"]]:
        return False, "no %s instance of %dx%d tiles" % ((sc["dtype"],)
                                                          + tiles)
    smem = _smem_bytes(tiles[0], tiles[1], sc["kh"] * sc["kw"] * sc["cin"],
                       sc["dtype"])
    if smem > _SMEM_MAX:
        return False, "shared memory %d > %d" % (smem, _SMEM_MAX)
    return True, None


def _tune_runner(sc):
    """Seeded buffers on the card (the CPU without one) and a call through
    ``fused_conv`` with a scale, a bias and ReLU, as a folded BatchNorm
    serves."""
    gen = torch.Generator().manual_seed(0)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    dt = torch.bfloat16 if sc["dtype"] == "bfloat16" else torch.float32
    x = torch.randn(sc["n"], sc["h"], sc["w"], sc["cin"], generator=gen)
    w = 0.1 * torch.randn(sc["kh"], sc["kw"], sc["cin"], sc["cout"],
                          generator=gen)
    scale = 1.0 + 0.1 * torch.randn(sc["cout"], generator=gen)
    bias = 0.1 * torch.randn(sc["cout"], generator=gen)
    args = (x.to(dev, dt), w.to(dev, dt), scale.to(dev), bias.to(dev))
    strides = (sc["sh"], sc["sw"])
    padding = ((sc["p0"], sc["p1"]), (sc["q0"], sc["q1"]))

    def fn(xx, ww, s, b):
        return fused_conv(xx, ww, strides, padding, scale=s, bias=b,
                          relu=True)
    return fn, args


# ResNet-50 v1's gated convs: (H=W, C_in, C_out, k, stride, pad)
RESNET50_GATED = ((224, 3, 64, 7, 2, 3), (56, 64, 64, 1, 1, 0),
                  (56, 64, 64, 3, 1, 1), (56, 64, 256, 1, 1, 0),
                  (56, 256, 64, 1, 1, 0))


def _tune_classes():
    """ResNet-50 v1's five gated convs at batch 8 (serving) and 128
    (training), in bfloat16."""
    return [{"n": n, "h": hw, "w": hw, "cin": cin, "kh": k, "kw": k,
             "cout": cout, "sh": s, "sw": s, "p0": p, "p1": p, "q0": p,
             "q1": p, "dtype": "bfloat16"}
            for n in (8, 128) for hw, cin, cout, k, s, p in RESNET50_GATED]


def _plan_of(x, w, strides, padding):
    """The autotune plan of this launch (None: the default)."""
    if not autotune.consulted():
        return None
    sc = shape_class(x, w, strides, padding)
    plan = autotune.lookup("pallas_conv", sc)
    if plan is not None and not _tune_feasible(plan, sc)[0]:
        autotune.plan_infeasible("pallas_conv")
        return None
    return plan


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, its ctypes signature set once."""
    from ... import kernels
    fn = kernels.library("fused_conv").mxtpu_fused_conv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 9 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    return fn


def _launch(x, w, strides, padding, scale, bias, residual, relu, oh, ow):
    for name, t in (("x", x), ("w", w), ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise MXNetError("fused_conv: %s must be contiguous" % name)
    if residual is not None and residual.dtype not in (x.dtype,
                                                       torch.float32):
        raise MXNetError("fused_conv: residual must be %s or float32, got %s"
                         % (x.dtype, residual.dtype))
    la = _launch_args(x, w, strides, padding,
                      plan=_plan_of(x, w, strides, padding))
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    craw = (torch.empty((n, oh, ow, cout), dtype=torch.float32,
                        device=x.device) if scale is not None else None)
    # per-channel vectors in float32 (exact for f32/bf16; the kernel reads
    # them as float32 like the TPU kernel's astype)
    scale = scale.float().contiguous() if scale is not None else None
    bias = bias.float().contiguous() if bias is not None else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    args = (la.dtype, la.route, la.vec_a, la.vec_b, la.block_m, la.block_n,
            la.k_pad, *la.grid, ptr(x), ptr(w), ptr(scale),
            ptr(bias), ptr(residual),
            int(residual is not None and residual.dtype == torch.float32),
            ptr(out), ptr(craw), n, h, wd, cin, kh, kw, cout,
            int(strides[0]), int(strides[1]), int(padding[0][0]),
            int(padding[1][0]), oh, ow, int(bool(relu)),
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        rc = _entry()(*args)
    else:   # the kernel launches on the current device
        with torch.cuda.device(x.device):
            rc = _entry()(*args)
    if rc != 0:
        raise MXNetError("fused_conv kernel launch failed: CUDA error %d" % rc)
    launched(fused_conv)
    # the FLOP ledger's count of the launch (FlopCounterMode sees no
    # kernel): a multiply-add a product, as PERF.md's bound column counts
    xprof.add_flops(2.0 * n * oh * ow * cout * kh * kw * cin)
    return out, craw


def _forward(x, w, strides, padding, scale, bias, residual, relu, oh, ow):
    """(out, craw): the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x, w, strides, padding, scale, bias, residual, relu,
                       oh, ow)
    return fused_conv_reference(x, w, strides, padding, scale, bias,
                                residual, relu)


def _conv_grads(x, w, dz, strides, padding, need_x=True, need_w=True):
    """(dx, dw) of the conv from its cotangent ``dz`` [N, OH, OW, C_out]:
    ``convolution_backward`` on NCHW views of the NHWC tensors (channels
    last in memory, so no layout copy is made on the card), which
    accumulates in float32; asymmetric padding is applied to x first and
    sliced off dx. dx comes back in x's type and dw in w's type. On the
    CPU the operands are made contiguous NCHW first: torch's CPU
    backward on the channels-last views crashes the process now and then
    (a segfault or an abort within a few dozen ResNet steps)."""
    n, h, wd, _ = x.shape
    (plo, phi), (qlo, qhi) = padding
    xn = x.permute(0, 3, 1, 2)
    if plo == phi and qlo == qhi:
        pad = [plo, qlo]
    else:
        xn = F.pad(xn, (qlo, qhi, plo, phi))
        pad = [0, 0]
    dzn, wn = dz.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if x.device.type == "cpu":
        dzn, xn, wn = dzn.contiguous(), xn.contiguous(), wn.contiguous()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dzn, xn, wn, None, list(strides), pad, [1, 1], False, [0, 0], 1,
        [bool(need_x), bool(need_w), False])
    if dx is not None:
        if pad == [0, 0] and (plo or phi or qlo or qhi):
            dx = dx[:, :, plo:plo + h, qlo:qlo + wd]
        dx = dx.permute(0, 2, 3, 1).to(x.dtype)
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)
    return dx, dw


def fused_conv_backward(x, w, g, strides, padding, scale=None, bias=None,
                        out=None, craw=None, relu=False, res_dtype=None,
                        needs=(True, True, True, True, True)):
    """(dx, dw, d_scale, d_bias, d_residual) of ``fused_conv`` from the
    output's cotangent ``g``: the JAX package's ``_core_bwd``. ``out`` is
    needed under ``relu`` (its mask), ``craw`` with ``scale``;
    ``res_dtype`` is the residual's type, None without one; ``needs``
    says which of the five gradients to compute (None for the others)."""
    # the reference upcasts g to float32 first; masking, casting and
    # summing in float32 from g itself give the same values without the
    # float32 copy of g where no scale multiplies it
    if relu:
        g = torch.where(out > 0, g, 0.0)
    d_res = g.to(res_dtype) if res_dtype is not None and needs[4] else None
    d_bias = g.sum(dim=(0, 1, 2), dtype=torch.float32).to(bias.dtype) \
        if bias is not None and needs[3] else None
    d_scale = None
    if scale is not None:
        g32 = g.float()
        if needs[2]:
            d_scale = (g32 * craw).sum(dim=(0, 1, 2)).to(scale.dtype)
        g = g32 * scale.float()
    dx = dw = None
    if needs[0] or needs[1]:
        # the cotangent meets the saved operands in their type; the
        # gradient convolutions accumulate in float32
        dz = g.to(promote(x.dtype, w.dtype))
        dx, dw = _conv_grads(x, w, dz, strides, padding, needs[0], needs[1])
    return dx, dw, d_scale, d_bias, d_res


class _FusedConv(torch.autograd.Function):
    """``fused_conv`` with its backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, residual, cfg):
        strides, padding, relu, oh, ow = cfg
        out, craw = _forward(x, w, strides, padding, scale, bias, residual,
                             relu, oh, ow)
        ctx.cfg = cfg
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(x, w, scale, bias, out if relu else None,
                              craw)
        if craw is not None:
            ctx.mark_non_differentiable(craw)
        return out, craw

    @staticmethod
    def backward(ctx, g, _g_craw):
        x, w, scale, bias, out, craw = ctx.saved_tensors
        strides, padding, relu, _, _ = ctx.cfg
        grads = fused_conv_backward(
            x, w, g, strides, padding, scale, bias, out, craw, relu,
            ctx.res_dtype, ctx.needs_input_grad[:5])
        return grads + (None,)


def fused_conv_with_raw(x, w, strides=(1, 1), padding=((0, 0), (0, 0)),
                        scale=None, bias=None, residual=None, relu=False):
    """``(out, craw)``: ``fused_conv`` plus the float32 raw conv, which is
    returned when ``scale`` is given (else None) — the tensor the JAX
    package saves for d(scale); craw carries no gradient."""
    strides = tuple(int(s) for s in strides)
    padding = tuple((int(a), int(b)) for a, b in padding)
    oh, ow = _check(x, w, strides, padding, scale, bias, residual)
    if x.device.type == "meta":   # shape inference: no kernel, no count
        shape = (x.shape[0], oh, ow, w.shape[3])
        return (torch.empty(shape, dtype=x.dtype, device="meta"),
                None if scale is None else
                torch.empty(shape, dtype=torch.float32, device="meta"))
    if x.device.type not in ("cuda", "cpu"):
        raise MXNetError("fused_conv: no kernel for device %s" % x.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, scale, bias, residual)):
        return _FusedConv.apply(x, w, scale, bias, residual,
                                (strides, padding, bool(relu), oh, ow))
    return _forward(x, w, strides, padding, scale, bias, residual, relu,
                    oh, ow)


def fused_conv(x, w, strides=(1, 1), padding=((0, 0), (0, 0)), scale=None,
               bias=None, residual=None, relu=False):
    """relu(conv(x, w) * scale + bias + residual) in one fused pass.

    NHWC x [N, H, W, C_in], HWIO w [kh, kw, C_in, C_out], both float32 or
    both bfloat16; ``scale``/``bias`` per-C_out vectors and ``residual`` an
    output-shaped tensor, all optional. The output has the operands' type."""
    return fused_conv_with_raw(x, w, strides, padding, scale, bias,
                               residual, relu)[0]


fused_conv.launches = 0
fused_conv.library = "fused_conv"   # what a capture of a launch needs

autotune.register_kernel(autotune.TunableKernel(
    kernel_id="pallas_conv", space=_tune_space, default=_tune_default,
    feasible=_tune_feasible, runner=_tune_runner, classes=_tune_classes))
