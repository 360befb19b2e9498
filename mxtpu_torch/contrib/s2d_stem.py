"""Space-to-depth stem of a channels-last ResNet (counterpart of
``mxtpu/contrib/s2d_stem.py``, the MLPerf ResNet trick).

The 7x7/2 stem conv on 3 channels is re-expressed exactly:
- mode 1: the input in 2x2 blocks (224x224x3 -> 112x112x12) and a 4x4
  stride-1 conv with padding (2, 1) whose weight is a zero-padded
  re-indexing of the 7x7 one (K = 192, C_out 64: the fused conv kernel's
  gate takes it);
- mode 2: 4x4 blocks (56x56x48), a 3x3 stride-1 conv to 4 x 64 channels
  with padding 1, and a 2x2 depth-to-space (K = 432, C_out 256:
  ``F.conv2d``);
- mode 0: the plain stem.
The embedded weights are gathered from the original 7x7 parameter inside
every forward, so the net keeps its parameters: files load as they are
and gradients reach the 7x7 weight.

Derivation (mode 1): output row y reads input rows R = 2y + k' with
k' = ky - 3 in [-3, 3]; with R = 2r + py, py = k' mod 2 and
r = y + floor(k'/2) in [y-2, y+1]: a 4-tap kernel over the blocks at
stride 1 with padding (2, 1); columns alike. The block's channel of
(py, px, c) is (py*2 + px)*C + c. Mode 2: output row Y = 2y + py reads
R = 4y + t, t = 2py + ky - 3 in [-3, 5]; R = 4(y + a - 1) + rho with
a = t//4 + 1 in {0, 1, 2}, rho = t % 4: 3 taps, padding 1; output
channel (py*2 + px)*F + f.

The reference's ``mode=None`` reads the mode from ``MXTPU_S2D_STEM`` each
time it traces; the port reads no environment, so the caller passes the
mode (0, 1 or 2) and ``None`` raises.
"""
from __future__ import annotations

import types

import torch

from ..base import MXNetError

__all__ = ["space_to_depth_nhwc", "embed_stem_weight",
           "space_to_depth4_nhwc", "depth_to_space2_nhwc",
           "embed_stem_weight4", "apply_to_resnet"]

_B = 2  # block size of mode 1 (fixed by the stride-2 stem)


def space_to_depth_nhwc(x):
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel-major in (py, px)."""
    n, h, w, c = x.shape
    y = x.reshape(n, h // _B, _B, w // _B, _B, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // _B, w // _B,
                                               _B * _B * c)


def space_to_depth4_nhwc(x):
    """(N, H, W, C) -> (N, H/4, W/4, 16C), channel-major in (rho, sigma)."""
    n, h, w, c = x.shape
    y = x.reshape(n, h // 4, 4, w // 4, 4, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 4, w // 4, 16 * c)


def depth_to_space2_nhwc(y, f):
    """(N, H, W, 4F) with channels (py, px, f) -> (N, 2H, 2W, F)."""
    n, h, w, _ = y.shape
    y = y.reshape(n, h, w, 2, 2, f)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, f)


def _check7(w):
    if tuple(w.shape[:2]) != (7, 7):
        raise MXNetError("s2d stem embedding expects a 7x7 kernel, got %s"
                         % (tuple(w.shape[:2]),))


_TAPS = {}


def _taps(mode, device):
    """For each slot of the embedded kernel, the index of its 7x7 tap
    (ky*7 + kx), or 49 for a zero: mode 1 [4, 4, py*2+px], mode 2
    [3, 3, rho*4+sigma, py*2+px]."""
    key = (mode, str(device))
    if key not in _TAPS:
        if mode == 1:
            idx = torch.full((4, 4, 4), 49, dtype=torch.long)
            for ky in range(7):
                py = (ky - 3) % _B
                a = (ky - 3 - py) // _B + 2
                for kx in range(7):
                    px = (kx - 3) % _B
                    b = (kx - 3 - px) // _B + 2
                    idx[a, b, py * _B + px] = ky * 7 + kx
        else:
            idx = torch.full((3, 3, 16, 4), 49, dtype=torch.long)
            for py in range(2):
                for ky in range(7):
                    t = 2 * py + ky - 3
                    a, rho = t // 4 + 1, t % 4
                    for px in range(2):
                        for kx in range(7):
                            u = 2 * px + kx - 3
                            b, sig = u // 4 + 1, u % 4
                            idx[a, b, rho * 4 + sig, py * 2 + px] = \
                                ky * 7 + kx
        _TAPS[key] = idx.to(device)
    return _TAPS[key]


def _gathered(w, mode):
    """The 7x7 taps of ``w`` (7, 7, C, F) at the slots of ``_taps``, a zero
    where none lands: one differentiable gather."""
    _check7(w)
    c, f = w.shape[2], w.shape[3]
    src = torch.cat([w.reshape(49, c, f), w.new_zeros(1, c, f)])
    return src[_taps(mode, w.device)]


def embed_stem_weight(w):
    """The (4, 4, 4C, F) kernel of mode 1 from a (7, 7, C, F) HWIO stem."""
    c, f = w.shape[2], w.shape[3]
    return _gathered(w, 1).reshape(4, 4, _B * _B * c, f)


def embed_stem_weight4(w):
    """The (3, 3, 16C, 4F) kernel of mode 2 from a (7, 7, C, F) stem."""
    c, f = w.shape[2], w.shape[3]
    g = _gathered(w, 2)                  # [3, 3, 16, 4, C, F]
    return g.permute(0, 1, 2, 4, 3, 5).reshape(3, 3, 16 * c, 4 * f)


def _stem(x, w, bias, mode):
    from ..ops.conv_acc import conv_fast
    conv = dict(lhs_dilation=(1, 1), rhs_dilation=(1, 1),
                dims=("NHWC", "HWIO", "NHWC"), groups=1)
    if mode == 0:
        return conv_fast(x, w, strides=(2, 2), padding=[(3, 3), (3, 3)],
                         bias=bias, **conv)
    if mode == 2:
        out = conv_fast(space_to_depth4_nhwc(x), embed_stem_weight4(w),
                        strides=(1, 1), padding=[(1, 1), (1, 1)], **conv)
        out = depth_to_space2_nhwc(out, w.shape[-1])
    else:
        out = conv_fast(space_to_depth_nhwc(x), embed_stem_weight(w),
                        strides=(1, 1), padding=[(2, 1), (2, 1)], **conv)
    return out if bias is None else out + bias


def apply_to_resnet(net, mode):
    """Route the stem Conv2D of a channels-last zoo ResNet through the
    space-to-depth stem of ``mode`` (0, 1 or 2), in place; its parameters
    stay as they are. Returns ``net``."""
    if mode is None:
        raise MXNetError(
            "s2d stem mode None is the reference's policy mode, read from "
            "MXTPU_S2D_STEM at trace time; the port reads no environment: "
            "pass mode=0, 1 or 2")
    if mode not in (0, 1, 2):
        raise MXNetError("s2d stem mode must be 0, 1 or 2, got %r" % (mode,))
    conv = list(net.features._modules.values())[0]
    if type(conv).__name__ != "Conv2D":
        raise MXNetError("expected the first feature block to be the stem "
                         "Conv2D; got %s" % type(conv).__name__)
    if getattr(conv, "_layout", None) != "NHWC":
        raise MXNetError("s2d stem transform supports NHWC nets (build the "
                         "zoo model under layout('NHWC'))")
    kw = conv._kwargs
    bad = [what for what, ok in (
        ("kernel != 7x7", tuple(kw["kernel"]) == (7, 7)),
        ("stride != 2", tuple(kw["stride"]) == (2, 2)),
        ("pad != 3", tuple(kw["pad"]) == (3, 3)),
        ("dilate != 1", tuple(kw["dilate"]) == (1, 1)),
        ("grouped", kw["num_group"] == 1),
        ("fused activation", conv.act is None)) if not ok]
    if bad:
        raise MXNetError("stem conv not s2d-transformable: %s"
                         % ", ".join(bad))

    def hybrid_forward(self, F, x, weight, bias=None):
        return _stem(x, weight, bias, mode)

    conv.hybrid_forward = types.MethodType(hybrid_forward, conv)
    return net
