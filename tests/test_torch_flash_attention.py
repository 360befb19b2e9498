"""The port's flash attention (mxtpu_torch/ops/pallas/flash_attention.py)
against the JAX package's (mxtpu/ops/pallas/flash_attention.py).

On this host the port's wrapper gets CPU tensors, so it runs its plain
version, which repeats ``_xla_attention_lse``; the JAX Pallas kernel runs
through the interpreter (MXTPU_FLASH_INTERPRET=1), which takes T a
multiple of 8 and Tk a multiple of 128. Ragged lengths go to the JAX
package's own XLA path (``_xla_attention_lse``), which the port's kernel
replaces with in-kernel masking. Inputs come from seeded numpy.

Tolerances:
* float32, out and lse: rtol=atol=1e-5 (the reference's own).
* bfloat16 lse: rtol=atol=1e-5 (float32 scores of bf16 inputs on both
  sides).
* bfloat16 out against the same XLA arithmetic: both sides round a float32
  out once, so they may differ by one bf16 spacing, at most 2^-7 |ref|:
  |err| <= 2^-7 |ref| + 1e-6.
* bfloat16 out against the Pallas kernel: besides that, the kernel rounds
  p to bf16 before p.v and the plain version does not, which moves out by
  at most 2^-9 max|v|: |err| <= 2^-7 |ref| + 2^-9 max|v|.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops.pallas import flash_attention as tfa

# the JAX package's ops.pallas exports the function under the module's name
jfa = importlib.import_module("mxtpu.ops.pallas.flash_attention")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    jfa.reset_dispatch_stats()


def _inputs(seed, b, h, t, tk, d, dtype):
    """q, k, v as float32 numpy, already rounded to ``dtype``."""
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(b, h, t, d), rng.randn(b, h, tk, d),
            rng.randn(b, h, tk, d))
    return [torch.from_numpy(a.astype(np.float32)).to(TDT[dtype]).float()
            .numpy() for a in arrs]


def _jax(q, k, v, causal, dtype):
    out, lse = jfa.flash_attention_with_lse(
        *(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)), causal=causal)
    only = jfa.flash_attention(*(jnp.asarray(a, JDT[dtype])
                                 for a in (q, k, v)), causal=causal)
    np.testing.assert_array_equal(np.asarray(only.astype(jnp.float32)),
                                  np.asarray(out.astype(jnp.float32)))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _port(q, k, v, causal, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    before = tfa.flash_attention.launches
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    only = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert tfa.flash_attention.launches == before   # plain version: no launch
    assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert tuple(lse.shape) == q.shape[:3]
    torch.testing.assert_close(only, out, rtol=0, atol=0)
    return out.float().numpy(), lse.numpy()


def _close_out(got, ref, v, dtype, vs_kernel):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    elif vs_kernel:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                                   atol=2.0 ** -9 * np.abs(v).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [128, 256])
def test_flash_matches_pallas_kernel(t, d, causal, dtype):
    q, k, v = _inputs(t + d, 2, 2, t, t, d, dtype)
    ref, ref_lse = _jax(q, k, v, causal, dtype)
    assert jfa.DISPATCH_STATS["pallas"] >= 1    # the kernel, no fallback
    got, lse = _port(q, k, v, causal, dtype)
    _close_out(got, ref, v, dtype, vs_kernel=True)
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_t_neq_tk_matches_pallas_kernel(causal):
    """128 queries over 256 keys (causal compares absolute positions)."""
    q, k, v = _inputs(5, 1, 3, 128, 256, 64, "float32")
    ref, ref_lse = _jax(q, k, v, causal, "float32")
    assert jfa.DISPATCH_STATS["pallas"] >= 1
    got, lse = _port(q, k, v, causal, "float32")
    _close_out(got, ref, v, "float32", vs_kernel=True)
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,tk", [(77, 77), (40, 77)])
def test_flash_ragged_matches_mxtpu(t, tk, causal, dtype):
    """Lengths off the TPU granules: the JAX package takes its XLA path,
    the port's kernel masks the tails (on the card)."""
    q, k, v = _inputs(t * tk, 2, 3, t, tk, 32, dtype)
    ref, ref_lse = _jax(q, k, v, causal, dtype)
    assert jfa.DISPATCH_STATS["pallas"] == 0 and jfa.DISPATCH_STATS["xla"] > 0
    got, lse = _port(q, k, v, causal, dtype)
    _close_out(got, ref, v, dtype, vs_kernel=False)
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)


def test_default_scale_is_inverse_sqrt_d():
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 1, 2, 16, 16, 48,
                                                    "float32"))
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v),
        tfa.flash_attention(q, k, v, scale=1.0 / 48 ** 0.5), rtol=0, atol=0)
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v, scale=0.3),
        tfa.flash_attention_reference(q, k, v, scale=0.3)[0], rtol=0, atol=0)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel."""

    @property
    def device(self):
        return torch.device("xpu", 0)


def _elsewhere(t):
    return torch.Tensor._make_subclass(_Elsewhere, t, t.requires_grad)


def test_wrapper_refuses_misuse_and_never_falls_back():
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(MXNetError, match="must all be float32 or all bfloat16"):
        tfa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(MXNetError, match="k and v must be"):
        tfa.flash_attention(q, q, q[:, :, :4, :8])
    with pytest.raises(MXNetError, match=r"\[B, H, T, D\]"):
        tfa.flash_attention(q[0], q[0], q[0])
    big = torch.randn(1, 1, 8, 160)   # any head dim runs (sliced past 128)
    torch.testing.assert_close(
        tfa.flash_attention(big, big, big),
        tfa.flash_attention_reference(big, big, big)[0], rtol=0, atol=0)
    # off the CPU the wrapper launches a kernel or raises; it never runs
    # the plain version (a tensor that reports another device stands in
    # for one here); a meta tensor (shape inference) gives a meta result
    # and counts no launch
    qo = _elsewhere(q)
    with pytest.raises(MXNetError, match="no kernel for device"):
        tfa.flash_attention(_elsewhere(q.clone().requires_grad_()), qo, qo)
    with torch.no_grad(), pytest.raises(MXNetError,
                                        match="no kernel for device"):
        tfa.flash_attention(qo, qo, qo)
    before = tfa.flash_attention.launches
    qm = q.to("meta")
    out = tfa.flash_attention(qm.requires_grad_(), qm, qm)
    assert out.device.type == "meta" and out.shape == q.shape
    assert tfa.flash_attention.launches == before
    # the plain version on CPU tensors stays differentiable
    q.requires_grad_()
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad.shape == q.shape


H100_SMS = 132   # an H100 SXM's SMs: the warpgroup rule's count off the card


def _launch_args(q, k, v, causal, scale):
    return tfa._launch_args(q, k, v, causal, scale, sms=H100_SMS)


def _fused_views(b, t, h, d, dtype):
    """q, k, v exactly as MultiHeadSelfAttention builds them: strided views
    of one [B, T, 3, H, D] projection."""
    x = torch.zeros(b, t, 3 * h * d, dtype=TDT[dtype])
    qkv = x.reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", [(1, 128), (8, 512), (2, 77)])
def test_launch_args_take_fused_qkv_views_async(b, t, dtype):
    """The served layout (row stride 3*H*D, head stride D, k and v offset by
    H*D elements) goes to the 16-byte async-copy staging, with no copy."""
    q, k, v = _fused_views(b, t, 12, 64, dtype)
    assert q.stride() == (t * 3 * 12 * 64, 64, 3 * 12 * 64, 1)
    la = _launch_args(q, k, v, False, 0.125)
    assert la.vec and la.d_tile == 64
    assert la.dtype == (0 if dtype == "float32" else 1)
    assert la.grid == b * 12 * la.n_q and la.n_q * la.block_q >= t


@pytest.mark.parametrize("dtype,d,vec", [
    ("bfloat16", 36, False),    # 72-byte rows: element-wise staging
    ("bfloat16", 40, True),
    ("float32", 36, True),      # 144-byte rows are whole 16-byte chunks
    ("float32", 34, False),
])
def test_launch_args_staging_follows_row_bytes(dtype, d, vec):
    q = torch.zeros(2, 3, 77, d, dtype=TDT[dtype])
    assert _launch_args(q, q, q, False, 1.0).vec is vec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_args_misaligned_view_takes_elementwise_staging(dtype):
    buf = torch.zeros(2 * 3 * 16 * 64 + 1, dtype=TDT[dtype])
    q = buf[1:].view(2, 3, 16, 64)             # base off by one element
    ok = torch.zeros(2, 3, 16, 64, dtype=TDT[dtype])
    assert _launch_args(ok, ok, ok, False, 1.0).vec
    assert not _launch_args(ok, q, ok, False, 1.0).vec
    assert not _launch_args(q, ok, ok, True, 1.0).vec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,tile", [(8, 32), (32, 32), (33, 64), (36, 64),
                                    (64, 64), (100, 128), (128, 128)])
def test_launch_args_head_dim_tile(d, tile, dtype):
    q = torch.zeros(1, 2, 16, d, dtype=TDT[dtype])
    assert _launch_args(q, q, q, False, 1.0).d_tile == tile


@pytest.mark.parametrize("b,t,wgs", [(1, 128, 1), (8, 128, 1), (8, 256, 1),
                                     (8, 512, 2), (4, 1024, 2)])
def test_launch_args_warpgroups_per_block(b, t, wgs):
    """bfloat16: two warpgroups (128 rows) per block where B*H*ceil(T/128)
    fills the card's SMs (an H100 SXM's 132 here) at least twice over, else
    one (64 rows); float32: one 128-thread group over 128 rows whatever the
    shape."""
    q, k, v = _fused_views(b, t, 12, 64, "bfloat16")
    la = _launch_args(q, k, v, False, 0.125)
    assert (b * 12 * -(-t // 128) >= 2 * H100_SMS) == (wgs == 2)
    assert (la.warpgroups, la.block_q) == (wgs, 64 * wgs)
    assert la.n_q == -(-t // la.block_q) and la.grid == b * 12 * la.n_q
    f = _launch_args(*_fused_views(b, t, 12, 64, "float32"), False, 0.125)
    assert (f.warpgroups, f.block_q) == (1, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", [0.05, 0.0, -0.125])
def test_flash_any_scale_matches_pallas_kernel(scale, causal, dtype):
    """The contract holds for any scale: the TPU kernel masks after
    scaling, so a zero or negative scale still gives masked keys no
    weight (the CUDA kernel does the same, checked on the card)."""
    q, k, v = _inputs(11, 1, 2, 128, 128, 32, dtype)
    args = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    ref, ref_lse = jfa.flash_attention_with_lse(*args, causal=causal,
                                                scale=scale)
    assert jfa.DISPATCH_STATS["pallas"] >= 1
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                            scale=scale)
    _close_out(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), v,
               dtype, vs_kernel=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_launch_args_ignore_the_stride_of_a_one_element_dim(dim, dtype):
    """A dim of one element never advances its stride, so an unaligned
    stride there keeps the 16-byte staging (the C entry point checks the
    same rule); the same stride on a longer dim does not."""
    size, stride = [2, 3, 16, 64], [3 * 16 * 64, 16 * 64, 64, 1]
    stride[dim] = 7
    buf = torch.zeros(4 * 3 * 16 * 64, dtype=TDT[dtype])
    ok = torch.zeros(2, 3, 16, 64, dtype=TDT[dtype])
    assert not _launch_args(buf.as_strided(size, stride), ok, ok, False,
                            1.0).vec
    size[dim] = 1
    assert _launch_args(buf.as_strided(size, stride), ok, ok, False, 1.0).vec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 256, 320])
def test_flash_wide_head_dim_matches_pallas_kernel(d, causal, dtype):
    """Head dims past 128: the JAX package zero-pads D to the 128-lane
    granule (``_pad_head_dim``) and runs its kernel; the port runs any D
    (on the card in 128-column slices of out)."""
    q, k, v = _inputs(d + causal, 1, 2, 128, 128, d, dtype)
    ref, ref_lse = _jax(q, k, v, causal, dtype)
    assert jfa.DISPATCH_STATS["pallas"] >= 1
    got, lse = _port(q, k, v, causal, dtype)
    _close_out(got, ref, v, dtype, vs_kernel=True)
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,slices", [(129, 2), (160, 2), (256, 2),
                                      (257, 3), (320, 3), (1000, 8)])
def test_launch_args_slice_head_dims_past_128(d, slices, dtype):
    """Past D 128 each row block is ``ceil(D / 128)`` blocks of 128 columns
    of out; bfloat16 runs one warpgroup (64 rows) a block, float32 128
    rows; the grid counts every slice. D <= 128 keeps one slice."""
    for b, t in ((8, 512), (1, 77)):
        q = torch.zeros(b, 12, t, d, dtype=TDT[dtype])
        la = _launch_args(q, q, q, True, 0.1)
        assert (la.d_tile, la.slices) == (128, slices)
        assert la.d_tile * la.slices >= d > la.d_tile * (la.slices - 1)
        assert (la.warpgroups, la.block_q) == \
            ((1, 64) if dtype == "bfloat16" else (1, 128))
        assert la.n_q == -(-t // la.block_q)
        assert la.grid == b * 12 * la.n_q * slices
        assert la.vec == ((d * q.element_size()) % 16 == 0)
    assert _launch_args(*_fused_views(8, 512, 12, 128, dtype), False,
                        0.1).slices == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wide_head_dim_on_strided_views(dtype):
    """D 256 on the strided q/k/v views of one fused projection (the
    served layout) equals the same attention on contiguous copies."""
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 64, 3 * 2 * 256).astype(np.float32)).to(TDT[dtype])
    qkv = x.reshape(2, 64, 3, 2, 256).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert _launch_args(q, k, v, False, None).vec
    got = tfa.flash_attention_with_lse(q, k, v, causal=True)
    ref = tfa.flash_attention_with_lse(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
