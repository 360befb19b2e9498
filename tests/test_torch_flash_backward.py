"""Flash attention's backward in the port (``ops/pallas/
flash_attention.py``: ``_Flash`` and ``flash_attention_backward``) against
``jax.grad`` of the JAX package's ``flash_attention`` and of
``flash_attention_with_lse`` with an lse cotangent, the kernel run by the
Pallas interpreter (``MXTPU_FLASH_INTERPRET=1``: T a multiple of 8, Tk of
128), on seeded numpy inputs: causal and not, T != Tk, D = 36 and D = 160,
at ``tests/test_flash_attention.py``'s gradient tolerances (rtol=1e-4,
atol=1e-4); bf16 gradients through strided q/k/v views within one bf16
spacing (2^-7) of the float32 backward; and the key blocks.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu_torch.ops.pallas import flash_attention as tfa

jfa = importlib.import_module("mxtpu.ops.pallas.flash_attention")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD = 1e-4


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    jfa.reset_dispatch_stats()


def _flash_inputs(seed, b, h, t, tk, d, dtype):
    r = np.random.RandomState(seed)
    arrs = [r.randn(b, h, n, d) for n in (t, tk, tk)]
    arrs = [torch.from_numpy(a.astype(np.float32)).to(TDT[dtype]).float()
            .numpy() for a in arrs]
    return arrs, r.randn(b, h, t, d).astype(np.float32), \
        r.randn(b, h, t).astype(np.float32)


FLASH = [(128, 128, 64, False), (128, 128, 64, True), (128, 256, 36, False),
         (128, 256, 36, True), (128, 128, 160, False),
         (128, 128, 160, True), (64, 256, 32, True)]


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("t,tk,d,causal", FLASH)
def test_flash_backward_matches_jax_grad(t, tk, d, causal, with_lse):
    (q, k, v), g_out, g_lse = _flash_inputs(t + tk + d, 1, 2, t, tk, d,
                                            "float32")

    def jloss(q_, k_, v_):
        if with_lse:
            out, lse = jfa.flash_attention_with_lse(q_, k_, v_, causal=causal)
            return jnp.sum(out * g_out) + jnp.sum(lse * g_lse)
        return jnp.sum(jfa.flash_attention(q_, k_, v_, causal=causal)
                       * g_out)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    assert jfa.DISPATCH_STATS["pallas"] >= 1   # the kernel, no fallback
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    if with_lse:
        out, lse = tfa.flash_attention_with_lse(tq, tk_, tv, causal=causal)
        loss = (out * torch.from_numpy(g_out)).sum() \
            + (lse * torch.from_numpy(g_lse)).sum()
    else:
        loss = (tfa.flash_attention(tq, tk_, tv, causal=causal)
                * torch.from_numpy(g_out)).sum()
    loss.backward()
    for name, got, r in zip("qkv", (tq.grad, tk_.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=GRAD,
                                   atol=GRAD, err_msg="d" + name)


def test_flash_backward_bf16_and_strided_views():
    """bf16 q/k/v as strided views of one fused projection, as the
    transformer hands them: gradients reach the projection, in bf16,
    within 2^-7 of the float32 backward of the same values."""
    r = np.random.RandomState(4)
    qkv32 = torch.from_numpy(r.randn(2, 40, 3, 2, 32).astype(np.float32))
    head = torch.from_numpy(r.randn(2, 2, 40, 32).astype(np.float32))
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        qkv = qkv32.to(dt).float().to(dt).requires_grad_()
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = tfa.flash_attention(q, k, v, causal=True)
        (out.float() * head).sum().backward()
        grads[dt] = qkv.grad
    assert grads[torch.bfloat16].dtype == torch.bfloat16
    ref = grads[torch.float32]
    err = (grads[torch.bfloat16].float() - ref).abs().max()
    assert err <= 2.0 ** -7 * ref.abs().max() + 1e-3


def test_flash_backward_is_blockwise_over_keys():
    """Key blocks of any size give the same gradients (the last block
    ragged), so no [T, Tk] matrix for all of Tk is needed."""
    r = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(r.randn(1, 2, 24, 8).astype(np.float32))
               for _ in range(3))
    out, lse = tfa.flash_attention_reference(q, k, v, True, 0.3)
    g, g_lse = torch.randn(1, 2, 24, 8), torch.randn(1, 2, 24)
    full = tfa.flash_attention_backward(q, k, v, out, lse, g, True, 0.3,
                                        g_lse, block_k=24)
    for bk in (5, 8):
        part = tfa.flash_attention_backward(q, k, v, out, lse, g, True, 0.3,
                                            g_lse, block_k=bk)
        for a, b in zip(part, full):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


