"""Contraction precision policy (counterpart of ``mxtpu/ops/precision_util.py``).

The JAX package keeps float32 contractions in full float32 (the global
``jax_default_matmul_precision='float32'``; ``mxu_precision`` only relaxes
all-bf16 operands) and accumulates bf16 contractions in float32. On the
card the same policy means:

* TF32 off for float32 matmuls AND convolutions. cuBLAS already defaults
  to full float32, but cuDNN convolutions default to TF32, which keeps
  about three decimal digits.
* no reduced-precision (bf16/fp16) reductions inside cuBLAS: bf16
  products accumulate in float32.

``apply_policy()`` sets those process-wide flags; the package calls it on
import, as the JAX package sets its precision global on import.
"""
from __future__ import annotations

import torch

__all__ = ["apply_policy", "promote"]


def apply_policy():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def promote(*dtypes):
    """The operands' promoted dtype (``jnp.promote_types`` for floats)."""
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out
