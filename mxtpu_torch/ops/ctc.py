"""CTC loss (counterpart of ``mxtpu/ops/ctc.py``).

The JAX package runs the alpha (forward-variable) recursion of Graves et
al. in the log semiring as a ``lax.scan``, in no Pallas kernel; here it is
the same recursion as a loop over time on tensors, and torch autograd
through it gives the gradient. Nothing reads a tensor on the host, so it
captures. The semantics are the JAX package's (ctc_loss-inl.h's code):

* ``data`` is TNC raw activations; the softmax over C is taken inside.
* ``blank_label='first'``: blank 0, tokens 1..C-1, label padding 0;
  ``'last'``: blank C-1, tokens 0..C-2, padding -1.
* Without ``label_lengths`` a label's length is the position of its first
  padding value (its width where there is none).
* The output is each sample's negative log likelihood, shape (N,).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["CTCLoss"]

_NEG = -1e30   # an effective -inf that keeps logaddexp's gradients finite


def _ctc_nll(log_probs, labels, data_lengths, label_lengths, blank):
    """Batched CTC negative log likelihood: ``log_probs`` [T, N, C] float32
    log-softmax, ``labels`` [N, L] int64 (anything past a label's length
    is ignored), ``data_lengths`` and ``label_lengths`` [N] int."""
    t_max, n, c = log_probs.shape
    width = labels.shape[1]
    s = 2 * width + 1
    dev = log_probs.device
    # the extended sequence: blanks at even s, labels at odd s
    s_idx = torch.arange(s, device=dev)
    lab_idx = torch.div(s_idx - 1, 2, rounding_mode="floor").clamp(
        0, width - 1)
    odd = s_idx % 2 == 1
    z = torch.where(odd, labels[:, lab_idx], blank).clamp(0, c - 1)
    # the skip s-2 -> s: a label that differs from the one before it
    z_prev2 = F.pad(z, (2, 0), value=blank)[:, :s]
    allow_skip = odd & (z != z_prev2)

    def emit(t):
        return log_probs[t].gather(1, z)

    has_label = label_lengths > 0
    first = torch.full((n, s), _NEG, dtype=torch.float32, device=dev)
    first[:, 0] = 0.0
    first[:, 1] = torch.where(has_label, 0.0, _NEG)
    alpha = first + emit(0)
    for t in range(1, t_max):
        a1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a2 = F.pad(alpha, (2, 0), value=_NEG)[:, :s]
        new = torch.logaddexp(alpha, a1)
        new = torch.where(allow_skip, torch.logaddexp(new, a2), new)
        new = new + emit(t)
        # past a sample's length its alpha stays, so the readout sees it
        # at exactly t = T_n - 1
        alpha = torch.where((t < data_lengths)[:, None], new, alpha)
    end = (2 * label_lengths).to(torch.int64)[:, None]
    ll_blank = alpha.gather(1, end)[:, 0]
    ll_label = torch.where(
        has_label, alpha.gather(1, (end - 1).clamp(min=0))[:, 0], _NEG)
    return -torch.logaddexp(ll_blank, ll_label)


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def CTCLoss(data, label, data_lengths=None, label_lengths=None,
            use_data_lengths=False, use_label_lengths=False,
            blank_label="first"):
    """Connectionist temporal classification loss (ref: ctc_loss.cc):
    ``data`` (T, N, C) raw activations, ``label`` (N, L) padded class ids;
    returns (N,) negative log likelihoods in ``data``'s type."""
    t_max, n, c = data.shape
    log_probs = data.to(torch.float32)
    log_probs = log_probs - log_probs.amax(dim=2, keepdim=True).detach()
    log_probs = log_probs - torch.log(
        torch.exp(log_probs).sum(dim=2, keepdim=True))
    labels = label.to(torch.int32).to(torch.int64)
    blank = 0 if blank_label == "first" else c - 1
    pad_value = 0 if blank_label == "first" else -1
    if use_data_lengths and data_lengths is not None:
        dlen = data_lengths.to(torch.int32)
    else:
        dlen = torch.full((n,), t_max, dtype=torch.int32, device=data.device)
    if use_label_lengths and label_lengths is not None:
        llen = label_lengths.to(torch.int32)
    else:
        is_pad = labels == pad_value
        llen = torch.where(is_pad.any(dim=1),
                           is_pad.to(torch.int32).argmax(dim=1),
                           labels.shape[1]).to(torch.int32)
    return _ctc_nll(log_probs, labels, dlen, llen, blank).to(data.dtype)
