"""Loss layers (counterpart of ``mxtpu/gluon/loss.py``): L1/L2,
SigmoidBCE, SoftmaxCE, KLDiv, Huber, Hinge/SquaredHinge, Logistic, Triplet
and Poisson NLL, each a HybridBlock over the ``F`` ops, so a loss takes
tensors or NDArrays like any block.

Each loss is per sample: the batch axis stays and every other axis is
averaged (``mean(exclude=True)``), after the weighting of
``_apply_weighting`` (``sample_weight`` broadcast-multiplied, then the
scalar ``weight``).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss"]

_NUMERIC = (int, float, np.number)


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Scale loss by the per-sample weight, then by the scalar weight."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, _NUMERIC):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """Base class: a scalar ``weight`` and the batch axis."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def _per_sample(self, F, loss, sample_weight, weight=None):
        loss = _apply_weighting(F, loss, self._weight if weight is None
                                else weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    """0.5 * weight * (pred - label)^2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(pred - _reshape_like(label, pred))
        return self._per_sample(F, loss, sample_weight, self._weight / 2)


class L1Loss(Loss):
    """|pred - label|."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(pred - _reshape_like(label, pred))
        return self._per_sample(F, loss, sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of sigmoid(pred), or of pred itself with
    ``from_sigmoid``; from logits it takes the stable form
    relu(x) - x*y + softrelu(-|x|)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if not self._from_sigmoid:
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label
                     + F.log(1. - pred + eps) * (1. - label))
        return self._per_sample(F, loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] (``sparse_label``: one class index per
    sample, float or int) or -sum(label * log softmax(pred)); with
    ``from_logits`` pred is already a log-probability."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        return self._per_sample(F, loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log(label) - pred), pred a log-probability unless
    ``from_logits=False``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        return self._per_sample(F, loss, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification over ``ops.ctc.CTCLoss`` with
    the blank last (label padding -1): ``pred`` NTC or TNC activations,
    ``label`` NT or TN; per-sample negative log likelihoods (ref:
    loss.py:CTCLoss)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise MXNetError("Only 'NTC' and 'TNC' layouts are supported, "
                             "got %s" % layout)
        if label_layout not in ("NT", "TN"):
            raise MXNetError("Only 'NT' and 'TN' label layouts supported, "
                             "got %s" % label_layout)
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """|d| - rho/2 where |d| > rho, else d^2 / (2 rho), d = pred - label."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(pred - _reshape_like(label, pred))
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        return self._per_sample(F, loss, sample_weight)


class HingeLoss(Loss):
    """relu(margin - pred * label), labels +-1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * _reshape_like(label, pred))
        return self._per_sample(F, loss, sample_weight)


class SquaredHingeLoss(Loss):
    """relu(margin - pred * label)^2, labels +-1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(F.relu(self._margin - pred
                               * _reshape_like(label, pred)))
        return self._per_sample(F, loss, sample_weight)


class LogisticLoss(Loss):
    """Logistic loss with signed (+-1) or binary (0/1) labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ("signed", "binary"):
            raise MXNetError("label_format must be signed or binary, got %s"
                             % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        return self._per_sample(F, loss, sample_weight)


class TripletLoss(Loss):
    """relu(sum(|pred - pos|^2 - |pred - neg|^2) + margin) per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(positive, pred)
        negative = _reshape_like(negative, pred)
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """exp(pred) - target * pred from logits, else pred - target *
    log(pred + eps); ``compute_full`` adds Stirling's log(target!) term;
    the mean over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = target * F.log(target + epsilon) - target + \
                0.5 * F.log(2 * target * 3.1415926535 + epsilon)
            loss = loss + stirling * (target > 1)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)
