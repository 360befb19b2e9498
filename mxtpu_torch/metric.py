"""Evaluation metrics (counterpart of ``mxtpu/metric.py``): the registry,
``create`` and ``np_metric``, and Accuracy, TopKAccuracy, F1, MCC,
Perplexity, MAE, MSE, RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, Loss, CustomMetric and CompositeEvalMetric.

Metrics run on the host in numpy, as the JAX package's do: an ``update``
reads its NDArrays or tensors back (one device-to-host copy each)."""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise MXNetError("labels/preds length mismatch: %d vs %d"
                         % (len(labels), len(preds)))


class EvalMetric:
    """Base metric (ref: metric.py:EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):  # pragma: no cover - abstract
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, (NDArray, _np.ndarray, torch.Tensor)):
            labels, preds = [labels], [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            l = _as_np(label).astype(_np.int64)
            if p.ndim > l.ndim:
                p = p.argmax(axis=self.axis)
            p = p.astype(_np.int64).reshape(-1)
            l = l.reshape(-1)
            self.sum_metric += (p == l).sum()
            self.num_inst += len(l)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            l = _as_np(label).astype(_np.int64)
            order = _np.argsort(-p, axis=1)[:, :self.top_k]
            self.sum_metric += (order == l[:, None]).any(axis=1).sum()
            self.num_inst += len(l)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        if hasattr(self, "tp"):
            self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            l = _as_np(label).astype(_np.int64).reshape(-1)
            if p.ndim > 1:
                p = p.argmax(axis=1)
            p = p.astype(_np.int64).reshape(-1)
            self.tp += ((p == 1) & (l == 1)).sum()
            self.fp += ((p == 1) & (l == 0)).sum()
            self.fn += ((p == 0) & (l == 1)).sum()
            prec = self.tp / max(self.tp + self.fp, 1)
            rec = self.tp / max(self.tp + self.fn, 1)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    """Matthews correlation (ref: metric.py:MCC)."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.tp = self.fp = self.tn = self.fn = 0

    def reset(self):
        super().reset()
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            l = _as_np(label).astype(_np.int64).reshape(-1)
            if p.ndim > 1:
                p = p.argmax(axis=1)
            p = p.astype(_np.int64).reshape(-1)
            self.tp += ((p == 1) & (l == 1)).sum()
            self.fp += ((p == 1) & (l == 0)).sum()
            self.tn += ((p == 0) & (l == 0)).sum()
            self.fn += ((p == 0) & (l == 1)).sum()
            denom = math.sqrt(max((self.tp + self.fp) * (self.tp + self.fn)
                                  * (self.tn + self.fp) * (self.tn + self.fn), 1))
            self.sum_metric = (self.tp * self.tn - self.fp * self.fn) / denom
            self.num_inst = 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            l = _as_np(label).astype(_np.int64).reshape(-1)
            p = p.reshape(-1, p.shape[-1])
            probs = p[_np.arange(len(l)), l]
            if self.ignore_label is not None:
                ignore = (l == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.log(_np.maximum(probs, 1e-10)).sum()
            num += len(l)
        self.sum_metric += math.exp(loss / max(num, 1)) * num
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _as_np(label), _as_np(pred)
            if l.ndim == 1:
                l = l.reshape(-1, 1)
            self.sum_metric += _np.abs(l - p.reshape(l.shape)).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _as_np(label), _as_np(pred)
            if l.ndim == 1:
                l = l.reshape(-1, 1)
            self.sum_metric += ((l - p.reshape(l.shape)) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _as_np(label), _as_np(pred)
            if l.ndim == 1:
                l = l.reshape(-1, 1)
            self.sum_metric += math.sqrt(((l - p.reshape(l.shape)) ** 2).mean())
            self.num_inst += 1


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l = _as_np(label).astype(_np.int64).reshape(-1)
            p = _as_np(pred).reshape(len(l), -1)
            prob = p[_np.arange(len(l)), l]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += len(l)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _as_np(label).reshape(-1), _as_np(pred).reshape(-1)
            cc = _np.corrcoef(l, p)[0, 1]
            self.sum_metric += cc
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of a loss output (ref: metric.py:Loss)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, _np.ndarray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            p = _as_np(pred)
            self.sum_metric += p.sum()
            self.num_inst += p.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__("custom(%s)" % name, **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self.sum_metric += m
                self.num_inst += n
            else:
                self.sum_metric += reval
                self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = metrics or []

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, vals = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            vals.append(v)
        return names, vals


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """Decorator creating a CustomMetric (ref: metric.py:np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name or numpy_feval.__name__
    return CustomMetric(feval, feval.__name__, allow_extra_outputs)


np = np_metric  # mx.metric.np parity (numpy is imported as _np to avoid clobbering)


def create(metric, *args, **kwargs):
    """Create a metric from name/callable/list (ref: metric.py:create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        comp = CompositeEvalMetric()
        for m in metric:
            comp.add(create(m, *args, **kwargs))
        return comp
    if isinstance(metric, str):
        aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
                   "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
                   "top_k_acc": "topkaccuracy"}
        key = aliases.get(metric.lower(), metric.lower()).replace("_", "").replace("-", "")
        lookup = {k.replace("_", ""): v for k, v in _REGISTRY.items()}
        if key not in lookup:
            raise MXNetError("Metric %s not registered" % metric)
        return lookup[key](*args, **kwargs)
    raise MXNetError("invalid metric spec %r" % (metric,))
