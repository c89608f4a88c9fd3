"""Evaluation metrics of the PyTorch port (counterpart of
incubator_mxnet_tpu/metric.py): the same classes, names, registry and
values.

The JAX metrics read every batch's result to the host (`float(...)` in
`update`), which on the card would wait for the device once a step.
Here `update` keeps `sum_metric` (and `num_inst` where it depends on the
data) as tensors on the predictions' device, summed in f64, and only
`get()` / `get_name_value()` read them, so `Accuracy.update` and
`TopKAccuracy.update` never synchronise with the card.  A count that
follows from shapes alone stays a Python int.  `CustomMetric` hands its
function numpy arrays, as in the JAX package, and so reads each batch.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import unwrap

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "Caffe", "Torch",
           "CustomMetric", "np", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from an instance, a function (a `CustomMetric`), a list
    (a `CompositeEvalMetric`) or a registered name ('acc', 'ce',
    'top_k_accuracy', ...)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    key = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "nll_loss": "negativeloglikelihood", "top_k_accuracy":
               "topkaccuracy", "top_k_acc": "topkaccuracy"}
    key = aliases.get(key, key)
    if key not in _REGISTRY:
        raise MXNetError("unknown metric %r" % metric)
    return _REGISTRY[key](*args, **kwargs)


def _tensor(x):
    """`x` as a tensor (a tensor or an NDArray's stays where it is)."""
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(_np.asarray(x))


def _pair(label, pred):
    """label and prediction as tensors on the prediction's device."""
    p = _tensor(pred)
    return _tensor(label).to(p.device), p


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _value(x):
    """A host number from a Python number or a one-element tensor."""
    return x.item() if isinstance(x, torch.Tensor) else x


def _as_numpy(x):
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        """(name, value); reads the device."""
        num = _value(self.num_inst)
        if num == 0:
            return (self.name, float("nan"))
        return (self.name, _value(self.sum_metric) / num)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

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

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return names, values


@register
class Accuracy(EvalMetric):
    """Share of predictions (argmax over `axis`) equal to the label."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            l, p = _pair(label, pred)
            l = l.to(torch.int64)
            if p.dim() > l.dim():
                p = p.argmax(dim=self.axis)
            p = p.to(torch.int64).reshape(-1)
            l = l.reshape(-1)
            self.sum_metric = self.sum_metric + (p == l).sum().double()
            self.num_inst += l.numel()


@register
class TopKAccuracy(EvalMetric):
    """Share of labels among the `top_k` highest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            l, p = _pair(label, pred)
            l = l.to(torch.int64).reshape(-1)
            k = min(self.top_k, p.shape[1])
            idx = torch.topk(p, k, dim=1).indices
            self.sum_metric = self.sum_metric + \
                (idx == l[:, None]).any(dim=1).sum().double()
            self.num_inst += l.numel()


@register
class F1(EvalMetric):
    """Binary F1 of the counts over every batch so far."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _pair(label, pred)
            l = l.reshape(-1).to(torch.int64)
            if p.dim() > 1 and p.shape[-1] > 1:
                p = p.argmax(dim=-1)
            else:
                p = (p.reshape(-1) > 0.5).to(torch.int64)
            self.tp = self.tp + ((p == 1) & (l == 1)).sum()
            self.fp = self.fp + ((p == 1) & (l == 0)).sum()
            self.fn = self.fn + ((p == 0) & (l == 1)).sum()
            prec = self.tp.double() / (self.tp + self.fp).clamp_min(1)
            rec = self.tp.double() / (self.tp + self.fn).clamp_min(1)
            self.sum_metric = 2 * prec * rec / (prec + rec).clamp_min(1e-12)
            self.num_inst = 1


def _diff(label, pred):
    """label (reshaped like pred) − pred, in f64."""
    l, p = _pair(label, pred)
    return l.reshape(p.shape).double() - p.double()


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self.sum_metric = self.sum_metric + \
                _diff(label, pred).abs().mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self.sum_metric = self.sum_metric + \
                (_diff(label, pred) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(_value(self.sum_metric)
                                     / self.num_inst))


def _picked(label, pred):
    """(labels as int64, the prediction of each row at its label, f64)."""
    l, p = _pair(label, pred)
    l = l.reshape(-1).to(torch.int64)
    p = p.reshape(-1, p.shape[-1])
    return l, p.gather(1, l[:, None]).squeeze(1).double()


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, prob = _picked(label, pred)
            self.sum_metric = self.sum_metric + \
                (-torch.log(prob + self.eps)).sum()
            self.num_inst += l.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels, rows whose
    label is `ignore_label` left out."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, prob = _picked(label, pred)
            nll = -torch.log(prob.clamp_min(1e-10))
            if self.ignore_label is not None:
                keep = l != self.ignore_label
                nll = nll * keep
                self.num_inst = self.num_inst + keep.sum()
            else:
                self.num_inst += l.shape[0]
            self.sum_metric = self.sum_metric + nll.sum()

    def get(self):
        num = _value(self.num_inst)
        if num == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(_value(self.sum_metric) / num))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            l, p = _pair(label, pred)
            l = l.reshape(-1).double()
            p = p.reshape(-1).double()
            lc, pc = l - l.mean(), p - p.mean()
            r = (lc * pc).sum() / torch.sqrt((lc * lc).sum()
                                             * (pc * pc).sum())
            self.sum_metric = self.sum_metric + r.clamp(-1.0, 1.0)
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of the loss values given as predictions."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            p = _tensor(pred)
            self.sum_metric = self.sum_metric + p.double().sum()
            self.num_inst += p.numel()


class Caffe(Loss):
    """ref: metric.Caffe: the `Loss` metric, named "loss" (not in the
    registry, as in the JAX package)."""


class Torch(Loss):
    """ref: metric.Torch: the `Loss` metric, named "loss" (not in the
    registry, as in the JAX package)."""


class CustomMetric(EvalMetric):
    """`feval(label, pred)` on numpy arrays returns a value, or
    (sum_metric, num_inst)."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__("custom(%s)" % name, **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """A `CustomMetric` from a function of numpy arrays."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name
    return CustomMetric(feval, name, allow_extra_outputs)
