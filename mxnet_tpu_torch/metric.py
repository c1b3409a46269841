"""Evaluation metrics — counterpart of ``mxnet_tpu/metric.py`` for the
training slice: ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``CrossEntropy``, ``Perplexity`` and ``create``.

``update`` takes lists of label/pred NDArrays.  The per-row work (argmax,
picking each label's probability) runs in torch on the prediction's own
device, so a full-vocabulary prediction is never copied to the host; the
sums come back as Python floats, which is where the training loop syncs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import string_types
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "CrossEntropy",
           "Perplexity", "create", "check_label_shapes"]


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels %s does not match shape of predictions %s"
            % (label_shape, pred_shape))


def _tensor(x, device=None):
    t = x._data if isinstance(x, NDArray) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


class EvalMetric:
    """Base metric accumulating (sum_metric, num_inst)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError("virtual EvalMetric.update")

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan")
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Several metrics as one."""

    def __init__(self, **kwargs):
        super().__init__("composite")
        self.metrics = kwargs.get("metrics", [])

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}".format(
                index, len(self.metrics)))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            results.append(value)
        return (names, results)


class Accuracy(EvalMetric):
    """Classification accuracy: argmax over axis 1 against the label."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            lab = _tensor(label, p.device)
            if p.ndim > 1 and p.shape != lab.shape:
                p = p.argmax(dim=1)
            p = p.to(torch.int32).reshape(-1)
            lab = lab.to(torch.int32).reshape(-1)
            self.sum_metric += int((p == lab).sum().item())
            self.num_inst += int(lab.numel())


def _picked_probs(label, pred, axis=-1):
    """(probability of each row's label as float64 host numpy, labels as
    int64 host numpy), rows taken along ``axis`` of the prediction."""
    p = _tensor(pred)
    nclass = p.shape[axis]
    p = p.movedim(axis, -1).reshape(-1, nclass) if p.ndim > 1 else p
    lab = _tensor(label, p.device).reshape(-1).to(torch.int64)
    if lab.shape[0] != p.shape[0]:
        raise ValueError("shape mismatch: %s vs %s"
                         % (tuple(label.shape), tuple(pred.shape)))
    picked = p.gather(1, lab.clamp(0, nclass - 1)[:, None]).squeeze(1)
    return (picked.to(torch.float64).cpu().numpy(), lab.cpu().numpy())


class Perplexity(EvalMetric):
    """Perplexity = exp(mean negative log-likelihood), labels equal to
    ``ignore_label`` left out."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            probs, lab = _picked_probs(label, pred, self.axis)
            if self.ignore_label is not None:
                ignore = (lab == self.ignore_label).astype(probs.dtype)
                probs = probs * (1 - ignore) + ignore
                num -= int(ignore.sum())
            loss -= float(np.sum(np.log(np.maximum(1e-10, probs))))
            num += lab.shape[0]
        self.sum_metric += math.exp(loss / max(1, num)) * num
        self.num_inst += num


class CrossEntropy(EvalMetric):
    """Cross-entropy of softmax outputs against integer labels."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            probs, lab = _picked_probs(label, pred)
            self.sum_metric += float((-np.log(probs + self.eps)).sum())
            self.num_inst += lab.shape[0]


def create(metric, **kwargs):
    """A metric by name, instance or list of them."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(child)
        return composite
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "cross-entropy": CrossEntropy, "perplexity": Perplexity,
               "composite": CompositeEvalMetric}
    if isinstance(metric, string_types) and metric.lower() in metrics:
        return metrics[metric.lower()](**kwargs)
    raise ValueError("Metric must be an EvalMetric, a list or one of %s"
                     % sorted(metrics))
