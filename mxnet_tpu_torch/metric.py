"""Evaluation metrics — counterpart of ``mxnet_tpu/metric.py``:
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``Loss``, ``Torch``, ``CustomMetric``, ``np`` and ``create``.

``update`` takes lists of label/pred NDArrays.  The per-row work (argmax,
top k, picking each label's probability, the errors) runs in torch on the
prediction's own device, so a full-vocabulary prediction is never copied to
the host; each pair comes back as Python numbers in one host read, which is
where the training loop syncs.  ``CustomMetric`` hands its function numpy
arrays, as the JAX package does.
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import string_types
from .ndarray import NDArray, _dense

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "Loss",
           "Torch",
           "CustomMetric", "np", "create", "check_label_shapes"]


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
    """``x`` as a tensor, on ``device`` where given: the metrics colocate
    the labels with the predictions before comparing them, and an array
    stored as pieces on a mesh is gathered whole."""
    t = _dense(x._data) if isinstance(x, NDArray) else \
        torch.as_tensor(numpy.asarray(x))
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


class TopKAccuracy(EvalMetric):
    """Whether the label is among the ``top_k`` largest predictions of its
    row.  The JAX package ranks with ``numpy.argsort``, which is not
    stable, so on tied predictions the two may pick different classes."""

    def __init__(self, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = kwargs.get("top_k", 1)
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            assert len(pred.shape) <= 2, \
                "Predictions should be no more than 2 dims"
            p = _tensor(pred).to(torch.float32)
            lab = _tensor(label, p.device).to(torch.int32).reshape(-1)
            if p.ndim == 1:
                hits = (p.to(torch.int32) == lab).sum()
            else:
                k = min(p.shape[1], self.top_k)
                top = torch.topk(p, k, dim=1).indices
                hits = (top == lab[:, None]).sum()
            self.sum_metric += int(hits.item())
            self.num_inst += int(p.shape[0])


class F1(EvalMetric):
    """Binary F1 score of each batch (argmax of the prediction against a
    0/1 label), averaged over batches."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred).argmax(dim=1)
            y = _tensor(label, p.device).to(torch.int32).reshape(-1)
            check_label_shapes(y, p, shape=1)
            ys = y.sort().values
            counts = torch.stack([((p == 1) & (y == 1)).sum(),
                                  ((p == 1) & (y == 0)).sum(),
                                  ((p == 0) & (y == 1)).sum(),
                                  (ys[1:] != ys[:-1]).sum() + 1])
            tp, fp, fn, classes = counts.tolist()
            if classes > 2:
                raise ValueError(
                    "F1 currently only supports binary classification.")
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.0
            self.sum_metric += f1_score
            self.num_inst += 1


def _errors(label, pred):
    """label - pred on the prediction's device, a 1-d label made a column
    first (so it broadcasts against the prediction as in the JAX
    package)."""
    p = _tensor(pred)
    lab = _tensor(label, p.device)
    if lab.ndim == 1:
        lab = lab.reshape(lab.shape[0], 1)
    return lab.to(torch.float64) - p.to(torch.float64)


class MAE(EvalMetric):
    """Mean absolute error, averaged over batches."""

    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += _errors(label, pred).abs().mean().item()
            self.num_inst += 1


class MSE(EvalMetric):
    """Mean squared error, averaged over batches."""

    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += _errors(label, pred).square().mean().item()
            self.num_inst += 1


class RMSE(EvalMetric):
    """Root mean squared error, averaged over batches."""

    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += \
                _errors(label, pred).square().mean().sqrt().item()
            self.num_inst += 1


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
            loss -= float(numpy.sum(numpy.log(numpy.maximum(1e-10, probs))))
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
            self.sum_metric += float((-numpy.log(probs + self.eps)).sum())
            self.num_inst += lab.shape[0]


class Loss(EvalMetric):
    """Mean of the raw outputs, for networks whose output is the loss
    (MakeLoss)."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += _tensor(pred).to(torch.float64).sum().item()
            self.num_inst += int(numpy.prod(pred.shape))


class Torch(Loss):
    """The reference's metric.Torch: the mean of the outputs."""

    def __init__(self, name="torch"):
        super().__init__(name)


class CustomMetric(EvalMetric):
    """A ``feval(label, pred)`` of numpy arrays, returning a value or a
    (sum, count) pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(label.asnumpy(), pred.asnumpy())
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A CustomMetric from a function of numpy arrays."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """A metric by name, function, instance or list of them."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(child)
        return composite
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
               "top_k_accuracy": TopKAccuracy, "topkaccuracy": TopKAccuracy,
               "perplexity": Perplexity, "cross-entropy": CrossEntropy,
               "loss": Loss, "torch": Torch,
               "composite": CompositeEvalMetric}
    if isinstance(metric, string_types) and metric.lower() in metrics:
        return metrics[metric.lower()](**kwargs)
    raise ValueError("Metric must be either callable or in {}".format(
        sorted(metrics)))
