"""Evaluation metrics (twin of ``incubator_mxnet_tpu/metric.py``; ref:
python/mxnet/metric.py — EvalMetric:44, CompositeEvalMetric:209,
Accuracy:339, TopKAccuracy:404, F1:478, Perplexity:573, MAE:678,
MSE:737, RMSE:795, CrossEntropy:854, NegativeLogLikelihood:922,
PearsonCorrelation:990, Loss:1043, CustomMetric:1087).

Metrics run on the host in numpy, as in the reference: ``update``
copies each label and prediction to numpy (NDArrays, torch tensors or
array-likes), so the numbers are the JAX package's for the same
arrays."""
import math
import warnings

import numpy as np

import torch

from .ndarray.ndarray import NDArray
from .utils.registry import get_registry

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy",
           "TopKAccuracy", "F1", "Perplexity", "MAE", "MSE", "RMSE",
           "CrossEntropy", "NegativeLogLikelihood",
           "PearsonCorrelation", "Loss", "CustomMetric", "np_metric",
           "create", "register"]

_REG = get_registry("metric")
register = _REG.register


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REG.get(metric)(*args, **kwargs)


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise ValueError(f"labels ({len(labels)}) and predictions "
                         f"({len(preds)}) must have equal length")


class EvalMetric:
    """Metric base."""

    def __init__(self, name, output_names=None, label_names=None):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.num_nonfinite = 0          # excluded bad batches
        self._nonfinite_warned = False

    def _include(self, sum_inc, num_inc):
        """Guarded accumulate into the running sums.

        A non-finite increment — the footprint of a NaN/Inf pred or
        label batch — is *excluded* (counted in ``num_nonfinite``,
        warned once) instead of being added: one bad batch must not
        turn every subsequent ``get()`` into NaN for the rest of the
        epoch.  Returns True when the increment was applied."""
        if not np.all(np.isfinite(sum_inc)):
            self.num_nonfinite += 1
            if not self._nonfinite_warned:
                warnings.warn(
                    f"metric {self.name}: non-finite batch update "
                    f"({sum_inc}) excluded from the running sum; "
                    "further exclusions counted in num_nonfinite "
                    "(warned once)", RuntimeWarning)
                self._nonfinite_warned = True
            return False
        self.sum_metric += sum_inc
        self.num_inst += num_inc
        return True

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
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

    def get_config(self):
        return {"metric": type(self).__name__, "name": self.name}

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    """(ref: metric.py:209)"""

    def __init__(self, metrics=None, name="composite",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.append(name)
            values.append(value)
        return names, values


@register("acc")
class Accuracy(EvalMetric):
    """(ref: metric.py:339)"""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").flatten()
            label = label.astype("int32").flatten()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register("top_k_accuracy")
class TopKAccuracy(EvalMetric):
    """(ref: metric.py:404)"""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label).astype("int32")
            idx = np.argsort(pred, axis=1)[:, ::-1][:, :self.top_k]
            self.sum_metric += (idx == label.reshape(-1, 1)).any(1).sum()
            self.num_inst += len(label)


@register("f1")
class F1(EvalMetric):
    """Binary F1 (ref: metric.py:478)"""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred, label = _as_np(pred), _as_np(label)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1)
            pred = (pred.flatten() > 0.5).astype(int) if \
                pred.dtype.kind == "f" and pred.ndim == label.ndim \
                else pred.flatten().astype(int)
            label = label.flatten().astype(int)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register("perplexity")
class Perplexity(EvalMetric):
    """(ref: metric.py:573)"""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss, num = 0.0, 0
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(-1).astype("int32")
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[np.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= np.log(np.maximum(probs, 1e-10)).sum()
            num += len(label)
        self._include(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(pred.shape)
            self._include(np.abs(label - pred).mean(), 1)


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(pred.shape)
            self._include(((label - pred) ** 2).mean(), 1)


@register("rmse")
class RMSE(EvalMetric):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(pred.shape)
            self._include(np.sqrt(((label - pred) ** 2).mean()), 1)


@register("ce", aliases=["cross-entropy"])
class CrossEntropy(EvalMetric):
    """(ref: metric.py:854)"""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            label = label.reshape(-1).astype("int32")
            prob = pred[np.arange(len(label)), label]
            self._include((-np.log(prob + self.eps)).sum(), len(label))


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    """(ref: metric.py:990)"""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label).reshape(-1), \
                _as_np(pred).reshape(-1)
            if len(label) > 1:
                self._include(np.corrcoef(label, pred)[0, 1], 1)


@register("loss")
class Loss(EvalMetric):
    """Mean of raw outputs, for loss-symbol heads (ref: metric.py:1043)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in preds:
            pred = _as_np(pred)
            self._include(pred.sum(), pred.size)


class CustomMetric(EvalMetric):
    """(ref: metric.py:1087)"""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 **kwargs):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                s, n = reval
                self._include(s, n)
            else:
                self._include(reval, 1)


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (ref: metric.py np)."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)
