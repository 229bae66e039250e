"""Modules computed in Python (twin of
``incubator_mxnet_tpu/module/python_module.py``; ref:
python/mxnet/module/python_module.py PythonModule:28,
PythonLossModule:240).

``PythonModule`` stubs the parameter and optimizer surface (a Python
module owns no trainable parameter), so a subclass implements forward
and backward only.  ``PythonLossModule`` is the common case: a loss
written by hand at the tail of a ``SequentialModule``, whose input
gradient comes from ``grad_func(label, pred)`` (or a subclass's
``_backward_impl``) on the scores' device.
"""
import logging

import numpy as np

from .. import ndarray as nd
from ..io.io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


def _desc(d):
    return d if isinstance(d, DataDesc) else DataDesc(*d)


class PythonModule(BaseModule):
    """A module whose computation is plain Python over NDArrays (ref:
    python_module.py:28)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # ---------------------------------------------------------- names
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ------------------------------------------------- param surface
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        pass

    def install_monitor(self, mon):
        pass

    # ----------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_desc(d) for d in data_shapes]
        self._label_shapes = None if label_shapes is None else [
            _desc(d) for d in label_shapes]
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """[(name, shape)] from ``self._data_shapes``; by default the
        first data shape passes through (override for anything else)."""
        return [(self._output_names[0],
                 tuple(self._data_shapes[0].shape))]


class PythonLossModule(PythonModule):
    """A loss head computed in Python (ref: python_module.py:240).

    ``forward`` keeps the scores and ``get_outputs`` returns them
    unchanged; ``backward`` makes the input gradient with
    ``grad_func(label, pred)`` (an NDArray or anything numpy takes,
    placed on the scores' device) or a subclass's ``_backward_impl``.
    """

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss head; it takes no out_grads"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError(
                "pass grad_func or override _backward_impl")
        grad = self._grad_func(self._labels, self._scores)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
