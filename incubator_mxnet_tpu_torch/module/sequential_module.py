"""SequentialModule: modules chained head to tail (twin of
``incubator_mxnet_tpu/module/sequential_module.py``; ref:
python/mxnet/module/sequential_module.py SequentialModule:28).

Each sub-module's outputs feed the next one's data inputs; backward
runs the chain in reverse, handing each module's input gradients to its
predecessor as output gradients.  The module added with
``take_labels=True`` (by default the last) gets the labels and updates
the metric.  Each sub-module binds its own executor on its own device,
so a chain of K modules runs K executors a step where one ``Module``
over the whole symbol runs one.
"""
import logging

from ..io.io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """(ref: sequential_module.py:28)"""

    META_TAKE_LABELS = "take_labels"
    # outputs are always wired to the next module's data names (the
    # reference's auto_wiring), so this meta is accepted and changes
    # nothing
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append a sub-module.  ``take_labels=True`` marks the one fed
        the labels (normally the last, with the loss)."""
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ------------------------------------------------------------ names
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def _takes_labels(self, i):
        return self._metas[i].get(self.META_TAKE_LABELS,
                                  i == len(self._modules) - 1)

    # ------------------------------------------------------------ params
    def get_params(self):
        arg, aux = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            dup = (set(arg) & set(a)) | (set(aux) & set(x))
            if dup:
                raise ValueError(
                    f"duplicate parameter names across sub-modules: "
                    f"{sorted(dup)}; give stages distinct layer names")
            arg.update(a)
            aux.update(x)
        return arg, aux

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        for m in self._modules:
            # each sub-module sees the other stages' keys as extras
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params,
                          allow_missing=allow_missing,
                          force_init=force_init, allow_extra=True)
        self.params_initialized = True

    # ------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert self._modules, "add() sub-modules before bind()"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        shapes = list(data_shapes)
        n = len(self._modules)
        for i, m in enumerate(self._modules):
            # every module but the first hands gradients back
            m.bind(shapes,
                   label_shapes=label_shapes if self._takes_labels(i)
                   else None,
                   for_training=for_training,
                   inputs_need_grad=inputs_need_grad or i > 0,
                   force_rebind=force_rebind, grad_req=grad_req)
            if i + 1 < n:
                # this module's outputs are the next one's data
                shapes = [DataDesc(name, tuple(out[1])) for name, out in
                          zip(self._modules[i + 1].data_names,
                              m.output_shapes)]
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------ step
    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, m in enumerate(self._modules):
            m.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            batch = DataBatch(m.get_outputs(), data_batch.label,
                              pad=data_batch.pad)

    def backward(self, out_grads=None):
        grads = out_grads
        for i in range(len(self._modules) - 1, -1, -1):
            self._modules[i].backward(out_grads=grads)
            if i > 0:
                grads = self._modules[i].get_input_grads()

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for i, m in enumerate(self._modules):
            if self._takes_labels(i):
                m.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for m in self._modules:
            m.install_monitor(mon)
