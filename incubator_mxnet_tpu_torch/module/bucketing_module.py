"""BucketingModule: variable-length training through one Module per
bucket (twin of ``incubator_mxnet_tpu/module/bucketing_module.py``; ref:
python/mxnet/module/bucketing_module.py — switch_bucket:337 lazily
binds one Module per bucket sharing the default bucket's parameters).

Each bucket is one static shape and binds its own executor, through the
graph-pass pipeline like any bind.  Parameters are copied into a
bucket's module when it becomes the current one (the reference shares
the storage; here each executor owns its arrays), and every bucket
borrows the default bucket's optimizer and updater, so the optimizer
state stays one across bucket switches."""
import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Drives a ``sym_gen(bucket_key) -> (symbol, data_names,
    label_names)`` factory, one Module per bucket."""

    def __init__(self, sym_gen, default_bucket_key=None,
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None):
        super().__init__(logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._grad_req = "write"

    # ------------------------------------------------------------ props
    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        return self._curr_module._symbol

    # ------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind the default bucket (ref: bucketing_module.py bind)."""
        if self.binded and not force_rebind:
            return
        assert shared_module is None, \
            "shared_module not supported for BucketingModule"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        symbol, data_names, label_names = self._sym_gen(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names,
                        logger=self.logger, context=self._context,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes,
                      label_shapes=None):
        """Activate (lazily binding) the bucket's module (ref:
        bucketing_module.py switch_bucket:337)."""
        assert self.binded, "call bind before switch_bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key],
                        grad_req=self._grad_req)
            module.params_initialized = True
            if self.optimizer_initialized:
                self._borrow_optimizer(module)
            self._buckets[bucket_key] = module
        if bucket_key != self._curr_bucket_key:
            module = self._buckets[bucket_key]
            # sync params from the currently-active module
            if self._curr_module is not None and \
                    self._curr_module.params_initialized:
                arg, aux = self._curr_module.get_params()
                module._exec.copy_params_from(arg, aux,
                                              allow_extra_params=True)
            self._curr_module = module
            self._curr_bucket_key = bucket_key

    # ------------------------------------------------------------ params
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._curr_module.init_params(initializer, arg_params,
                                      aux_params, allow_missing,
                                      force_init, allow_extra)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params,
                   allow_missing=False, force_init=True,
                   allow_extra=False):
        self._curr_module.init_params(
            arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init)
        self.params_initialized = True

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Init on the default bucket; other buckets *borrow* the same
        optimizer/updater so momentum state stays continuous across
        bucket switches (ref: bucketing_module.py borrow_optimizer)."""
        if self.optimizer_initialized and not force_init:
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                self._borrow_optimizer(mod)
        self.optimizer_initialized = True

    def _borrow_optimizer(self, module):
        """Share the default bucket's optimizer state (ref:
        module.py borrow_optimizer)."""
        default = self._buckets[self._default_bucket_key]
        module._optimizer = default._optimizer
        module._updater = default._updater
        module._kvstore = default._kvstore
        module._update_on_kvstore = default._update_on_kvstore
        module.optimizer_initialized = True

    # ------------------------------------------------------------ step
    def forward(self, data_batch, is_train=None):
        assert self.binded
        self.switch_bucket(data_batch.bucket_key,
                           data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
