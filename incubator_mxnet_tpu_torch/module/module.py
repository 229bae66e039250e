"""Module: the symbolic trainer over one Executor (twin of
``incubator_mxnet_tpu/module/module.py``; ref:
python/mxnet/module/module.py — bind:355, init_params,
init_optimizer:464, forward:560, backward:602, update:619,
update_metric:726).

One card, one executor: the reference's DataParallelExecutorGroup
slices a batch over its GPUs; the multi-card path here is the fused
``kvstore='tpu'`` step (``parallel/symbol_step.py``), which comes with
``kvstore.py``/``parallel/mesh.py`` (ROADMAP item A4) and raises, as
every kvstore but None, 'local' and 'device' does.  The optimizer runs
in the process through ``optimizer.get_updater``, with
``rescale_grad`` 1/batch by default and each parameter's
``lr_mult``/``wd_mult`` read from the symbol's attributes.

Not in this slice (ROADMAP item A11): the step guard
(``MXTPU_NONFINITE_POLICY`` raises), the bind-time memory preflight,
the perf gauges and telemetry.
"""
import logging
import os
import pickle

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from .. import resilience
from ..context import cpu
from ..initializer import InitDesc
from ..io.io import DataDesc
from ..model import (_create_kvstore, save_checkpoint, load_checkpoint,
                     checkpoint_companion_path, save_data_state,
                     load_data_state)
from .base_module import BaseModule

__all__ = ["Module"]


def _check_guard_env():
    policy = os.environ.get("MXTPU_NONFINITE_POLICY", "off").lower()
    if policy not in ("", "off"):
        raise NotImplementedError(
            "MXTPU_NONFINITE_POLICY: the step guard is not ported yet "
            "(ROADMAP item A11)")


def _to_desc(d):
    return d if isinstance(d, DataDesc) else DataDesc(*d)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise NotImplementedError(
                    "Module over several devices: the data-parallel path "
                    "needs kvstore.py and parallel/mesh.py (ROADMAP item "
                    "A4); give one device")
            context = context[0]
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._context = context
        self._fixed_param_names = set(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None
        self._preloaded_params = None
        self._preload_opt_states = None

    # ------------------------------------------------------------ bind
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return list(zip(self.output_names, self._exec.output_shapes))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Allocate the executor's arrays from the inputs' shapes on the
        module's device (None: the card)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_to_desc(d) for d in data_shapes]
        self._label_shapes = [_to_desc(d) for d in (label_shapes or [])]
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes})
        if isinstance(grad_req, str):
            req = {}
            for n in self._symbol.list_arguments():
                frozen = n in self._fixed_param_names or not for_training \
                    or n in self._label_names or (
                        n in self._data_names and not inputs_need_grad)
                req[n] = "null" if frozen else grad_req
        else:
            req = grad_req
        self._exec = self._symbol.simple_bind(self._context, grad_req=req,
                                              **shapes)
        if shared_module is not None and shared_module._exec is not None:
            self._exec.copy_params_from(
                shared_module._exec.arg_dict, shared_module._exec.aux_dict,
                allow_extra_params=True)
        self.binded = True
        if self._preloaded_params is not None:      # Module.load
            arg, aux = self._preloaded_params
            self.init_params(arg_params=arg, aux_params=aux,
                             force_init=True)
            self._preloaded_params = None

    # ------------------------------------------------------------ params
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        """Fill the parameters and aux states from ``arg_params`` /
        ``aux_params`` where they are given, else by ``initializer``
        (default Uniform(0.01)), each picked by its name and its
        ``__init__`` attribute."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        attrs = self._symbol.attr_dict()

        def _fill(name, arr, cache):
            if cache is not None and name in cache:
                arr[:] = cache[name]
                return
            if cache is not None and not allow_missing:
                raise RuntimeError(
                    f"parameter '{name}' missing from provided params "
                    "(pass allow_missing=True to initialize it)")
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name, {})), arr)
            elif cache is None:
                init_mod.Uniform(0.01)(InitDesc(name, attrs.get(name, {})),
                                       arr)

        for name in self._param_names:
            _fill(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            _fill(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True

    def get_params(self):
        """Copies of (arg_params, aux_params)."""
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (a name: created with ``rescale_grad`` 1/batch
        unless given, and the symbol's lr/wd multipliers) and its
        updater."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        _check_guard_env()
        if isinstance(kvstore, str) and kvstore == "tpu":
            raise NotImplementedError(
                "kvstore='tpu': the fused mesh step (parallel/"
                "symbol_step.py) needs kvstore.py and parallel/mesh.py, "
                "the second half of ROADMAP item A4; on one card use "
                "'device', 'local' or None")
        _create_kvstore(kvstore, 1)           # raises on multi-card stores
        if isinstance(optimizer, str):
            params = dict(optimizer_params or ())
            if "rescale_grad" not in params and self._data_shapes:
                params["rescale_grad"] = 1.0 / max(
                    self._data_shapes[0].shape[0], 1)
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt_mod.create(optimizer, sym=self._symbol,
                                       param_idx2name=idx2name, **params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        states, self._preload_opt_states = self._preload_opt_states, None
        if states:
            try:
                self.load_optimizer_states(states)
            except (FileNotFoundError,
                    resilience.CheckpointCorruptError) as exc:
                # the params may come from a fallback epoch whose
                # .states never existed or was torn: the weights are
                # intact and momentum rebuilds
                import warnings
                warnings.warn(f"optimizer states {states} could not be "
                              f"loaded ({exc}); resuming with freshly "
                              "initialized optimizer state",
                              RuntimeWarning)

    # ------------------------------------------------------------ step
    def _batch_inputs(self, data_batch):
        inputs = {}
        for desc, arr in zip(self._data_shapes, data_batch.data):
            inputs[desc.name] = arr
        if data_batch.label is not None and self._label_shapes:
            for desc, arr in zip(self._label_shapes, data_batch.label):
                if desc.name in self._exec.arg_dict:  # may be label-free
                    inputs[desc.name] = arr
        return inputs

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train,
                           **self._batch_inputs(data_batch))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """The training step's forward and backward."""
        self._exec.forward_backward(**self._batch_inputs(data_batch))

    def update(self):
        """Apply the optimizer to every parameter with a gradient."""
        assert self.optimizer_initialized
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is not None:      # fixed / grad_req 'null': skipped
                self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self._exec.outputs)

    def install_monitor(self, mon):
        mon.install(self._exec)

    # ------------------------------------------------------------ ckpt
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        data_iter=None):
        """Save params (and optimizer states, and the input pipeline's
        position when ``data_iter`` is given), each file atomically."""
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")
        if data_iter is not None:
            save_data_state(prefix, epoch, data_iter)

    @staticmethod
    def load_data_state(prefix, epoch, data_iter, strict=False):
        """Restore ``data_iter`` from the checkpoint's ``.data``
        companion (``model.load_data_state``)."""
        return load_data_state(prefix, epoch, data_iter, strict=strict)

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        states = self._updater.get_states()
        resilience.atomic_save(fname, lambda f: f.write(states))

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        raw = resilience.read_validated_bytes(fname)
        # decode under the corruption guard, apply outside it
        obj = resilience.decode_or_corrupt(fname, lambda: pickle.loads(raw))
        self._updater.set_states(obj)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (of either package); its params
        apply at ``bind()``, and with ``load_optimizer_states`` the
        ``.states`` of the epoch that loaded apply at
        ``init_optimizer()``."""
        symbol, arg_params, aux_params, eff = load_checkpoint(
            prefix, epoch, return_epoch=True, ctx=cpu())
        mod = Module(symbol, **kwargs)
        mod._preloaded_params = (arg_params, aux_params)
        if load_optimizer_states:
            mod._preload_opt_states = checkpoint_companion_path(prefix, eff)
        return mod
