"""Module: the symbolic trainer over one Executor (twin of
``incubator_mxnet_tpu/module/module.py``; ref:
python/mxnet/module/module.py — bind:355, init_params,
init_optimizer:464, forward:560, backward:602, update:619,
update_metric:726).

One device, one executor: the reference's DataParallelExecutorGroup
slices a batch over its GPUs.  The optimizer has ``rescale_grad``
1/batch by default and each parameter's ``lr_mult``/``wd_mult`` read
from the symbol's attributes, and runs by the kvstore:

- None, 'local', 'device' (one device): ``optimizer.get_updater`` in
  the process, one update per parameter;
- a ``KVStore`` or a 'dist_*' name: push and pull through the store
  (``model._create_kvstore``), which runs the optimizer unless a
  parameter is larger than 16M entries;
- 'tpu': the fused step (``parallel.SymbolTrainStep``) over the ambient
  mesh: ``forward_backward`` runs forward, backward and the update in
  one step, on a CUDA device one CUDA graph replay, and ``update``
  returns at once.  The step owns the values; the executor's arrays
  are refreshed from it when they are read (``get_params``, a
  checkpoint, a forward outside the step).  A manual ``forward`` /
  ``backward`` / ``update`` loop runs the executor and the eager
  updater, and the next fused step takes the values up again.  Only an
  optimizer with a functional twin (SGD, NAG, Adam) has a fused step.

Not in this slice: the multi-device contexts and the sharded
checkpoints (ROADMAP item A9); the step guard
(``MXTPU_NONFINITE_POLICY`` raises), the bind-time memory preflight,
the perf gauges and telemetry (A11).
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
from ..ndarray.ndarray import NDArray
from ..parallel.optim import load_state, state_to_numpy
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
                    "Module over several devices: the multi-card modes "
                    "are ROADMAP item A9; give one device (a mesh step "
                    "takes kvstore='tpu')")
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
        self._kvstore = None
        self._update_on_kvstore = False
        self._mesh_step = None      # kvstore='tpu': the fused step
        self._mesh_dirty = False    # step values newer than the exec's
        self._mesh_pending = False  # the fused step ran; update() owes none
        self._mesh_stale = False    # exec values newer than the step's
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

    @property
    def graph_opt_report(self):
        """Pass-pipeline report of the bound executor (per-pass node
        deltas).  None before bind."""
        return getattr(self, "_graph_opt_report", None)

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
        # the pass pipeline's report of this bind (None when
        # MXTPU_GRAPH_OPT=0 or placed)
        self._graph_opt_report = self._exec.graph_report
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
        if self._mesh_step is not None:
            # the executor's values are the truth now: the fused step
            # takes them up before its next step
            self._mesh_dirty = False
            self._mesh_stale = True
        self.params_initialized = True

    def get_params(self):
        """Copies of (arg_params, aux_params)."""
        self._sync_mesh_params()
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
        use_mesh_step = isinstance(kvstore, str) and kvstore == "tpu"
        arg_params = {n: self._exec.arg_dict[n] for n in self._param_names}
        kv, update_on_kvstore = (None, False) if use_mesh_step else \
            _create_kvstore(kvstore, 1, arg_params)
        if isinstance(optimizer, str):
            params = dict(optimizer_params or ())
            if "rescale_grad" not in params and self._data_shapes:
                batch = self._data_shapes[0].shape[0]
                if kv is not None:
                    batch *= kv.num_workers
                params["rescale_grad"] = 1.0 / max(batch, 1)
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt_mod.create(optimizer, sym=self._symbol,
                                       param_idx2name=idx2name, **params)
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore and kv is not None
        self._updater = None
        self._mesh_step = None
        if use_mesh_step:
            self._init_mesh_step()
        if kv is not None:
            for i, name in enumerate(self._param_names):
                kv.init(i, self._exec.arg_dict[name])
            if self._update_on_kvstore:
                kv.set_optimizer(optimizer)
        if not self._update_on_kvstore and not use_mesh_step:
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

    # ------------------------------------------------------------ mesh
    def _init_mesh_step(self):
        """kvstore='tpu': the fused step over the ambient mesh (default:
        one over the executor's device) in place of the executor group
        and the store's push and pull."""
        from ..parallel import current_mesh, make_mesh
        from ..parallel.optim import default_wd_mults, from_imperative
        from ..parallel.symbol_step import SymbolTrainStep
        opt = self._optimizer
        fopt = from_imperative(opt)
        if fopt is None:
            raise ValueError(
                f"kvstore='tpu' supports sgd/nag/adam-family "
                f"optimizers in the fused step; got "
                f"{type(opt).__name__}. Use kvstore='device' for the "
                "eager update path.")
        ex = self._exec
        trainable = [n for n in self._param_names if n in ex.grad_dict]
        pvals = {n: ex.arg_dict[n]._data for n in trainable}
        # fixed parameters ride with the aux states
        aux_vals = {n: ex.aux_dict[n]._data for n in self._aux_names}
        aux_vals.update({n: ex.arg_dict[n]._data
                         for n in self._param_names
                         if n not in ex.grad_dict})
        input_names = [d.name for d in self._data_shapes]
        input_names += [d.name for d in (self._label_shapes or [])
                        if d.name in ex.arg_dict]
        mesh = current_mesh() or make_mesh(
            devices=[ex.arg_dict[trainable[0]]._data.device])
        self._mesh_step = SymbolTrainStep(
            self._symbol, pvals, aux_vals, input_names, optimizer=fopt,
            mesh=mesh, rescale_grad=getattr(opt, "rescale_grad", 1.0),
            lr_mults={n: opt.lr_mult.get(n, 1.0) for n in trainable},
            wd_mults=default_wd_mults(trainable, opt.wd_mult))
        self._mesh_dirty = self._mesh_pending = self._mesh_stale = False

    def _sync_mesh_params(self):
        """Copy the fused step's values into the executor's arrays
        (when they are read, not at every step)."""
        if self._mesh_step is None or not self._mesh_dirty:
            return
        params, aux = self._mesh_step.owned_values()
        ex = self._exec
        for n, v in params.items():
            ex.arg_dict[n]._data = v
        for n, v in aux.items():
            (ex.aux_dict if n in ex.aux_dict else ex.arg_dict)[n]._data = v
        self._mesh_dirty = False

    def _push_mesh_params(self):
        """Hand the executor's values to the fused step (after an eager
        update or ``set_params``)."""
        ex = self._exec
        step = self._mesh_step
        step.set_values(
            {n: ex.arg_dict[n]._data for n in step.params},
            {n: (ex.aux_dict[n] if n in ex.aux_dict else ex.arg_dict[n])
             ._data for n in step.aux})
        self._mesh_stale = False

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
        inputs = self._batch_inputs(data_batch)
        step = self._mesh_step
        if not is_train and step is not None and not self._mesh_stale \
                and set(step.input_names) <= set(inputs):
            # score / predict on the fused step's values
            outs = step.evaluate({n: inputs[n] for n in step.input_names})
            self._exec._outputs = [NDArray(o) for o in outs]
            return
        self._sync_mesh_params()
        self._exec.forward(is_train=is_train, **inputs)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """The training step's forward and backward; under
        kvstore='tpu' the whole fused step, update included."""
        if self._mesh_step is None:
            self._exec.forward_backward(**self._batch_inputs(data_batch))
            return
        from ..parallel.optim import scheduled_lr
        if self._mesh_stale:
            self._push_mesh_params()
        outs = self._mesh_step(self._batch_inputs(data_batch),
                               lr=scheduled_lr(self._optimizer))
        self._exec._outputs = [NDArray(o) for o in outs]
        self._mesh_dirty = True
        self._mesh_pending = True

    def update(self):
        """Apply the optimizer to every parameter with a gradient (ref:
        module.py update:619, model.py _update_params_on_kvstore:105).
        After a fused kvstore='tpu' step there is nothing left to do; a
        manual forward/backward loop under kvstore='tpu' runs the eager
        updater."""
        assert self.optimizer_initialized
        if self._mesh_step is not None:
            if self._mesh_pending:
                self._mesh_pending = False
                return
            if self._updater is None:
                self._updater = opt_mod.get_updater(self._optimizer)
            self._sync_mesh_params()
            self._mesh_stale = True
        kv = self._kvstore
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:          # fixed / grad_req 'null': skipped
                continue
            weight = self._exec.arg_dict[name]
            if kv is not None and self._update_on_kvstore:
                kv.push(i, grad, priority=-i)
                kv.pull(i, out=weight, priority=-i)
            elif kv is not None:
                kv.push(i, grad, priority=-i)
                kv.pull(i, out=grad, priority=-i)
                self._updater(i, grad, weight)
            else:
                self._updater(i, grad, weight)

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
        """The optimizer state: the fused step's tree (numpy, as the JAX
        Module writes it), the store's, or the updater's."""
        assert self.optimizer_initialized
        if self._mesh_step is not None:
            tree = state_to_numpy(self._mesh_step.opt_state)
            resilience.atomic_save(fname, lambda f: pickle.dump(tree, f))
        elif self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            states = self._updater.get_states()
            resilience.atomic_save(fname, lambda f: f.write(states))

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._mesh_step is None:
            self._kvstore.load_optimizer_states(fname)
            return
        raw = resilience.read_validated_bytes(fname)
        # decode under the corruption guard, apply outside it
        obj = resilience.decode_or_corrupt(fname, lambda: pickle.loads(raw))
        if self._mesh_step is not None:
            load_state(self._mesh_step.opt_state, obj)
        else:
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
