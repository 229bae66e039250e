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

The step sentinel (``MXTPU_NONFINITE_POLICY``): on the updater routes
a ``GuardedUpdater`` skips a bad step whole; under kvstore='tpu' the
fused step is built with ``numeric_guard`` (the select on the device),
and ``update`` folds its finiteness scalar into the guard's counter,
read once every ``MXTPU_GUARD_INTERVAL`` steps.  ``bind`` runs the
memory preflight (the executor's plan: gradients of every parameter,
no donation; no rungs, so it fits, warns or raises ``MemoryPlanError``).
``perf_report`` gives the graph's per-family cost and roofline table,
and the executor route's ``update`` ticks the MFU clock (the fused step
ticks its own).

A context list binds one executor over the whole batch on its first
context, as the JAX Module's numbers are a single context's.
``save_sharded_checkpoint`` / ``load_sharded_checkpoint`` write and
restore the fused step's reshardable generations
(``parallel/checkpoint.py``).  ``update`` counts
``train_steps_total``, and the eager path attributes its parameters
and optimizer state to the tracing layer's memory gauges.
"""
import logging
import pickle

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from .. import resilience, telemetry, tracing
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


def _to_desc(d):
    return d if isinstance(d, DataDesc) else DataDesc(*d)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger)
        if isinstance(context, (list, tuple)):
            # the JAX Module binds one executor over the whole batch
            # whatever the list holds (its numbers are a single
            # context's): the port runs the batch on the list's first
            # context; data parallelism over devices is the mesh step's
            # (kvstore='tpu') or the processes' (dist_sync)
            if not context:
                raise ValueError("an empty context list")
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
        self._guard = None          # step sentinel (MXTPU_NONFINITE_POLICY)
        self._kvstore = None
        self._update_on_kvstore = False
        self._perf_clock = None     # MFU gauges (perf observatory)
        self._perf_cost = None      # cached graph CostReport (3x fwd)
        self._perf_tried = False    # don't re-cost after a failure
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
        self._preflight_memory(shapes, for_training)
        self._exec = self._symbol.simple_bind(self._context, grad_req=req,
                                              **shapes)
        self._perf_cost = None
        self._perf_tried = False
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

    def _plan_maker(self, shapes, for_training, optimizer_bytes=0.0):
        """``make_plan(remat, grad_accum)`` of the executor route at
        ``shapes``: every gradient live (the executor's arrays), the
        update in place by the per-parameter updater, whose temporaries
        are counted (``perf.memory_planner.eager_update_bytes``), and
        the optimizer state given (unknown at bind: 0)."""
        from ..perf import memory_planner as mp
        live = mp.symbol_liveness(self._symbol, dict(shapes),
                                  input_names=[n for n in shapes if n in
                                               set(self._data_names)
                                               | set(self._label_names)])
        return lambda r, a: mp.plan_memory(
            liveness=live, train=for_training, donate=True,
            max_param_bytes=live["params_bytes"],
            optimizer_bytes=optimizer_bytes,
            update_bytes=mp.eager_update_bytes(live["max_param_bytes"])
            if for_training else 0.0, grad_accum=a, remat=r)

    def _preflight_memory(self, shapes, for_training):
        """The memory gate at bind time: plan the executor route's peak
        live bytes (``_plan_maker``) against the device's capacity per
        MXTPU_MEM_POLICY.  The executor route has no remat or
        grad_accum rungs, so the plan fits, warns, or raises a typed
        MemoryPlanError before anything is allocated.  A planner
        failure on an exotic graph is logged, not raised."""
        from ..perf import memory_planner as mp
        try:
            mp.preflight(self._plan_maker(shapes, for_training),
                         site="module_bind", device=self._context)
        except resilience.MemoryPlanError:
            raise
        except Exception:
            mp.plan_failed("module_bind")

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
        # step sentinel, armed by MXTPU_NONFINITE_POLICY; the Module has
        # no user-scaled loss, so no LossScaler (that is the Trainer's)
        guard = resilience.NumericGuard(name="Module")
        self._guard = guard if guard.enabled else None
        if use_mesh_step:
            self._init_mesh_step()
        if kv is not None:
            for i, name in enumerate(self._param_names):
                kv.init(i, self._exec.arg_dict[name])
            if self._update_on_kvstore:
                kv.set_optimizer(optimizer)
        if not self._update_on_kvstore and not use_mesh_step:
            self._updater = self._new_updater()
        if not use_mesh_step:
            # device-memory attribution (docs/observability.md); the
            # fused step's SymbolTrainStep registers its own providers
            self._register_memory_providers()
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
            wd_mults=default_wd_mults(trainable, opt.wd_mult),
            numeric_guard=self._guard is not None,
            guard_select=self._guard is not None
            and self._guard.drops_updates)
        self._mesh_dirty = self._mesh_pending = self._mesh_stale = False

    def _new_updater(self):
        return opt_mod.GuardedUpdater(self._optimizer, guard=self._guard) \
            if self._guard is not None \
            else opt_mod.get_updater(self._optimizer)

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

    def _register_memory_providers(self):
        """Attribute this module's device buffers in the tracing
        layer's memory gauges: bound params + eager-updater optimizer
        state.  Weakref'd so a dropped module stops being counted."""
        for unreg in getattr(self, "_mem_unregister", ()):
            unreg()

        def _param_arrays(mod):
            if mod._exec is None:
                return []
            return [mod._exec.arg_dict[n]._data
                    for n in mod._param_names
                    if n in mod._exec.arg_dict]

        def _opt_arrays(mod):
            states = getattr(mod._updater, "states", None)
            return tracing.updater_state_arrays(states) \
                if states else []

        self._mem_unregister = tracing.register_param_opt_providers(
            self, _param_arrays, _opt_arrays)

    def update(self):
        """Apply the optimizer to every parameter with a gradient (ref:
        module.py update:619, model.py _update_params_on_kvstore:105).
        After a fused kvstore='tpu' step there is nothing left to do but
        the guard's accounting; a manual forward/backward loop under
        kvstore='tpu' runs the eager updater.

        Step sentinel: with MXTPU_NONFINITE_POLICY armed, the step's
        gradients reduce to one finiteness scalar, host-read every
        MXTPU_GUARD_INTERVAL steps; a bad step is skipped whole
        (weights, optimizer state, LR-schedule count), and
        MXTPU_MAX_BAD_STEPS consecutive bad steps raise DivergedError
        for fit's checkpoint rollback."""
        assert self.optimizer_initialized
        telemetry.counter("train_steps_total").inc()
        if self._mesh_step is None:
            # the fused step ticks its own clock
            if self._perf_clock is None and not self._perf_tried:
                self._arm_perf_clock()
            if self._perf_clock is not None:
                self._perf_clock.tick()
        if self._mesh_step is not None:
            if self._mesh_pending:
                self._mesh_pending = False
                if self._guard is not None:
                    self._mesh_guard_read()
                return
            if self._updater is None:
                self._updater = self._new_updater()
            self._sync_mesh_params()
            self._mesh_stale = True
        if self._guard is not None:
            grads = [g for g in (self._exec.grad_dict.get(n)
                                 for n in self._param_names)
                     if g is not None]
            if isinstance(self._updater, opt_mod.GuardedUpdater):
                proceed = self._updater.begin_step(grads)
            else:
                # update_on_kvstore: the optimizer runs in the store, so
                # the step is guarded before any push
                proceed = opt_mod.guarded_step_begin(self._guard, None,
                                                     grads)
            if not proceed:
                return
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

    def _mesh_guard_read(self):
        """The fused step already dropped a bad update on the device;
        the host folds its flag into the guard's counter and, on a due
        step, reads it for the policy and divergence accounting."""
        due = self._guard.begin_step()
        opt_mod.accumulate_window(self._guard, self._mesh_step.last_finite)
        if not due:
            return
        with telemetry.span("host_sync"):
            bad = opt_mod.read_window_bad(self._guard)
        if bad and self._guard.drops_updates:
            # keep the LR schedule in step with the weights (before
            # record, which raises under policy=raise)
            self._optimizer.num_update -= bad
        self._guard.record(bad == 0, dropped=max(bad, 1))

    # ------------------------------------------------------------ perf
    def _bound_shapes(self):
        """Variable name -> shape for everything the bind fixed."""
        shapes = {d.name: tuple(d.shape) for d in self._data_shapes}
        shapes.update({d.name: tuple(d.shape)
                       for d in (self._label_shapes or [])})
        for n in self._param_names:
            shapes[n] = tuple(self._exec.arg_dict[n].shape)
        for n in self._aux_names:
            shapes[n] = tuple(self._exec.aux_dict[n].shape)
        return shapes

    def _graph_cost(self):
        """Analytic CostReport of one TRAIN step (3x forward) at the
        bound shapes; cached per bind."""
        if self._perf_cost is None:
            from .. import perf
            self._perf_cost = perf.symbol_cost(
                self._symbol, self._bound_shapes()).scaled(3.0)
        return self._perf_cost

    def _device(self):
        arrays = list(self._exec.arg_dict.values())
        return arrays[0]._data.device if arrays else cpu().device

    def _arm_perf_clock(self):
        """Arm the train_mfu/train_mbu clock once from the graph cost
        model (never retried after a failure, never on the step
        path)."""
        self._perf_tried = True
        try:
            from .. import perf
            rep = self._graph_cost()
            self._perf_clock = perf.TrainPerfClock(
                rep.flops, rep.bytes, device=self._device(),
                dtype=self._dtype())
        except Exception:
            self._perf_clock = None

    def _dtype(self):
        arrays = list(self._exec.arg_dict.values())
        return str(arrays[0]._data.dtype).replace("torch.", "") \
            if arrays else "float32"

    def perf_report(self, xla_check=True):
        """Per-family cost/roofline report for the bound graph.

        Returns a dict: ``per_family`` rows (flops%, bytes%,
        predicted-time%, bound-by label, arithmetic intensity),
        ``total`` summary, coverage counts, the device roofline verdict
        for one train step and the device's caps.  ``xla_check`` (the
        JAX package's name) adds ``flop_counter_check``: the analytic
        forward FLOPs against ``FlopCounterMode``'s count of the bound
        graph's forward on ``meta`` tensors (products only), or None."""
        assert self.binded, "call bind before perf_report"
        from .. import perf
        rep = self._graph_cost()
        caps = perf.caps_for(self._device())
        dtype = self._dtype()
        out = {
            "per_family": rep.table(caps, dtype),
            "total": rep.summary(),
            "coverage": rep.coverage,
            "default_ops": rep.default_ops,
            "unknown_ops": rep.unknown_ops,
            "roofline": perf.roofline(rep.flops, rep.bytes, caps, dtype),
            "device": caps.as_dict(),
            "n_nodes": rep.n_nodes,
        }
        if xla_check:
            out["flop_counter_check"] = self._counted_fwd_delta(rep)
        return out

    def _counted_fwd_delta(self, train_rep):
        """Analytic-vs-counted forward FLOPs of the bound graph (its
        forward run once on ``meta`` tensors under FlopCounterMode), or
        None when counting fails."""
        import torch

        from .. import perf
        from ..executor import build_graph_fn
        ex = self._exec
        meta = {n: torch.empty(tuple(v.shape), dtype=v._data.dtype,
                               device="meta")
                for n, v in ex.arg_dict.items()}
        aux = {n: torch.empty(tuple(v.shape), dtype=v._data.dtype,
                              device="meta")
               for n, v in ex.aux_dict.items()}
        try:
            run = build_graph_fn(self._symbol,
                                 default_device=torch.device("meta"))
            cost = perf.jit_cost(
                lambda: run(meta, aux, lambda fold, dev: None, False))
        except Exception:
            return None
        if not cost or not cost.get("flops"):
            return None
        analytic_fwd = train_rep.flops / 3.0
        return {"analytic_fwd_flops": analytic_fwd,
                "counted_fwd_flops": cost["flops"],
                "rel_delta": abs(analytic_fwd - cost["flops"])
                / cost["flops"]}

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

    # ---------------------------------------------------- elastic ckpt
    def save_sharded_checkpoint(self, ckpt_dir, step=None,
                                data_iter=None):
        """Reshardable sharded checkpoint (``parallel/checkpoint.py``):
        parameters, aux states and the fused step's optimizer state land
        as one manifest generation under ``ckpt_dir``, each rank writing
        the slices it owns; the input pipeline's position rides in the
        same generation when ``data_iter`` is given.  kvstore='tpu'
        only (the eager paths keep the prefix/epoch format).  Returns
        the generation directory."""
        if self._mesh_step is None:
            raise RuntimeError(
                "save_sharded_checkpoint needs the kvstore='tpu' mesh "
                "step (legacy contexts: use save_checkpoint)")
        if self._mesh_stale:
            # an eager update or set_params touched the executor since
            # the last fused step: save what the user sees
            self._push_mesh_params()
        data_state = data_iter.state_dict() \
            if data_iter is not None else None
        return self._mesh_step.save_checkpoint(
            ckpt_dir, step=step, data_state=data_state)

    def load_sharded_checkpoint(self, ckpt_dir, data_iter=None):
        """Restore the newest valid sharded generation into the fused
        step, resharded onto this job's mesh, and the data iterator's
        cursor from the generation's companion when ``data_iter`` is
        given.  Returns the companion state (or None)."""
        if self._mesh_step is None:
            raise RuntimeError(
                "load_sharded_checkpoint needs the kvstore='tpu' mesh "
                "step (legacy contexts: use model.load_checkpoint)")
        state = self._mesh_step.load_checkpoint(ckpt_dir)
        # the restored values are the truth now: the executor re-pulls
        # them, and no stale push may overwrite them
        self._mesh_dirty = True
        self._mesh_stale = False
        if data_iter is not None and state is not None:
            data_iter.load_state_dict(state)
        return state

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
