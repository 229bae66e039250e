"""SymbolTrainStep: one fused forward + backward + optimizer step of a
Symbol graph, the ``kvstore='tpu'`` step of ``Module`` (twin of
``incubator_mxnet_tpu/parallel/symbol_step.py``; ref:
python/mxnet/module/executor_group.py:99, python/mxnet/model.py
_update_params_on_kvstore:105).

One step runs the bound graph's forward (``executor.build_graph_fn``,
the same op functions the Executor calls), the backward of the Output
ops' ones cotangent (a loss head such as ``SoftmaxOutput`` starts its
own gradient), and the functional update with ``rescale_grad`` and each
parameter's lr/wd multipliers.  Where the JAX step is one jit
executable, this one, on a CUDA device, is one CUDA graph replay
(``_graph.StepGraph``), captured once per batch signature: parameters,
aux states and optimizer state are the graph's buffers, updated in
place, and the learning rate and ``rescale_grad`` are device tensors
written before each replay.  On the CPU the same step runs op by op.

``numeric_guard=True`` is the step sentinel's variant: the gradients
(times a ``poison`` device tensor, 1 unless the ``grad:nonfinite``
injection fires) reduce to one on-device finiteness scalar, kept as
``last_finite`` for the host's guard-interval read, and with
``guard_select`` (default: guarded; False for policy ``warn``) the
parameters, aux states and optimizer state are selected against their
values before the update, ``torch.where(finite, new, old)``, inside the
step (and its graph), so a bad step changes none of them.  Before the
first step the memory preflight plans the graph (``perf.
memory_planner.symbol_liveness``); this step has no rungs, so the plan
fits, warns, or raises ``MemoryPlanError``.  The first step also costs
the graph (``perf.symbol_cost``, 3x the forward) and arms the MFU clock.
``save_checkpoint`` / ``load_checkpoint`` write and restore reshardable
generations (``parallel/checkpoint.py``; parameters, aux states and the
optimizer state in the JAX package's layout, restored in place).

The first call of each batch signature (the capture on the card, the
first op-by-op run on the CPU) is timed into the compile ledger
``symbol_train_step``, and the step's parameters, aux states and
optimizer state are attributed to the tracing layer's memory gauges,
as the JAX package attributes its compiles and buffers.
"""
import time

import torch

from .. import tracing

from .. import random as _random
from ..ndarray.ndarray import NDArray, _as_tensor
from . import _graph
from . import optim as foptim
from .mesh import make_mesh

__all__ = ["SymbolTrainStep"]


def _tensor(v, device):
    """A batch value (NDArray, tensor or array-like) on ``device``."""
    if isinstance(v, NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    return _as_tensor(v, device)


class SymbolTrainStep:
    """The fused training step over a bound Symbol.

    Parameters
    ----------
    symbol : Symbol, the whole graph with its loss-output heads
    param_vals / aux_vals : dict name -> tensor or NDArray, the initial
        values (copied: the step owns its values); fixed parameters ride
        with the aux states
    input_names : the data and label variables fed each batch, in order
    optimizer : a FunctionalOptimizer or its name ('sgd', 'nag', 'adam')
    rescale_grad : float, the reference Module's 1/batch
    lr_mults / wd_mults : per-parameter multipliers (name -> float)
    mesh : a one-device mesh (``parallel.make_mesh``); default: one over
        the first parameter's device
    """

    def __init__(self, symbol, param_vals, aux_vals, input_names,
                 optimizer="sgd", optimizer_params=None, mesh=None,
                 rescale_grad=1.0, lr_mults=None, wd_mults=None,
                 batch_axis=0, numeric_guard=False,
                 guard_select=None):
        from ..executor import _next_seed, build_graph_fn
        from ..symbol.symbol import _topo
        first = next(iter(param_vals.values()))
        first = first._data if isinstance(first, NDArray) else first
        self.mesh = mesh if mesh is not None \
            else make_mesh(devices=[first.device])
        self.device = self.mesh.device
        # the optimized graph the single-device Executor binds
        # (MXTPU_GRAPH_OPT; random nodes keep their stamped indices)
        from ..graph.passes import optimize_symbol
        symbol, self.graph_report = optimize_symbol(symbol,
                                                    device=self.device)
        self._symbol = symbol
        self._run = build_graph_fn(symbol, default_device=self.device)
        self._param_names = tuple(sorted(param_vals))
        self._input_names = tuple(input_names)
        if isinstance(optimizer, str):
            self.opt = foptim.create(optimizer,
                                     **(optimizer_params or {}))
        else:
            self.opt = optimizer
        self.rescale_grad = float(rescale_grad)
        self._lr_mults = {n: float((lr_mults or {}).get(n, 1.0))
                          for n in self._param_names}
        self._wd_mults = {n: float((wd_mults or {}).get(n, 1.0))
                          for n in self._param_names}
        self.params = {n: self._own(param_vals[n])
                       for n in self._param_names}
        self.aux = {n: self._own(v) for n, v in aux_vals.items()}
        self.opt_state = self.opt.init(self.params)
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._scale = torch.full((), self.rescale_grad,
                                 dtype=torch.float32, device=self.device)
        self._guarded = bool(numeric_guard)
        self._guard_select = self._guarded if guard_select is None \
            else bool(guard_select)
        # the grad:nonfinite injection's multiplier, read by the step
        self._poison = torch.ones((), dtype=torch.float32,
                                  device=self.device)
        self.last_finite = None
        self._mem_plan = None
        self.cost_report = None
        self._perf_clock = None
        # one generator per random node of the graph, seeded from the
        # package's seed (random.seed): a replay draws fresh masks
        n_rng = sum(1 for node in _topo(symbol._heads)
                    if not node.is_variable and node.op.needs_rng)
        self._gens = [_random.generator(_next_seed(), self.device)
                      for _ in range(n_rng)]
        self.trace_counts = {}
        self._graph = _graph.StepGraph(self._step, self._mutable,
                                       "symbol_train_step",
                                       self.trace_counts)
        self._signatures = set()

        # device-memory attribution (docs/observability.md): the step
        # owns the job's params and optimizer state on the device;
        # weakref providers so a dropped step stops being counted
        def _param_arrays(st):
            return list(st.params.values()) + list(st.aux.values())

        def _opt_arrays(st):
            return _graph.tensors_of(st.opt_state)

        self._mem_unregister = tracing.register_param_opt_providers(
            self, _param_arrays, _opt_arrays)

    def _own(self, v):
        return _tensor(v, self.device).clone()

    # ------------------------------------------------------------ step
    def _step(self, *inputs):
        """The whole step, in place; returns the graph's outputs (and,
        guarded, the gradients' finiteness scalar after them)."""
        vals = dict(zip(self._input_names, inputs))
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in self.params.items()
                  if p.is_floating_point()}
        vals.update(self.params)
        vals.update(leaves)
        with torch.enable_grad():
            outs, aux_upd = self._run(vals, self.aux,
                                      lambda fold, dev: self._gens[fold],
                                      True)
        heads = [o for o in outs
                 if o.requires_grad and o.is_floating_point()]
        names = list(leaves)
        grads = [None] * len(names)
        if heads and names:
            grads = torch.autograd.grad(
                heads, [leaves[n] for n in names],
                [torch.ones_like(h) for h in heads], allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, grads)}
        finite = old = None
        if self._guarded:
            grads = dict(zip(names, torch._foreach_mul(
                list(grads.values()), self._poison)))
            from ..optimizer import all_finite
            finite = all_finite(list(grads.values()))
            if finite is True:
                finite = torch.ones((), dtype=torch.bool,
                                    device=self.device)
            if self._guard_select:
                touched = self._mutable()
                with torch.no_grad():
                    old = [t.clone() for t in touched]
        self.opt.update({n: self.params[n] for n in names}, grads,
                        self.opt_state, scale=self._scale, lr=self._lr,
                        lr_mults=self._lr_mults, wd_mults=self._wd_mults)
        with torch.no_grad():
            for n, v in aux_upd.items():
                self.aux[n].copy_(v)
            if old is not None:
                # a bad step leaves params, aux states and optimizer
                # state as they were, on the device, at every step
                for t, o in zip(touched, old):
                    torch.where(finite, t, o, out=t)
        outs = tuple(o.detach() for o in outs)
        return outs + (finite,) if self._guarded else outs

    def _mutable(self):
        return (list(self.params.values()) + list(self.aux.values())
                + _graph.tensors_of(self.opt_state))

    @property
    def capture_skipped(self):
        """The op that kept a batch signature from being captured (a
        ``Custom`` node), or None: such a step runs eagerly on the
        card."""
        return self._graph.capture_skipped

    # ------------------------------------------------------------- run
    def __call__(self, inputs, rng=None, lr=0.01):
        """One step on a batch: ``inputs`` maps each input name to an
        array (host or device).  Returns the list of output tensors
        (copies, on the step's device).  ``rng`` (an int) reseeds the
        step's generators; ``lr`` is this step's learning rate.  On a
        CUDA device the step is one CUDA graph replay."""
        vals = [_tensor(inputs[n], self.device) for n in self._input_names]
        if rng is not None:
            for fold, g in enumerate(self._gens):
                g.manual_seed((int(rng) + 0x9E3779B9 * (fold + 1))
                              % (1 << 63))
        self._lr.fill_(float(lr))
        if self._guarded:
            from ..optimizer import grad_poison
            self._poison.fill_(grad_poison() or 1.0)
        sig = tuple((n, tuple(v.shape), str(v.dtype))
                    for n, v in zip(self._input_names, vals))
        first = sig not in self._signatures
        from ..resilience import as_oom_error, check_oom
        t0 = time.monotonic()
        try:
            if first and self._mem_plan is None:
                self._preflight(vals)
            # mem:oom injection point; one env read without a spec
            check_oom("symbol_train_step")
            if self.device.type != "cuda":
                outs = list(self._step(*vals))
            else:
                outs = list(self._graph(vals, self._gens))
        except Exception as exc:
            # this step has no runtime rungs: a real (or injected) OOM
            # is typed and stays loud
            oom = as_oom_error(exc, "symbol_train_step",
                               plan=self._mem_plan)
            if oom is None:
                raise
            raise oom from exc
        if self._guarded:
            self.last_finite = outs.pop()
        if first:
            # a new batch signature: the card captured it, the CPU ran
            # it op by op for the first time
            self._signatures.add(sig)
            cost = self._arm_perf(vals)
            tracing.compile_ledger("symbol_train_step").record(
                {"shape": tuple(sorted((n, s) for n, s, _ in sig)),
                 "dtype": tuple(sorted((n, d) for n, _, d in sig)),
                 "train_flag": True},
                time.monotonic() - t0, cost=cost)
        if self._perf_clock is not None:
            self._perf_clock.tick()
        return outs

    def _shapes(self, vals):
        shapes = {n: tuple(v.shape)
                  for n, v in zip(self._input_names, vals)}
        shapes.update({n: tuple(v.shape) for n, v in self.params.items()})
        shapes.update({n: tuple(v.shape) for n, v in self.aux.items()})
        return shapes

    def _preflight(self, vals):
        """Plan the graph's step before its first run.  This step fixes
        remat and grad_accum at construction, so the ladder has no
        rungs here: the plan fits (within MXTPU_MEM_GATE_MARGIN), warns
        or raises ``MemoryPlanError`` per MXTPU_MEM_POLICY.  A planner
        failure on an exotic graph is logged, not raised."""
        from ..perf import memory_planner as mp
        from ..resilience import MemoryPlanError
        try:
            dtypes = {n: str(v.dtype).replace("torch.", "")
                      for n, v in zip(self._input_names, vals)}
            live = mp.symbol_liveness(
                self._symbol, self._shapes(vals), dtypes=dtypes,
                input_names=list(self._input_names))
            res = mp.preflight(
                lambda r, a: mp.plan_memory(
                    liveness=live,
                    params_bytes=mp.tree_bytes(self.params)
                    + mp.tree_bytes(self.aux),
                    max_param_bytes=mp.tree_bytes(self.params),
                    optimizer_bytes=mp.tree_bytes(self.opt_state),
                    grad_accum=a, remat=r, donate=True),
                site="symbol_train_step", device=self.device)
        except MemoryPlanError:
            raise
        except Exception:
            mp.plan_failed("symbol_train_step")
            return
        if res is not None:
            self._mem_plan = res.plan

    def _arm_perf(self, vals):
        """Cost the graph at the first batch's shapes (a ``meta`` walk,
        at the first step only) and arm the train_mfu/train_mbu clock.
        Returns the compile ledger's cost summary, or None when costing
        fails."""
        try:
            from ..perf import TrainPerfClock, symbol_cost
            # a train step ~= 3x the forward graph (fwd + bwd)
            self.cost_report = symbol_cost(
                self._symbol, self._shapes(vals)).scaled(3.0)
            dtype = str(next(iter(self.params.values())).dtype) \
                if self.params else "float32"
            self._perf_clock = TrainPerfClock(
                self.cost_report.flops, self.cost_report.bytes,
                device=self.device, dtype=dtype)
            return self.cost_report.summary()
        except Exception:
            self.cost_report = None
            self._perf_clock = None
            return None

    def arm_perf(self, flops_per_step=0.0, bytes_per_step=0.0,
                 tokens_per_step=0.0, dtype=None):
        """Arm (or re-arm) the MFU clock with a per-step cost, in place
        of the graph's own (the first step arms that)."""
        from ..perf import TrainPerfClock
        if self._perf_clock is None:
            self._perf_clock = TrainPerfClock(
                flops_per_step, bytes_per_step, tokens_per_step,
                device=self.device, dtype=dtype or "float32")
        else:
            self._perf_clock.arm(flops_per_step, bytes_per_step,
                                 tokens_per_step)
        return self._perf_clock

    @torch.no_grad()
    def evaluate(self, inputs, rng=None):
        """The inference forward on ``inputs`` (score / predict)."""
        from ..executor import _next_seed
        vals = {n: _tensor(v, self.device) for n, v in inputs.items()}
        vals.update(self.params)
        seed = _next_seed() if rng is None else int(rng)
        outs, _ = self._run(vals, self.aux, seed, False)
        return outs

    # ---------------------------------------------------------- values
    @property
    def input_names(self):
        """The per-batch graph inputs (data and label variable names)."""
        return self._input_names

    def owned_values(self):
        """(params, aux) copies, safe to hand to other holders: the
        step's own tensors change in place at every step."""
        return ({n: v.clone() for n, v in self.params.items()},
                {n: v.clone() for n, v in self.aux.items()})

    def set_values(self, param_vals, aux_vals):
        """Copy new values into the step's tensors (in place, so a
        captured graph reads them)."""
        with torch.no_grad():
            for mine, new in ((self.params, param_vals),
                              (self.aux, aux_vals)):
                for n, v in new.items():
                    mine[n].copy_(_tensor(v, self.device))

    # ------------------------------------------------------ checkpoint
    def save_checkpoint(self, path, step=None, data_state=None):
        """Write params, aux states and optimizer state as one sharded
        generation under ``path`` (``parallel/checkpoint.py``), with
        the input iterator's ``data_state`` in the same generation.
        Returns the generation directory."""
        from . import checkpoint as _ckpt
        params, aux = self.owned_values()
        state = foptim.checkpoint_state(self.opt_state)
        return _ckpt.save_sharded(
            path, {"params": params, "aux": aux, "opt_state": state},
            self.mesh, step=step, data_state=data_state,
            extra={"optimizer": foptim.state_structure(state)})

    def load_checkpoint(self, path):
        """Restore the newest valid generation under ``path`` into this
        step's tensors, in place (a captured graph keeps reading them).
        Returns the generation's data-iterator companion state (or
        None)."""
        from . import checkpoint as _ckpt
        tree = {"params": self.params, "aux": dict(self.aux),
                "opt_state": foptim.checkpoint_state(self.opt_state)}
        restored, manifest, gen_dir = _ckpt.load_latest(
            path, tree, self.mesh)
        self.set_values(restored["params"], restored["aux"])
        with torch.no_grad():
            foptim.load_state(self.opt_state, restored["opt_state"])
        return _ckpt.load_data_companion(gen_dir, manifest)
