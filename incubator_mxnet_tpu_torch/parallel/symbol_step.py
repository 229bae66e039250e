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

The graph runs as bound: the symbol passes (``optimize_symbol``) are
ROADMAP item A7, and the JAX goldens show they preserve values.  Not
here: ``numeric_guard`` (the step guard, A11) and the sharded
checkpoints (A9) raise.
"""
import torch

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
        if numeric_guard:
            raise NotImplementedError(
                "numeric_guard: the step guard is not ported yet "
                "(ROADMAP item A11)")
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

    def _own(self, v):
        return _tensor(v, self.device).clone()

    # ------------------------------------------------------------ step
    def _step(self, *inputs):
        """The whole step, in place; returns the graph's outputs."""
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
        self.opt.update({n: self.params[n] for n in names}, grads,
                        self.opt_state, scale=self._scale, lr=self._lr,
                        lr_mults=self._lr_mults, wd_mults=self._wd_mults)
        with torch.no_grad():
            for n, v in aux_upd.items():
                self.aux[n].copy_(v)
        return tuple(o.detach() for o in outs)

    def _mutable(self):
        return (list(self.params.values()) + list(self.aux.values())
                + _graph.tensors_of(self.opt_state))

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
        if self.device.type != "cuda":
            return list(self._step(*vals))
        return list(self._graph(vals, self._gens))

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
        raise NotImplementedError(
            "sharded checkpoints (parallel/checkpoint.py) are ROADMAP "
            "item A9; save through Module.save_checkpoint")

    def load_checkpoint(self, path):
        raise NotImplementedError(
            "sharded checkpoints (parallel/checkpoint.py) are ROADMAP "
            "item A9; load through Module.load")
