"""Executor: a bound Symbol graph (twin of
``incubator_mxnet_tpu/executor.py``; ref: src/executor/graph_executor.cc
Forward/Backward, include/mxnet/executor.h).

The JAX package compiles the whole graph into one XLA executable and
replays the forward inside ``jax.vjp`` for the backward.  Here the graph
runs eagerly, op by op, each op's own torch function in topological
order (``build_graph_fn``), and torch's autograd keeps the backward:

- ``forward(is_train=True)`` runs with the arguments that have a
  gradient buffer as leaves that require grad, and keeps the graph;
  ``backward()`` differentiates it with ``torch.autograd.grad``, the
  head gradient of each floating output ones (the Output ops' contract:
  a loss head such as ``SoftmaxOutput`` starts its own gradient) unless
  ``out_grads`` gives it.  The forward is not replayed, so the backward
  sees the forward's dropout masks, and a BatchNorm's moving stats are
  updated once per step on either route (``forward`` + ``backward`` or
  ``forward_backward``), as MXNet's are.  The JAX package's replay
  updates them a second time on the split route: its defect, recorded
  in ROADMAP.
- ``forward(is_train=False)`` runs under ``torch.no_grad()``.
- Ops marked ``needs_rng`` draw from a ``torch.Generator`` made for the
  node and seeded from the forward's seed, which comes from the
  package's default CPU generator (``random.seed``), so a seeded run
  repeats.  The draws are torch's, not JAX's threefry: random ops are
  compared with the JAX package by distribution, never by value.
- ``group2ctx`` places each node whose ``ctx_group`` attribute names a
  group on that group's device: its inputs move there by ``.to()``,
  which autograd carries back in the backward.
- A partial last batch is padded to the bound batch and the outputs
  sliced back, only when every output carries the batch as its leading
  dimension (the JAX package's rule).

Arrays are NDArrays over torch tensors.  Writes rebind an array's tensor
(``NDArray`` semantics), so the graph of a forward never sees a later
update.
"""
import logging

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, torch_dtype
from .context import resolve
from .ndarray.ndarray import NDArray
from .symbol.symbol import _topo

__all__ = ["Executor", "build_graph_fn"]

_LOG = logging.getLogger(__name__)
_PARTIAL_WARNED = False        # once-per-process notice of a padded batch
_SEED_MIX = 0x9E3779B97F4A7C15


def _next_seed():
    """A forward's seed, from the package's default CPU generator."""
    return int(torch.randint(0, 1 << 62, (),
                             generator=_random.default_generator()))


def _node_generator(seed, fold, device):
    """The generator of the ``fold``-th random node of a forward."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + _SEED_MIX * (fold + 1)) % (1 << 63))
    return gen


def build_graph_fn(symbol, placements=None, default_device=None,
                   tap=None):
    """The evaluation function of a Symbol graph:
    ``run(arg_vals, aux_vals, seed, is_train) -> (outputs, aux_updates)``
    on torch tensors, in whatever grad mode the caller set.

    ``placements`` (id(node) -> torch.device) moves each placed node's
    inputs to its device; ``default_device`` is where creation ops
    (``_zeros``, ...) put their result when the node has no placement.
    ``tap(name, outputs)`` is called after every op node with its output
    tensors (the monitor hook)."""
    order = _topo(symbol._heads)
    heads = list(symbol._heads)

    def run(arg_vals, aux_vals, seed, is_train):
        env = {}
        aux_updates = {}
        fold = 0
        for node in order:
            if node.is_variable:
                if node.name in arg_vals:
                    env[(id(node), 0)] = arg_vals[node.name]
                elif node.name in aux_vals:
                    env[(id(node), 0)] = aux_vals[node.name]
                else:
                    raise KeyError(f"unbound variable '{node.name}'")
                continue
            op = node.op
            ins = [env[(id(n), i)] for n, i in node.inputs]
            dev = default_device
            if placements is not None and id(node) in placements:
                dev = placements[id(node)]
                ins = [x.to(dev) for x in ins]
            elif ins:
                dev = ins[0].device
            params = dict(node.params)
            if "ctx" in op.param_defaults:
                params["ctx"] = dev
            if op.needs_mode:
                params["_training"] = is_train
            if op.needs_rng:
                params["_rng"] = _node_generator(seed, fold, dev)
                fold += 1
            outs = op.fn(*ins, **params)
            outs_list = list(outs) if isinstance(outs, (tuple, list)) \
                else [outs]
            if op.num_aux and is_train:
                aux_new = outs_list[-op.num_aux:]
                outs_list = outs_list[:-op.num_aux]
                for (anode, _), val in zip(node.inputs[-op.num_aux:],
                                           aux_new):
                    aux_updates[anode.name] = val
            if tap is not None:
                tap(node.name, outs_list)
            for i, o in enumerate(outs_list):
                env[(id(node), i)] = o
        return [env[(id(n), i)] for n, i in heads], aux_updates

    return run


def _scan_ctx_groups(symbol, group2ctx):
    """Resolve group2ctx against the graph: (placements: id(op node) ->
    device of its ``ctx_group``, var_ctx: variable name -> device)."""
    devices = {}
    for g, c in group2ctx.items():
        try:
            devices[g] = torch.device(c)
        except (TypeError, RuntimeError):
            raise TypeError(f"group2ctx[{g!r}] must be a device, got "
                            f"{type(c).__name__}") from None
    placements, var_ctx = {}, {}
    for node in _topo(symbol._heads):
        grp = node.attrs.get("ctx_group")
        if grp is None or grp not in devices:
            continue
        if node.is_variable:
            var_ctx[node.name] = devices[grp]
        else:
            placements[id(node)] = devices[grp]
    return placements, var_ctx


def _as_tensor(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


class Executor:
    """A bound computation graph (ref: include/mxnet/executor.h)."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, shared_exec=None,
                 group2ctx=None, _ctx_group_scan=None):
        self._symbol = symbol
        self._ctx = resolve(ctx)
        self._arg_names = arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        self.arg_dict = self._normalize(args, arg_names, "args")
        self.aux_dict = self._normalize(aux_states, aux_names,
                                        "aux_states", allow_empty=True)
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in arg_names}
        if args_grad is None:
            args_grad = {}
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self.grad_dict = {
            n: args_grad.get(n) for n in arg_names
            if self._grad_req.get(n, "null") != "null"
            and args_grad.get(n) is not None}

        self._group2ctx = dict(group2ctx) if group2ctx else None
        placements = None
        if group2ctx:
            placements, _ = _ctx_group_scan or \
                _scan_ctx_groups(symbol, group2ctx)
        self._placements = placements
        self._run = build_graph_fn(symbol, placements=placements,
                                   default_device=self._ctx)
        self._monitor_cb = None
        self._run_tapped = None
        self._outputs = None
        self._graph = None             # (outputs, leaves) of a train forward
        self._batch_row_outputs = {}   # batch -> pad/slice is exact

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _normalize(vals, names, what, allow_empty=False):
        if vals is None:
            if allow_empty:
                return {}
            raise ValueError(f"{what} must be provided to bind")
        if isinstance(vals, (list, tuple)):
            if len(vals) != len(names):
                raise ValueError(
                    f"{what}: expected {len(names)} entries ({names}), "
                    f"got {len(vals)}")
            return dict(zip(names, vals))
        return dict(vals)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n]
                for n in self._symbol.list_auxiliary_states()]

    @property
    def outputs(self):
        if self._outputs is None:
            raise RuntimeError("call forward() first")
        return self._outputs

    @property
    def output_shapes(self):
        _, out_shapes, _ = self._symbol.infer_shape(
            **{k: v.shape for k, v in self.arg_dict.items()})
        return out_shapes

    def _set_inputs(self, kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise ValueError(
                    f"unknown argument '{k}'; bound arguments are "
                    f"{sorted(self.arg_dict)}")
            bound = self.arg_dict[k]._data
            self.arg_dict[k]._data = _as_tensor(v).detach().to(
                device=bound.device, dtype=bound.dtype)

    def set_monitor_callback(self, callback, monitor_all=False):
        """Per-op output tap for debugging (ref:
        MXExecutorSetMonitorCallback): while set, ``forward`` calls
        ``callback(op_name, [NDArray, ...])`` after every op node.
        ``None`` removes it."""
        if callback is None:
            self._monitor_cb = None
            self._run_tapped = None
            return

        def tapped(name, outs):
            self._monitor_cb(name, [NDArray(o.detach()) for o in outs])

        self._monitor_cb = callback
        self._run_tapped = build_graph_fn(
            self._symbol, placements=self._placements,
            default_device=self._ctx, tap=tapped)

    # ------------------------------------------------------------- forward
    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays (``kwargs`` rebinds inputs
        first); returns the output NDArrays.

        A PARTIAL LAST BATCH (an input whose leading dimension is below
        the bound batch) is zero-padded up to the bound shape and the
        outputs sliced back, when every output has the batch as its
        leading dimension; a graph that reduces over the batch runs at
        the input's own shape instead."""
        n_partial = self._pad_partial(kwargs)
        self._forward(bool(is_train), kwargs)
        if n_partial is not None:
            batch = self._partial_bound_batch
            self._outputs = [
                NDArray(o._data[:n_partial])
                if o.shape and o.shape[0] == batch else o
                for o in self._outputs]
        return self._outputs

    def _forward(self, is_train, kwargs):
        self._set_inputs(kwargs)
        run = self._run_tapped or self._run
        seed = _next_seed()
        args = {k: v._data for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        self._graph = None
        if is_train:
            leaves = {n: args[n].detach().requires_grad_(True)
                      for n in self._grad_names()}
            args.update(leaves)
            with torch.enable_grad():
                outs, aux_upd = run(args, aux, seed, True)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, aux_upd = run(args, aux, seed, False)
        for name, val in aux_upd.items():
            self.aux_dict[name]._data = val.detach()
        self._outputs = [NDArray(o.detach()) for o in outs]

    _partial_bound_batch = None

    def _outputs_are_batch_rowed(self, batch):
        """True iff every graph output's leading dim is ``batch``: the
        precondition for pad/slice to be exact (a padded row must never
        fold into a real row's value, which a batch-reducing output
        would)."""
        cached = self._batch_row_outputs.get(batch)
        if cached is None:
            try:
                shapes = self.output_shapes
            except ValueError:
                shapes = None
            cached = bool(shapes) and all(
                s and s[0] == batch for s in shapes)
            self._batch_row_outputs[batch] = cached
        return cached

    def _pad_partial(self, kwargs):
        """Pad partial-last-batch inputs to the bound batch size;
        returns the true row count (or None when nothing padded)."""
        n = None
        bound_batch = None
        partial = []
        for k, v in kwargs.items():
            bound = self.arg_dict.get(k)
            if bound is None:
                continue                # _set_inputs raises clearly
            vshape = tuple(v.shape) if hasattr(v, "shape") \
                else np.asarray(v).shape
            bshape = bound.shape
            if vshape == bshape or len(vshape) != len(bshape) \
                    or not bshape:
                continue
            if vshape[1:] == bshape[1:] and vshape[0] < bshape[0]:
                if n is not None and n != vshape[0]:
                    raise ValueError(
                        "partial batch sizes disagree across inputs "
                        f"({n} vs {vshape[0]} for {k!r})")
                n = vshape[0]
                bound_batch = bshape[0]
                partial.append(k)
        if n is None or not self._outputs_are_batch_rowed(bound_batch):
            return None
        for k in partial:
            t = _as_tensor(kwargs[k]).detach()
            pad = torch.zeros(self.arg_dict[k].shape, dtype=t.dtype,
                              device=t.device)
            pad[:n] = t
            kwargs[k] = pad
        self._partial_bound_batch = bound_batch
        global _PARTIAL_WARNED
        if not _PARTIAL_WARNED:
            _LOG.warning("partial batch of %d rows padded to the bound "
                         "batch %d (outputs sliced back; reported once)",
                         n, bound_batch)
            _PARTIAL_WARNED = True
        return n

    # ------------------------------------------------------------- backward
    def _grad_names(self):
        return [n for n in self._arg_names
                if self._grad_req.get(n, "null") != "null"
                and self.grad_dict.get(n) is not None
                and self.arg_dict[n]._data.is_floating_point()]

    def backward(self, out_grads=None):
        """Gradients of the last ``forward(is_train=True)`` into the
        grad arrays by grad_req ("write" replaces, "add" accumulates).
        ``out_grads`` gives the head gradients (one per output; None
        entries keep the ones default)."""
        if self._graph is None:
            raise MXNetError(
                "backward needs a forward(is_train=True) before it (the "
                "graph of a forward is differentiated once)")
        outs, leaves = self._graph
        self._graph = None
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        if out_grads is None:
            out_grads = [None] * len(outs)
        heads, cts = [], []
        for o, g in zip(outs, out_grads):
            if not (o.requires_grad and o.is_floating_point()):
                continue
            heads.append(o)
            cts.append(torch.ones_like(o) if g is None else
                       _as_tensor(g).to(device=o.device, dtype=o.dtype))
        names = list(leaves)
        grads = [None] * len(names)
        if heads and names:
            grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                        cts, allow_unused=True)
        for name, g in zip(names, grads):
            buf = self.grad_dict[name]
            if g is None:
                g = torch.zeros_like(leaves[name])
            g = g.to(buf._data.dtype)
            if self._grad_req.get(name) == "add":
                buf._data = buf._data + g
            else:
                buf._data = g

    def forward_backward(self, out_grads=None, **kwargs):
        """Forward in training mode at the inputs' own shapes, then the
        backward: the training step."""
        self._forward(True, kwargs)
        self.backward(out_grads)
        return self._outputs

    # ------------------------------------------------------------- misc
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for dst, src, what in ((self.arg_dict, arg_params, "argument"),
                               (self.aux_dict, aux_params, "aux state")):
            for k, v in (src or {}).items():
                if k in dst:
                    bound = dst[k]._data
                    dst[k]._data = _as_tensor(v).detach().to(
                        device=bound.device, dtype=bound.dtype, copy=True)
                elif not allow_extra_params:
                    raise ValueError(f"unknown {what} {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """Rebind with new input shapes: new arrays for the inputs, the
        parameters and aux states carried over where their shapes
        stay."""
        shapes = {k: v.shape for k, v in self.arg_dict.items()}
        shapes.update(kwargs)
        type_dict = {k: v._data.dtype for k, v in self.arg_dict.items()}
        type_dict.update({k: v._data.dtype
                          for k, v in self.aux_dict.items()})
        return Executor._simple_bind(
            self._symbol, self._ctx, self._grad_req, type_dict, shapes,
            _copy_from=self, group2ctx=self._group2ctx)

    @classmethod
    def _simple_bind(cls, symbol, ctx, grad_req, type_dict, shape_kwargs,
                     _copy_from=None, group2ctx=None):
        """Allocate every array from the inferred shapes and bind (ref:
        MXExecutorSimpleBind)."""
        device = resolve(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        arg_names = symbol.list_arguments()
        if len(set(arg_names)) != len(arg_names):
            dupes = sorted({n for n in arg_names
                            if arg_names.count(n) > 1})
            raise ValueError(
                f"duplicate argument names {dupes}: distinct variables "
                "share a name (a scoped NameManager can restart counters "
                "mid-graph) — disambiguate with name=/name.Prefix scopes")
        aux_names = symbol.list_auxiliary_states()
        type_dict = type_dict or {}
        var_ctx, scan = {}, None
        if group2ctx:
            scan = _scan_ctx_groups(symbol, group2ctx)
            var_ctx = scan[1]

        def _alloc(n, s):
            return NDArray(torch.zeros(
                s, dtype=torch_dtype(type_dict.get(n, "float32")),
                device=var_ctx.get(n, device)))

        args = {n: _alloc(n, s) for n, s in zip(arg_names, arg_shapes)}
        aux = {n: _alloc(n, s) for n, s in zip(aux_names, aux_shapes)}
        if isinstance(grad_req, str):
            req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            req = dict(zip(arg_names, grad_req))
        else:
            req = dict(grad_req)
        grads = {n: NDArray(torch.zeros_like(args[n]._data))
                 for n in arg_names if req.get(n, "null") != "null"}
        ex = cls(symbol, device, args, grads, req, aux,
                 group2ctx=group2ctx, _ctx_group_scan=scan)
        if _copy_from is not None:
            for mine, theirs in ((ex.arg_dict, _copy_from.arg_dict),
                                 (ex.aux_dict, _copy_from.aux_dict)):
                for k, v in theirs.items():
                    if k in mine and v.shape == mine[k].shape:
                        mine[k]._data = v._data
        return ex
