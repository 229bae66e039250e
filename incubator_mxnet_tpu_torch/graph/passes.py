"""Graph-optimization passes and the PassManager (twin of
``incubator_mxnet_tpu/graph/passes.py``; role of nnvm's pass registry).

Named passes with declared ordering run over the :class:`~.ir.Graph`
copy of a Symbol DAG between symbol construction and executor bind, so
the executor walks fewer nodes.

Level contract (``MXTPU_GRAPH_OPT``):

- ``0``: pipeline off; ``optimize_symbol`` returns the input Symbol.
- ``1`` (default): the safe structural passes: identity elimination,
  transpose-pair elimination, constant folding, common-subexpression
  elimination, dead-node pruning.  Output-preserving bit for bit.
- ``2``: adds elementwise-chain pre-fusion (``fuse.py``).

Every pass reports a node delta, and publishes it as the JAX package
does (``graph_passes_total``, ``graph_nodes_eliminated_total``); a
pipeline run is the ``graph_optimize`` span.

Constant folding evaluates on the graph's device (``optimize_symbol``'s
``device``, the device the graph is bound to) and keeps each value as a
numpy array, as the JAX package does; ``executor.build_graph_fn`` makes
each one a tensor on the bound device once, when it builds the walk.
"""
import torch

from .. import telemetry
from ..utils.env import get_env
from ..ops.registry import OpDef
from ..symbol.symbol import _Node  # graph-ok: the pass pipeline's own module
from .ir import Graph, entry_key, freeze_params

__all__ = ["GraphPass", "PassManager", "register_pass", "PASSES",
           "default_pass_names", "optimize_symbol", "stamp_rng_indices",
           "CONST_OP", "FOLD_MAX_ELEMENTS"]

# Constant folding bakes values at bind time; cap the baked size so a
# folded subtree never turns into a huge literal.
FOLD_MAX_ELEMENTS = 65536

# Op names whose nodes are constant sources (no tensor inputs, value
# fully determined by static params).
_CONST_SOURCES = ("_zeros", "_ones", "_full", "_arange", "_eye")


def _const_fn(value=None, ctx=None):
    """Replay a folded constant (value baked as a static param)."""
    return torch.as_tensor(value, device=ctx)


# Internal op for folded constants.  Not registered in the global OPS
# table: optimized graphs are bind-internal and never round-trip
# through tojson/load_json.
CONST_OP = OpDef("_graph_const", _const_fn, differentiable=False)


def stamp_rng_indices(graph):
    """Pin each random node's generator index (``__rng_index__``) before
    any rewrite, so a pass that removes other nodes cannot shift it and
    an optimized graph draws what the unoptimized one draws."""
    idx = 0
    for node in graph.topo():
        if node.op is not None and node.op.needs_rng:
            node.attrs["__rng_index__"] = str(idx)  # graph-ok: pass pipeline
            idx += 1


class GraphPass:
    """A named rewrite over a :class:`Graph`.  Subclasses set ``name``
    (unique), optionally ``after`` (passes that must run earlier when
    both are selected), and implement :meth:`run`, returning an
    optional dict of pass-specific stats."""

    name = None
    after = ()

    def run(self, graph):
        raise NotImplementedError


PASSES = {}


def register_pass(cls):
    """Class decorator adding a pass to the registry."""
    if not cls.name:
        raise ValueError("pass needs a name")
    if cls.name in PASSES:
        raise ValueError(f"pass '{cls.name}' registered twice")
    PASSES[cls.name] = cls
    return cls


def _is_pure(op):
    """Ops safe for value-keyed rewrites: deterministic, no mode
    branch, no aux-state writeback."""
    return (op is not None and not op.needs_rng and not op.needs_mode
            and op.num_aux == 0)


# Ops whose output dtype is always float: scalar-identity elimination is
# dtype-safe only downstream of these (``int32 * 1.0`` promotes).
FLOAT_RESULT_OPS = frozenset({
    "tanh", "sigmoid", "exp", "expm1", "log", "log1p", "log2",
    "log10", "sqrt", "rsqrt", "cbrt", "rcbrt", "erf", "erfinv",
    "sin", "cos", "tan", "sinh", "cosh", "arctan", "arcsinh",
    "softmax", "log_softmax", "softrelu", "softsign", "gamma",
    "gammaln", "radians", "degrees", "reciprocal",
    "_div_scalar", "_rdiv_scalar", "mean", "norm", "LayerNorm",
    "InstanceNorm", "BatchNorm", "L2Normalization",
})

# Activation produces float only for the saturating kinds;
# act_type='relu' preserves integer dtypes.
_FLOAT_ACT_TYPES = frozenset({"sigmoid", "tanh", "softrelu",
                              "softsign"})


@register_pass
class EliminateIdentity(GraphPass):
    """Drop exact no-op nodes: ``_copy``/``identity`` always, and the
    scalar identities mul/div by 1 when the input is provably float.
    Add/sub of 0 is never eliminated (it rewrites -0.0 to +0.0)."""

    name = "eliminate_identity"

    _SCALAR_ONE = ("_mul_scalar", "_div_scalar")
    _SCALAR_PROMOTING = ("_mul_scalar", "_div_scalar", "_plus_scalar",
                         "_minus_scalar", "_rminus_scalar",
                         "_rdiv_scalar", "_power_scalar",
                         "_rpower_scalar")

    @classmethod
    def _produces_float(cls, node):
        if node.op is None:
            return False
        if node.op.name in FLOAT_RESULT_OPS:
            return True
        if node.op.name == "Activation":
            return node.params.get("act_type") in _FLOAT_ACT_TYPES
        return (node.op.name in cls._SCALAR_PROMOTING
                and isinstance(node.params.get("scalar", 1.0), float))

    def run(self, graph):
        mapping = {}

        def resolve(entry):
            while entry_key(entry) in mapping:
                entry = mapping[entry_key(entry)]
            return entry

        for node in graph.topo():
            if node.op is None or len(node.inputs) != 1:
                continue
            opname = node.op.name
            if opname == "_copy":
                mapping[(id(node), 0)] = resolve(node.inputs[0])
            elif opname in self._SCALAR_ONE:
                scalar = node.params.get("scalar", 1.0)
                inode, _ = resolve(node.inputs[0])
                if isinstance(scalar, (int, float)) \
                        and not isinstance(scalar, bool) \
                        and float(scalar) == 1.0 \
                        and self._produces_float(inode):
                    mapping[(id(node), 0)] = resolve(node.inputs[0])
        graph.apply_replacements(mapping)
        return {"removed": len(mapping)}


@register_pass
class EliminateTransposePairs(GraphPass):
    """Compose back-to-back ``transpose`` nodes; a pair whose
    permutations cancel is removed entirely."""

    name = "eliminate_transpose_pairs"
    after = ("eliminate_identity",)

    @staticmethod
    def _axes(node):
        axes = node.params.get("axes", ())
        axes = tuple(int(a) for a in axes) if axes else ()
        return axes or None      # empty = reverse; rank unknown here

    def run(self, graph):
        cancelled = merged = 0
        changed = True
        while changed:
            changed = False
            for node in graph.topo():
                if node.op is None or node.op.name != "transpose":
                    continue
                inner, iidx = node.inputs[0]
                if iidx != 0 or inner.op is None \
                        or inner.op.name != "transpose":
                    continue
                outer_ax, inner_ax = self._axes(node), self._axes(inner)
                if outer_ax is None or inner_ax is None \
                        or len(outer_ax) != len(inner_ax):
                    continue
                composed = tuple(inner_ax[a] for a in outer_ax)
                if composed == tuple(range(len(composed))):
                    graph.replace_entry((node, 0), inner.inputs[0])
                    cancelled += 1
                else:
                    node.inputs[0] = inner.inputs[0]  # graph-ok: pass pipeline
                    node.params["axes"] = composed  # graph-ok: pass pipeline
                    merged += 1
                changed = True
        return {"cancelled_pairs": cancelled, "merged": merged}


def _numpy(t):
    """A folded value as numpy (None for a dtype numpy lacks)."""
    try:
        return t.detach().cpu().numpy()
    except TypeError:
        return None


@register_pass
class FoldConstants(GraphPass):
    """Evaluate subtrees rooted only in constant sources
    (``_zeros``/``_ones``/``_full``/``_arange``/``_eye``) at bind time,
    on the graph's device, and bake the result as one ``_graph_const``
    node."""

    name = "fold_constants"
    after = ("eliminate_identity", "eliminate_transpose_pairs")

    def run(self, graph):
        dev = graph.device
        values = {}       # id(node) -> np.ndarray
        mapping = {}      # batched entry rewrites (one final sweep)
        folded = 0

        def call(op, ins, params):
            params = dict(params)
            if "ctx" in op.param_defaults:
                params["ctx"] = dev
            with torch.no_grad():
                return op.fn(*ins, **params)

        for node in graph.topo():
            op = node.op
            if op is None:
                continue
            if op is CONST_OP:
                values[id(node)] = node.params["value"]
                continue
            if op.name in _CONST_SOURCES:
                try:
                    v = _numpy(call(op, [], node.params))
                except Exception:       # dynamic param: leave as-is
                    continue
                if v is not None:
                    values[id(node)] = v
                continue
            if not _is_pure(op) or not node.inputs:
                continue
            if op.n_outputs(node.params) != 1:
                continue
            in_vals = [values.get(id(n)) for n, i in node.inputs]
            if any(v is None for v in in_vals) \
                    or any(i != 0 for _, i in node.inputs):
                continue
            try:
                out = call(op, [torch.as_tensor(v, device=dev)
                                for v in in_vals], node.params)
                if not isinstance(out, torch.Tensor):
                    continue
                out = _numpy(out)
            except Exception:
                continue
            if out is None or out.size > FOLD_MAX_ELEMENTS:
                continue
            const = _Node(CONST_OP, node.name + "_const",  # graph-ok: pass pipeline
                          params={"value": out})
            graph.nodes.append(const)
            mapping[(id(node), 0)] = (const, 0)
            values[id(node)] = out     # downstream folds see through
            folded += 1
        graph.apply_replacements(mapping)
        return {"folded": folded}


@register_pass
class EliminateCommonSubexpressions(GraphPass):
    """Merge structurally identical pure nodes (same op, same frozen
    params, same input entries) into one.  Variables are never merged;
    random, mode and aux ops are excluded (two dropout nodes draw
    different masks by design)."""

    name = "eliminate_common_subexpressions"
    after = ("fold_constants",)

    def run(self, graph):
        seen = {}
        mapping = {}
        merged = 0

        def resolve(entry):
            while entry_key(entry) in mapping:
                entry = mapping[entry_key(entry)]
            return entry

        for node in graph.topo():
            if node.op is None or not _is_pure(node.op):
                continue
            frozen = freeze_params(node.params)
            if frozen is None:
                continue
            key = (node.op.name, frozen,
                   tuple(entry_key(resolve(e)) for e in node.inputs))
            rep = seen.get(key)
            if rep is None:
                seen[key] = node
            elif rep is not node:
                for i in range(node.op.n_outputs(node.params)):
                    mapping[(id(node), i)] = (rep, i)
                merged += 1
        graph.apply_replacements(mapping)
        return {"merged": merged}


@register_pass
class PruneDeadNodes(GraphPass):
    """Sweep nodes no longer reachable from any head.  Reachable nodes,
    every head in particular, are never dropped."""

    name = "prune_dead_nodes"
    after = ("eliminate_identity", "eliminate_transpose_pairs",
             "fold_constants", "eliminate_common_subexpressions",
             "fuse_elemwise")

    def run(self, graph):
        live = {id(n) for n in graph.topo()}
        before = len(graph.nodes)
        graph.nodes = [n for n in graph.nodes if id(n) in live]
        return {"swept": before - len(graph.nodes)}


def default_pass_names(level):
    names = ["eliminate_identity", "eliminate_transpose_pairs",
             "fold_constants", "eliminate_common_subexpressions"]
    if level >= 2:
        names.append("fuse_elemwise")
    names.append("prune_dead_nodes")
    return names


class PassManager:
    """Runs a set of named passes in dependency order with per-pass
    node-delta stats (``nnvm::ApplyPasses``)."""

    def __init__(self, pass_names):
        from . import fuse                      # registers fuse pass
        del fuse
        unknown = [n for n in pass_names if n not in PASSES]
        if unknown:
            raise KeyError(f"unknown graph passes {unknown}; "
                           f"registered: {sorted(PASSES)}")
        self._passes = [PASSES[n]() for n in
                        self._order(list(pass_names))]

    @staticmethod
    def _order(names):
        """Stable topological order honoring each pass's ``after``."""
        selected = set(names)
        placed, out = set(), []
        remaining = list(names)
        while remaining:
            progressed = False
            for n in list(remaining):
                deps = [d for d in PASSES[n].after
                        if d in selected and d != n]
                if all(d in placed for d in deps):
                    out.append(n)
                    placed.add(n)
                    remaining.remove(n)
                    progressed = True
            if not progressed:
                raise ValueError(
                    f"graph pass dependency cycle among {remaining}")
        return out

    @property
    def pass_names(self):
        return [p.name for p in self._passes]

    def run(self, graph):
        """Apply all passes; returns the pipeline report."""
        report = {"nodes_before": graph.n_nodes(), "passes": []}
        for p in self._passes:
            before = graph.n_nodes()
            extra = p.run(graph) or {}
            after = graph.n_nodes()
            telemetry.counter("graph_passes_total").inc()
            if before > after:
                telemetry.counter(
                    "graph_nodes_eliminated_total").inc(before - after)
            entry = {"pass": p.name, "nodes_before": before,
                     "nodes_after": after}
            entry.update(extra)
            report["passes"].append(entry)
        report["nodes_after"] = graph.n_nodes()
        return report


def optimize_symbol(symbol, level=None, pass_names=None, *, device=None):
    """Run the pipeline over a Symbol; returns ``(symbol, report)``.

    ``level`` defaults to ``MXTPU_GRAPH_OPT`` (0 = off, 1 = safe
    passes, 2 = + elementwise pre-fusion).  ``device`` is where constant
    folding evaluates (default: the CPU); pass the device the graph will
    be bound to.  The input Symbol is never mutated; at level 0 it is
    returned as it is.  The returned Symbol is bind-internal: it may hold
    ``_graph_const`` and fused nodes that do not round-trip through
    ``tojson``.
    """
    if level is None:
        level = get_env("MXTPU_GRAPH_OPT")
    level = int(level)
    if level <= 0:
        return symbol, {"level": 0, "nodes_before": None,
                        "nodes_after": None, "passes": []}
    with telemetry.span("graph_optimize"):
        graph = Graph.from_symbol(symbol, device=device)
        stamp_rng_indices(graph)
        pm = PassManager(pass_names or default_pass_names(level))
        report = pm.run(graph)
        report["level"] = level
        return graph.to_symbol(), report
