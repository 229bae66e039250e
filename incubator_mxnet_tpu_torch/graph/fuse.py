"""Elementwise-chain pre-fusion, ``MXTPU_GRAPH_OPT=2`` (twin of
``incubator_mxnet_tpu/graph/fuse.py``).

Maximal single-consumer chains of pure elementwise ops collapse into
one :class:`FusedOp` node whose ``fn`` runs the member ops in order.
It launches the same torch ops in the same order as the unfused chain,
so its output equals the chain's bit for bit; the executor walks one
node instead of N.  In the JAX package XLA fuses the chain into one
region; no hand kernel stands behind it there or here.

Only stateless ops fuse: anything with random draws, train/eval mode
branches, aux-state writeback or several outputs breaks a chain.
"""
from ..ops import elemwise as _ew
from ..symbol.symbol import _Node  # graph-ok: the pass pipeline's own module
from .ir import entry_key
from .passes import GraphPass, register_pass

__all__ = ["FusedOp", "ELEMWISE_OPS", "FuseElemwise"]


def _elemwise_names():
    """Canonical op names with purely elementwise compute, derived from
    the op tables of ``ops.elemwise`` so the set cannot drift from the
    registry."""
    names = set(_ew._UNARY)
    names |= {"broadcast_" + n for n in _ew._BINARY}
    names |= {"broadcast_" + n for n in _ew._CMP}
    names |= {"_" + n for n in _ew._CMP}
    names |= set(_ew._SCALAR)
    names |= {"broadcast_logical_and", "broadcast_logical_or",
              "broadcast_logical_xor"}
    names |= {"gamma", "softrelu", "smooth_l1", "logical_not",
              "add_n", "elemwise_addto", "_copy", "BlockGrad",
              "clip", "Activation", "where", "zeros_like",
              "ones_like", "Cast", "amp_cast"}
    return frozenset(names)


ELEMWISE_OPS = _elemwise_names()


class FusedOp:
    """A synthesized op replaying an elementwise chain.  It has the
    ``OpDef`` surface the executor reads (``fn``, ``n_outputs``, the
    mode/rng/aux flags) and is not registered in the global OPS table:
    fused graphs are bind-internal and never serialize."""

    variadic = True
    needs_mode = False
    needs_rng = False
    num_aux = 0
    aux_names = ()
    arg_names = ()
    differentiable = True
    param_defaults = {}

    def __init__(self, steps, name):
        # steps: [(OpDef, params, [("x", ext_idx) | ("c", chain_idx)])]
        self.steps = steps
        self.name = name
        self.doc = "fused elementwise chain: " + " -> ".join(
            op.name for op, _, _ in steps)
        self.fn = self._make_fn()

    def _make_fn(self):
        steps = self.steps

        def fused(*inputs):
            env = []
            for op, params, spec in steps:
                vals = [inputs[i] if tag == "x" else env[i]
                        for tag, i in spec]
                env.append(op.fn(*vals, **params))
            return env[-1]
        fused.__name__ = self.name
        return fused

    def n_outputs(self, params):
        return 1

    def __repr__(self):
        return f"FusedOp({self.name}, {len(self.steps)} ops)"


def _fusible(node):
    op = node.op
    return (op is not None and op.name in ELEMWISE_OPS
            and not op.needs_rng and not op.needs_mode
            and op.num_aux == 0 and op.n_outputs(node.params) == 1)


@register_pass
class FuseElemwise(GraphPass):
    """Collapse single-consumer chains (length >= 2) of elementwise ops
    into one FusedOp node."""

    name = "fuse_elemwise"
    after = ("eliminate_identity", "eliminate_transpose_pairs",
             "fold_constants", "eliminate_common_subexpressions")

    def run(self, graph):
        consumers = graph.consumers()
        in_chain = set()
        chains = []
        for node in graph.topo():
            if id(node) in in_chain or not _fusible(node):
                continue
            chain = [node]
            cur = node
            while True:
                cons = consumers.get(id(cur), [])
                if len(cons) != 1:
                    break
                nxt, _slot = cons[0]
                if nxt is None or id(nxt) in in_chain \
                        or not _fusible(nxt):
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) >= 2:
                chains.append(chain)
                in_chain.update(id(n) for n in chain)
        fused_nodes = 0
        for chain in chains:
            self._fuse(graph, chain)
            fused_nodes += len(chain)
        return {"chains": len(chains), "ops_fused": fused_nodes}

    @staticmethod
    def _fuse(graph, chain):
        chain_pos = {id(n): k for k, n in enumerate(chain)}
        external, ext_index = [], {}
        steps = []
        for n in chain:
            spec = []
            for inode, iidx in n.inputs:
                pos = chain_pos.get(id(inode))
                if pos is not None and iidx == 0:
                    spec.append(("c", pos))
                else:
                    k = entry_key((inode, iidx))
                    if k not in ext_index:
                        ext_index[k] = len(external)
                        external.append((inode, iidx))
                    spec.append(("x", ext_index[k]))
            steps.append((n.op, dict(n.params), spec))
        tail = chain[-1]
        op = FusedOp(steps, f"{tail.name}_fused{len(chain)}")
        fused = _Node(op, op.name, inputs=external,  # graph-ok: pass pipeline
                      attrs=dict(tail.attrs))
        graph.nodes.append(fused)
        graph.replace_node(tail, fused)
