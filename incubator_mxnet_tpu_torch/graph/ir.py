"""A mutable IR over the Symbol ``_Node`` DAG (twin of
``incubator_mxnet_tpu/graph/ir.py``; role of ``nnvm::Graph``).

A :class:`Graph` is a copy of the node DAG reachable from a Symbol's
heads, owned by the optimization pipeline.  Passes mutate the copy
freely; the user's Symbol is never modified, and ``to_symbol()`` hands
the rewritten heads back as an ordinary Symbol the Executor can bind.

Entries are ``(node, out_index)`` pairs as in ``symbol.symbol``; node
identity is Python object identity.  ``device`` is where constant
folding evaluates (the device the graph will be bound to), so a folded
value has the bits the unfolded graph computes there.
"""
import numpy as np
import torch

from ..symbol.symbol import Symbol, _Node, _topo  # graph-ok: pass pipeline

__all__ = ["Graph", "freeze_params", "entry_key"]


def freeze_params(params):
    """Canonical hashable form of a node's static params: lists become
    tuples, dicts sorted item tuples, and array values (constants baked
    by folding) hash by dtype, shape and bytes.  None when a value
    resists canonicalization (the caller then skips hash-keyed rewrites
    for that node)."""
    def _freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(_freeze(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
        if isinstance(v, np.ndarray):
            return ("__array__", str(v.dtype), v.shape, v.tobytes())
        return v
    try:
        frozen = tuple(sorted((k, _freeze(v)) for k, v in params.items()))
        hash(frozen)
        return frozen
    except (TypeError, ValueError):
        return None


def entry_key(entry):
    """Hashable identity of an (node, out_index) entry."""
    return (id(entry[0]), entry[1])


class Graph:
    """A mutable copy of the DAG under a set of head entries.

    ``nodes`` is the owned-node list: rewrites append replacement nodes
    to it and the dead-node pruning pass sweeps it back to the set
    reachable from ``heads``.  Execution always follows reachability, so
    a stale entry in ``nodes`` is bookkeeping only.
    """

    def __init__(self, heads, nodes=None, device=None):
        self.heads = list(heads)   # [(node, out_idx)]
        self.nodes = list(nodes) if nodes is not None \
            else _topo(self.heads)
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)

    # ------------------------------------------------------------ build
    @classmethod
    def from_symbol(cls, symbol, device=None):
        """Deep-copy the reachable DAG (fresh ``_Node`` objects, shared
        ``OpDef`` references, copied params/attrs dicts)."""
        mapping = {}
        for node in _topo(symbol._heads):
            mapping[id(node)] = _Node(  # graph-ok: pass pipeline
                node.op, node.name,
                inputs=[(mapping[id(n)], i) for n, i in node.inputs],
                params=dict(node.params), attrs=dict(node.attrs))
        heads = [(mapping[id(n)], i) for n, i in symbol._heads]
        return cls(heads, nodes=list(mapping.values()), device=device)

    def to_symbol(self):
        return Symbol(self.heads)

    # ------------------------------------------------------------ query
    def topo(self):
        """Topological order of reachable nodes (variables included)."""
        return _topo(self.heads)

    def n_nodes(self):
        return len(self.topo())

    def consumers(self):
        """Map id(node) -> list of (consumer node or None, slot); None
        marks a head entry, ``slot`` is the input (or head) position."""
        out = {}
        order = self.topo()
        for node in order:
            out.setdefault(id(node), [])
        for node in order:
            for slot, (inp, _) in enumerate(node.inputs):
                out[id(inp)].append((node, slot))
        for pos, (node, _) in enumerate(self.heads):
            out[id(node)].append((None, pos))
        return out

    # ------------------------------------------------------------ rewrite
    def replace_entry(self, old_entry, new_entry):
        """Redirect every use of ``old_entry`` to ``new_entry``."""
        self.apply_replacements({entry_key(old_entry): new_entry})

    def apply_replacements(self, mapping):
        """Apply many entry redirects in one graph walk.  ``mapping`` is
        {entry_key(old): new_entry}; chains are resolved transitively."""
        if not mapping:
            return

        def resolve(entry):
            seen = set()
            k = entry_key(entry)
            while k in mapping:
                if k in seen:
                    raise ValueError(f"cyclic entry replacement at {k}")
                seen.add(k)
                entry = mapping[k]
                k = entry_key(entry)
            return entry

        for node in self.topo():
            node.inputs = [resolve(e) for e in node.inputs]  # graph-ok: pass pipeline
        self.heads = [resolve(e) for e in self.heads]

    def replace_node(self, old, new):
        """Redirect all output entries of ``old`` to the same-index
        entries of ``new``."""
        oid = id(old)
        for node in self.topo():
            node.inputs = [(new, i) if id(n) == oid else (n, i)  # graph-ok: pass pipeline
                           for n, i in node.inputs]
        self.heads = [(new, i) if id(n) == oid else (n, i)
                      for n, i in self.heads]
