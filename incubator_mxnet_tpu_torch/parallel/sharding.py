"""Parameter sharding rules: regex -> PartitionSpec (twin of
``incubator_mxnet_tpu/parallel/sharding.py``).

A table of (parameter-name regex -> PartitionSpec) says how each
weight is laid out over the mesh.  The JAX package hands the layout to
XLA, which derives the collectives; the port hands it to DTensor: a
spec is a list of placements over the mesh's ``DeviceMesh`` (a dim
named by axis ``a`` is ``Shard(dim)`` on mesh dim ``a``, every other
mesh dim ``Replicate()``), and DTensor's sharding propagation inserts
the collectives of the forward and backward.  The default rules are
Megatron's tensor parallelism for Dense stacks:

- column-parallel matmul: shard the output-features dim over 'tp';
- row-parallel matmul: shard the input-features dim over 'tp' (the
  partial sums are reduced on the way out);
- embeddings: shard the vocab dim over 'tp';
- everything else (biases, norm scales): replicated.

The slice arithmetic below (``spec_to_json`` ... ``intersect_bounds``)
is the reshardable checkpoint's substrate, bit-equal to the JAX
package's: a pure function of spec, mesh shape, coordinate and global
shape, so it needs no process group.
"""
import re

from .mesh import NamedSharding, PartitionSpec, is_dtensor

__all__ = ["ShardingRules", "tp_rules_for_dense_stacks",
           "apply_rules", "constrain", "spec_to_json",
           "spec_from_json", "bounds_of", "shard_bounds",
           "intersect_bounds"]

P = PartitionSpec


class ShardingRules:
    """Ordered (regex, PartitionSpec) table with a replicated default."""

    def __init__(self, rules=None, default=P()):
        self.rules = [(re.compile(pat), spec)
                      for pat, spec in (rules or [])]
        self.default = default

    def spec_for(self, name, ndim=None):
        """Spec for ``name``; with ``ndim``, a spec longer than the
        array's rank falls back to replicated."""
        for pat, spec in self.rules:
            if pat.search(name):
                if ndim is not None and len(spec) > ndim:
                    return self.default
                return spec
        return self.default

    def shardings(self, mesh, params):
        """Dict of NamedShardings matching a ``{name: tensor}`` dict."""
        return {n: NamedSharding(mesh, self.spec_for(n, v.ndim))
                for n, v in params.items()}

    def restrict_to_axes(self, axis_names):
        """Copy with the rules that name axes absent from
        ``axis_names`` dropped (their parameters fall back to
        replicated)."""
        axes = set(axis_names)

        def ok(spec):
            for el in spec:
                if el is None:
                    continue
                els = el if isinstance(el, tuple) else (el,)
                if any(a not in axes for a in els):
                    return False
            return True

        return ShardingRules(
            [(pat.pattern, spec) for pat, spec in self.rules
             if ok(spec)], self.default)


def tp_rules_for_dense_stacks():
    """Default Megatron-ish rules for blocks built from Dense layers
    named ``*_up_*``/``*_down_*`` (or ``*col*``/``*row*``): up/col
    projections column-parallel, down/row projections row-parallel.
    Dense weights are (out_features, in_features).  The expert rules
    shard a stacked expert dim over 'ep' (a mesh with ep > 1 waits for
    the expert-parallel step)."""
    return ShardingRules([
        (r"expert_(up|down)_weight$", P("ep", None, None)),
        (r"expert_(up|down)_bias$", P("ep", None)),
        (r"(_up_|col|qkv|gate)\w*weight$", P("tp", None)),
        (r"(_down_|row|proj_o|out_proj)\w*weight$", P(None, "tp")),
        (r"(_up_|col|qkv|gate)\w*bias$", P("tp")),
        (r"embedding\w*weight$", P("tp", None)),
    ])


def apply_rules(mesh, params, rules):
    """Lay each parameter out by its rule: a DTensor of this rank's
    slice where the spec shards over a mesh axis of size > 1, the
    tensor itself otherwise (``NamedSharding.place``)."""
    shardings = rules.shardings(mesh, params)
    return {n: shardings[n].place(v) for n, v in params.items()}


def constrain(x, mesh, *spec):
    """Activation annotation: ``x`` (a DTensor) redistributed to
    ``spec``'s placements; a plain tensor on a mesh with nothing to
    shard passes through."""
    sh = NamedSharding(mesh, P(*spec))
    if not is_dtensor(x):
        if sh.is_replicated_everywhere():
            return x
        return sh.place(x)
    return x.redistribute(x.device_mesh, sh.placements())


# ---------------------------------------------------------------------
# spec-driven slice arithmetic (the reshardable checkpoint's substrate,
# parallel/checkpoint.py): a PartitionSpec over a mesh partitions an
# array into rectangular slices; saving records the slices each rank
# owns, loading intersects a destination slice with the recorded source
# slices, so a restore reads only the shard files that overlap it.
# ---------------------------------------------------------------------


def spec_to_json(spec):
    """PartitionSpec -> JSON-able list (None | axis | [axes...] per
    dim), the manifest's layout record."""
    out = []
    for el in tuple(spec):
        if el is None or isinstance(el, str):
            out.append(el)
        else:
            out.append(list(el))
    return out


def spec_from_json(data):
    """Inverse of :func:`spec_to_json`."""
    return PartitionSpec(*[
        tuple(el) if isinstance(el, list) else el for el in data])


def bounds_of(idx, shape):
    """Normalize an index (tuple of slices with None defaults) to a
    bounds tuple ``((lo, hi), ...)``, one closed-open interval per dim:
    the one definition shared by the checkpoint's save and load
    sides."""
    return tuple((0 if s.start is None else int(s.start),
                  int(dim) if s.stop is None else int(s.stop))
                 for s, dim in zip(idx, shape))


def shard_bounds(sharding, shape):
    """Partition an array of ``shape`` by ``sharding`` into unique
    rectangular slices: dict mapping a bounds tuple to the mesh device
    ids (ranks) holding that slice, ascending; the first is the slice's
    owner, the one rank that writes it."""
    shape = tuple(int(d) for d in shape)
    out = {}
    for dev, idx in sharding.devices_indices_map(shape).items():
        out.setdefault(bounds_of(idx, shape), []).append(dev)
    return {b: sorted(devs) for b, devs in out.items()}


def intersect_bounds(a, b):
    """Intersection of two bounds tuples, or None when disjoint (0-d
    bounds ``()`` intersect to ``()``)."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)
