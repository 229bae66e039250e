"""Analytic device-memory planner: predict a train or inference
step's peak live device memory BEFORE the step runs or is captured
(twin of ``incubator_mxnet_tpu/perf/memory_planner.py``).

The answer comes analytically from the Symbol graph — the topo walk the
cost model does, each op run on ``meta`` tensors (``perf/cost_model.
py``) — or, for a step with no Symbol graph (``ShardedTrainStep``),
from the aten ops its forward dispatches on ``meta`` tensors
(:func:`dispatch_liveness`, in place of the JAX package's
``jaxpr_liveness``).
The preflight gate in ``ShardedTrainStep`` / ``SymbolTrainStep`` /
``Module`` consults capacity (``perf/device_db.py``) and walks the
degrade ladder (enable remat -> raise grad_accum -> typed
``MemoryPlanError``) before the step is built.

The model, per device:

- **params**: parameter + aux-state bytes.
- **grads**: the gradients live at once: the working gradient under
  donation (the JAX step), the whole tree otherwise; under
  ``grad_accum`` > 1 an accumulator tree besides.  The port's steps
  take ``torch.autograd.grad`` of the whole tree at once, so they pass
  the tree's bytes as the working gradient.
- **optimizer**: the real optimizer-state tree's bytes (callers pass
  ``tree_bytes(opt_state)``; metadata only, no device reads).
- **activations**: the liveness term.  Without remat every non-shape
  op output is retained for the backward (sum of those intervals);
  with remat only the recompute window's forward peak is live.
  Batch-carried, so divided by ``grad_accum`` (micro-batching).
- **inputs / outputs**: the batch; donation credits the output tree.

``_ELEMENTWISE_RETAIN`` (0.5), the share of elementwise outputs counted
as kept, is the JAX package's, calibrated against XLA's fusion, which
eager torch does not do; it stays (so plans compare with the JAX
package's like for like): on the card the transformer step's eager plan
came within 20% of its measured peak with it.  The cross-check on the card is
:func:`cuda_live_bytes`: ``torch.cuda.max_memory_allocated`` over one
step, less what was live before it, in place of the JAX package's
``xla_live_bytes`` (a compiled executable's buffer assignment).
"""
import collections
import logging

import numpy as np

from ..utils.env import get_env
from .device_db import hbm_capacity

__all__ = ["MemoryPlan", "PreflightResult", "plan_memory",
           "symbol_liveness", "dispatch_liveness", "tree_bytes",
           "sharded_tree_bytes", "max_leaf_bytes", "cuda_live_bytes",
           "next_divisor", "preflight", "PLAN_FAILURES",
           "plan_failed", "eager_update_bytes"]

_CATEGORIES = ("params", "grads", "optimizer", "activations",
               "inputs", "outputs", "kv_pool")

# site -> preflights that could not plan (the gate is a guard, not a
# dependency: such a step runs unplanned, says so in a warning, and is
# counted here, where a run can hold it to zero)
PLAN_FAILURES = collections.Counter()


def plan_failed(site):
    """Record that the preflight at ``site`` could not plan (called from
    the caller's ``except``: the warning carries the traceback)."""
    PLAN_FAILURES[site] += 1
    logging.getLogger("mxtpu.memory").warning(
        "memory preflight at %s skipped: planning failed", site,
        exc_info=True)

# Fraction of elementwise-family op outputs counted as retained
# buffers: the JAX package's value, calibrated on XLA's fusion of
# elementwise chains into their consumers (see the module docstring).
_ELEMENTWISE_RETAIN = 0.5


def _prod(shape):
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None and hasattr(tree, "shape"):
        yield tree


def _leaf_bytes(leaf):
    dtype = getattr(leaf, "dtype", None)
    itemsize = getattr(dtype, "itemsize", None)
    if itemsize is None:
        itemsize = np.dtype(dtype).itemsize if dtype is not None else 4
    return _prod(getattr(leaf, "shape", ())) * int(itemsize)


def tree_bytes(tree):
    """Summed bytes of a nest of dicts/lists of tensors or arrays —
    metadata only (shape x itemsize), never a device read."""
    return float(sum(_leaf_bytes(leaf) for leaf in _leaves(tree)))


def _leaf_slice_bytes(leaf, sharding):
    """Largest per-device slice of one leaf under ``sharding`` (a
    ``parallel.NamedSharding``; the full size where there is none or
    a dim does not split evenly).  A DTensor leaf without a sharding
    counts its local slice."""
    from ..parallel.sharding import shard_bounds
    shape = tuple(getattr(leaf, "shape", ()))
    if sharding is None:
        local = getattr(leaf, "_local_tensor", None)
        if local is not None:
            return _leaf_bytes(local)
        return _leaf_bytes(leaf)
    if not shape:
        return _leaf_bytes(leaf)
    try:
        slice_elems = max(
            _prod([hi - lo for lo, hi in bounds])
            for bounds in shard_bounds(sharding, shape))
    except ValueError:          # a dim that does not split evenly
        slice_elems = _prod(shape)
    return slice_elems * (_leaf_bytes(leaf) // max(1, _prod(shape)))


def _iter_sharded_leaves(tree, shardings):
    if shardings is not None and hasattr(shardings, "get") \
            and hasattr(tree, "items"):
        for name, leaf in tree.items():
            yield leaf, shardings.get(name)
        return
    for leaf in _leaves(tree):
        yield leaf, None


def sharded_tree_bytes(tree, shardings=None):
    """Per-device bytes of a tree: each leaf contributes its largest
    per-device slice, so ZeRO/tp sharding shrinks the plan as it
    shrinks the card.  Pass a name -> NamedSharding dict for a dict
    tree, or nothing to count each leaf as it lies (a DTensor by its
    local slice)."""
    return float(sum(_leaf_slice_bytes(leaf, sh)
                     for leaf, sh in _iter_sharded_leaves(
                         tree, shardings)))


def max_leaf_bytes(tree, shardings=None):
    """Largest single per-device leaf slice in a tree — the planner's
    "working gradient" bound under donation."""
    return float(max(
        (_leaf_slice_bytes(leaf, sh)
         for leaf, sh in _iter_sharded_leaves(tree, shardings)),
        default=0.0))


def _sweep(t_bytes, t_prod, last_use):
    """Peak of the summed live bytes: +bytes at the producer, -bytes
    after the last use."""
    deltas = {}
    for key, b in t_bytes.items():
        deltas[t_prod[key]] = deltas.get(t_prod[key], 0.0) + b
        release = last_use[key] + 1
        deltas[release] = deltas.get(release, 0.0) - b
    live = peak = 0.0
    for p in sorted(deltas):
        live += deltas[p]
        peak = max(peak, live)
    return peak


# ------------------------------------------------------------- liveness
def symbol_liveness(symbol, shapes, dtypes=None, input_names=None):
    """Tensor-interval liveness over a Symbol graph.

    Walks the graph in the cost model's topo order, inferring every
    tensor's shape and dtype on ``meta`` tensors, and returns the raw
    byte terms the planner composes:

    - ``params_bytes`` / ``inputs_bytes``: variable tensors split by
      ``input_names`` (aux states count as params),
    - ``retained_bytes``: outputs of non-shape ops — the set the
      backward pass keeps live when remat is off (elementwise-family
      outputs count at ``_ELEMENTWISE_RETAIN``),
    - ``forward_peak_bytes``: max over topo positions of the summed
      bytes of live intermediates (producer -> last consumer) — the
      recompute window remat pays instead,
    - ``outputs_bytes``: the head tensors.
    """
    from ..base import torch_dtype
    from ..symbol.symbol import _meta_run, _topo
    from .cost_model import ZERO_COST, _FAMILY

    shapes = dict(shapes or {})
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    known = {k: v for k, v in shapes.items()
             if k in set(arg_names) | set(aux_names)}
    arg_shapes, _, aux_shapes = symbol.infer_shape_partial(**known)
    for nm, s in list(zip(arg_names, arg_shapes)) \
            + list(zip(aux_names, aux_shapes)):
        if s is not None and nm not in shapes:
            shapes[nm] = tuple(s)
    if input_names is None:
        # default: the variables the caller gave shapes for are the
        # data inputs; everything recovered by inference is a param
        input_names = set(known) - set(aux_names)
    input_names = set(input_names)

    order = _topo(symbol._heads)
    pos = {id(n): i for i, n in enumerate(order)}
    avals = {}              # (id(node), idx) -> (shape, torch dtype)
    t_bytes = {}            # intermediate tensors: key -> bytes
    t_prod = {}             # key -> producer position
    last_use = {}           # key -> last consumer position
    retained = 0.0
    params_bytes = inputs_bytes = max_param = 0.0

    for node in order:
        if node.is_variable:
            if node.name not in shapes:
                continue
            dt = torch_dtype((dtypes or {}).get(
                node.name, node.attrs.get("__dtype__", "float32")))
            shape = tuple(shapes[node.name])
            avals[(id(node), 0)] = (shape, dt)
            nbytes = _prod(shape) * dt.itemsize
            if node.name in input_names:
                inputs_bytes += nbytes
            else:
                params_bytes += nbytes
                max_param = max(max_param, nbytes)
            continue
        in_keys = [(id(n), i) for n, i in node.inputs]
        if any(k not in avals for k in in_keys):
            raise ValueError(
                f"memory_planner: unknown input shape at op "
                f"'{node.op.name}' (node '{node.name}') — pass "
                "shapes for all data variables")
        for k in in_keys:
            if k in t_bytes:
                last_use[k] = max(last_use.get(k, 0), pos[id(node)])
        outs = _meta_run(node, [avals[k][0] for k in in_keys],
                         [avals[k][1] for k in in_keys])
        shape_only = node.op.name in ZERO_COST
        fused = _FAMILY.get(node.op.name) == "elementwise"
        for i, o in enumerate(outs):
            key = (id(node), i)
            shape, dt = tuple(o.shape), o.dtype
            avals[key] = (shape, dt)
            nbytes = _prod(shape) * dt.itemsize
            t_bytes[key] = nbytes
            t_prod[key] = pos[id(node)]
            last_use[key] = pos[id(node)]
            if not shape_only:
                retained += nbytes * (_ELEMENTWISE_RETAIN if fused
                                      else 1.0)

    outputs_bytes = 0.0
    end = len(order)
    for node, idx in symbol._heads:
        key = (id(node), idx)
        if key in avals:
            shape, dt = avals[key]
            outputs_bytes += _prod(shape) * dt.itemsize
        if key in t_bytes:
            last_use[key] = end

    return {"params_bytes": params_bytes,
            "inputs_bytes": inputs_bytes,
            "outputs_bytes": outputs_bytes,
            "retained_bytes": retained,
            "forward_peak_bytes": _sweep(t_bytes, t_prod, last_use),
            "max_param_bytes": max_param,
            "n_nodes": len(order)}


# aten ops whose outputs are real buffers a kernel writes (the
# counterpart of the JAX walk's heavy primitives); every other op that
# is not a view counts at _ELEMENTWISE_RETAIN.  empty / empty_like are
# what the flash op gives on meta (its output and lse).
_HEAVY_OPS = frozenset((
    "mm", "addmm", "bmm", "baddbmm", "matmul", "convolution",
    "_convolution", "cudnn_convolution", "gather", "scatter",
    "scatter_add", "index", "index_select", "index_put", "embedding",
    "slice_scatter", "sort", "topk", "empty", "empty_like",
    "new_empty"))


def _op_name(func):
    return func.overloadpacket.__name__


def _is_view(func):
    return any(r.alias_info is not None for r in func._schema.returns)


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _liveness_mode():
    """A dispatch mode recording each aten op of a call: its output
    tensors' bytes and position, and each tensor's last reader."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Liveness(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.pos = 0
            self.owner = {}      # id(tensor) -> record (views: the base's)
            self.keep = []       # every tensor seen: its id stays its own
            self.records = []    # [bytes, producer pos, last use, heavy]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.pos += 1
            ins = _tensors(list(args)) + _tensors(kwargs or {})
            for t in ins:
                rec = self.owner.get(id(t))
                if rec is not None:
                    rec[2] = self.pos
            outs = _tensors(out)
            self.keep += outs
            if _is_view(func):
                src = next((self.owner[id(t)] for t in ins
                            if id(t) in self.owner), None)
                for o in outs:
                    if src is not None:
                        self.owner[id(o)] = src
                return out
            for o in outs:
                rec = [float(_leaf_bytes(o)), self.pos, self.pos,
                       _op_name(func) in _HEAVY_OPS]
                self.records.append(rec)
                self.owner[id(o)] = rec
            return out

    return Liveness()


def dispatch_liveness(fn, *example_args, data_args=None):
    """Interval liveness over the aten ops one call ``fn(*example_args)``
    dispatches on ``meta`` tensors (a ``TorchDispatchMode`` records each
    op's outputs and each tensor's last reader): the counterpart of the
    JAX package's ``jaxpr_liveness`` (a jaxpr walk) for steps with no
    Symbol graph (``ShardedTrainStep``).  Nothing runs on a device.  A
    ``torch.fx`` trace (``make_fx``) of the same call gives the same
    intervals but costs seconds of tracing at bench.py's transformer
    width, where this walk costs the ops' dispatch.

    ``example_args`` are tensors (or dicts/lists of them) on ``meta``;
    ``data_args`` are the indices of the arguments that are the batch
    (counted as ``inputs_bytes``; default all).  View ops (outputs that
    alias their input) hold no bytes of their own and extend their
    base's interval.  Flash attention appears as its outputs alone
    (``ops.flash.meta_shapes_only``), as its kernels keep no (L, L)
    tensor.  Returns the liveness dict of :func:`symbol_liveness`, with
    ``params_bytes``/``max_param_bytes`` 0 (the caller supplies those
    from its real value trees) and ``elementwise_bytes``, the outputs
    counted at ``_ELEMENTWISE_RETAIN``."""
    from ..ops.flash import meta_shapes_only
    mode = _liveness_mode()
    with meta_shapes_only(), mode:
        result = fn(*example_args)
    end = mode.pos + 1
    outputs_bytes = 0.0
    for t in _tensors(result):
        outputs_bytes += _leaf_bytes(t)
        rec = mode.owner.get(id(t))
        if rec is not None:
            rec[2] = end
    retained = elementwise = 0.0
    t_bytes, t_prod, last_use = {}, {}, {}
    for k, (nb, prod, last, heavy) in enumerate(mode.records):
        if not nb:
            continue
        t_bytes[k], t_prod[k], last_use[k] = nb, prod, last
        if heavy:
            retained += nb
        else:
            retained += nb * _ELEMENTWISE_RETAIN
            elementwise += nb
    data = set(range(len(example_args))) if data_args is None \
        else set(data_args)
    inputs_bytes = float(sum(_leaf_bytes(t) for k, a in
                             enumerate(example_args) if k in data
                             for t in _leaves(a)))
    peak = _sweep(t_bytes, t_prod, last_use)
    return {"params_bytes": 0.0,
            "inputs_bytes": inputs_bytes,
            "outputs_bytes": outputs_bytes,
            "retained_bytes": retained,
            "forward_peak_bytes": min(peak, retained),
            "max_param_bytes": 0.0,
            "elementwise_bytes": elementwise,
            "n_nodes": mode.pos}


# ----------------------------------------------------------------- plan
class MemoryPlan:
    """One step's predicted peak live device memory, by category."""

    __slots__ = _CATEGORIES + ("meta",)

    def __init__(self, params=0.0, grads=0.0, optimizer=0.0,
                 activations=0.0, inputs=0.0, outputs=0.0,
                 kv_pool=0.0, meta=None):
        self.params = float(params)
        self.grads = float(grads)
        self.optimizer = float(optimizer)
        self.activations = float(activations)
        self.inputs = float(inputs)
        self.outputs = float(outputs)
        self.kv_pool = float(kv_pool)
        self.meta = dict(meta or {})

    def total(self):
        return (self.params + self.grads + self.optimizer
                + self.activations + self.inputs + self.outputs
                + self.kv_pool)

    def headroom(self, device=None, margin=None):
        """Bytes to spare against the device's usable capacity
        (negative = predicted overflow)."""
        from .device_db import headroom as _headroom
        return _headroom(self.total(), device, margin)

    def as_dict(self):
        d = {c: getattr(self, c) for c in _CATEGORIES}
        d["total"] = self.total()
        d.update(self.meta)
        return d

    def describe(self):
        parts = [f"{c}={getattr(self, c) / (1 << 20):.1f}MB"
                 for c in _CATEGORIES if getattr(self, c) > 0]
        extras = [f"{k}={v}" for k, v in sorted(self.meta.items())]
        return (f"total={self.total() / (1 << 20):.1f}MB ("
                + " ".join(parts + extras) + ")")

    def __repr__(self):
        return f"MemoryPlan({self.describe()})"


def plan_memory(symbol=None, shapes=None, *, train=True, dtypes=None,
                input_names=None, liveness=None, params_bytes=None,
                max_param_bytes=None, optimizer_bytes=0.0,
                grad_accum=1, remat=False, donate=True,
                batch_shards=1, meta=None, update_bytes=0.0):
    """Compose a :class:`MemoryPlan` for one step.

    Either pass a Symbol + shapes (the liveness pass runs here) or a
    precomputed ``liveness`` dict (:func:`symbol_liveness` output —
    lets the degrade ladder re-plan rungs without re-walking the
    graph). ``params_bytes`` overrides the graph's replicated
    parameter sizes with the caller's per-device sharded sizes;
    ``batch_shards`` is the mesh's data-parallel width (activations
    and inputs are batch-carried, so they shrink by it).

    The gradient term follows the JAX step under donation: only the
    *working* gradient (``max_param_bytes``, by default the largest
    leaf) is live at once.  Without donation the full gradient tree
    materializes; under ``grad_accum`` > 1 a full accumulator tree
    persists next to the working gradient either way.  A step that
    takes every gradient at once (the port's) passes the tree's bytes
    as ``max_param_bytes``.

    ``update_bytes`` (the port's, default 0: the JAX plan) adds what an
    unfused in-place update holds besides the trees while it runs, into
    ``outputs``: the per-parameter eager updater's temporaries
    (:func:`eager_update_bytes`).
    """
    live = liveness if liveness is not None else symbol_liveness(
        symbol, shapes, dtypes=dtypes, input_names=input_names)
    accum = max(1, int(grad_accum))
    shards = max(1, int(batch_shards))

    params = float(params_bytes if params_bytes is not None
                   else live["params_bytes"])
    max_param = float(max_param_bytes if max_param_bytes is not None
                      else live.get("max_param_bytes", 0.0))
    if not train:
        grads = 0.0
    elif accum > 1:
        grads = params + max_param
    elif donate:
        grads = max_param
    else:
        grads = params
    if train:
        base = live["forward_peak_bytes"] if remat \
            else live["retained_bytes"]
        # remat can never plan WORSE than no-remat
        base = min(base, live["retained_bytes"])
    else:
        base = live["forward_peak_bytes"]
    activations = base / accum / shards
    inputs = live["inputs_bytes"] / shards
    if train:
        # donated params/opt alias their argument buffers; without
        # donation the updated trees materialize next to the old ones
        outputs = 0.0 if donate else params + float(optimizer_bytes)
        outputs += float(update_bytes)
    else:
        outputs = live["outputs_bytes"] / shards
    info = {"train": bool(train), "remat": bool(remat),
            "grad_accum": accum, "batch_shards": shards,
            "n_nodes": live.get("n_nodes", 0)}
    info.update(meta or {})
    return MemoryPlan(params, grads, float(optimizer_bytes),
                      activations, inputs, outputs, meta=info)


# temporaries of the port's per-parameter update ops (``ops/
# optimizer_op.py``: the rescaled gradient, momentum * mom, lr * g, the
# new weight before the copy into place), in units of the parameter
# updated: on an NVIDIA H100 80GB HBM3 at 700 W the MNIST MLP's update
# peaked 4.0 times its largest parameter above the step's live trees
# (chip_smoke.py phase operability (v))
_EAGER_UPDATE_TEMPS = 4


def eager_update_bytes(max_param_bytes):
    """Bytes the per-parameter eager updater holds beside the trees while
    it updates the largest parameter (``_EAGER_UPDATE_TEMPS`` of it)."""
    return _EAGER_UPDATE_TEMPS * float(max_param_bytes)


def cuda_live_bytes(fn, *args, device=None):
    """Measure one call ``fn(*args)`` on a card: the peak of
    ``torch.cuda.max_memory_allocated`` over the call, less the bytes
    allocated before it — the measured counterpart of a plan's total,
    in place of the JAX package's ``xla_live_bytes``.  Synchronizes
    before and after the call (a measurement, never on a step path).
    Returns ``(peak_bytes, before_bytes)``."""
    import torch
    dev = torch.device("cuda") if device is None else torch.device(device)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    return (float(torch.cuda.max_memory_allocated(dev) - before),
            float(before))


# --------------------------------------------------------------- ladder
class PreflightResult:
    """Outcome of one preflight gate: the accepted plan plus the
    remat/grad_accum the ladder settled on and the rungs it took."""

    __slots__ = ("plan", "remat", "grad_accum", "rungs")

    def __init__(self, plan, remat, grad_accum, rungs):
        self.plan = plan
        self.remat = remat
        self.grad_accum = grad_accum
        self.rungs = list(rungs)


def next_divisor(n, current):
    """Smallest divisor of ``n`` strictly greater than ``current``
    (the ladder's next grad_accum candidate), or None."""
    n, current = int(n), int(current)
    if n <= 0:
        return None
    for d in range(current + 1, n + 1):
        if n % d == 0:
            return d
    return None


def preflight(make_plan, *, site, device=None, can_remat=False,
              batch_size=0, policy=None, remat=False, grad_accum=1,
              max_rungs=8):
    """Run the preflight memory gate for one step about to be built.

    ``make_plan(remat, grad_accum)`` returns the MemoryPlan for that
    configuration. Under ``MXTPU_MEM_POLICY=degrade`` a predicted
    overflow walks the ladder deterministically: enable remat (if
    ``can_remat``), then raise grad_accum to the next divisor of
    ``batch_size``, re-planning after each rung; a ladder that runs
    dry raises ``MemoryPlanError`` carrying the full per-category
    plan. ``warn`` logs the overflow and builds anyway; ``off``
    skips planning entirely (returns None). Each rung taken emits a
    ``mem_degrade`` flight-recorder event and bumps
    ``memory_plan_degrades_total``.

    Runs at bind/preflight time only — never on the step path — so it
    adds no host sync to a step.
    """
    import logging

    if policy is None:
        policy = str(get_env("MXTPU_MEM_POLICY")).lower()
    if policy == "off":
        return None
    from .. import telemetry, tracing

    log = logging.getLogger("mxtpu.memory")
    plan = make_plan(remat, grad_accum)
    rungs = []
    capacity = hbm_capacity(device)
    while plan.headroom(device) < 0:
        if policy != "degrade":
            log.warning(
                "memory plan overflow at %s (policy=warn): %s vs "
                "capacity %.1fMB — building anyway", site,
                plan.describe(), capacity / (1 << 20))
            break
        if can_remat and not remat:
            remat, rung = True, "remat"
        else:
            nxt = next_divisor(batch_size, grad_accum) \
                if batch_size else None
            if nxt is None or len(rungs) >= max_rungs:
                _publish_plan(plan)
                from ..resilience import MemoryPlanError
                raise MemoryPlanError(site, plan, rungs,
                                      capacity=capacity)
            grad_accum, rung = nxt, f"grad_accum={nxt}"
        rungs.append(rung)
        telemetry.counter("memory_plan_degrades_total").inc()
        tracing.trace_event(
            "mem_degrade", site=site, rung=rung,
            predicted_bytes=plan.total(), capacity_bytes=capacity)
        log.warning(
            "memory plan overflow at %s: %s vs capacity %.1fMB — "
            "degrade ladder rung '%s'%s", site, plan.describe(),
            capacity / (1 << 20), rung,
            " (numerics change: smaller micro-batches)"
            if rung.startswith("grad_accum") else
            " (numerics unchanged; more compute)")
        plan = make_plan(remat, grad_accum)
    _publish_plan(plan)
    return PreflightResult(plan, remat, grad_accum, rungs)


def _publish_plan(plan):
    """Record the accepted (or last attempted) plan: the peak gauge,
    and the tracing layer's plan (total and categories), which the
    heartbeat's ``memory_plan_delta_bytes`` measures drift against and
    debugz ``memz`` serves."""
    from .. import telemetry, tracing
    telemetry.gauge("memory_plan_peak_bytes").set(plan.total())
    tracing.set_memory_plan(plan.total(),
                            {c: getattr(plan, c) for c in _CATEGORIES})
