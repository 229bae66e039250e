"""CachedOp: signature-keyed trace-once replay for Gluon HybridBlocks
(twin of ``incubator_mxnet_tpu/graph/cached_op.py``; ref:
src/imperative/cached_op.cc).

``HybridBlock.hybridize()`` routes ``__call__`` here.  A call's key is
its signature (input shapes, dtypes and devices, canonicalized static
arguments) plus the train flag; entries live in an LRU of
``MXTPU_CACHEDOP_CAPACITY`` (<= 0: no bound).  Each entry runs in one
of two modes, chosen when it is built:

- **graph**: at ``MXTPU_GRAPH_OPT`` >= 1, when the block traces into a
  Symbol (``HybridBlock._trace_symbol``) with no random op, the Symbol
  goes through the pass pipeline (``passes.optimize_symbol``) and
  ``executor.build_graph_fn`` walks the optimized graph; a training
  call writes the BatchNorm moving stats back into the parameters in
  place.  Blocks with random ops take jit mode, so their masks come
  from the eager stream.
- **jit**: the block's eager forward.

How an entry runs depends on where its inputs live:

- On the CPU each call runs the entry's forward as written, and torch's
  autograd records it under ``autograd.record()``; the gradient reaches
  each Parameter's buffer through its tensor's hook, as in an eager
  call.  ``trace_count`` counts entries built (traces).
- On a CUDA device the entry is captured as a ``torch.cuda.CUDAGraph``
  the first time (``parallel._graph``'s mechanism: warm-up on a side
  stream, undone from a snapshot of the moving stats and generators;
  generators registered; outputs cloned out), and every later call
  with that key is one replay.  A call under ``autograd.record()``
  replays a captured forward and backward pair through a
  ``torch.autograd.Function`` (the design of
  ``torch.cuda.make_graphed_callables``): its backward copies the
  output gradients into the pair's buffers, replays the backward and
  hands clones of the gradients to torch, which accumulates them into
  the parameters as an eager backward does.  ``trace_count`` counts
  captures: one per key and route (recorded or not).

A block whose forward reaches a ``Custom`` op (``operator.py``: its
Python runs at every call) cannot be captured: the warm-up before the
capture sees the op (``parallel._graph.refuse_capture``), the entry then
runs eagerly on the card as it would on the CPU, and ``stats()`` says
why (its ``capture_skipped`` key, "Custom"; absent while nothing was
skipped), as a warning does once.

A captured graph reads the parameters by address.  ``set_data``,
``load_params`` and ``initialize(force_reinit=True)`` write in place, so
replays see them; a parameter that gets new storage (``reset_ctx``,
``cast``, a late materialization) drops the captures
(``parameter.storage_epoch``).  A pair keeps its forward's activations
in its own memory pool until its backward replays, so a pair is busy
from its forward's replay until its backward has replayed or the call's
autograd graph is freed.  A recorded call whose key has no free pair
captures another one: a block applied several times under one
``record()`` (an unrolled cell, a siamese pair) holds one pair per use
that waits for its backward, and ``trace_count`` counts each.  A second
backward through one replayed call raises, since the first one's
replay may have reused its activations' memory.

Telemetry is the JAX package's: ``cachedop_cache_hits_total`` and
``cachedop_cache_misses_total`` count lookups, and each miss (the
entry's build and its first call: a trace on the CPU, the capture on
the card) is timed into the compile ledger ``cachedop:<block name>``
with the signature diff against the nearest cached entry.  The counts
also stay on the object (``hits``, ``misses``, ``trace_count``,
``stats()``).
"""
import logging
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd, telemetry, tracing
from .. import random as _random
from ..gluon import parameter as _parameter
from ..ndarray.ndarray import NDArray
from ..parallel import _graph
from ..utils.env import get_env
from .passes import optimize_symbol

__all__ = ["CachedOp", "UnsupportedSignatureError", "canonical_static",
           "in_trace", "Inside"]

_TLS = threading.local()
_LOG = logging.getLogger(__name__)


class UnsupportedSignatureError(TypeError):
    """An argument cannot participate in a replay-cache signature."""


def in_trace():
    """True while an entry of some CachedOp runs its forward on this
    thread (its body, a warm-up or a capture): a hybridized child then
    runs its forward directly."""
    return getattr(_TLS, "depth", 0) > 0


class Inside:
    """Scope of an entry's forward on this thread: hybridized blocks
    called within it run their forward directly (``in_trace``)."""

    __slots__ = ()

    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1

    def __exit__(self, *exc):
        _TLS.depth -= 1


def canonical_static(v):
    """Stable hashable form of a non-tensor argument.  Numbers collapse
    to their Python type class (``np.float32(2.0)`` == ``2.0`` but !=
    ``2``), so equal constants always hit the same entry."""
    if isinstance(v, (bool, np.bool_)):
        return ("b", bool(v))
    if isinstance(v, (int, np.integer)):
        return ("i", int(v))
    if isinstance(v, (float, np.floating)):
        return ("f", float(v))
    if v is None or isinstance(v, str):
        return ("s", v)
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return canonical_static(v.item())
    raise UnsupportedSignatureError(
        f"cannot key a replay cache on argument of type "
        f"{type(v).__name__}")


class _ArgsTemplate:
    """Splits call args into tensor leaves and a static skeleton.

    ``signature`` is the hashable key part; ``tensor_nds`` the NDArray
    leaves in traversal order; ``_rebuild_args`` re-creates the
    (possibly nested) argument structure around fresh tensors."""

    __slots__ = ("signature", "tensor_nds", "_spec")

    def __init__(self, args):
        self.tensor_nds = []
        spec, sig = [], []
        for a in args:
            s, g = self._walk(a)
            spec.append(s)
            sig.append(g)
        self._spec = tuple(spec)
        self.signature = tuple(sig)

    def _walk(self, a):
        if isinstance(a, np.ndarray) and a.ndim != 0:
            a = NDArray(torch.from_numpy(np.ascontiguousarray(a)))
        if isinstance(a, NDArray):
            self.tensor_nds.append(a)
            t = a._data
            return (("T", len(self.tensor_nds) - 1),
                    ("nd", tuple(t.shape), str(t.dtype), str(t.device)))
        if isinstance(a, (list, tuple)):
            walked = [self._walk(x) for x in a]
            tag = "L" if isinstance(a, list) else "U"
            return ((tag, tuple(w[0] for w in walked)),
                    (tag, tuple(w[1] for w in walked)))
        c = canonical_static(a)
        return (("S", c), ("s", c))

    @property
    def is_flat(self):
        """True when every top-level arg is a tensor or a static."""
        return all(s[0] in ("T", "S") for s in self._spec)

    def flat_args(self, make_tensor):
        """The flat argument list with ``make_tensor(i)`` filling tensor
        slots (symbol tracing); statics pass as their canonical
        values."""
        out, ti = [], 0
        for tag, payload in self._spec:
            if tag == "T":
                out.append(make_tensor(ti))
                ti += 1
            elif tag == "S":
                out.append(payload[1])
            else:
                raise UnsupportedSignatureError(
                    "nested argument structures cannot be "
                    "symbol-traced")
        return out


def _signature_components(template, training):
    """Flatten a call signature into the named-component dict the
    compile ledger diffs: tensor shapes, tensor dtypes, canonical
    static args, train flag (docs/observability.md)."""
    shapes, dtypes, statics = [], [], []

    def walk(sig):
        tag = sig[0]
        if tag == "nd":
            shapes.append(sig[1])
            dtypes.append(sig[2])
        elif tag == "s":
            statics.append(sig[1])
        else:                       # L / U nested structures
            for s in sig[1]:
                walk(s)

    for s in template.signature:
        walk(s)
    return {"shape": tuple(shapes), "dtype": tuple(dtypes),
            "static_arg": tuple(statics),
            "train_flag": bool(training)}


def _rebuild_args(spec, tensor_vals):
    """Reassemble a call's argument structure around fresh tensors.
    Module-level so an entry keeps only the static ``spec``, never the
    building call's input arrays."""
    def _build(s):
        tag, payload = s
        if tag == "T":
            return NDArray(tensor_vals[payload])
        if tag == "S":
            return payload[1]
        seq = [_build(x) for x in payload]
        return seq if tag == "L" else tuple(seq)
    return [_build(s) for s in spec]


class _Entry:
    """One signature: its mode and its forward on tensors, plus the
    CUDA graphs captured for it: ``captures["infer"]`` a StepGraph, and
    under each recorded route's key a list of ``_Pair``s."""

    __slots__ = ("mode", "forward", "counted", "captures", "eager")

    def __init__(self, mode, forward):
        self.mode = mode
        # (inputs, training, subs) -> out tensors; subs maps Parameters
        # to the tensors that stand in for theirs
        self.forward = forward
        self.counted = False
        self.captures = {}
        self.eager = None      # on the card: the ops that refused capture


class _Pair:
    """A captured forward and its captured backward, sharing one memory
    pool (``torch.cuda.make_graphed_callables``'s design).  ``owner``
    is a weak reference to the ``_Use`` of the call whose backward the
    pool's activations wait for, or None."""

    __slots__ = ("fwd", "bwd", "static_in", "static_out", "out_grad",
                 "grad_of", "static_grads", "n_in", "owner")

    def busy(self):
        return self.owner is not None and self.owner() is not None


class _Use:
    """One replayed call's claim on its pair, held by its autograd ctx:
    the claim lapses when the backward has replayed or the ctx is
    freed."""

    __slots__ = ("__weakref__",)


class _Replay(torch.autograd.Function):
    """Forward: one replay of the pair's forward graph.  Backward: one
    replay of its backward graph.  Inputs and gradients are copied into
    and out of the graph's buffers."""

    @staticmethod
    def forward(ctx, pair, *tensors):
        for s, x in zip(pair.static_in, tensors[:pair.n_in]):
            s.copy_(x)
        pair.fwd.replay()
        ctx.pair, ctx.use = pair, _Use()
        pair.owner = weakref.ref(ctx.use)
        outs = tuple(o.detach().clone() for o in pair.static_out)
        ctx.mark_non_differentiable(
            *[o for i, o in enumerate(outs) if i not in pair.grad_of])
        return outs

    @staticmethod
    def backward(ctx, *out_grads):
        pair = ctx.pair
        if not pair.busy() or pair.owner() is not ctx.use:
            raise RuntimeError(
                "a hybridized call's captured backward runs once per "
                "forward: call the block again to backpropagate again")
        for buf, i in zip(pair.out_grad, pair.grad_of):
            g = out_grads[i]
            if g is None:
                buf.zero_()
            else:
                buf.copy_(g)
        pair.bwd.replay()
        pair.owner = None
        return (None,) + tuple(None if g is None else g.clone()
                               for g in pair.static_grads)


class CachedOp:
    """Signature-keyed trace-once replay cache for one HybridBlock."""

    def __init__(self, block, capacity=None):
        self._block = block
        self._capacity = capacity if capacity is not None \
            else get_env("MXTPU_CACHEDOP_CAPACITY")
        self._entries = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._trace_events = 0
        # resolved once: the hit path pays no registry lock per call
        self._hits_ctr = telemetry.counter("cachedop_cache_hits_total")
        self._misses_ctr = telemetry.counter(
            "cachedop_cache_misses_total")
        self._ledger = tracing.compile_ledger(f"cachedop:{block.name}")
        params = block.collect_params()
        self._param_names = sorted(params.keys())
        self._params = [params[n] for n in self._param_names]
        self._param_by_name = dict(zip(self._param_names, self._params))
        self._state_params = [p for p in self._params
                              if p.grad_req == "null"]
        self._epoch = None           # parameter storage the captures read
        self._addresses = None

    # ------------------------------------------------------------ stats
    @property
    def trace_count(self):
        """Traces (CPU) and captures (CUDA): one per signature in steady
        state."""
        return self._trace_events

    def stats(self):
        out = {"hits": self.hits, "misses": self.misses,
               "traces": self._trace_events,
               "entries": len(self._entries),
               "modes": sorted({e.mode for e in self._entries.values()})}
        skipped = sorted({n for e in self._entries.values()
                          for n in (e.eager or ())})
        if skipped:          # the card ran an entry eagerly: say why
            out["capture_skipped"] = ",".join(skipped)
        return out

    # ------------------------------------------------------------ call
    def __call__(self, *args):
        training = bool(autograd.is_training())
        recording = autograd.is_recording()
        template = _ArgsTemplate(args)
        key = (template.signature, training)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is None:
            self._misses_ctr.inc()
            self.misses += 1
            t0 = time.monotonic()
            entry = self._build_entry(template, training)
            with self._lock:
                entry = self._entries.setdefault(key, entry)
                self._entries.move_to_end(key)
                while self._capacity > 0 and \
                        len(self._entries) > self._capacity:
                    self._entries.popitem(last=False)
            out = self._execute(entry, template, training, recording)
            # timed through the first call: that call traces (CPU) or
            # captures (card)
            self._ledger.record(
                _signature_components(template, training),
                time.monotonic() - t0)
            return out
        self._hits_ctr.inc()
        self.hits += 1
        return self._execute(entry, template, training, recording)

    # ------------------------------------------------------------ build
    def _device(self, inputs):
        if inputs:
            return inputs[0].device
        for p in self._params:
            if p._allocated():
                return p._var.device
        return torch.device("cpu")

    def _build_entry(self, template, training):
        level = get_env("MXTPU_GRAPH_OPT")
        if level >= 1 and template.is_flat:
            try:
                return self._build_graph_entry(template, training, level)
            except Exception:          # block not symbol-traceable
                pass
        return self._build_jit_entry(template, training)

    def _build_graph_entry(self, template, training, level):
        from ..executor import build_graph_fn
        from ..symbol.symbol import Symbol, _topo
        sym, input_names = self._block._trace_symbol(template)
        if not isinstance(sym, Symbol):
            raise UnsupportedSignatureError(
                "symbol trace returned non-Symbol")
        for node in _topo(sym._heads):
            if node.op is not None and node.op.needs_rng:
                # graph rng nodes would draw from the graph's own
                # generators, not the eager stream: jit mode keeps it
                raise UnsupportedSignatureError(
                    f"rng op '{node.op.name}' in traced graph")
        clash = set(self._param_names) & set(input_names)
        if clash:
            raise UnsupportedSignatureError(
                f"input names collide with parameters: {sorted(clash)}")
        known = set(self._param_names) | set(input_names)
        unknown = [n for n in sym.list_inputs() if n not in known]
        if unknown:
            raise UnsupportedSignatureError(
                f"traced graph has unbound inputs {unknown}")
        device = self._device([a._data for a in template.tensor_nds])
        opt_sym, _ = optimize_symbol(sym, level=level, device=device)
        run = build_graph_fn(opt_sym, default_device=device)
        params = list(zip(self._param_names, self._params))
        by_name = self._param_by_name

        def forward(inputs, training, subs=None):
            subs = subs or {}
            vals = {name: subs.get(p, p._var) for name, p in params}
            vals.update(zip(input_names, inputs))
            outs, aux_upd = run(vals, {}, 0, training)
            if aux_upd:
                with torch.no_grad():
                    for name, v in aux_upd.items():
                        p = by_name.get(name)
                        if p is not None:
                            p._var.copy_(v)
            return list(outs)

        return _Entry("graph", forward)

    def _build_jit_entry(self, template, training):
        block = self._block
        spec = template._spec          # structure only, no arrays

        def forward(inputs, training, subs=None):
            args = _rebuild_args(spec, inputs)
            if subs:
                # functional_call substitutes by path and calls the
                # block, which inside a trace runs its forward
                by_tensor = {id(p._var): t for p, t in subs.items()}
                with Inside():
                    outs = torch.func.functional_call(
                        block, {path: by_tensor[id(v)]
                                for path, v in block.named_parameters()
                                if id(v) in by_tensor},
                        tuple(args), tie_weights=True, strict=False)
            else:
                outs = block.forward(*args)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            return [o._data for o in outs]

        return _Entry("jit", forward)

    # ---------------------------------------------------------- execute
    def _execute(self, entry, template, training, recording):
        inputs = [a._data for a in template.tensor_nds]
        outs = None
        if self._on_card(inputs) and entry.eager is None:
            outs = self._replay(entry, inputs, training, recording)
        if outs is None:
            if not entry.counted:
                entry.counted = True
                self._trace_events += 1
            with Inside(), autograd._RecordingStateScope(recording,
                                                         training), \
                    autograd.grad_scope(
                        inputs + [p._var for p in self._params]):
                outs = entry.forward(inputs, training)
        out_arrays = [NDArray(o) for o in outs]
        return out_arrays[0] if len(out_arrays) == 1 else out_arrays

    # ------------------------------------------------------------ card
    def _on_card(self, inputs):
        return self._device(inputs).type == "cuda"

    def _check_storage(self):
        """Drop every capture when a parameter's storage moved since
        they were taken."""
        epoch = _parameter.storage_epoch()
        if epoch == self._epoch:
            return
        addresses = tuple(p._var.data_ptr() for p in self._params
                          if p._allocated())
        if addresses != self._addresses:
            for e in self._entries.values():
                e.captures.clear()
        self._epoch, self._addresses = epoch, addresses

    def _mutable(self):
        return [p._var for p in self._state_params if p._allocated()]

    def _replay(self, entry, inputs, training, recording):
        self._check_storage()
        device = self._device(inputs)
        gens = [] if entry.mode == "graph" \
            else [_random.current_generator(device)]
        tparams = [p for p in self._params
                   if p.grad_req != "null" and p._var.requires_grad]
        trainable = [p._var for p in tparams]
        needs = tuple(x.requires_grad for x in inputs)
        if recording and (trainable or any(needs)):
            key = ("pair", needs) + tuple(id(g) for g in gens)
            pairs = entry.captures.setdefault(key, [])
            pair = next((p for p in pairs if not p.busy()), None)
            if pair is None:       # every pair waits for its backward
                pair = self._capture_pair(entry, inputs, needs, tparams,
                                          training, gens)
                if pair is None:   # refused: the caller runs it eagerly
                    return None
                pairs.append(pair)
                self._trace_events += 1
            return list(_Replay.apply(pair, *inputs, *trainable))
        step = entry.captures.get("infer")
        if step is None:
            def fn(*xs):
                with Inside(), autograd._RecordingStateScope(
                        False, training), torch.no_grad():
                    return tuple(entry.forward(list(xs), training))
            step = entry.captures["infer"] = _graph.StepGraph(
                fn, self._mutable, "cachedop")
        n = step.counts.get("cachedop", 0)
        outs = step(inputs, gens)
        self._trace_events += step.counts.get("cachedop", 0) - n
        if step.capture_skipped:
            entry.eager = step.capture_skipped.split(",")
        return list(outs)

    def _capture_pair(self, entry, inputs, needs, tparams, training,
                      gens):
        """Capture a forward and its backward.  Both differentiate
        aliases of the trainable parameters (the same storage, so a
        replay reads their current values), not the parameters: while
        an earlier call's autograd graph is alive it holds the
        parameters' gradient accumulators, made on another stream, and
        a backward that reached them would sync that stream inside the
        capture."""
        device = inputs[0].device if inputs else tparams[0]._var.device
        pair = _Pair()
        pair.n_in = len(inputs)
        pair.owner = None
        with torch.cuda.device(device):
            static_in = [x.detach().clone().requires_grad_(rg)
                         for x, rg in zip(inputs, needs)]

            def aliases():
                return {p: p._var.detach().requires_grad_()
                        for p in tparams}

            def fwd(subs):
                with Inside(), autograd._RecordingStateScope(
                        True, training), torch.enable_grad():
                    return entry.forward(static_in, training, subs)

            def wrt(subs):
                return [s for s in static_in if s.requires_grad] \
                    + list(subs.values())

            def fwd_bwd():
                subs = aliases()
                outs = [o for o in fwd(subs) if o.requires_grad]
                torch.autograd.grad(outs, wrt(subs),
                                    [torch.ones_like(o) for o in outs],
                                    allow_unused=True)

            refused = _graph.warm_up(fwd_bwd, self._mutable, gens)
            if refused:
                entry.eager = refused
                _LOG.warning("%s: not captured, %s runs Python at every "
                             "call; the block runs eagerly on the card",
                             self._block.name, ", ".join(refused))
                return None
            subs = aliases()
            pair.fwd = _graph.new_graph(device, gens)
            with torch.cuda.graph(pair.fwd):
                static_out = fwd(subs)
            pair.grad_of = [i for i, o in enumerate(static_out)
                            if o.requires_grad]
            pair.out_grad = [torch.empty_like(static_out[i])
                             for i in pair.grad_of]
            pair.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(pair.bwd, pool=pair.fwd.pool()):
                grads = torch.autograd.grad(
                    [static_out[i] for i in pair.grad_of], wrt(subs),
                    pair.out_grad, allow_unused=True)
        it = iter(grads)
        pair.static_grads = [next(it) if rg else None for rg in needs] \
            + [next(it) for _ in tparams]
        pair.static_in = static_in
        pair.static_out = [o.detach() for o in static_out]
        return pair
