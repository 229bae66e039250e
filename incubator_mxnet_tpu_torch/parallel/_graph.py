"""A training step captured as one CUDA graph: the port's counterpart of
the one ``jax.jit`` executable each JAX train step compiles to.

``StepGraph(fn, mutable)`` turns ``fn(*inputs) -> tensor or tuple of
tensors``, a step that updates its state in place, into one
``torch.cuda.CUDAGraph`` per input signature (shapes, dtypes and the
generators it draws from), as jit traces once per signature:

- the inputs are copied into static buffers, which the graph reads;
- before a capture, warm-up steps run on a side stream (lazy
  initialisation, cuBLAS and cuDNN workspaces, autograd's streams); the
  state they change (``mutable()``: parameters, optimizer state,
  BatchNorm's moving stats) is snapshotted before them and put back
  after them, and each generator's state too, so the captured step
  starts where the call found the step;
- every generator the step draws from is registered with the graph
  (``CUDAGraph.register_generator_state``): a replay draws fresh masks
  from the generator's current offset and advances it, as an eager step
  would;
- the outputs are cloned out of the graph's memory pool before they
  reach the caller, so the next replay cannot overwrite a returned
  loss;
- between the warm-up and the capture the allocator's cached blocks
  are released (``torch.cuda.empty_cache``): the capture allocates from
  a private pool, and the warm-up's cache would otherwise hold the card
  beside it (an out-of-memory during either propagates; the train
  steps' OOM ladder drops the graph and captures again);
- ``counts[name]`` counts captures, as the serving engine's
  ``trace_counts`` does.

A capture keys its generators by identity and holds them, so no later
generator can take a collected one's ``id`` and replay from its state.
Each new generator costs a capture and a memory pool of its own: a
caller draws from one generator across steps (and reseeds it), and a
second capture of the same inputs for another generator warns.

Anything a replay must see change per step has to live in a device
tensor that the step reads (the learning rate, Adam's step count): a
Python number is frozen into the graph at capture.  A capture that
fails raises; nothing drops to an eager step on the card, with one
exception, stated where it is read: an op whose Python runs at every
call (a ``Custom`` op) reports each call to ``refuse_capture``, and a
signature whose warm-up reached one is not captured.  Its calls run the
step eagerly on the card (the first call also pays the two warm-up
runs), ``capture_skipped`` names the op, and a warning says so once.
"""
import collections
import logging
import warnings

import torch

__all__ = ["StepGraph", "WARMUP_STEPS", "tensors_of", "warm_up",
           "new_graph", "refuse_capture"]

WARMUP_STEPS = 2
_LOG = logging.getLogger(__name__)
_REFUSED = collections.Counter()     # op name -> calls that refuse capture


def refuse_capture(name):
    """Called by an op at each call whose host code a CUDA graph cannot
    hold (a ``Custom`` op's Python): a warm-up that reaches it keeps its
    step eager, and a capture that reaches it anyway raises."""
    _REFUSED[name] += 1
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{name} runs Python at every call and cannot run inside a "
            f"CUDA graph capture")


def tensors_of(tree):
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def warm_up(run, mutable, generators, steps=WARMUP_STEPS):
    """Run ``run()`` ``steps`` times on a side stream (lazy
    initialisation, library workspaces, autograd's streams) and undo
    what they changed: the tensors of ``mutable()`` and each generator's
    state are put back, so a capture after it starts where the caller
    found the state.  Returns the names of the ops the runs reached that
    refuse capture (``refuse_capture``), sorted."""
    before = collections.Counter(_REFUSED)
    state = mutable()
    snapshot = [t.detach().clone() for t in state]
    gen_states = [g.get_state() for g in generators]
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            for _ in range(steps):
                run()
    finally:            # a failed warm-up leaves no trace either
        main.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, snapshot):
                t.copy_(s)
        del snapshot
        for g, s in zip(generators, gen_states):
            g.set_state(s)
    return sorted(n for n, c in _REFUSED.items() if c != before[n])


def new_graph(device, generators):
    """A ``torch.cuda.CUDAGraph`` with ``generators`` registered (torch's
    default generator of ``device`` registers itself at capture)."""
    graph = torch.cuda.CUDAGraph()
    default = torch.cuda.default_generators[device.index or 0]
    for g in generators:
        if g is not default:
            graph.register_generator_state(g)
    return graph


def _signature(inputs, generators):
    return (tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
            tuple(id(g) for g in generators))


class _Captured:
    def __init__(self, graph, static_in, static_out, generators):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.generators = tuple(generators)   # their ids key the capture


class StepGraph:
    """``fn`` captured once per signature and replayed after.

    Parameters
    ----------
    fn : callable(*inputs) -> Tensor or tuple of Tensors; runs the
        whole step on its inputs and updates its state in place
    mutable : callable() -> list of the tensors ``fn`` changes in place
        (restored after the warm-up steps)
    name : the key of ``counts`` that counts captures
    counts : dict shared with the owner (its ``trace_counts``)
    """

    def __init__(self, fn, mutable, name="step", counts=None):
        self.fn = fn
        self.mutable = mutable
        self.name = name
        self.counts = counts if counts is not None else {}
        self._captured = {}
        self._eager = {}          # signature -> the ops that refused

    @property
    def capture_skipped(self):
        """The ops (comma-joined) that kept a signature from being
        captured, or None."""
        names = sorted({n for ops in self._eager.values() for n in ops})
        return ",".join(names) or None

    def __call__(self, inputs, generators=()):
        """Replay the step on ``inputs`` (CUDA tensors); returns clones
        of its outputs (a tuple).  A signature whose warm-up reached an
        op that refuses capture runs the step eagerly instead."""
        key = _signature(inputs, generators)
        if key in self._eager:
            return self._run_eager(inputs)
        cap = self._captured.get(key)
        if cap is None:
            same_inputs = sum(k[0] == key[0] for k in self._captured)
            if same_inputs:
                warnings.warn(
                    f"{self.name}: a new generator makes capture "
                    f"{same_inputs + 1} of the same inputs, with a memory "
                    f"pool of its own; draw from one generator across "
                    f"steps", stacklevel=3)
            cap = self._capture(inputs, generators)
            if isinstance(cap, list):
                self._eager[key] = cap
                _LOG.warning("%s: not captured, %s runs Python at every "
                             "call; the step runs eagerly on the card",
                             self.name, ", ".join(cap))
                return self._run_eager(inputs)
            self._captured[key] = cap
        for s, x in zip(cap.static_in, inputs):
            s.copy_(x, non_blocking=True)
        cap.graph.replay()
        return tuple(o.clone() for o in cap.static_out)

    def _run_eager(self, inputs):
        out = self.fn(*inputs)
        return out if isinstance(out, tuple) else (out,)

    def _capture(self, inputs, generators):
        """The captured step, or the list of ops that refused capture."""
        device = inputs[0].device
        with torch.cuda.device(device):
            static_in = [torch.empty_like(x) for x in inputs]
            for s, x in zip(static_in, inputs):
                s.copy_(x)
            refused = warm_up(lambda: self.fn(*static_in), self.mutable,
                              generators)
            if refused:
                return refused
            # the capture allocates from a pool of its own: hand back
            # what the warm-up left cached, so the two never hold the
            # card's memory at once
            torch.cuda.empty_cache()
            graph = new_graph(device, generators)
            try:
                with torch.cuda.graph(graph):
                    out = self.fn(*static_in)
            except BaseException:
                # a failed capture (out of memory, most often) leaves no
                # graph behind and hands its pool back at once
                graph.reset()
                del graph
                torch.cuda.empty_cache()
                raise
        out = out if isinstance(out, tuple) else (out,)
        self.counts[self.name] = self.counts.get(self.name, 0) + 1
        return _Captured(graph, static_in, out, generators)
