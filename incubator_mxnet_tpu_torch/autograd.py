"""Imperative autograd (twin of ``incubator_mxnet_tpu/autograd.py``):
record/pause scopes, marked variables, backward, grad, Function.

It rides on torch's own autograd instead of a tape of its own:

- Outside ``record()``, ``nd`` ops run under ``torch.no_grad()``.
  Inside it, an op is recorded (run under ``torch.enable_grad()``) only
  if one of its inputs is marked or comes from a recorded op, that is,
  if its tensor requires grad.
- ``attach_grad()`` / ``mark_variables`` keep the mark (the gradient
  buffer and ``grad_req``) on the NDArray, and make its tensor a torch
  leaf that requires grad.  When ``out=`` or ``x[:] = v`` rebinds a
  marked array's data, the new tensor becomes a fresh leaf with the
  same mark, as the JAX package rebinds its buffer (a leaf that
  requires grad cannot be written in place in torch).
- ``backward`` calls ``torch.autograd.backward`` with a head gradient
  of ones where none is given (MXNet's rule; torch asks for one on a
  non-scalar head).  A hook on each marked leaf then moves the
  gradient into the NDArray's buffer by ``grad_req``: "write" replaces
  it on every backward, "add" accumulates, "null" leaves it alone.
- ``grad(..., create_graph=True)`` differentiates through torch, so
  the gradients it returns can be differentiated again.
- ``Function`` runs as a ``torch.autograd.Function`` underneath.
- ``torch_mode(training)`` is the scope of a Gluon block called on
  torch tensors (by the train step's ``functional_call``, or by a plain
  torch module that holds Gluon layers): inside it ``nd`` ops follow
  torch's own grad mode, as any torch code does, and the training flag
  is the one given (the module's ``training``), not ``record``'s.

- ``get_symbol`` re-traces an array's recorded history into a Symbol:
  under ``record()`` each registry op's outputs keep the op, its
  params and its input arrays (``_history``), which torch's graph does
  not name.
"""
import contextlib
import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "torch_mode",
           "mark_variables", "backward", "grad", "get_symbol", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.torch_mode = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    prev = _st().recording
    _st().recording = bool(is_record)
    return prev


def set_training(train_mode_):
    prev = _st().training
    _st().training = bool(train_mode_)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train):
        self._rec = is_record
        self._train = train

    def __enter__(self):
        s = _st()
        self._prev = (s.recording, s.training)
        if self._rec is not None:
            s.recording = self._rec
        if self._train is not None:
            s.training = self._train
        return self

    def __exit__(self, *exc):
        s = _st()
        s.recording, s.training = self._prev


def record(train_mode=True):
    """Scope in which imperative ops are recorded for backward()."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which recording (and by default training mode) is off."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


class torch_mode:
    """Scope in which ``nd`` ops keep torch's grad mode and
    ``is_training()`` is ``training``.  (A class, not a generator: a
    Gluon layer called on torch tensors enters one per call.)"""

    __slots__ = ("_training", "_prev")

    def __init__(self, training):
        self._training = bool(training)

    def __enter__(self):
        s = _st()
        self._prev = s.torch_mode, s.training
        s.torch_mode, s.training = True, self._training
        return self

    def __exit__(self, *exc):
        s = _st()
        s.torch_mode, s.training = self._prev


def in_torch_mode():
    return _st().torch_mode


def grad_scope(tensors):
    """torch's grad mode for an op on ``tensors``: in ``torch_mode``
    the ambient one; else enabled when recording and one of them
    requires grad, and disabled otherwise."""
    s = _st()
    if s.torch_mode:
        return contextlib.nullcontext()
    if s.recording and any(isinstance(t, torch.Tensor)
                           and t.requires_grad for t in tensors):
        return torch.enable_grad()
    return torch.no_grad()


# ---------------------------------------------------------------------------
# marked variables
# ---------------------------------------------------------------------------

_GRAD_REQS = ("write", "add", "null")


def _write_grad(ref, leaf):
    """Post-accumulate hook of a marked leaf: move the gradient torch
    accumulated into the NDArray's buffer, by its grad_req."""
    g, leaf.grad = leaf.grad, None
    arr = ref()
    if arr is None or g is None or arr._grad_req == "null":
        return
    buf = arr._grad
    if arr._grad_req == "add":
        buf._data = buf._data + g.detach()
    else:
        buf._data = g.detach().to(buf._data.dtype)


def rebind(arr, tensor):
    """Point ``arr`` at ``tensor``; a marked array gets a fresh leaf
    that requires grad, carrying its mark."""
    if getattr(arr, "_grad", None) is None:
        arr._data = tensor
        return
    if not tensor.is_floating_point():
        raise TypeError(f"cannot mark a {tensor.dtype} array for "
                        "gradients: torch differentiates floats only")
    leaf = tensor.detach().requires_grad_(True)
    ref = weakref.ref(arr)
    leaf.register_post_accumulate_grad_hook(
        lambda t: _write_grad(ref, t))
    arr._data = leaf


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays, making them autograd leaves."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, "
                             f"got {req!r}")
        v._grad = g
        v._grad_req = req
        rebind(v, v._data)


def _as_list(x):
    from .ndarray.ndarray import NDArray
    return [x] if isinstance(x, NDArray) else list(x)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Compute gradients of heads w.r.t. marked variables, storing them
    in each variable's gradient buffer.  A head without a given
    gradient gets ones; heads with no recorded history are skipped."""
    heads = _as_list(heads)
    head_grads = [None] * len(heads) if head_grads is None \
        else _as_list(head_grads)
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue
        tensors.append(h._data)
        grads.append(torch.ones_like(h._data) if hg is None
                     else hg._data.to(h._data.dtype))
    if tensors:
        torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False):
    """Gradients of heads w.r.t. ``variables``, returned as NDArrays
    (the variables' own buffers are left alone, as in MXNet).  With
    ``create_graph`` they carry their own history."""
    from .ndarray.ndarray import NDArray
    heads = _as_list(heads)
    variables = _as_list(variables)
    head_grads = [None] * len(heads) if head_grads is None \
        else _as_list(head_grads)
    outs = [h._data for h in heads]
    gos = [torch.ones_like(o) if hg is None else hg._data.to(o.dtype)
           for o, hg in zip(outs, head_grads)]
    with torch.enable_grad():
        got = torch.autograd.grad(
            outs, [v._data for v in variables], gos,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    if any(g is None for g in got):
        raise ValueError("one of the variables does not participate "
                         "in the graph of heads")
    return [NDArray(g) for g in got]


class _Recorded:
    """One recorded op call, for ``get_symbol``: the op (None for an
    opaque ``Function``), its user params and its inputs, each the
    ``(record, index)`` that made it, a weak reference to a leaf array,
    None for an absent optional input or ``CONST_INPUT`` for an inlined
    constant.  No array is held, so a record keeps no activation
    alive."""

    __slots__ = ("op", "inputs", "params", "name")

    def __init__(self, op, inputs, params, name):
        self.op, self.inputs, self.params, self.name = \
            op, inputs, params, name


class _ConstInput:
    def __repr__(self):
        return "CONST_INPUT"


CONST_INPUT = _ConstInput()


def _record(op, args, params, out_arrays, name=None):
    """Keep ``op``'s call on the arrays it returned (``_history``)."""
    from .ndarray.ndarray import NDArray

    def ref(a):
        if a is None:
            return None
        if not isinstance(a, NDArray):
            return CONST_INPUT
        h = getattr(a, "_history", None)
        return h if h is not None else weakref.ref(a)

    rec = _Recorded(op, [ref(a) for a in args], params, name or op.name)
    for i, a in enumerate(out_arrays):
        a._history = (rec, i)


def _history_order(x):
    """Recorded calls reachable from ``x``, dependencies first."""
    order, seen = [], set()
    stack = [(x._history[0], False)]
    while stack:
        rec, done = stack.pop()
        if done:
            order.append(rec)
            continue
        if id(rec) in seen:
            continue
        seen.add(id(rec))
        stack.append((rec, True))
        for inp in reversed(rec.inputs):
            if isinstance(inp, tuple) and id(inp[0]) not in seen:
                stack.append((inp[0], False))
    return order


def get_symbol(x):
    """Re-trace the recorded history of ``x`` into a Symbol (ref:
    python/mxnet/autograd.py get_symbol), by replaying the registry ops
    each recorded call made.

    Leaf arrays become Variables named var0, var1... in first-use
    order.  Only registry-op history is traceable: a custom
    ``Function``'s call is opaque and raises, as does an input that
    was an inlined constant (numpy, list or scalar)."""
    from .symbol import symbol as sym_mod

    if getattr(x, "_history", None) is None:
        return sym_mod.Variable("var0")
    rec_syms = {}      # id(record) -> Symbol with all outputs
    arr_syms = {}      # id(weak reference to a leaf) -> Variable
    counter = [0]

    def leaf(ref):
        # CPython hands out one weak reference per referent, so its id
        # names the leaf for as long as a record holds it
        if id(ref) not in arr_syms:
            arr_syms[id(ref)] = sym_mod.Variable(f"var{counter[0]}")
            counter[0] += 1
        return arr_syms[id(ref)]

    for rec in _history_order(x):
        if rec.op is None:
            raise ValueError(
                f"get_symbol: '{rec.name}' was recorded as an opaque "
                "closure (custom Function); only registry-op history is "
                "traceable")
        sym_args = []
        for inp in rec.inputs:
            if inp is None:
                sym_args.append(None)
                continue
            if inp is CONST_INPUT:
                raise ValueError(
                    f"get_symbol: an input of '{rec.name}' was an "
                    "inlined constant (raw numpy/list/scalar), which a "
                    "Symbol cannot re-bind — pass tensor inputs as "
                    "NDArrays to make the history re-traceable")
            if isinstance(inp, tuple):
                s = rec_syms[id(inp[0])]
                sym_args.append(s[inp[1]] if len(s) > 1 else s)
            else:
                sym_args.append(leaf(inp))
        rec_syms[id(rec)] = sym_mod._invoke(rec.op, sym_args,
                                            dict(rec.params))
    rec, idx = x._history
    s = rec_syms[id(rec)]
    return s[idx] if len(s) > 1 else s


# ---------------------------------------------------------------------------
# user-defined differentiable functions
# ---------------------------------------------------------------------------


class _FunctionBridge(torch.autograd.Function):
    """Runs an ``autograd.Function``'s forward and backward (on
    NDArrays) as torch's forward and backward.  The arrays the user
    saves travel through ``ctx.save_for_backward``, so no tensor is
    kept on a Python attribute of the graph."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outputs = func.forward(*[NDArray(t) for t in tensors])
        saved, func._saved = func._saved, ()
        ctx.func = func
        ctx.single = isinstance(outputs, NDArray)
        ctx.save_for_backward(*[a._data for a in saved])
        outs = [outputs] if ctx.single else list(outputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        func = ctx.func
        func._saved = tuple(NDArray(t) for t in ctx.saved_tensors)
        with pause():
            grads = func.backward(*[NDArray(g) for g in out_grads])
        func._saved = ()
        if isinstance(grads, NDArray):
            grads = [grads]
        return (None,) + tuple(None if g is None else g._data
                               for g in grads)


class Function:
    """User-defined differentiable function.

    Subclass and implement forward(self, *inputs) and
    backward(self, *output_grads), both on NDArrays.
    """

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (is_recording()
                and any(x._data.requires_grad for x in inputs)):
            with pause():
                return self.forward(*inputs)
        outs = [NDArray(t) for t in
                _FunctionBridge.apply(self, *[x._data for x in inputs])]
        _record(None, inputs, {}, outs, type(self).__name__)
        return outs[0] if len(outs) == 1 else outs
