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

``get_symbol`` needs the symbolic frontend (ROADMAP item 6) and raises
until it is ported.
"""
import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training",
           "mark_variables", "backward", "grad", "get_symbol", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
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


def grad_scope(tensors):
    """torch's grad mode for an op on ``tensors``: enabled when
    recording and one of them requires grad, else disabled."""
    if is_recording() and any(isinstance(t, torch.Tensor)
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


def get_symbol(x):
    """Re-trace the recorded history of ``x`` into a Symbol: needs the
    symbolic frontend, which is not ported yet (ROADMAP item 6)."""
    raise NotImplementedError(
        "autograd.get_symbol needs the symbolic frontend (sym), which "
        "the port does not have yet (ROADMAP item 6)")


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
        return outs[0] if len(outs) == 1 else outs
