"""Custom operators defined in Python (twin of
``incubator_mxnet_tpu/operator.py``; ref: python/mxnet/operator.py
CustomOp/CustomOpProp:96+, registered through MXCustomOpRegister,
src/c_api/c_api.cc:1157, run by src/operator/custom/custom.cc).

A ``CustomOpProp`` subclass registered under a name (``register``) is
called through the registry op ``Custom`` (``nd.Custom``,
``sym.Custom``, ``F.Custom`` in a HybridBlock) with ``op_type=`` that
name; its other keyword arguments go to the prop's constructor.  The
user's ``forward`` and ``backward`` receive port NDArrays on the
inputs' device and write their outputs with ``assign``.  A
``torch.autograd.Function`` wires the backward: it keeps only the
tensors ``declare_backward_dependency`` names (the others reach
``backward`` as None), so the op composes with ``autograd``, the
Executor, ``Module`` and hybridized blocks like a built-in op.

The user's Python, and any ``asnumpy()`` in it, runs at every call, so a
CUDA graph cannot hold it: each call reports itself to
``parallel._graph.refuse_capture``, and a captured train step or a
hybridized block whose warm-up reaches a ``Custom`` node runs eagerly on
the card instead, recording why (``capture_skipped == "Custom"`` on the
step, in the CachedOp's ``stats()``).  The operator a prop creates is
kept per (op_type, arguments, input shapes, dtypes, device, train flag),
as the reference caches its callable.
"""
import functools

import numpy as np
import torch

from .ops.registry import defop

# ``ops`` imports this module to register 'Custom', before ``ndarray``
# and ``parallel`` exist: those are imported where they are used

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_REGISTRY = {}


class CustomOp:
    """Base of a user op's implementation (ref: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says: 'null' skips,
        'add' accumulates, anything else overwrites (ref: operator.py
        CustomOp.assign)."""
        if req in ("null", 0):
            return
        if req in ("add", 3):
            dst[:] = dst + src
        else:
            dst[:] = src


class CustomOpProp:
    """Describes a custom op: its arguments, outputs, shapes and types,
    and the operator it creates (ref: operator.py CustomOpProp:96)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type,
                [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Decorator: register a CustomOpProp subclass as ``reg_name`` (ref:
    operator.py register / MXCustomOpRegister)."""
    def _reg(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return _reg


def get_all_registered():
    return dict(_REGISTRY)


class _Spec:
    """One created operator with its signature: what the autograd
    Function needs at both passes."""

    def __init__(self, op_type, kwargs_tuple, in_shapes, in_dtypes,
                 device, training):
        from .context import Context
        prop = _REGISTRY[op_type](**dict(kwargs_tuple))
        in_shapes2, out_shapes, _ = prop.infer_shape(
            [list(s) for s in in_shapes])
        _, out_types, _ = prop.infer_type(list(in_dtypes))
        self.ctx = Context.from_device(device)
        self.op = prop.create_operator(self.ctx, in_shapes2,
                                       list(in_dtypes))
        self.in_shapes = [tuple(s) for s in in_shapes]
        self.in_dtypes = list(in_dtypes)
        self.out_shapes = [tuple(s) for s in out_shapes]
        self.out_types = [t if isinstance(t, str) else np.dtype(t).name
                          for t in out_types]
        self.training = training
        n_out, n_in = len(self.out_shapes), len(self.in_shapes)
        # the reference's dependency ids: out_grad, then in_data, then
        # out_data
        deps = set(prop.declare_backward_dependency(
            list(range(n_out)), list(range(n_out, n_out + n_in)),
            list(range(n_out + n_in, 2 * n_out + n_in))))
        self.keep_grad = [i in deps for i in range(n_out)]
        self.keep_in = [n_out + i in deps for i in range(n_in)]
        self.keep_out = [n_out + n_in + i in deps for i in range(n_out)]

    def zeros(self, shapes, dtypes):
        from .ndarray.ndarray import zeros
        return [zeros(s, ctx=self.ctx, dtype=t)
                for s, t in zip(shapes, dtypes)]


@functools.lru_cache(maxsize=256)
def _cached_spec(op_type, kwargs_tuple, in_shapes, in_dtypes, device,
                 training):
    return _Spec(op_type, kwargs_tuple, in_shapes, in_dtypes, device,
                 training)


def _wrap(tensors, keep=None):
    """Tensors as NDArrays; None where ``keep`` says not kept."""
    from .ndarray.ndarray import NDArray
    keep = keep or [True] * len(tensors)
    return [NDArray(t) if k and t is not None else None
            for t, k in zip(tensors, keep)]


class _CustomFunction(torch.autograd.Function):
    """Forward: the user's ``forward``.  Backward: the user's
    ``backward`` on the declared dependencies."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        from . import autograd
        out_nd = spec.zeros(spec.out_shapes, spec.out_types)
        with autograd.pause():
            spec.op.forward(spec.training, ["write"] * len(out_nd),
                            _wrap(inputs), out_nd, [])
        outs = tuple(o._data.detach() for o in out_nd)
        ctx.spec = spec
        ctx.n_in = len(inputs)
        ctx.save_for_backward(
            *[x if k else None for x, k in zip(inputs, spec.keep_in)],
            *[o if k else None for o, k in zip(outs, spec.keep_out)])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        from . import autograd
        from .base import torch_dtype
        spec = ctx.spec
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        grads = [torch.zeros(s, dtype=torch_dtype(t),
                             device=spec.ctx.device)
                 if g is None else g
                 for g, s, t in zip(grads, spec.out_shapes, spec.out_types)]
        in_grad = spec.zeros(spec.in_shapes, spec.in_dtypes)
        with autograd.pause():
            spec.op.backward(["write"] * len(in_grad),
                             _wrap(grads, spec.keep_grad), _wrap(ins),
                             _wrap(outs), in_grad, [])
        return (None,) + tuple(g._data for g in in_grad)


def _n_outputs(params):
    op_type = params.get("op_type")
    if op_type in _REGISTRY:
        # the prop made with the op's own arguments: list_outputs() may
        # depend on them
        kwargs = {k: v for k, v in params.items()
                  if k != "op_type" and not k.startswith("_")}
        return len(_REGISTRY[op_type](**kwargs).list_outputs())
    return 1


@defop("Custom", variadic=True, needs_mode=True, num_outputs=_n_outputs)
def custom(*inputs, op_type=None, _training=False, **kwargs):
    """Invoke a registered Python custom op (ref:
    src/operator/custom/custom.cc)."""
    if op_type not in _REGISTRY:
        raise ValueError(
            f"custom op '{op_type}' not registered; known: "
            f"{sorted(_REGISTRY)}")
    in_shapes = tuple(tuple(x.shape) for x in inputs)
    in_dtypes = tuple(str(x.dtype).rpartition(".")[2] for x in inputs)
    if any(x.device.type == "meta" for x in inputs):
        # shape inference: the prop's shapes and types, no user code
        from .base import torch_dtype
        prop = _REGISTRY[op_type](**kwargs)
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        _, out_types, _ = prop.infer_type(list(in_dtypes))
        outs = tuple(torch.empty(tuple(s), dtype=torch_dtype(t),
                                 device="meta")
                     for s, t in zip(out_shapes, out_types))
        return outs[0] if len(outs) == 1 else outs
    from .parallel import _graph
    _graph.refuse_capture("Custom")
    spec = _cached_spec(op_type, tuple(sorted(kwargs.items())), in_shapes,
                        in_dtypes, inputs[0].device, bool(_training))
    outs = _CustomFunction.apply(spec, *inputs)
    return outs[0] if len(outs) == 1 else tuple(outs)
