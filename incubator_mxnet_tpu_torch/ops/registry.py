"""The operator registry (twin of ``incubator_mxnet_tpu/ops/registry.py``).

Every op is declared once here, by name, with a compute function on
torch tensors; the ``nd`` surface is generated from these entries
(``ndarray/register.py``), so the surface cannot drift from the ops.
Names, ``arg_names`` and parameter defaults are the JAX package's, so
code written against one package's op surface runs on the other.

An OpDef's ``fn`` maps torch tensors and static Python params to torch
tensor(s).  It runs eagerly; ``nd`` decides whether torch autograd
records it (``ndarray.imperative_invoke``).

The JAX ``OpDef`` also has ``cache_vjp``, which routes ops built on
``lax.scan`` through a stable pair of jitted functions so that JAX's
compile cache, keyed on jaxpr identity, is hit on every eager call.
PyTorch runs eagerly and compiles nothing per call, so the field has no
counterpart here and is left out.
"""
import inspect

__all__ = ["OpDef", "defop", "alias", "get_op", "find_op", "list_ops",
           "OPS"]

OPS = {}


class OpDef:
    """A registered operator.

    Attributes
    ----------
    name : canonical op name (e.g. 'broadcast_add')
    fn : compute function ``fn(*inputs, **params) -> out | tuple``
    num_outputs : int or callable(params)->int
    variadic : True if the op takes a variable number of tensor inputs
    needs_mode : fn takes a ``_training`` kwarg (dropout, BN, ...)
    needs_rng : fn takes a ``_rng`` kwarg (a ``torch.Generator``)
    num_aux : number of trailing inputs that are auxiliary states
        (rebound by the frontend, e.g. BatchNorm moving stats); when >0
        in training mode fn returns their updated values appended after
        the regular outputs.
    arg_names : names of tensor inputs
    differentiable : recorded by autograd
    """

    __slots__ = ("name", "fn", "num_outputs", "variadic", "needs_mode",
                 "needs_rng", "num_aux", "arg_names", "aux_names",
                 "differentiable", "param_defaults", "doc")

    def __init__(self, name, fn, num_outputs=1, variadic=False,
                 needs_mode=False, needs_rng=False, num_aux=0,
                 arg_names=None, aux_names=None, differentiable=True):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.variadic = variadic
        self.needs_mode = needs_mode
        self.needs_rng = needs_rng
        self.num_aux = num_aux
        self.aux_names = aux_names or []
        self.differentiable = differentiable
        self.doc = fn.__doc__ or ""
        sig = inspect.signature(fn)
        if arg_names is None and not variadic:
            arg_names = [p.name for p in sig.parameters.values()
                         if p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)
                         and p.default is p.empty
                         and not p.name.startswith("_")]
        self.arg_names = arg_names or []
        # static param defaults (kwargs of fn)
        self.param_defaults = {
            p.name: p.default for p in sig.parameters.values()
            if p.default is not p.empty and not p.name.startswith("_")}

    def n_outputs(self, params):
        if callable(self.num_outputs):
            return self.num_outputs(params)
        return self.num_outputs

    def __repr__(self):
        return f"OpDef({self.name})"


def defop(name, aliases=(), **attrs):
    """Decorator: register the function as op ``name``."""
    def _reg(fn):
        op = OpDef(name, fn, **attrs)
        if name in OPS:
            raise ValueError(f"op '{name}' registered twice")
        OPS[name] = op
        for a in aliases:
            if a in OPS:
                raise ValueError(f"op alias '{a}' registered twice")
            OPS[a] = op
        return fn
    return _reg


def alias(existing, *new_names):
    """Register additional Python-facing names for an existing op."""
    op = OPS[existing]
    for n in new_names:
        if n in OPS and OPS[n] is not op:
            raise ValueError(f"alias '{n}' conflicts")
        OPS[n] = op


def get_op(name):
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(f"unknown operator '{name}'") from None


def find_op(name):
    return OPS.get(name)


def list_ops():
    return sorted(OPS)
