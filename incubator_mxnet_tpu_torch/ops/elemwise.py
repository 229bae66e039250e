"""Elementwise, scalar and comparison operators (twin of
``incubator_mxnet_tpu/ops/elemwise.py``): the same 116 names.

Each is one PyTorch call.  The JAX package left these to XLA, which
fuses them into their neighbours; no hand kernel is needed here either.
Comparisons return the left input's dtype, as in MXNet.
"""
import torch
import torch.nn.functional as F

from .registry import defop, alias


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# --------------------------------------------------------------------------
# unary math
# --------------------------------------------------------------------------
_UNARY = {
    "abs": torch.abs,
    "arccos": torch.arccos,
    "arccosh": torch.arccosh,
    "arcsin": torch.arcsin,
    "arcsinh": torch.arcsinh,
    "arctan": torch.arctan,
    "arctanh": torch.arctanh,
    "cbrt": _cbrt,
    "ceil": torch.ceil,
    "cos": torch.cos,
    "cosh": torch.cosh,
    "degrees": torch.rad2deg,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "fix": torch.trunc,
    "floor": torch.floor,
    "gammaln": torch.lgamma,
    "log": torch.log,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "negative": torch.negative,
    "radians": torch.deg2rad,
    "rint": torch.round,             # half to even, as jnp.rint
    "round": torch.round,            # half to even, as jnp.round
    "sign": torch.sign,
    "sin": torch.sin,
    "sinh": torch.sinh,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "tan": torch.tan,
    "tanh": torch.tanh,
    "trunc": torch.trunc,
    "reciprocal": lambda x: 1.0 / x,
    "rsqrt": torch.rsqrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "erf": torch.erf,
    "erfinv": torch.erfinv,
}


def _make_unary(name, f):
    def _op(data, _f=f):
        return _f(data)
    _op.__name__ = name
    _op.__doc__ = f"Elementwise {name}."
    return _op


for _n, _f in _UNARY.items():
    defop(_n)(_make_unary(_n, _f))


@defop("gamma")
def gamma(data):
    """Gamma function: exp(lgamma(x)), with the sign restored for
    negative non-integer x, where it alternates between poles."""
    sign = torch.where(data >= 0, 1.0,
                       1.0 - 2.0 * (torch.abs(torch.floor(data)) % 2))
    return sign.to(data.dtype) * torch.exp(torch.lgamma(data))


@defop("_copy", aliases=["identity"])
def _copy(data):
    """Identity / copy."""
    return data + 0


@defop("BlockGrad", aliases=["stop_gradient"])
def block_grad(data):
    """Identity forward, zero gradient."""
    return data.detach()


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward gives ``grad_scale`` whatever the
    incoming gradient, divided by the batch size (``"batch"``) or by the
    count of entries above ``valid_thresh`` (``"valid"``)."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(data)
        ctx.args = (grad_scale, valid_thresh, normalization)
        return data * 1.0

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.args
        if normalization == "batch":
            grad_scale = grad_scale / data.shape[0]
        grad = torch.full_like(data, grad_scale)
        if normalization == "valid":
            grad = grad / torch.clamp_min(
                (data > valid_thresh).to(data.dtype).sum(), 1.0)
        return grad, None, None, None


@defop("make_loss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Mark an output as a loss head: identity forward, and a backward
    that starts the gradient at ``grad_scale`` (the JAX package's
    ``contrib_misc.py`` gives its ``make_loss`` the same rule)."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _MakeLoss.apply(data, float(grad_scale),
                               float(valid_thresh), str(normalization))
    return data * 1.0


@defop("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """Smooth-L1."""
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


@defop("softrelu")
def softrelu(data):
    """log(1+exp(x))."""
    return F.softplus(data)


# --------------------------------------------------------------------------
# elementwise binary (same-shape) and broadcasting variants: torch
# broadcasts natively, so both families share one function
# --------------------------------------------------------------------------
_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": torch.remainder,          # floor mod, as jnp.mod
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
}

_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
}


def _make_binary(name, f, cmp=False):
    def _op(lhs, rhs, _f=f, _cmp=cmp):
        out = _f(lhs, rhs)
        if _cmp:
            out = out.to(lhs.dtype)
        return out
    _op.__name__ = name
    _op.__doc__ = f"Elementwise/broadcast {name}."
    return _op


for _n, _f in _BINARY.items():
    defop("broadcast_" + _n)(_make_binary("broadcast_" + _n, _f))
for _n, _f in _CMP.items():
    defop("broadcast_" + _n)(_make_binary("broadcast_" + _n, _f, cmp=True))
    defop("_" + _n)(_make_binary("_" + _n, _f, cmp=True))

alias("broadcast_add", "elemwise_add", "_add", "_plus", "broadcast_plus")
alias("broadcast_sub", "elemwise_sub", "_sub", "_minus", "broadcast_minus")
alias("broadcast_mul", "elemwise_mul", "_mul")
alias("broadcast_div", "elemwise_div", "_div")
alias("broadcast_mod", "_mod")
alias("broadcast_power", "_power")
alias("broadcast_maximum", "_maximum", "maximum")
alias("broadcast_minimum", "_minimum", "minimum")
alias("broadcast_hypot", "_hypot")


@defop("elemwise_addto", differentiable=False)
def elemwise_addto(lhs, rhs):
    """In-place accumulate helper (kAddTo analog)."""
    return lhs + rhs


# --------------------------------------------------------------------------
# scalar family
# --------------------------------------------------------------------------
def _as(x, s):
    return torch.as_tensor(s, dtype=x.dtype, device=x.device)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_as(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.clamp_min(x, s),
    "_minimum_scalar": lambda x, s: torch.clamp_max(x, s),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _as(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
}


def _make_scalar(name, f):
    def _op(data, scalar=1.0, _f=f):
        return _f(data, scalar)
    _op.__name__ = name
    _op.__doc__ = f"Scalar op {name}."
    return _op


for _n, _f in _SCALAR.items():
    defop(_n)(_make_scalar(_n, _f))


# logical
@defop("logical_not")
def logical_not(data):
    return (data == 0).to(data.dtype)


for _n, _f in {"logical_and": torch.logical_and,
               "logical_or": torch.logical_or,
               "logical_xor": torch.logical_xor}.items():
    defop("broadcast_" + _n)(_make_binary("broadcast_" + _n, _f, cmp=True))


# --------------------------------------------------------------------------
# n-ary
# --------------------------------------------------------------------------
@defop("add_n", aliases=["ElementWiseSum", "_sparse_ElementWiseSum",
                         "_sparse_add_n"], variadic=True)
def add_n(*args):
    """Sum of N tensors."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
