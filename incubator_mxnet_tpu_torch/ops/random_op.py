"""Random sampling ops (twin of ``incubator_mxnet_tpu/ops/random_op.py``;
ref: src/operator/random/sample_op.cc, multisample_op.cc,
sample_multinomial_op.cc): its 26 names, aliases counted.

Every op draws from the ``torch.Generator`` it is handed as ``_rng``:
``nd`` hands it ``random.current_generator(device)`` (the innermost
``key_provider``'s, else the package's default generator of the
device), a bound graph one generator per random node, seeded from the
forward's seed (``executor.build_graph_fn``).  torch's global generator
is never drawn from.  The parameterisations are the JAX package's:
``gamma`` is ``beta * Gamma(alpha)``, ``exponential`` is
``Exp(1) / lam``, and the two negative binomials are gamma-Poisson
mixtures.  The draws are torch's, not JAX's threefry, so the two
packages agree in distribution, never by value.

Shape inference runs an op on ``meta`` tensors with ``_rng=None``: it
then returns an empty tensor of the output's shape and dtype.
"""
import torch

from ..base import torch_dtype
from .registry import defop


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dt(dtype):
    return torch_dtype(dtype if dtype not in (None, "None") else "float32")


def _device(ctx):
    return torch.device("cpu") if ctx is None else torch.device(ctx)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one per entry of the float tensor
    ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


@defop("_random_uniform", aliases=["uniform", "random_uniform"],
       needs_rng=True, differentiable=False)
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
                   _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    u = torch.rand(s, generator=_rng, dtype=dt, device=dev)
    return low + u * (high - low)


@defop("_random_normal", aliases=["normal", "random_normal"],
       needs_rng=True, differentiable=False)
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
                  _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    return loc + scale * torch.randn(s, generator=_rng, dtype=dt,
                                     device=dev)


@defop("_random_gamma", aliases=["random_gamma"], needs_rng=True,
       differentiable=False)
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
                 _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    return beta * _gamma(torch.full(s, float(alpha), dtype=dt, device=dev),
                         _rng)


@defop("_random_exponential", aliases=["random_exponential"],
       needs_rng=True, differentiable=False)
def random_exponential(lam=1.0, shape=(), dtype="float32", ctx=None,
                       _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    out = torch.empty(s, dtype=dt, device=dev)
    if _rng is None:
        return out
    return out.exponential_(1.0, generator=_rng) / lam


@defop("_random_poisson", aliases=["random_poisson"], needs_rng=True,
       differentiable=False)
def random_poisson(lam=1.0, shape=(), dtype="float32", ctx=None, _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    rate = torch.full(s, float(lam), dtype=torch.float32, device=dev)
    return torch.poisson(rate, generator=_rng).to(dt)


def _gamma_poisson(r, scale, s, dt, dev, gen):
    """Poisson(Gamma(r) * scale): the negative binomials' mixture."""
    lam = _gamma(torch.full(s, float(r), dtype=torch.float32, device=dev),
                 gen) * scale
    return torch.poisson(lam, generator=gen).to(dt)


@defop("_random_negative_binomial", aliases=["random_negative_binomial"],
       needs_rng=True, differentiable=False)
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                             ctx=None, _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    return _gamma_poisson(k, (1 - p) / p, s, dt, dev, _rng)


@defop("_random_generalized_negative_binomial",
       aliases=["random_generalized_negative_binomial"], needs_rng=True,
       differentiable=False)
def random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32",
                            ctx=None, _rng=None):
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    r = 1.0 / alpha
    p = r / (r + mu)
    return _gamma_poisson(r, (1 - p) / p, s, dt, dev, _rng)


# tensor-parameter multisample variants (ref: multisample_op.cc): the
# output is the parameters' shape followed by ``shape``
def _ext(t, shape):
    return t.reshape(tuple(t.shape) + (1,) * len(_shape(shape)))


@defop("_sample_uniform", needs_rng=True, differentiable=False)
def sample_uniform(low, high, shape=(), dtype="float32", _rng=None):
    s = tuple(low.shape) + _shape(shape)
    if _rng is None:
        return torch.empty(s, dtype=_dt(dtype), device=low.device)
    u = torch.rand(s, generator=_rng, dtype=_dt(dtype), device=low.device)
    return _ext(low, shape) + u * _ext(high - low, shape)


@defop("_sample_normal", needs_rng=True, differentiable=False)
def sample_normal(mu, sigma, shape=(), dtype="float32", _rng=None):
    s = tuple(mu.shape) + _shape(shape)
    if _rng is None:
        return torch.empty(s, dtype=_dt(dtype), device=mu.device)
    z = torch.randn(s, generator=_rng, dtype=_dt(dtype), device=mu.device)
    return _ext(mu, shape) + z * _ext(sigma, shape)


@defop("_sample_gamma", needs_rng=True, differentiable=False)
def sample_gamma(alpha, beta, shape=(), dtype="float32", _rng=None):
    s = tuple(alpha.shape) + _shape(shape)
    dt = _dt(dtype)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=alpha.device)
    a = _ext(alpha, shape).to(dt).expand(s).contiguous()
    return _gamma(a, _rng) * _ext(beta, shape)


@defop("_sample_exponential", needs_rng=True, differentiable=False)
def sample_exponential(lam, shape=(), dtype="float32", _rng=None):
    s = tuple(lam.shape) + _shape(shape)
    out = torch.empty(s, dtype=_dt(dtype), device=lam.device)
    if _rng is None:
        return out
    return out.exponential_(1.0, generator=_rng) / _ext(lam, shape)


@defop("_sample_poisson", needs_rng=True, differentiable=False)
def sample_poisson(lam, shape=(), dtype="float32", _rng=None):
    s = tuple(lam.shape) + _shape(shape)
    if _rng is None:
        return torch.empty(s, dtype=_dt(dtype), device=lam.device)
    rate = _ext(lam, shape).float().expand(s).contiguous()
    return torch.poisson(rate, generator=_rng).to(_dt(dtype))


@defop("_sample_multinomial", aliases=["sample_multinomial"],
       needs_rng=True, differentiable=False,
       num_outputs=lambda p: 2 if p.get("get_prob") else 1)
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                       _rng=None):
    """Draw class indices from probability rows (ref:
    sample_multinomial_op.cc): each row of ``data`` (its last axis)
    is normalised, and ``shape`` draws are made from it; with
    ``get_prob`` also each draw's log-probability (float32)."""
    n = _shape(shape)
    count = 1
    for s in n:
        count *= s
    out_shape = tuple(data.shape[:-1]) + n
    K = data.shape[-1]
    if _rng is None:
        idx = torch.empty(out_shape, dtype=_dt(dtype), device=data.device)
        return (idx, torch.empty(out_shape, device=data.device)) \
            if get_prob else idx
    rows = data.reshape(-1, K).float().clamp_min(1e-30)
    draws = torch.multinomial(rows, max(count, 1), replacement=True,
                              generator=_rng)
    idx = draws.reshape(out_shape).to(_dt(dtype))
    if get_prob:
        logp = torch.log_softmax(rows.log(), dim=-1).gather(1, draws)
        return idx, logp.reshape(out_shape)
    return idx


@defop("_shuffle", aliases=["shuffle"], needs_rng=True,
       differentiable=False)
def shuffle(data, _rng=None):
    """The rows of ``data`` (its first axis) in a random order."""
    if _rng is None:
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=_rng, device=data.device)
    return data[perm]


@defop("_random_randint", needs_rng=True, differentiable=False)
def random_randint(low=0, high=1, shape=(), dtype="int32", ctx=None,
                   _rng=None):
    """Uniform integers in [low, high)."""
    s, dt, dev = _shape(shape), _dt(dtype), _device(ctx)
    if _rng is None:
        return torch.empty(s, dtype=dt, device=dev)
    return torch.randint(int(low), int(high), s, generator=_rng,
                         device=dev).to(dt)
