"""``nd.random`` namespace (twin of ``incubator_mxnet_tpu/ndarray/random.py``;
ref: python/mxnet/ndarray/random.py).  Each sampler draws from
``random.current_generator`` of the device it makes its result on
(``ctx``, default the card)."""
from ..ops.registry import get_op
from .ndarray import imperative_invoke

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]


def _call(name, kwargs):
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    out = kwargs.pop("out", None)
    return imperative_invoke(get_op(name), (), kwargs, out)


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None):
    return _call("_random_uniform", dict(low=low, high=high, shape=shape,
                                         dtype=dtype, ctx=ctx, out=out))


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None):
    return _call("_random_normal", dict(loc=loc, scale=scale, shape=shape,
                                        dtype=dtype, ctx=ctx, out=out))


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, out=None):
    return _call("_random_gamma", dict(alpha=alpha, beta=beta, shape=shape,
                                       dtype=dtype, ctx=ctx, out=out))


def exponential(lam=1, shape=(), dtype="float32", ctx=None, out=None):
    return _call("_random_exponential", dict(lam=lam, shape=shape,
                                             dtype=dtype, ctx=ctx, out=out))


def poisson(lam=1, shape=(), dtype="float32", ctx=None, out=None):
    return _call("_random_poisson", dict(lam=lam, shape=shape, dtype=dtype,
                                         ctx=ctx, out=out))


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                      out=None):
    return _call("_random_negative_binomial",
                 dict(k=k, p=p, shape=shape, dtype=dtype, ctx=ctx,
                      out=out))


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, out=None):
    return _call("_random_generalized_negative_binomial",
                 dict(mu=mu, alpha=alpha, shape=shape, dtype=dtype,
                      ctx=ctx, out=out))


def multinomial(data, shape=(), get_prob=False, dtype="int32", out=None):
    return imperative_invoke(get_op("_sample_multinomial"), (data,),
                             dict(shape=shape, get_prob=get_prob,
                                  dtype=dtype), out)


def shuffle(data, out=None):
    return imperative_invoke(get_op("_shuffle"), (data,), {}, out)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    return _call("_random_randint", dict(low=low, high=high, shape=shape,
                                         dtype=dtype, ctx=ctx, out=out))
