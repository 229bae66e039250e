"""Seeding, random sources and the samplers (twin of
``incubator_mxnet_tpu/random.py`` and ``random_state.py``).

Whatever samples in the port takes an explicit ``torch.Generator``.
``seed(n)`` resets the package's default generators (one per device),
which samplers use when the caller passes none; torch's own global
generator is never drawn from.  ``key_provider(generator)`` makes one
generator the source of the random masks (dropout) drawn inside its
scope, the role ``random_state.key_provider(rng)`` plays around the JAX
package's ``PureBlock.apply``.  The numbers differ from JAX's threefry
keys for the same seed: the tests make their inputs with numpy and
hand them to both packages.

The samplers (``uniform``, ``normal``, ..., ``randint``) are
``nd.random``'s, each drawing from ``current_generator`` of the device
it makes its result on.
"""
import contextlib
import threading

import torch

from .context import as_device

__all__ = ["seed", "generator", "default_generator", "key_provider",
           "current_generator", "uniform", "normal", "gamma", "exponential",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]

_DEFAULT = torch.Generator()
_DEVICE_DEFAULTS = {}     # torch.device -> generator, made at first use
_SCOPES = threading.local()


def seed(seed_state):
    """Seed the package's default generators (the CPU's and every
    device's) with ``seed_state``."""
    _DEFAULT.manual_seed(int(seed_state))
    for gen in _DEVICE_DEFAULTS.values():
        gen.manual_seed(int(seed_state))


def default_generator(device="cpu"):
    """The package's default generator on ``device``; a device's is
    made at first use, seeded like the CPU's."""
    device = as_device(device)
    if device.type == "cpu":
        return _DEFAULT
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = _DEVICE_DEFAULTS.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_DEFAULT.initial_seed())
        _DEVICE_DEFAULTS[device] = gen
    return gen


def generator(seed_state, device="cpu"):
    """A new generator on ``device``, seeded with ``seed_state``."""
    g = torch.Generator(device=as_device(device))
    g.manual_seed(int(seed_state))
    return g


def _stack():
    if not hasattr(_SCOPES, "stack"):
        _SCOPES.stack = []
    return _SCOPES.stack


@contextlib.contextmanager
def key_provider(gen):
    """Within the scope (of this thread), random masks draw from
    ``gen``, which must lie on the device of the tensors they mask."""
    stack = _stack()
    stack.append(gen)
    try:
        yield gen
    finally:
        stack.pop()


def current_generator(device):
    """The innermost ``key_provider``'s generator, else the package's
    default generator on ``device``."""
    stack = _stack()
    return stack[-1] if stack else default_generator(device)


# the samplers: last, since nd imports this module for its generators
from .ndarray.random import (uniform, normal, gamma, exponential,  # noqa: E402,F401
                             poisson, negative_binomial,
                             generalized_negative_binomial, multinomial,
                             shuffle, randint)
