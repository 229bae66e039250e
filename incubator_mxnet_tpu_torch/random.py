"""Seeding (twin of ``incubator_mxnet_tpu/random.py`` and
``random_state.py``).

Whatever samples in the port takes an explicit ``torch.Generator``.
``seed(n)`` resets the package's default generator, which samplers
use when the caller passes none.  Its numbers differ from JAX's
threefry keys for the same seed: the tests make their inputs with
numpy and hand them to both packages.
"""
import torch

__all__ = ["seed", "generator", "default_generator"]

_DEFAULT = torch.Generator()


def seed(seed_state):
    """Seed the package's default (CPU) generator."""
    _DEFAULT.manual_seed(int(seed_state))


def default_generator():
    return _DEFAULT


def generator(seed_state, device="cpu"):
    """A new generator on ``device``, seeded with ``seed_state``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_state))
    return g
