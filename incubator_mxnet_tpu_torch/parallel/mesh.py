"""Named device meshes (twin of ``incubator_mxnet_tpu/parallel/mesh.py``).

The JAX package lays parameters and batches out over a
``jax.sharding.Mesh`` with the axes ``AXES`` = (dp, pp, sp, tp, ep),
outermost first, and lets XLA insert the collectives.  The port's mesh
is the same named grid over this process's devices (CUDA cards, or the
host when there is none).  On one card every axis has size 1, and a
sharding over it is the replicated placement: the step runs where the
card is.  A mesh over more than one device can be made but raises
where a step would place work on it (``Mesh.device``): the multi-card
modes (NCCL process groups, DTensor placements) are ROADMAP item A9.
"""
import contextlib

import numpy as np
import torch

from ..context import as_device

__all__ = ["AXES", "Mesh", "NamedSharding", "PartitionSpec", "P",
           "make_mesh", "current_mesh", "use_mesh", "named_sharding",
           "replicated", "shard_batch"]

AXES = ("dp", "pp", "sp", "tp", "ep")

_MULTI = ("a mesh over more than one device needs the multi-card modes "
          "(NCCL process groups and sharded placements), ROADMAP item A9")

_mesh_stack = []


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (or None), as ``jax.sharding.
    PartitionSpec``."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A named grid of devices: ``devices`` an array of torch.devices
    shaped by ``axis_names``; ``shape`` maps each axis to its size."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """The mesh's one device (raises for a larger mesh: A9)."""
        if self.size != 1:
            raise NotImplementedError(_MULTI)
        return self.devices.flat[0]

    def __repr__(self):
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({sizes}; {list(self.devices.flat)})"


class NamedSharding:
    """A placement over a mesh (``jax.sharding.NamedSharding``); on a
    one-device mesh every spec is the replicated placement."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        names = [a for s in self.spec if s is not None
                 for a in (s if isinstance(s, tuple) else (s,))]
        bad = [a for a in names if a not in mesh.axis_names]
        if bad:
            raise ValueError(f"axes {bad} are not in the mesh's "
                             f"{mesh.axis_names}")

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(dp=None, pp=1, sp=1, tp=1, ep=1, devices=None):
    """A named Mesh over this process's devices (default: every CUDA
    card, else the host).  ``dp=None`` means whatever is left: dp =
    n_devices / (pp*sp*tp*ep).  All five axes are always present."""
    devices = _devices() if devices is None \
        else [as_device(d) for d in devices]
    n = len(devices)
    model = pp * sp * tp * ep
    if dp is None:
        if n % model != 0:
            raise ValueError(
                f"{n} devices not divisible by pp*sp*tp*ep={model}")
        dp = n // model
    want = dp * model
    if want > n:
        raise ValueError(
            f"mesh {dp}x{pp}x{sp}x{tp}x{ep}={want} exceeds "
            f"{n} devices")
    grid = np.empty(want, dtype=object)
    grid[:] = devices[:want]
    return Mesh(grid.reshape(dp, pp, sp, tp, ep), AXES)


def current_mesh():
    """The innermost mesh installed by :func:`use_mesh` (or None)."""
    return _mesh_stack[-1] if _mesh_stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for trainers and the
    kvstore."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def named_sharding(mesh, *spec):
    """NamedSharding for ``spec`` (axis names / None per dimension)."""
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def shard_batch(mesh, ndim, batch_axis=0, seq_axis=None):
    """Sharding for a batch tensor: the batch dim over ('dp',),
    optionally a sequence dim over ('sp',)."""
    spec = [None] * ndim
    spec[batch_axis] = "dp"
    if seq_axis is not None:
        spec[seq_axis] = "sp"
    return NamedSharding(mesh, PartitionSpec(*spec))
