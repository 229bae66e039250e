"""Named device meshes (twin of ``incubator_mxnet_tpu/parallel/mesh.py``).

The JAX package lays parameters and batches out over a
``jax.sharding.Mesh`` with the axes ``AXES`` = (dp, pp, sp, tp, ep),
outermost first, and lets XLA insert the collectives.  The port's mesh
is the same named grid, with one device per process: over a
``torch.distributed`` world of several ranks (``dist.init``) the grid
holds the world's ranks in order (rank r at row-major position r), each
rank computing on its own device (``dist.rank_device``), and the mesh's
``device_mesh()`` is the ``torch.distributed.device_mesh.DeviceMesh``
over its axes of size > 1: DTensor placements and the per-axis process
groups (``group(axis)``) come from it.  A one-device mesh is the
replicated placement on that device.  A grid over several devices in
one process can be made for the layout arithmetic (``shard_bounds``,
``devices_indices_map``) but places nothing (``Mesh.device`` raises):
one process drives one device.  A mesh with ``sp``, ``pp`` or ``ep``
above 1 raises: sequence, pipeline and expert parallelism are ROADMAP
item A9b.
"""
import contextlib
import sys

import numpy as np
import torch

from ..context import as_device

__all__ = ["AXES", "Mesh", "NamedSharding", "PartitionSpec", "P",
           "make_mesh", "current_mesh", "use_mesh", "named_sharding",
           "replicated", "shard_batch"]

AXES = ("dp", "pp", "sp", "tp", "ep")

_A9B = ("a mesh with {axis}={n}: sequence, pipeline and expert "
        "parallelism are ROADMAP item A9b")

_mesh_stack = []


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (or None), as ``jax.sharding.
    PartitionSpec``."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _world():
    """(rank, world size) of the joined process group, or (0, 1)."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return (torch.distributed.get_rank(),
                torch.distributed.get_world_size())
    return 0, 1


class Mesh:
    """A named grid of devices: ``devices`` an array of torch.devices
    shaped by ``axis_names``, ``ids`` the same-shaped array of their
    ids (a world mesh's ranks; 0..n-1 for a mesh in one process);
    ``shape`` maps each axis to its size."""

    def __init__(self, devices, axis_names, ids=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.ids = np.arange(self.devices.size).reshape(
            self.devices.shape) if ids is None else np.asarray(ids)
        _, world = _world()
        # a mesh over the joined world: one device per rank
        self.spans_world = self.size > 1 and self.size == world
        self._device_mesh = None

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """This process's device of the mesh (raises for a grid over
        several devices in one process)."""
        if self.size == 1:
            return self.devices.flat[0]
        if not self.spans_world:
            raise NotImplementedError(
                f"a mesh of {self.size} devices in one process places "
                "nothing: one process drives one device (join a world of "
                f"{self.size} ranks with dist.init, one device a rank)")
        return self.devices.flat[self.local_ids()[0]]

    def local_ids(self):
        """The device ids this process hosts."""
        if self.spans_world:
            return [_world()[0]]
        return [int(i) for i in self.ids.flat]

    def coord(self, dev_id):
        """{axis: index} of the device with id ``dev_id``."""
        pos = np.argwhere(self.ids == dev_id)
        if not len(pos):
            raise ValueError(f"device {dev_id} is not in {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in pos[0])))

    def active_axes(self):
        """The axes of size > 1, in mesh order (the DeviceMesh's)."""
        return tuple(a for a in self.axis_names if self.shape[a] > 1)

    def device_mesh(self):
        """The DeviceMesh over the active axes (built once, by every
        rank: its per-axis groups are collective to make); None for a
        one-device mesh."""
        if not self.active_axes():
            return None
        if self._device_mesh is None:
            if not self.spans_world:
                raise NotImplementedError(
                    "a DeviceMesh needs a world of one rank per device "
                    f"(this mesh has {self.size} devices in one process)")
            from torch.distributed.device_mesh import DeviceMesh
            axes = self.active_axes()
            grid = self.ids.reshape([self.shape[a] for a in axes])
            self._device_mesh = DeviceMesh(
                self.device.type, torch.as_tensor(grid.astype(np.int64)),
                mesh_dim_names=axes)
        return self._device_mesh

    def group(self, axis):
        """The process group of this rank's line along ``axis``; None
        for an axis of size 1 (nothing to communicate)."""
        if self.shape.get(axis, 1) <= 1:
            return None
        return self.device_mesh().get_group(axis)

    def __repr__(self):
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({sizes}; {list(self.devices.flat)})"


class NamedSharding:
    """A placement of an array over a mesh, by a PartitionSpec
    (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        bad = [a for a in self._named() if a not in mesh.axis_names]
        if bad:
            raise ValueError(f"axes {bad} are not in the mesh's "
                             f"{mesh.axis_names}")

    def _named(self):
        return [a for s in self.spec if s is not None
                for a in (s if isinstance(s, tuple) else (s,))]

    def is_replicated_everywhere(self):
        """True when no dim is split over an axis of size > 1."""
        return all(self.mesh.shape[a] == 1 for a in self._named())

    def _dim_axes(self, el):
        if el is None:
            return ()
        return el if isinstance(el, tuple) else (el,)

    def index_for(self, dev_id, shape):
        """The tuple of slices device ``dev_id`` holds of an array of
        ``shape`` (as ``devices_indices_map``'s values)."""
        coord = self.mesh.coord(dev_id)
        idx = []
        for d, dim in enumerate(shape):
            el = self.spec[d] if d < len(self.spec) else None
            axes = self._dim_axes(el)
            n, pos = 1, 0
            for a in axes:
                n *= self.mesh.shape[a]
                pos = pos * self.mesh.shape[a] + coord[a]
            if n == 1:
                idx.append(slice(None))
                continue
            if dim % n:
                raise ValueError(
                    f"dim {d} of size {dim} does not split evenly over "
                    f"{axes} ({n} shards)")
            step = dim // n
            idx.append(slice(pos * step, (pos + 1) * step))
        return tuple(idx)

    def devices_indices_map(self, shape):
        """{device id: tuple of slices} for an array of ``shape``."""
        shape = tuple(int(d) for d in shape)
        return {int(i): self.index_for(int(i), shape)
                for i in self.mesh.ids.flat}

    def placements(self):
        """DTensor placements over ``mesh.device_mesh()``'s dims: for
        each active axis, ``Shard(d)`` where dim d names it, else
        ``Replicate()``.  A dim over several axes must name them in
        mesh order (DTensor splits the outer mesh dim first)."""
        from torch.distributed.tensor import Replicate, Shard
        out = {a: Replicate() for a in self.mesh.active_axes()}
        order = {a: i for i, a in enumerate(self.mesh.axis_names)}
        for d, el in enumerate(self.spec):
            axes = [a for a in self._dim_axes(el)
                    if self.mesh.shape[a] > 1]
            if [order[a] for a in axes] != sorted(order[a] for a in axes):
                raise ValueError(
                    f"spec {self.spec}: dim {d} names {axes} out of the "
                    f"mesh's order {self.mesh.axis_names}")
            for a in axes:
                out[a] = Shard(d)
        return [out[a] for a in self.mesh.active_axes()]

    def place(self, tensor):
        """This rank's layout of ``tensor`` (the whole array, the same
        on every rank): a DTensor of its slice on ``mesh.device_mesh()``,
        or the tensor itself where the spec splits nothing."""
        if self.is_replicated_everywhere():
            return tensor
        from torch.distributed.tensor import DTensor
        local = tensor[self.index_for(self.mesh.local_ids()[0],
                                      tuple(tensor.shape))]
        return DTensor.from_local(
            local.detach().clone().contiguous(), self.mesh.device_mesh(),
            self.placements(), run_check=False,
            shape=tensor.shape, stride=tensor.stride())

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def is_dtensor(t):
    """Whether ``t`` is a DTensor, without importing DTensor (~1 s) in a
    process that never made one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def spec_of(leaf, mesh):
    """The PartitionSpec of a DTensor laid out on ``mesh``'s DeviceMesh
    (None for any other tensor: it is replicated)."""
    if not is_dtensor(leaf):
        return None
    names = leaf.device_mesh.mesh_dim_names
    if mesh.active_axes() != tuple(names or ()):
        raise ValueError(f"a DTensor on mesh dims {names} is not laid out "
                         f"on {mesh!r}")
    dims = [[] for _ in range(leaf.ndim)]
    for axis, pl in zip(names, leaf.placements):
        if pl.is_shard():
            dims[pl.dim % leaf.ndim].append(axis)
    return PartitionSpec(*[None if not a else a[0] if len(a) == 1
                           else tuple(a) for a in dims])


def _devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(dp=None, pp=1, sp=1, tp=1, ep=1, devices=None):
    """A named Mesh.  In a joined world of several ranks (and no
    ``devices``): over the world's ranks, each on ``dist.rank_device``.
    Otherwise over this process's devices (default: every CUDA card,
    else the host).  ``dp=None`` means whatever is left: dp = n /
    (pp*sp*tp*ep).  All five axes are always present; sp, pp or ep above
    1 raise (A9b)."""
    _, world = _world()
    ids = None
    if devices is None and world > 1:
        from .. import dist
        devices = [dist.rank_device(r) for r in range(world)]
        ids = list(range(world))
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
    for axis, size in (("pp", pp), ("sp", sp), ("ep", ep)):
        if size > 1:
            raise NotImplementedError(_A9B.format(axis=axis, n=size))
    if ids is not None and want != n:
        raise ValueError(f"a world mesh spans every rank: {want} of "
                         f"{n} ranks")
    grid = np.empty(want, dtype=object)
    grid[:] = devices[:want]
    shape = (dp, pp, sp, tp, ep)
    return Mesh(grid.reshape(shape), AXES,
                None if ids is None else np.asarray(ids).reshape(shape))


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
