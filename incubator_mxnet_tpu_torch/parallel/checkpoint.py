"""Sharded, reshardable checkpoints with a manifest (twin of
``incubator_mxnet_tpu/parallel/checkpoint.py``; the format is the JAX
package's, so a generation written by either package loads in the
other).

- **Sharded save**: each rank writes only the slices it owns (one file
  per owner device, ``resilience.atomic_save`` with its CRC32 sidecar),
  so a save costs O(params/world) a rank.
- **Manifest**: the process hosting the mesh's lowest device id writes
  ``manifest.json`` last (the commit marker): the mesh's axes and shape,
  each leaf's PartitionSpec, global shape and dtype, its slice -> file
  map, the step, and the data companion's name.  Leaf keys are the JAX
  package's ``keystr`` paths (``['params']['w']``), dict keys sorted.
- **Reshard on load**: a manifest restores onto another mesh (dp x tp
  reshaped, the world shrunk or grown): each destination slice is
  assembled from the recorded source slices it intersects
  (``sharding.intersect_bounds``), reading only those shard files.
- **Generations and fallback**: saves land in ``gen-<step>/``; a
  corrupt shard or manifest fails its generation and the loader falls
  back to the newest valid one; ``MXTPU_CKPT_KEEP`` generations stay.

A leaf is a torch tensor: a DTensor on the mesh's ``DeviceMesh`` is
laid out by its placements (``mesh.spec_of``), any other tensor (or
numpy array) is replicated.  Shard payloads are pickled dicts of numpy
arrays, as the JAX package writes them.  In a world of several ranks
every rank calls with the same tree; the ranks order their writes with
``dist.barrier`` (under the collective deadline).

Fault injection: ``checkpoint:shard:<nth>:truncate|corrupt|error``
damages (or fails) the nth shard-file write.
"""
import json
import os
import pickle
import shutil

import numpy as np
import torch

from .. import resilience, telemetry, tracing
from ..utils.env import get_env
from .mesh import NamedSharding, is_dtensor, spec_of
from .sharding import (bounds_of, intersect_bounds, shard_bounds,
                       spec_to_json)

__all__ = ["save_sharded", "load_sharded", "load_latest",
           "generations", "load_data_companion", "FORMAT"]

FORMAT = "mxtpu-sharded-v1"

_MANIFEST = "manifest.json"
_DATA_COMPANION = "data.pkl"


# ---------------------------------------------------------------------
# leaf flattening: the JAX package's keystr paths
# ---------------------------------------------------------------------


def _flatten(tree, prefix=""):
    """(key, leaf) pairs with JAX ``keystr`` paths: dict keys sorted,
    sequence items by index; None and empty containers hold no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(tree, values, prefix=""):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return values[prefix]


def _dtype_name(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _shape(leaf):
    return tuple(int(d) for d in np.shape(leaf)) \
        if not isinstance(leaf, torch.Tensor) else \
        tuple(int(d) for d in leaf.shape)


def _local_np(leaf):
    """This rank's data of a leaf, as numpy."""
    if is_dtensor(leaf):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _named_sharding_for(leaf, mesh):
    """The leaf's NamedSharding when it is a DTensor laid out on
    ``mesh``; None otherwise (replicated)."""
    spec = spec_of(leaf, mesh)
    return None if spec is None else NamedSharding(mesh, spec)


def _full_bounds(shape):
    return tuple((0, int(d)) for d in shape)


def _rel_index(bounds, base):
    """Numpy index of ``bounds`` relative to a block starting at
    ``base``'s lower corners."""
    return tuple(slice(lo - b0, hi - b0)
                 for (lo, hi), (b0, _) in zip(bounds, base))


# ---------------------------------------------------------------------
# save
# ---------------------------------------------------------------------


def _shard_file(owner_id):
    return f"shard-{owner_id:05d}.pkl"


def _is_writer(mesh):
    """Whether this process hosts the mesh's lowest device id (the
    writer of the manifest, the data companion and replicated
    leaves)."""
    return int(mesh.ids.min()) in mesh.local_ids()


def save_sharded(ckpt_dir, tree, mesh, step=None, data_state=None,
                 extra=None, keep=None):
    """Write one checkpoint generation of ``tree`` under
    ``ckpt_dir/gen-<step>/``; returns the generation directory.

    ``tree`` is a nest of dicts/lists of tensors (params, states,
    optimizer state, counters).  A DTensor leaf saves one entry per
    unique slice, written by the slice's owner (its lowest rank); any
    other leaf saves as one replicated slice.  ``step`` defaults to one
    past the newest generation; ``data_state`` (an input iterator's
    ``state_dict()``) is pickled beside the shards; ``keep`` bounds the
    kept generations (default ``MXTPU_CKPT_KEEP``)."""
    with telemetry.span("checkpoint_save"):
        return _save_sharded(ckpt_dir, tree, mesh, step, data_state,
                             extra, keep)


def _save_sharded(ckpt_dir, tree, mesh, step, data_state, extra, keep):
    from .. import dist
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    if step is None:
        gens = generations(ckpt_dir, require_valid=False)
        step = (gens[0] + 1) if gens else 0
    gen_dir = os.path.join(ckpt_dir, f"gen-{int(step):08d}")
    os.makedirs(gen_dir, exist_ok=True)
    mine = set(mesh.local_ids())
    min_dev = int(mesh.ids.min())
    writer = _is_writer(mesh)

    # re-saving a step: uncommit the old generation (its manifest goes
    # before any shard is replaced), so no crash pairs the old manifest
    # with a mix of old and new shard files
    if writer:
        for stale in (_MANIFEST, resilience.checksum_path(_MANIFEST)):
            try:
                os.unlink(os.path.join(gen_dir, stale))
            except FileNotFoundError:
                pass
    _sync_processes(mesh, "mxtpu_ckpt_uncommit")

    files = {}          # owner id -> {slice name: numpy array}
    leaves = {}
    for key, leaf in _flatten(tree):
        sh = _named_sharding_for(leaf, mesh)
        shape = _shape(leaf)
        spec = spec_to_json(sh.spec) if sh is not None \
            else [None] * len(shape)
        slices = []
        if sh is None:
            bounds = _full_bounds(shape)
            name = f"{key}#0"
            slices.append({"lo": [b[0] for b in bounds],
                           "hi": [b[1] for b in bounds],
                           "file": _shard_file(min_dev), "name": name})
            if min_dev in mine:
                files.setdefault(min_dev, {})[name] = _local_np(leaf)
        else:
            for i, (bounds, devs) in enumerate(
                    sorted(shard_bounds(sh, shape).items())):
                owner = devs[0]
                name = f"{key}#{i}"
                slices.append({"lo": [b[0] for b in bounds],
                               "hi": [b[1] for b in bounds],
                               "file": _shard_file(owner), "name": name})
                if owner in mine:
                    files.setdefault(owner, {})[name] = _local_np(leaf)
        leaves[key] = {"shape": list(shape), "dtype": _dtype_name(leaf),
                       "spec": spec, "slices": slices}

    for owner_id, payload in sorted(files.items()):
        kind = resilience.inject("checkpoint", "shard")
        path = os.path.join(gen_dir, _shard_file(owner_id))
        resilience.atomic_save(
            path, lambda f, p=payload: pickle.dump(p, f, protocol=4))
        if kind in ("truncate", "corrupt"):
            # the damage lands on the committed file, after its sidecar
            # was written from the healthy bytes
            resilience.damage_file(path, kind)
        telemetry.counter("checkpoint_shard_saved_total").inc()

    data_ref = None
    if data_state is not None:
        if writer:
            resilience.atomic_save(
                os.path.join(gen_dir, _DATA_COMPANION),
                lambda f: pickle.dump(data_state, f, protocol=4))
        data_ref = _DATA_COMPANION

    # the manifest goes last across the whole world: every rank's shard
    # files are in place before it commits
    _sync_processes(mesh, "mxtpu_ckpt_shards")
    if writer:
        manifest = {
            "format": FORMAT,
            "step": int(step),
            "mesh": {"axes": list(mesh.axis_names),
                     "shape": [int(mesh.shape[a])
                               for a in mesh.axis_names]},
            "world": {"processes": int(dist.num_workers()),
                      "devices": int(mesh.size),
                      "generation": int(os.environ.get(
                          "MXTPU_WORLD_GENERATION", "0") or 0)},
            "leaves": leaves,
            "data": data_ref,
            "extra": extra or {},
        }
        resilience.atomic_write_bytes(
            os.path.join(gen_dir, _MANIFEST),
            json.dumps(manifest, indent=1, sort_keys=True).encode())
        _prune(ckpt_dir, keep)
    # no rank returns (and reads) before the manifest is committed
    _sync_processes(mesh, "mxtpu_ckpt_commit")
    return gen_dir


def _sync_processes(mesh, tag):
    """Cross-process ordering point of a save over a world mesh (a no-op
    in one process), under the collective deadline."""
    if mesh.spans_world:
        from .. import dist
        dist.barrier(tag)


def _prune(ckpt_dir, keep):
    keep = int(keep if keep is not None else get_env("MXTPU_CKPT_KEEP"))
    if keep <= 0:
        return
    valid = generations(ckpt_dir)
    for step in valid[keep:]:
        shutil.rmtree(os.path.join(ckpt_dir, f"gen-{step:08d}"),
                      ignore_errors=True)
    # uncommitted generations older than the newest valid one (a save
    # killed before its manifest) still hold shard bytes: sweep them
    if valid:
        stale = set(generations(ckpt_dir, require_valid=False)) \
            - set(valid)
        for step in stale:
            if step < valid[0]:
                shutil.rmtree(
                    os.path.join(ckpt_dir, f"gen-{step:08d}"),
                    ignore_errors=True)


# ---------------------------------------------------------------------
# load
# ---------------------------------------------------------------------


def generations(ckpt_dir, require_valid=True):
    """Generation steps under ``ckpt_dir``, newest first; with
    ``require_valid`` only those whose manifest passes its CRC
    sidecar."""
    out = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return out
    for name in names:
        if not name.startswith("gen-"):
            continue
        stem = name[len("gen-"):]
        if not stem.isdigit():
            continue
        if require_valid:
            man = os.path.join(ckpt_dir, name, _MANIFEST)
            if not resilience.verify_checkpoint(man):
                continue
        out.append(int(stem))
    return sorted(out, reverse=True)


def _read_manifest(gen_dir):
    raw = resilience.read_validated_bytes(
        os.path.join(gen_dir, _MANIFEST))
    manifest = resilience.decode_or_corrupt(
        os.path.join(gen_dir, _MANIFEST), lambda: json.loads(raw))
    if manifest.get("format") != FORMAT:
        raise resilience.CheckpointCorruptError(
            f"{gen_dir}: unknown sharded-checkpoint format "
            f"{manifest.get('format')!r} (want {FORMAT})")
    return manifest


class _ShardReader:
    """Validated, cached access to a generation's shard files: each
    file is CRC-checked and unpickled once, and only the files the
    requested slices name are read."""

    def __init__(self, gen_dir):
        self.gen_dir = gen_dir
        self._cache = {}

    def slice_array(self, slc):
        fname = slc["file"]
        if fname not in self._cache:
            path = os.path.join(self.gen_dir, fname)
            raw = resilience.read_validated_bytes(path)
            self._cache[fname] = resilience.decode_or_corrupt(
                path, lambda: pickle.loads(raw))
        payload = self._cache[fname]
        if slc["name"] not in payload:
            raise resilience.CheckpointCorruptError(
                f"{self.gen_dir}/{fname}: missing slice "
                f"{slc['name']!r} (manifest/shard mismatch)")
        return payload[slc["name"]]


def _assemble_block(entry, reader, bounds, shape, dtype):
    """One destination slice, from the source slices it intersects."""
    block = np.empty([hi - lo for lo, hi in bounds], dtype)
    covered = 0
    for slc in entry["slices"]:
        src_b = tuple(zip(slc["lo"], slc["hi"]))
        inter = intersect_bounds(src_b, bounds)
        if inter is None:
            continue
        src = reader.slice_array(slc)
        if not bounds:          # 0-d leaf
            return np.asarray(src, dtype)
        block[_rel_index(inter, bounds)] = src[_rel_index(inter, src_b)]
        covered += int(np.prod([hi - lo for lo, hi in inter]))
    want = int(np.prod([hi - lo for lo, hi in bounds])) if bounds else 1
    if covered < want:
        raise resilience.CheckpointCorruptError(
            f"slice coverage hole restoring a leaf of shape {shape}: "
            f"{covered}/{want} elements — source and destination "
            "partitions disagree on the global shape")
    return block


def _assemble_leaf(entry, reader, leaf, mesh, shape, dtype):
    """The destination leaf in ``leaf``'s layout: this rank's slice of
    a DTensor target (a DTensor with its placements), the whole array
    of any other."""
    sh = _named_sharding_for(leaf, mesh)
    if sh is None:
        block = _assemble_block(entry, reader, _full_bounds(shape),
                                shape, dtype)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(block, order="C")).to(
                leaf.device)
        return block
    bounds = bounds_of(sh.index_for(mesh.local_ids()[0], shape), shape)
    block = _assemble_block(entry, reader, bounds, shape, dtype)
    local = torch.from_numpy(np.array(block, order="C")).to(leaf.device)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, leaf.device_mesh, leaf.placements,
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def load_sharded(gen_dir, target_tree, mesh):
    """Restore one generation into the layout of ``target_tree`` (the
    live step state, whose DTensor placements define the destination):
    returns (tree, manifest).  The tree's keys and each leaf's global
    shape and dtype must match the manifest's, or it raises naming the
    keys."""
    with telemetry.span("checkpoint_load"):
        manifest = _read_manifest(gen_dir)
        reader = _ShardReader(gen_dir)
        flat = _flatten(target_tree)
        want = {k for k, _ in flat}
        have = set(manifest["leaves"])
        if want != have:
            missing = sorted(want - have)
            extra = sorted(have - want)
            raise ValueError(
                f"sharded checkpoint {gen_dir} does not match the target "
                f"tree structure: missing={missing[:8]} "
                f"extra={extra[:8]} (optimizer/state trees must be built "
                "the same way they were saved)")
        out = {}
        for key, leaf in flat:
            entry = manifest["leaves"][key]
            shape = tuple(entry["shape"])
            dtype = _dtype_name(leaf)
            if shape != _shape(leaf) or entry["dtype"] != dtype:
                raise ValueError(
                    f"sharded checkpoint {gen_dir} leaf {key}: saved "
                    f"{entry['shape']}/{entry['dtype']} vs target "
                    f"{_shape(leaf)}/{dtype} — global shapes/dtypes "
                    "must match to reshard")
            out[key] = _assemble_leaf(entry, reader, leaf, mesh, shape,
                                      np.dtype(dtype))
        return _unflatten(target_tree, out), manifest


class _ArrayReader:
    """A whole-array source for ``_assemble_leaf``: each leaf's one
    replicated slice is the array itself."""

    def __init__(self, arrays):
        self.arrays = arrays

    def slice_array(self, slc):
        return self.arrays[slc["name"]]


def restore_arrays(tree, target_tree, mesh):
    """``tree`` (whole arrays: numpy, or anything ``np.asarray`` takes,
    in ``target_tree``'s structure) laid out as ``target_tree``: each
    DTensor leaf gets this rank's slice, every other leaf the whole
    array as a tensor on its device.  Keys, global shapes and dtypes
    must match, as a generation's must (``load_sharded``)."""
    src = {k: np.asarray(v) for k, v in _flatten(tree)}
    flat = _flatten(target_tree)
    want = {k for k, _ in flat}
    if want != set(src):
        raise ValueError(
            f"arrays do not match the target tree structure: missing="
            f"{sorted(want - set(src))[:8]} extra="
            f"{sorted(set(src) - want)[:8]}")
    out = {}
    for key, leaf in flat:
        shape, dtype = _shape(leaf), _dtype_name(leaf)
        if src[key].shape != shape or str(src[key].dtype) != dtype:
            raise ValueError(
                f"leaf {key}: given {src[key].shape}/{src[key].dtype} vs "
                f"target {shape}/{dtype}")
        entry = {"slices": [{"lo": [0] * len(shape), "hi": list(shape),
                             "name": key}]}
        out[key] = _assemble_leaf(entry, _ArrayReader(src), leaf, mesh,
                                  shape, np.dtype(dtype))
    return _unflatten(target_tree, out)


def load_latest(ckpt_dir, target_tree, mesh):
    """Restore the newest fully valid generation, falling back past
    corrupt shards or manifests generation by generation (a warning and
    a ``checkpoint_shard_fallback`` trace event each hop).  Returns
    (tree, manifest, gen_dir); raises CheckpointCorruptError when none
    restores."""
    import warnings
    gens = generations(ckpt_dir)
    if not gens:
        raise resilience.CheckpointCorruptError(
            f"no committed checkpoint generation under {ckpt_dir} (a "
            "save that died before its manifest rename leaves nothing "
            "visible, by design)")
    last_exc = None
    for i, step in enumerate(gens):
        gen_dir = os.path.join(ckpt_dir, f"gen-{step:08d}")
        try:
            tree, manifest = load_sharded(gen_dir, target_tree, mesh)
            return tree, manifest, gen_dir
        except (resilience.CheckpointCorruptError, OSError) as exc:
            last_exc = exc
            telemetry.counter("checkpoint_shard_corrupt_total").inc()
            if i + 1 < len(gens):
                tracing.trace_event(
                    "checkpoint_shard_fallback", from_gen=step,
                    to_gen=gens[i + 1], error=str(exc)[:200])
                warnings.warn(
                    f"sharded checkpoint generation {step} failed "
                    f"validation ({exc}); falling back to generation "
                    f"{gens[i + 1]}", RuntimeWarning)
    raise resilience.CheckpointCorruptError(
        f"every checkpoint generation under {ckpt_dir} failed "
        f"validation (newest error: {last_exc})")


def load_data_companion(gen_dir, manifest=None):
    """The data iterator's ``state_dict`` saved with a generation, or
    None when the save carried none."""
    if manifest is None:
        manifest = _read_manifest(gen_dir)
    ref = manifest.get("data")
    if not ref:
        return None
    path = os.path.join(gen_dir, ref)
    raw = resilience.read_validated_bytes(path)
    return resilience.decode_or_corrupt(path, lambda: pickle.loads(raw))

