"""KVStore: the parameter-synchronization facade (twin of
``incubator_mxnet_tpu/kvstore.py``; ref: include/mxnet/kvstore.h:84,
src/kvstore/kvstore_local.h:50).

There is no parameter server, as in the JAX package:

- 'local' / 'device': a single-process store (the reference's Comm
  reduce, ref: src/kvstore/comm.h:41): ``push`` sums a key's replicas,
  in order, and runs the updater where one is set; ``pull`` hands back
  the stored weight (or, without an updater, the summed gradient).
- 'tpu' (also 'dist_sync', 'dist_device_sync', 'dist_sync_device',
  'nccl', 'horovod'): the reduction belongs to the training step
  (``parallel.ShardedTrainStep``, ``parallel.SymbolTrainStep``), so the
  store holds the master copy and applies the optimizer; on one process
  push and pull are the local ops.
- 'dist_async' has no synchronous-collective analog and raises.

A store over several processes (``MXTPU_NUM_WORKERS`` > 1, or a
``torch.distributed`` group of more than one rank) needs the multi-card
modes over NCCL, ROADMAP item A9, and raises.
"""
import os
import pickle

import torch

from . import autograd
from . import optimizer as opt_mod
from . import resilience

__all__ = ["KVStore", "create"]

_MULTI = ("a kvstore over several processes needs the multi-card modes "
          "(NCCL process groups), ROADMAP item A9")


def _world_size():
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("MXTPU_NUM_WORKERS", "1"))


class KVStore:
    """A single-process store with Comm-style aggregation."""

    def __init__(self, kv_type="local"):
        if _world_size() > 1:
            raise NotImplementedError(_MULTI)
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    # ------------------------------------------------------------ basics
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Initialize key(s) with initial weight(s) (ref: kvstore.py
        init:96); a key already there keeps its value."""
        for k, v in self._pairs(key, value):
            if k in self._store:
                continue
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = vv.copy()

    def push(self, key, value, priority=0):
        """Push gradient(s): a key's replicas are summed in order, then
        the updater runs if one is set (ref: kvstore.py push:140)."""
        for k, v in self._pairs(key, value):
            vals = v if isinstance(v, (list, tuple)) else [v]
            merged = vals[0]
            if len(vals) > 1:
                merged = vals[0].copy()
                for extra in vals[1:]:
                    merged += extra.as_in_context(merged.context)
            if self._updater is not None:
                if k not in self._store:
                    raise KeyError(f"key {k} not initialized")
                self._updater(self._key_int(k), merged, self._store[k])
            else:
                self._store["__grad__" + str(k)] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Pull the current weights (or the merged gradients when no
        updater is set) into ``out`` (ref: kvstore.py pull:220)."""
        for k, o in self._pairs(key, out):
            src = self._store.get(k)
            if self._updater is None:
                src = self._store.get("__grad__" + str(k), src)
            if src is None:
                raise KeyError(f"key {k} not initialized")
            outs = o if isinstance(o, (list, tuple)) else [o]
            for dst in outs:
                # a copy: the lazy sparse updates write the stored
                # weight's rows in place
                autograd.rebind(dst, src._data.to(dst.context.device,
                                                  copy=True))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in ``row_ids`` (ref: kvstore.py:289).

        O(k), like the reference's server-side row gather (ref:
        src/kvstore/kvstore_dist_server.h:212): a row-sparse ``out``
        receives the unique pulled rows, ascending, and their ids only; a
        dense ``out`` receives those rows of the stored value and zeros
        elsewhere."""
        from .ndarray.ndarray import NDArray
        from .ndarray.sparse import RowSparseNDArray
        for k, o in self._pairs(key, out):
            src = self._store.get(k)
            if src is None:
                raise KeyError(f"key {k} not initialized")
            outs = o if isinstance(o, (list, tuple)) else [o]
            rids = row_ids if isinstance(row_ids, (list, tuple)) \
                else [row_ids] * len(outs)
            for dst, rid in zip(outs, rids):
                data = src._data
                dev = dst.context.device
                if isinstance(dst, RowSparseNDArray):
                    # row ids repeat in a batch, and a row-sparse array
                    # sums duplicates when densified: each row once
                    uniq = torch.unique(rid._data.to(data.device,
                                                     torch.int32))
                    dst._sp_data = NDArray(
                        data.index_select(0, uniq).to(dev))
                    dst._sp_indices = NDArray(uniq.to(dev))
                    dst._dense_cache = None
                    dst._sp_stale = False
                    continue
                data = data.to(dev)
                idx = rid._data.to(dev).long()
                full = torch.zeros_like(data)
                full[idx] = data[idx]
                autograd.rebind(dst, full)

    # ---------------------------------------------------------- optimizer
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run the optimizer store-side (ref: kvstore.py
        set_optimizer:354)."""
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    # ----------------------------------------------------------- dist API
    def barrier(self):
        """Nothing to wait for in one process."""

    def send_command_to_servers(self, head, body):
        """No servers: kept for the API."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, atomically with a CRC32 sidecar."""
        if self._updater is None:
            raise ValueError("no updater/optimizer set")
        data = self._updater.get_states(dump_optimizer)
        resilience.atomic_save(fname, lambda f: f.write(data))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise ValueError("no updater/optimizer set")
        raw = resilience.read_validated_bytes(fname)
        # decode under the corruption guard, apply outside it
        obj = resilience.decode_or_corrupt(fname, lambda: pickle.loads(raw))
        self._updater.set_states(obj)

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _key_int(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    @staticmethod
    def _pairs(key, value):
        if isinstance(key, (list, tuple)):
            if value is None:
                value = [None] * len(key)
            return list(zip(key, value))
        return [(key, value)]


def create(name="local"):
    """Create a KVStore (ref: src/kvstore/kvstore.cc:35)."""
    name = (name or "local").lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device"):
        return KVStore(name)
    if name in ("tpu", "dist_sync", "dist_device_sync", "dist_sync_device",
                "nccl", "horovod"):
        return KVStore("tpu")
    if name == "dist_async":
        raise ValueError(
            "dist_async (parameter-server apply-on-arrival) has no ICI "
            "collective analog on TPU; use 'tpu' (synchronous in-step "
            "all-reduce) — see SURVEY.md §7 hard-parts #4")
    raise ValueError(f"unknown kvstore type {name!r}")
