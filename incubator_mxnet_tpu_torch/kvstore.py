"""KVStore: the parameter-synchronization facade (twin of
``incubator_mxnet_tpu/kvstore.py``; ref: include/mxnet/kvstore.h:84,
src/kvstore/kvstore_local.h:50).

There is no parameter server, as in the JAX package:

- 'local' / 'device': a single-process store (the reference's Comm
  reduce, ref: src/kvstore/comm.h:41): ``push`` sums a key's replicas,
  in order, and runs the updater where one is set; ``pull`` hands back
  the stored weight (or, without an updater, the summed gradient).
- 'tpu' (also 'dist_sync', 'dist_device_sync', 'dist_sync_device',
  'nccl', 'horovod'): the in-step reduction belongs to the training
  step (``parallel.ShardedTrainStep``, ``parallel.SymbolTrainStep``),
  so the store holds the master copy and applies the optimizer.  Over
  several processes (``tools/launch.py``, ``dist.init``), ``init``
  broadcasts rank 0's value and ``push`` allreduces the summed replicas
  over every worker before the updater runs, so every replica applies
  the same gradient (the reference's server-side sum); ``rank``,
  ``num_workers`` and ``barrier`` are the process group's.  The
  collectives run through ``dist`` (NCCL or gloo by ``dist.backend``),
  retried on transient failures before the op is entered, never after.
- 'dist_async' has no synchronous-collective analog and raises.
"""
import pickle

import torch

from . import autograd
from . import optimizer as opt_mod
from . import resilience

__all__ = ["KVStore", "create"]


class KVStore:
    """A store with Comm-style aggregation (over processes for a
    'tpu'-type store in a world of several)."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    # ------------------------------------------------------------ basics
    @property
    def rank(self):
        from . import dist
        return dist.rank()

    @property
    def num_workers(self):
        from . import dist
        return dist.num_workers()

    @staticmethod
    def _dist_retry(fn, op_name, *args):
        """A dist collective with bounded retry on transient errors
        raised before the op is entered; deadline expiries and in-op
        failures (``CollectiveAbortedError``) are never retried: peers
        may have completed the op."""
        return resilience.retry_call(
            resilience.call_transient_mapped, fn, *args,
            op_name=op_name, retry_on=(resilience.TransientError,))

    def _multi(self):
        return self.type == "tpu" and self.num_workers > 1

    def init(self, key, value):
        """Initialize key(s) with initial weight(s) (ref: kvstore.py
        init:96); a key already there keeps its value.  Over several
        processes rank 0's value is broadcast, so every worker starts
        from the same weights."""
        from . import dist
        from .ndarray.ndarray import NDArray
        multi = self._multi()
        for k, v in self._pairs(key, value):
            if k in self._store:
                continue
            vv = v[0] if isinstance(v, (list, tuple)) else v
            if multi:
                self._store[k] = NDArray(
                    self._dist_retry(dist.broadcast,
                                     f"kvstore.init({k}).broadcast",
                                     vv._data), vv.context)
            else:
                self._store[k] = vv.copy()

    def push(self, key, value, priority=0):
        """Push gradient(s): a key's replicas are summed in order and,
        over several processes, allreduced over every worker; then the
        updater runs if one is set (ref: kvstore.py push:140)."""
        from . import dist
        from .ndarray.ndarray import NDArray
        multi = self._multi()
        for k, v in self._pairs(key, value):
            vals = v if isinstance(v, (list, tuple)) else [v]
            merged = vals[0]
            if len(vals) > 1:
                merged = vals[0].copy()
                for extra in vals[1:]:
                    merged += extra.as_in_context(merged.context)
            if multi:
                merged = NDArray(
                    self._dist_retry(dist.allreduce_sum,
                                     f"kvstore.push({k}).allreduce",
                                     merged._data), merged.context)
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
        """Wait for every worker (nothing to wait for in one
        process)."""
        from . import dist
        dist.barrier("kvstore_barrier")

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
        # over several processes (tools/launch.py) this joins the
        # process group; push then allreduces over the workers
        from . import dist
        dist.init()
        return KVStore("tpu")
    if name == "dist_async":
        raise ValueError(
            "dist_async (parameter-server apply-on-arrival) has no ICI "
            "collective analog on TPU; use 'tpu' (synchronous in-step "
            "all-reduce) — see SURVEY.md §7 hard-parts #4")
    raise ValueError(f"unknown kvstore type {name!r}")
