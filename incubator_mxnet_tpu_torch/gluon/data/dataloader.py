"""DataLoader (twin of ``incubator_mxnet_tpu/gluon/data/dataloader.py``;
ref: python/mxnet/gluon/data/dataloader.py:23-73).

* ``num_workers=0`` — synchronous loading in the caller.
* ``num_workers>0``, ``thread_pool=True`` — thread workers.
* ``num_workers>0`` (default) — forked worker processes.  A worker
  builds a batch with numpy and returns it through
  ``multiprocessing.shared_memory``: the parent receives a small
  descriptor and copies the batch out of ``/dev/shm`` once.

Batches are host (``cpu()``) NDArrays, in the sampler's order whatever
the workers' speeds, so every mode gives the same batches bit for bit.

The process pool is the loader's own, not ``multiprocessing.Pool``:
each worker has a pipe of its own, and the workers are forked from the
calling thread while the loader runs no thread of its own, so a child
never inherits a lock that a helper thread of the loader held at the
fork.  A record file a dataset holds is reopened in each child at its
first read (``recordio``), since a forked child would otherwise share
the parent's file offset.  Every wait on a worker has a deadline:
``MXTPU_DATA_TIMEOUT`` bounds the wait for each batch; a worker that
died has its batches re-dispatched to a fresh worker, after
``MXTPU_DL_DEAD_GRACE`` seconds for what it sent before it died, up to
``MXTPU_DATA_WORKER_RESTARTS`` times; past either, the loader raises
``DataPipelineError``.

Workers touch only numpy and host tensors: a sample on the card
raises in the worker, since a forked child must never touch CUDA.
"""
import collections
import concurrent.futures as _futures
import glob
import itertools
import multiprocessing as _mp
import os
import time
import warnings
from multiprocessing import connection as _connection
from multiprocessing import shared_memory as _shm

import numpy as np

from ...context import cpu
from ...ndarray.ndarray import NDArray, array as _array
from ... import telemetry
from ...resilience import DataPipelineError, inject
from ...utils.env import get_env
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

_SHM_PREFIX = "mxtpu_dl_"
_POLL_S = 0.5


def nd_array(arr):
    return _array(arr, ctx=cpu())


def _sweep_segments(prefix):
    """Unlink every /dev/shm segment under ``prefix``; returns the
    count."""
    removed = 0
    for path in glob.glob("/dev/shm/" + prefix + "*"):
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed


def _bounded_window(items, submit, max_inflight):
    """Yield submitted handles in order with at most ``max_inflight``
    outstanding: unconsumed results hold memory, so the producers never
    run a whole epoch ahead of the consumer."""
    inflight = collections.deque()
    it = iter(items)
    exhausted = False
    while inflight or not exhausted:
        while not exhausted and len(inflight) < max_inflight:
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                break
            inflight.append(submit(item))
        if inflight:
            yield inflight.popleft()


def default_batchify_fn(data):
    """Stack samples into a batch (ref: dataloader.py default_batchify)."""
    if isinstance(data[0], NDArray):
        return nd_array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    return nd_array(np.asarray(data))


def _host_numpy(arr):
    """A host NDArray's values; an array on the card raises, since a
    forked worker must not touch CUDA."""
    if arr._data.device.type != "cpu":
        raise RuntimeError(
            "dataset samples are NDArrays on the card: a forked "
            "DataLoader worker cannot touch the device.  Return host "
            "arrays from the dataset, or use thread_pool=True / "
            "num_workers=0.")
    return arr.asnumpy()


def _numpy_batchify_fn(data):
    """``default_batchify_fn`` that stays in numpy, run in workers."""
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [_numpy_batchify_fn(list(i)) for i in data]
    if isinstance(data[0], NDArray):
        return np.stack([_host_numpy(d) for d in data])
    return np.asarray(data)


def _tracker_unregister(name):
    """Keep the resource tracker out of a segment's lifetime: the
    worker creates it and the parent unlinks it, which one process's
    tracker cannot model."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister("/" + name.lstrip("/"),
                                    "shared_memory")
    except Exception:
        pass


def _to_shm(obj, prefix):
    """Move a batch's numpy payloads into shared-memory descriptors."""
    if isinstance(obj, NDArray):          # a custom batchify's NDArray
        inner = _to_shm(_host_numpy(obj), prefix)
        if inner[0] == "np":
            return ("nd",) + inner[1:]
        return ("ndpy", inner[1])         # zero-size: carried inline
    if isinstance(obj, np.ndarray) and obj.nbytes > 0:
        arr = np.ascontiguousarray(obj)
        seg = _shm.SharedMemory(create=True, size=arr.nbytes,
                                name=prefix + os.urandom(8).hex())
        _tracker_unregister(seg.name)
        view = np.frombuffer(seg.buf, dtype=arr.dtype).reshape(arr.shape)
        view[...] = arr
        del view                          # release the buffer export
        name = seg.name
        seg.close()
        return ("np", name, arr.shape, arr.dtype.str)
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj) is tuple,
                [_to_shm(o, prefix) for o in obj])
    return ("py", obj)


def _from_shm(desc):
    """Parent side: copy a descriptor's payloads out of /dev/shm and
    unlink the segments."""
    tag = desc[0]
    if tag in ("np", "nd"):
        _, name, shape, dtype = desc
        seg = _shm.SharedMemory(name=name)
        try:
            arr = np.frombuffer(seg.buf, dtype=np.dtype(dtype)) \
                .reshape(shape)
            out = arr.copy()
            del arr
        finally:
            seg.close()
            seg.unlink()
        return nd_array(out) if tag == "nd" else out
    if tag == "ndpy":
        return nd_array(desc[1])
    if tag == "seq":
        _, is_tuple, items = desc
        items = [_from_shm(i) for i in items]
        return tuple(items) if is_tuple else items
    return desc[1]


def _promote(obj):
    """numpy -> host NDArray, keeping the default batchify's shape."""
    if isinstance(obj, np.ndarray):
        return nd_array(obj)
    if isinstance(obj, list):
        return [_promote(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_promote(o) for o in obj)
    return obj


def _worker_loop(conn, dataset, batchify, prefix):
    """A worker process: build each requested batch into shared memory
    and send back its descriptor, until the parent sends None or goes
    away."""
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg is None:
            return
        token, idxs = msg
        try:
            inject("dataloader", "worker")
            desc = _to_shm(batchify([dataset[i] for i in idxs]),
                           prefix + token + "_")
            reply = ("ok", token, desc)
        except Exception as exc:
            reply = ("err", token, f"{type(exc).__name__}: {exc}")
        try:
            conn.send(reply)
        except (EOFError, OSError):
            return


class _WorkerPool:
    """``n`` forked worker processes, each with a pipe of its own.
    Every method runs in the loader's calling thread."""

    def __init__(self, n, dataset, batchify, prefix):
        self._ctx = _mp.get_context("fork")
        self._args = (dataset, batchify, prefix)
        self.procs = [None] * n
        self.conns = [None] * n
        self.tasks = [dict() for _ in range(n)]   # token -> idxs
        for w in range(n):
            self.start(w)

    def start(self, w):
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker_loop,
                                 args=(child,) + self._args, daemon=True)
        with warnings.catch_warnings():
            # the children are numpy-only and forked from this thread
            warnings.filterwarnings(
                "ignore", category=DeprecationWarning,
                message=r"This process .* is multi-threaded")
            warnings.filterwarnings(
                "ignore", category=RuntimeWarning,
                message=r"os\.fork\(\) was called\.")
            proc.start()
        child.close()
        self.procs[w], self.conns[w], self.tasks[w] = proc, parent, {}

    def submit(self, token, idxs):
        """Send a task to the least-loaded live worker."""
        w = min(range(len(self.procs)), key=lambda i: len(self.tasks[i]))
        self.tasks[w][token] = idxs
        try:
            self.conns[w].send((token, idxs))
        except OSError:
            pass    # the worker died: its tasks count as lost
        return w

    def receive(self, timeout):
        """Replies that arrive within ``timeout``: ``[(w, msg)]``; a
        worker whose pipe closed gives ``(w, None)``."""
        ready = _connection.wait(self.conns, timeout=timeout)
        out = []
        for conn in ready:
            w = self.conns.index(conn)
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                out.append((w, None))
                continue
            self.tasks[w].pop(msg[1], None)
            out.append((w, msg))
        return out

    def dead(self):
        return [w for w, p in enumerate(self.procs)
                if p.exitcode is not None]

    def close(self):
        for conn in self.conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 2.0
        for proc in self.procs:
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=2.0)
        for conn in self.conns:
            conn.close()


class DataLoader:
    """(ref: dataloader.py DataLoader)"""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, thread_pool=False):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size required unless batch_sampler given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle and sampler are exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._batches_served = 0
        self._epoch_rng = None
        self._resume = None

    # ------------------------------------------------- resumable state
    def state_dict(self):
        """Batches served this epoch and numpy's generator state at the
        epoch's start (the sampler's shuffle source): a restore replays
        the same order and skips the served batches."""
        if self._resume is not None:
            return dict(self._resume)    # armed but not yet applied
        rng = self._epoch_rng if self._epoch_rng is not None \
            else np.random.get_state()
        return {"type": "DataLoader",
                "batches_served": self._batches_served,
                "epoch_rng": rng}

    def load_state_dict(self, state):
        """Arm a resume: the next ``iter()`` restores the generator
        state, rebuilds the sampler order, and skips the served index
        batches without loading their data."""
        if state.get("type") != "DataLoader":
            raise ValueError(
                f"state_dict type {state.get('type')!r} does not "
                "match DataLoader")
        self._resume = dict(state)

    def _sampler_batches(self, skip):
        for j, idxs in enumerate(self._batch_sampler):
            if j < skip:
                continue
            yield idxs

    def __iter__(self):
        resume, self._resume = self._resume, None
        if resume is not None:
            np.random.set_state(resume["epoch_rng"])
            skip = int(resume["batches_served"])
        else:
            skip = 0
        self._epoch_rng = np.random.get_state()
        self._batches_served = skip
        batches = self._sampler_batches(skip)
        batchify = self._batchify_fn or default_batchify_fn
        if self._num_workers == 0:
            for batch in batches:
                out = batchify([self._dataset[i] for i in batch])
                self._batches_served += 1
                yield out
            return
        if self._thread_pool:
            yield from self._iter_threads(batches, batchify)
            return
        yield from self._iter_processes(batches)

    def _iter_threads(self, batches, batchify):
        timeout = get_env("MXTPU_DATA_TIMEOUT")
        with _futures.ThreadPoolExecutor(self._num_workers) as pool:
            def submit(idxs):
                return pool.submit(
                    lambda: batchify([self._dataset[i] for i in idxs]))
            for fut in _bounded_window(batches, submit,
                                       2 * self._num_workers):
                try:
                    out = fut.result(timeout=timeout if timeout > 0
                                     else None)
                except _futures.TimeoutError:
                    raise DataPipelineError(
                        f"DataLoader: no batch arrived within "
                        f"{timeout:g}s (MXTPU_DATA_TIMEOUT); a thread "
                        "worker is stalled in the dataset") from None
                self._batches_served += 1
                yield out

    def _iter_processes(self, batches):
        if (self._batchify_fn is None
                or self._batchify_fn is default_batchify_fn):
            worker_batchify, promote = _numpy_batchify_fn, _promote
        else:
            worker_batchify, promote = self._batchify_fn, lambda b: b
        # a prefix of its own for this iteration: segments whose
        # descriptors never reach the parent are swept at the end
        prefix = "%s%x_%s_" % (_SHM_PREFIX, os.getpid(),
                               os.urandom(4).hex())
        timeout = get_env("MXTPU_DATA_TIMEOUT")
        grace = get_env("MXTPU_DL_DEAD_GRACE")
        max_restarts = get_env("MXTPU_DATA_WORKER_RESTARTS")
        pool = _WorkerPool(self._num_workers, self._dataset,
                           worker_batchify, prefix)
        try:
            tokens = ("%x" % i for i in itertools.count())
            order = collections.deque()      # tokens in sampler order
            idxs_of, sent_at, replies = {}, {}, {}
            restarts = 0

            def dispatch(token):
                pool.submit(token, idxs_of[token])
                sent_at[token] = time.monotonic()

            def refill():
                while len(order) < 2 * self._num_workers:
                    idxs = next(batches, None)
                    if idxs is None:
                        return
                    token = next(tokens)
                    order.append(token)
                    idxs_of[token] = idxs
                    dispatch(token)

            refill()
            while order:
                head = order[0]
                while head not in replies:
                    for w, msg in pool.receive(_POLL_S):
                        if msg is not None:
                            replies[msg[1]] = msg
                    for w in pool.dead():
                        lost = self._drain_dead(pool, w, grace, replies)
                        if not lost:
                            pool.start(w)
                            continue
                        for token in lost:
                            _sweep_segments(prefix + token + "_")
                        if restarts >= max_restarts:
                            raise DataPipelineError(
                                "a DataLoader worker died (exit code "
                                f"{pool.procs[w].exitcode}) holding "
                                f"{len(lost)} batch(es); re-dispatched "
                                f"{restarts} time(s) already "
                                "(MXTPU_DATA_WORKER_RESTARTS="
                                f"{max_restarts}); check the dataset's "
                                "__getitem__ or batchify_fn for crashes "
                                "in native code or OOM")
                        restarts += 1
                        telemetry.counter(
                            "dataloader_worker_restarts_total").inc()
                        warnings.warn(
                            "a DataLoader worker died holding "
                            f"{len(lost)} batch(es); re-dispatching "
                            f"(restart {restarts}/{max_restarts})",
                            RuntimeWarning)
                        pool.start(w)
                        for token in lost:
                            dispatch(token)
                    if head not in replies and timeout > 0 and \
                            time.monotonic() - sent_at[head] > timeout:
                        raise DataPipelineError(
                            f"DataLoader: no batch arrived within "
                            f"{timeout:g}s (MXTPU_DATA_TIMEOUT); the "
                            "worker pool is stalled: check the "
                            "dataset's __getitem__ for hangs, or raise "
                            "the timeout for slow sources")
                order.popleft()
                kind, _, payload = replies.pop(head)
                del idxs_of[head], sent_at[head]
                if kind == "err":
                    raise DataPipelineError(
                        f"DataLoader worker raised {payload}")
                out = promote(_from_shm(payload))
                refill()
                self._batches_served += 1
                yield out
        finally:
            pool.close()
            _sweep_segments(prefix)

    @staticmethod
    def _drain_dead(pool, w, grace, replies):
        """Read what dead worker ``w`` sent before it died, for up to
        ``grace`` seconds (its pipe ends at once when nothing is left);
        returns the tokens it still held."""
        conn = pool.conns[w]
        deadline = time.monotonic() + grace
        while pool.tasks[w] and time.monotonic() < deadline:
            if not conn.poll(min(_POLL_S, max(0.0, deadline -
                                               time.monotonic()))):
                continue
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            pool.tasks[w].pop(msg[1], None)
            replies[msg[1]] = msg
        lost = list(pool.tasks[w])
        conn.close()
        return lost

    def __len__(self):
        return len(self._batch_sampler)
