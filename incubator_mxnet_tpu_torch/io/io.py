"""Data iterators (twin of ``incubator_mxnet_tpu/io/io.py``; ref:
python/mxnet/io.py DataDesc:43, DataBatch:116, DataIter:177,
NDArrayIter, ResizeIter, PrefetchingIter; src/io/iter_csv.cc:151,
iter_mnist.cc:80).

Batches are NDArrays on the host (``cpu()``), as the reference's
iterators give them; the executor copies each input onto its own
device when it binds the batch (``Executor.forward``).

``NDArrayIter(shuffle=True)`` draws its order from a
``numpy.random.RandomState`` of its own, seeded by ``seed`` (None: from
the operating system), never from numpy's global state, and its
``state_dict`` carries that generator's state, so a restored iterator
replays this epoch's remaining batches and every later shuffle.

``LibSVMIter`` gives CSR batches (``ndarray/sparse.py``), parsed
straight to CSR.  ``ImageRecordIter`` is ``image.ImageRecordIter``.

Every wait on a background producer (``PrefetchingIter``,
``DevicePrefetchIter``, ``ImageRecordIter``) is bounded by
``MXTPU_DATA_TIMEOUT``: a producer that died or wedged surfaces as a
``DataPipelineError`` naming its source.  The producers inject faults
at the JAX package's points (``data:prefetch``,
``data:device_prefetch``; ``MXTPU_FAULT_SPEC``), and the consumers
publish its metrics (``prefetch_queue_wait_seconds``,
``prefetch_queue_depth``, ``prefetch_batches_total``).
``DataServiceIter`` is the multi-process data service
(``data_service/``).
"""
import gzip
import queue
import struct
import threading
import time

import numpy as np

from ..context import cpu, resolve
from ..ndarray.ndarray import NDArray, array as nd_array
from .. import telemetry
from ..resilience import DataPipelineError, data_timeout, inject
from ..utils.env import get_env

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "CSVIter", "MNISTIter", "LibSVMIter", "ImageRecordIter",
           "DataServiceIter"]

_GET_POLL_S = 0.2


def _bounded_get(q, source, thread=None, timeout=None):
    """``q.get()`` bounded by ``MXTPU_DATA_TIMEOUT`` (``timeout=None``
    reads the flag; a value <= 0 disables the deadline).  Raises
    ``DataPipelineError`` naming ``source`` when the producer thread
    died without delivering, or when nothing arrives in time.

    Telemetry: each successful get publishes its queue-wait time and
    the post-get queue depth (``prefetch_queue_wait_seconds`` /
    ``prefetch_queue_depth``)."""
    t0 = time.monotonic()
    item = _bounded_get_inner(q, source, thread, timeout)
    tel_hist = telemetry.histogram("prefetch_queue_wait_seconds")
    if tel_hist is not telemetry.NULL_METRIC:
        tel_hist.observe(time.monotonic() - t0)
        telemetry.gauge("prefetch_queue_depth").set(q.qsize())
    return item


def _bounded_get_inner(q, source, thread, timeout):
    if timeout is None:
        timeout = data_timeout()
    deadline = time.monotonic() + timeout \
        if timeout and timeout > 0 else None
    while True:
        try:
            return q.get(timeout=_GET_POLL_S)
        except queue.Empty:
            pass
        if thread is not None and not thread.is_alive():
            try:  # the final put may have landed after our get timed out
                return q.get_nowait()
            except queue.Empty:
                raise DataPipelineError(
                    f"{source}: prefetch worker thread died without "
                    "delivering a batch, end-of-epoch, or error; the "
                    "stream cannot continue") from None
        if deadline is not None and time.monotonic() >= deadline:
            raise DataPipelineError(
                f"{source} stalled: no batch arrived within "
                f"{timeout:g}s (MXTPU_DATA_TIMEOUT); the upstream "
                "iterator or its storage is wedged") from None


def _stop_aware_put(q, stop, item):
    """Bounded put that re-checks ``stop``, so a producer blocked on a
    full queue sees a reset.  True when the item landed."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _halt_worker_thread(thread, q, stop, source, timeout=30):
    """Stop and join a producer, draining its queue while joining (a
    producer mid-put needs a slot to see the stop) and after.  A worker
    still alive past ``timeout`` is wedged inside the inner iterator:
    resetting that iterator under it would interleave two readers, so
    this raises ``DataPipelineError`` instead."""
    stop.set()
    if thread is not None:
        deadline = time.monotonic() + timeout
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                raise DataPipelineError(
                    f"{source}: worker still blocked in the inner "
                    f"iterator after {timeout}s; it cannot be reset "
                    "safely")
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


class DataDesc:
    """Name, shape, dtype and layout of one input."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype}," \
               f"{self.layout}]"

    def __iter__(self):  # unpacks like the reference's namedtuple
        yield self.name
        yield self.shape

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One mini-batch."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    def state_dict(self):
        """Checkpointable position: enough to resume the stream at the
        exact batch (saved by ``model.save_data_state``)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support checkpointable "
            "iterator state (state_dict)")

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` snapshot.  The restored position
        survives exactly one later ``reset()`` (fit resets at each epoch
        start); iterating disarms that shield."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support checkpointable "
            "iterator state (load_state_dict)")

    def skip(self, num_batches):
        """Advance past ``num_batches`` without delivering them (to
        fast-forward to a resume point); an iterator with a cursor
        skips without building the batches."""
        for _ in range(num_batches):
            self.next()



def _init_data(data, allow_empty, default_name):
    """Normalize data into a list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """In-memory batch iterator: shuffle (from ``seed``), and the
    ``last_batch_handle`` rules pad (wrap the tail batch around, with
    ``pad`` rows), discard and roll_over (the tail leads the next
    epoch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", *, seed=None):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._rng = np.random.RandomState(seed)
        self._carry = np.array([], dtype=np.int64)  # roll_over leftovers
        self._resume_pending = False
        self._order = np.arange(self.num_data)
        if shuffle:
            self._rng.shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) \
                // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self._resume_pending:
            # a just-restored position survives the epoch-start reset
            self._resume_pending = False
            return
        base = np.arange(self.num_data)
        if self.shuffle:
            self._rng.shuffle(base)
        if self.last_batch_handle == "roll_over":
            self._order = np.concatenate([self._carry, base])
            self._carry = np.array([], dtype=np.int64)
        else:
            self._order = base
        self.cursor = -self.batch_size

    def state_dict(self):
        """Cursor, epoch order, roll-over carry and the shuffle
        generator's state."""
        return {"type": "NDArrayIter", "cursor": int(self.cursor),
                "order": self._order.copy(), "carry": self._carry.copy(),
                "rng": self._rng.get_state()}

    def load_state_dict(self, state):
        if state.get("type") != "NDArrayIter":
            raise ValueError(f"state_dict type {state.get('type')!r} "
                             "does not match NDArrayIter")
        order = np.asarray(state["order"], dtype=np.int64)
        if len(order) and order.max() >= self.num_data:
            raise ValueError(
                f"iterator state references sample {int(order.max())} "
                f"but the dataset has only {self.num_data} samples — "
                "state from a different dataset?")
        self._order = order
        self._carry = np.asarray(state["carry"], dtype=np.int64)
        self.cursor = int(state["cursor"])
        if state.get("rng") is not None:
            self._rng.set_state(state["rng"])
        self._resume_pending = True

    def skip(self, num_batches):
        """Move the cursor past ``num_batches`` without building them;
        disarms the resume shield, as iterating does."""
        self._resume_pending = False
        self.cursor += num_batches * self.batch_size

    def iter_next(self):
        self._resume_pending = False
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        if self.last_batch_handle == "roll_over":
            if self.cursor + self.batch_size <= len(self._order):
                return True
            if self.cursor < len(self._order):
                self._carry = self._order[self.cursor:]
            return False
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, v in arrays:
            idx = self._order[self.cursor:self.cursor + self.batch_size]
            part = v[idx]
            if len(part) < self.batch_size:  # pad by wrapping
                extra = self._order[:self.batch_size - len(part)]
                part = np.concatenate([part, v[extra]], axis=0)
            out.append(nd_array(part, ctx=cpu()))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """An iterator resized to ``size`` batches per epoch (restarting
    the inner one when it runs out)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch of one or more iterators (their
    batches joined), ``prefetch_depth`` batches ahead: host batch
    preparation overlaps the device's step (ref: io.py PrefetchingIter,
    src/io/iter_prefetcher.h:47).

    ``state_dict`` pairs the inner iterators' epoch-start state with the
    count of batches delivered, since the worker reads ahead of the
    consumer; a restore reloads that state and skips the delivered
    batches.  A ``reset()`` of an epoch nothing was taken from keeps it
    (and what the worker read ahead), so ``fit``'s epoch-start reset of
    a fresh iterator does not reset the inner ones under the worker."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = prefetch_depth
        self._queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._exhausted = False
        self._error = None
        self._delivered = 0
        self._pending_resume = None
        self._capture_epoch_state()
        self._start()

    def _start(self):
        # the worker keeps ITS queue and stop event: one that outlives
        # a reset() must not write into the replacement queue
        q, stop = self._queue, self._stop

        def worker():
            while not stop.is_set():
                try:
                    inject("data", "prefetch")
                    batches = [it.next() for it in self.iters]
                except StopIteration:
                    _stop_aware_put(q, stop, None)
                    return
                except Exception as exc:   # surfaces in the consumer
                    _stop_aware_put(q, stop, ("err", exc))
                    return
                if not _stop_aware_put(q, stop, batches):
                    return
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _renamed(self, descs_of, renames):
        out = []
        for i, it in enumerate(self.iters):
            descs = descs_of(it)
            if renames:
                descs = [DataDesc(renames[i].get(d.name, d.name), d.shape,
                                  d.dtype) for d in descs]
            out.extend(descs)
        return out

    @property
    def provide_data(self):
        return self._renamed(lambda it: it.provide_data, self.rename_data)

    @property
    def provide_label(self):
        return self._renamed(lambda it: it.provide_label,
                             self.rename_label)

    def _halt_worker(self):
        _halt_worker_thread(self._thread, self._queue, self._stop,
                            "PrefetchingIter")
        self._thread = None

    def _capture_epoch_state(self):
        try:
            self._epoch_state = [it.state_dict() for it in self.iters]
        except NotImplementedError:
            self._epoch_state = None

    def reset(self):
        if (self._pending_resume is None and self._delivered == 0
                and self._error is None and not self._exhausted
                and self._thread is not None):
            return      # an epoch nothing was taken from is kept
        self._halt_worker()
        if self._pending_resume is not None:
            state, self._pending_resume = self._pending_resume, None
            for it, inner in zip(self.iters, state["inner"]):
                it.load_state_dict(inner)
                # skip() fast-forwards and disarms the inner reset
                # shield: the prefetcher owns the resume here
                it.skip(state["delivered"])
        else:
            for it in self.iters:
                it.reset()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)
        self._exhausted = False
        self._error = None
        self._delivered = 0
        self._capture_epoch_state()
        self._start()

    def state_dict(self):
        if self._pending_resume is not None:
            return dict(self._pending_resume)    # not applied yet
        if self._epoch_state is None:
            raise NotImplementedError(
                "PrefetchingIter state needs every inner iterator to "
                "implement state_dict")
        return {"type": "PrefetchingIter", "inner": self._epoch_state,
                "delivered": self._delivered}

    def load_state_dict(self, state):
        if len(state.get("inner") or []) != len(self.iters):
            raise ValueError(
                "state_dict holds state for "
                f"{len(state.get('inner') or [])} inner iterators; "
                f"this PrefetchingIter wraps {len(self.iters)}")
        self._halt_worker()
        self._pending_resume = dict(state)

    def next(self):
        if self._pending_resume is not None:
            self.reset()    # applies the restored position
        if self._exhausted:
            raise StopIteration
        if self._error is not None:
            raise self._error
        item = _bounded_get(self._queue, "PrefetchingIter",
                            thread=self._thread)
        if item is None:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "err":
            self._error = _typed(item[1], "PrefetchingIter")
            raise self._error
        self._delivered += 1
        telemetry.counter("prefetch_batches_total").inc()
        data = [d for b in item for d in b.data]
        label = [lb for b in item for lb in b.label]
        return DataBatch(data, label, pad=item[0].pad)

    def iter_next(self):
        raise NotImplementedError("use next()")


def _typed(exc, source):
    """A worker's exception as a ``DataPipelineError`` (kept as it is
    when it already is one)."""
    if isinstance(exc, DataPipelineError):
        return exc
    err = DataPipelineError(
        f"{source} worker raised {type(exc).__name__}: {exc}")
    err.__cause__ = exc
    return err


class DevicePrefetchIter(DataIter):
    """Stage batch N+1 on the card while batch N's step runs (twin of
    the JAX package's, which starts ``jax.device_put`` from a thread).

    A worker thread takes each host batch from ``data_iter``, copies it
    into a pinned host slot and from there to the card on a CUDA stream
    of the iterator's own (``non_blocking``), then records an event.
    ``next()`` makes the caller's current stream wait on that event and
    calls ``record_stream`` on each staged tensor for that stream, so
    the caching allocator cannot hand the memory on while the step
    reads it.  The run holds ``depth`` pinned slots (one ring for each
    batch signature); a slot is refilled only after the copy out of it
    has completed, and at most ``depth`` staged batches wait for the
    consumer, so the staged batches hold ``depth`` x the batch's bytes
    of card memory.  A batch whose tensors are on the card already
    passes through uncopied.  Call ``next()`` on the stream the step
    runs on: a captured step copies its inputs into its static buffers
    on the current stream, after the wait.

    A ``reset()`` of an epoch nothing was taken from keeps it, as
    ``PrefetchingIter``'s does.  ``ctx=None`` means the card (it raises
    on a host without one); on a ``cpu()`` context the batches pass
    through unchanged, which keeps the resume protocol testable there.
    ``depth=None`` reads ``MXTPU_DEVICE_PREFETCH_DEPTH`` (default 2).

        train = mt.io.DevicePrefetchIter(
            mt.io.ImageRecordIter(...), ctx=mt.tpu(0))
        module.fit(train, ...)
    """

    def __init__(self, data_iter, ctx=None, depth=None):
        super().__init__(data_iter.batch_size)
        self._iter = data_iter
        self._device = resolve(ctx)
        if depth is None:
            depth = get_env("MXTPU_DEVICE_PREFETCH_DEPTH")
        self._depth = max(1, int(depth))
        self._on_card = self._device.type == "cuda"
        if self._on_card:
            import torch
            if self._device.index is None:
                self._device = torch.device(
                    "cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
        self._rings = {}          # batch signature -> [slot, ...]
        self._staged = 0          # batches staged by the current worker
        self._delivered = 0
        self._pending_resume = None
        self._capture_epoch_state()
        self._spawn()

    def _capture_epoch_state(self):
        try:
            self._epoch_state = self._iter.state_dict()
        except NotImplementedError:
            self._epoch_state = None

    def _spawn(self):
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._room = threading.Semaphore(self._depth)
        self._terminal = None
        # the worker keeps ITS queue, stop event and semaphore: one that
        # outlives a reset() must not write into their replacements
        q, stop, room = self._queue, self._stop, self._room

        def worker():
            while not stop.is_set():
                try:
                    inject("data", "device_prefetch")
                    batch = self._iter.next()
                except StopIteration:
                    _stop_aware_put(q, stop, ("end", None))
                    return
                except Exception as exc:     # surfaces in the consumer
                    _stop_aware_put(q, stop, ("err", exc))
                    return
                while not room.acquire(timeout=0.05):
                    if stop.is_set():
                        return
                try:
                    staged = self._stage(batch)
                except Exception as exc:
                    _stop_aware_put(q, stop, ("err", exc))
                    return
                if not _stop_aware_put(q, stop, ("ok", staged)):
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        """``(DataBatch on the card, event or None)`` of a host batch."""
        arrays = list(batch.data) + list(batch.label or [])
        tensors = [a._data if isinstance(a, NDArray) else a
                   for a in arrays]
        event = None
        if self._on_card:
            tensors, event = self._copy_in(tensors)
        out = [NDArray(t) for t in tensors]
        n = len(batch.data)
        return DataBatch(out[:n], out[n:], pad=batch.pad,
                         index=batch.index, bucket_key=batch.bucket_key,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label), event

    def _copy_in(self, tensors):
        """Copy the host tensors to the card through a pinned slot on
        the iterator's stream; a tensor on the card already passes."""
        import torch
        host = [t for t in tensors if t.device.type == "cpu"]
        if not host:
            return [t.to(self._device) for t in tensors], None
        sig = tuple((tuple(t.shape), t.dtype) for t in host)
        ring = self._rings.get(sig)
        if ring is None:
            for old in self._rings.values():    # a new signature: the
                for slot in old:                # old slots' copies end
                    if slot["event"] is not None:   # before they go
                        slot["event"].synchronize()
            self._rings.clear()
            ring = self._rings[sig] = [
                {"bufs": [torch.empty(s, dtype=d, pin_memory=True)
                          for s, d in sig],
                 "event": None}
                for _ in range(self._depth)]
        slot = ring[self._staged % self._depth]
        self._staged += 1
        if slot["event"] is not None:
            slot["event"].synchronize()    # the copy out of it ended
        for buf, t in zip(slot["bufs"], host):
            buf.copy_(t)
        out, bufs = [], iter(slot["bufs"])
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            for t in tensors:
                if t.device.type == "cpu":
                    out.append(next(bufs).to(self._device,
                                             non_blocking=True))
                else:
                    out.append(t.to(self._device))
            event = slot["event"] = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def _halt_worker(self):
        _halt_worker_thread(self._thread, self._queue, self._stop,
                            "DevicePrefetchIter")
        self._staged = 0

    def reset(self):
        if (self._pending_resume is None and self._delivered == 0
                and self._terminal is None and self._thread.is_alive()):
            return      # an epoch nothing was taken from is kept
        self._halt_worker()
        if self._pending_resume is not None:
            state, self._pending_resume = self._pending_resume, None
            self._iter.load_state_dict(state["inner"])
            self._iter.skip(state["delivered"])
        else:
            self._iter.reset()
        self._delivered = 0
        self._capture_epoch_state()
        self._spawn()

    def state_dict(self):
        if self._pending_resume is not None:
            return dict(self._pending_resume)
        if self._epoch_state is None:
            raise NotImplementedError(
                "DevicePrefetchIter state needs the inner iterator to "
                "implement state_dict")
        return {"type": "DevicePrefetchIter", "inner": self._epoch_state,
                "delivered": self._delivered}

    def load_state_dict(self, state):
        if state.get("type") != "DevicePrefetchIter":
            raise ValueError(f"state_dict type {state.get('type')!r} "
                             "does not match DevicePrefetchIter")
        self._halt_worker()
        self._pending_resume = dict(state)

    def next(self):
        if self._pending_resume is not None:
            self.reset()    # applies the restored position
        if self._terminal is not None:     # the worker is gone: raise
            kind, payload = self._terminal  # again instead of waiting
            if kind == "end":               # on a producerless queue
                raise StopIteration
            raise payload
        kind, payload = _bounded_get(self._queue, "DevicePrefetchIter",
                                     thread=self._thread)
        if kind == "end":
            self._terminal = (kind, payload)
            raise StopIteration
        if kind == "err":
            err = _typed(payload, "DevicePrefetchIter")
            self._terminal = (kind, err)
            raise err
        batch, event = payload
        if event is not None:
            import torch
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for a in list(batch.data) + list(batch.label):
                if a._data.device.type == "cuda":
                    a._data.record_stream(stream)
        self._room.release()
        self._delivered += 1
        telemetry.counter("prefetch_batches_total").inc()
        return batch

    def iter_next(self):
        raise NotImplementedError("use next()")


class CSVIter(NDArrayIter):
    """CSV file iterator."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        super().__init__(data, label, batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard", label_name="label")


def _read_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad MNIST image magic {magic}")
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(
            n, rows, cols)


def _read_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, _ = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad MNIST label magic {magic}")
        return np.frombuffer(f.read(), dtype=np.uint8)


class MNISTIter(NDArrayIter):
    """MNIST idx-format files (optionally gzipped) as batches: images
    scaled to [0, 1], (N, 1, 28, 28) or flat (N, 784); ``seed`` seeds
    the shuffle."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, **kwargs):
        imgs = _read_idx_images(image).astype(np.float32) / 255.0
        lbls = _read_idx_labels(label).astype(np.float32)
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            lbls = lbls[part_index::num_parts]
        imgs = imgs.reshape(len(imgs), -1) if flat else imgs[:, None]
        super().__init__(imgs, lbls, batch_size, shuffle=shuffle,
                         seed=seed)


class LibSVMIter(DataIter):
    """LibSVM text as CSR data batches (ref: src/io/iter_libsvm.cc:200,
    which emits CSR too), with the JAX package's arguments and tail: the
    last batch is padded by wrapping to the first rows (``pad`` says how
    many), and ``num_parts``/``part_index`` take every num_parts-th row.

    The JAX package builds a dense row a line; this parses each line
    straight to its nonzeros, so a million features cost nothing, and
    gives the same batches bit for bit: columns ascending, a later
    duplicate of a column overriding an earlier one, zero values (as
    float32) dropped, values as float32, indices and indptr int32.
    Batches are host (``cpu()``) arrays."""

    def __init__(self, data_libsvm, data_shape, label_shape=(1,),
                 batch_size=1, num_parts=1, part_index=0, **kwargs):
        dim = int(np.prod(data_shape))
        cols, vals, counts, labels = [], [], [], []
        with open(data_libsvm) as f:
            for ln in f:
                parts = ln.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = {}
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    c = int(i)
                    if not -dim <= c < dim:
                        raise IndexError(f"{data_libsvm}: feature {c} "
                                         f"out of range for {dim}")
                    row[c % dim] = np.float32(float(v))
                kept = sorted((c, v) for c, v in row.items() if v != 0)
                cols.append(np.array([c for c, _ in kept], np.int32))
                vals.append(np.array([v for _, v in kept], np.float32))
                counts.append(len(kept))
        take = slice(part_index, None, num_parts)
        self._cols, self._vals = cols[take], vals[take]
        self._counts = np.asarray(counts[take], np.int32)
        self._labels = np.asarray(labels, np.float32)[take]
        self._dim = dim
        self._cursor = 0
        super().__init__(batch_size)
        self.provide_data = [DataDesc("data", (batch_size, dim))]
        self.provide_label = [DataDesc(
            "label", (batch_size,) + tuple(label_shape)
            if label_shape != (1,) else (batch_size,))]

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        return self._cursor < len(self._cols)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        from ..ndarray import sparse as nd_sparse
        i = self._cursor
        self._cursor += self.batch_size
        rows = list(range(i, min(i + self.batch_size, len(self._cols))))
        pad = self.batch_size - len(rows)
        rows += list(range(pad))        # wrap the tail (NDArrayIter 'pad')
        indptr = np.zeros(len(rows) + 1, np.int32)
        np.cumsum(self._counts[rows], out=indptr[1:])
        data = nd_sparse.csr_matrix(
            (np.concatenate([self._vals[r] for r in rows]),
             np.concatenate([self._cols[r] for r in rows]), indptr),
            shape=(len(rows), self._dim), ctx=cpu())
        label = nd_array(self._labels[rows], ctx=cpu())
        return DataBatch([data], [label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def ImageRecordIter(*args, **kwargs):
    """The RecordIO image pipeline: ``image.ImageRecordIter`` (ref:
    src/io/iter_image_recordio_2.cc)."""
    from ..image.record_iter import ImageRecordIter as _Impl
    return _Impl(*args, **kwargs)


def DataServiceIter(*args, **kwargs):
    """Sharded multi-process input data service: N decode worker
    processes feeding bounded shared-memory rings
    (docs/data_service.md).  Provided by the data_service package."""
    from ..data_service.service import DataServiceIter as _Impl
    return _Impl(*args, **kwargs)
