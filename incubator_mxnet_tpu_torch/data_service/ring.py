"""Bounded shared-memory batch ring: the transport between one
decode worker process and the ``DataServiceIter`` parent (twin of
``incubator_mxnet_tpu/data_service/ring.py``; docs/data_service.md).

One ring per shard, single-producer single-consumer.  The segment
holds ``depth`` fixed-size slots (header + NCHW float32 data + label)
in one parent-owned ``/dev/shm`` mapping, so a batch crosses the
process boundary as ONE memcpy out of the slot — no per-batch segment
churn, no descriptors to lose when a worker dies, and bounded memory
(``depth × slot_bytes``) by construction.

Backpressure is the two counting semaphores: the producer must
acquire ``free`` before writing (a full ring blocks the *worker*,
never grows memory) and the consumer must acquire ``filled`` before
reading.  Both sides acquire in short poll slices so they can always
observe stop/teardown and worker death: no wait here is unbounded.

The parent creates and unlinks the segment; fork-started workers
inherit the mapping, so a SIGKILLed worker can never orphan a
segment (tests assert /dev/shm is clean after close).
"""
import os
import pickle
import time
from multiprocessing import shared_memory as _shm

import numpy as np

from ..resilience import DataPipelineError

__all__ = ["ShmBatchRing", "RingProducerDead"]

# slot kinds (header word 0)
KIND_DATA = 1      # a decoded batch
KIND_END = 2       # shard exhausted for this epoch (clean exit)
KIND_ERROR = 3     # worker raised; payload is the pickled exception

# int64 header words per slot:
# [kind, filled, pad, consumed, bad_records, seq, payload_len, _]
_HDR_WORDS = 8
_HDR_BYTES = _HDR_WORDS * 8

# poll slice for semaphore acquires: producer notices stop, consumer
# notices a dead producer, within one slice (io.io._GET_POLL_S analog)
_POLL_S = 0.2


class RingProducerDead(DataPipelineError):
    """The worker feeding this ring died without delivering (the
    supervisor's restart trigger — distinct from a stream deadline,
    which is operator-facing)."""


def _check_room(nbytes, root="/dev/shm"):
    """Raise :class:`DataPipelineError` when ``root`` cannot hold a
    ring of ``nbytes``: the segment is sparse until its pages are
    touched, so a ring that does not fit would otherwise die of
    SIGBUS at the prefault, not fail typed.  Nothing is shrunk."""
    try:
        st = os.statvfs(root)
    except OSError:
        return
    free = st.f_bavail * st.f_frsize
    if nbytes > free:
        raise DataPipelineError(
            f"data-service ring of {nbytes} bytes does not fit in "
            f"{root} ({free} bytes free of "
            f"{st.f_blocks * st.f_frsize}); lower num_workers or "
            "MXTPU_DATA_RING_DEPTH, or give the host more shared "
            "memory")


class ShmBatchRing:
    """SPSC ring of ``depth`` batch slots in one shm segment."""

    def __init__(self, batch_size, data_shape, label_width, depth,
                 ctx, tag=""):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_bytes = batch_size * int(
            np.prod(self.data_shape)) * 4
        self._label_bytes = batch_size * label_width * 4
        self._slot_bytes = _HDR_BYTES + self._data_bytes \
            + self._label_bytes
        self._ctx = ctx
        _check_room(depth * self._slot_bytes)
        name = "mxtpu_ds_%x_%s%s" % (os.getpid(),
                                     os.urandom(4).hex(), tag)
        self._seg = _shm.SharedMemory(create=True, name=name,
                                      size=depth * self._slot_bytes)
        self.name = name
        self._closed = False
        # pre-fault every page once at creation (first-touch faults
        # on tmpfs allocate+zero each page, which on old kernels
        # dwarfs the memcpy itself); workers prefault their own page
        # tables at spawn (see prefault())
        self.prefault()
        self.reset_sync()

    # ---------------------------------------------------------- sync
    def reset_sync(self):
        """Fresh semaphores + indices: called before every worker
        (re)spawn — a SIGKILLed producer can die between acquiring
        ``free`` and releasing ``filled``, leaving the counts
        unbalanced; semaphores cannot be reset in place, so restart
        replaces them (the new worker inherits the new set through
        fork) and any undelivered slots are simply re-produced from
        the parent's last-delivered cursor."""
        self._free = self._ctx.Semaphore(self.depth)
        self._filled = self._ctx.Semaphore(0)
        self._stop = self._ctx.Event()
        self._wseq = 0        # producer-side slot index
        self._rseq = 0        # consumer-side slot index

    @property
    def stop(self):
        return self._stop

    def request_stop(self):
        self._stop.set()

    def filled_depth(self):
        """Approximate ready-batch count (the ring-depth gauge)."""
        try:
            return self._filled.get_value()
        except NotImplementedError:     # macOS; gauge degrades to 0
            return 0

    # ---------------------------------------------------- slot views
    def _views(self, seq):
        off = (seq % self.depth) * self._slot_bytes
        hdr = np.frombuffer(self._seg.buf, np.int64,
                            count=_HDR_WORDS, offset=off)
        data = np.frombuffer(
            self._seg.buf, np.float32,
            count=self._data_bytes // 4, offset=off + _HDR_BYTES)
        label = np.frombuffer(
            self._seg.buf, np.float32, count=self._label_bytes // 4,
            offset=off + _HDR_BYTES + self._data_bytes)
        return hdr, data, label

    # ------------------------------------------------- producer side
    def prefault(self):
        """Touch every page from THIS process: a forked worker's
        first write to each shm page is a minor fault that can cost
        more than the memcpy itself on old kernels; paying all of
        them up front (while the parent is still spawning siblings)
        keeps the steady-state produce path fault-free.  Only safe
        before production starts — it zeroes the touched bytes."""
        np.frombuffer(self._seg.buf, np.uint8)[::4096] = 0

    def _acquire_free(self):
        while not self._stop.is_set():
            if self._free.acquire(timeout=0.05):
                return True
        return False

    def produce_slot(self):
        """Zero-copy produce: wait for a free slot (backpressure —
        blocks the *worker*, never grows memory) and return
        ``(data_view, label_view)`` shaped arrays the decoder writes
        straight into shared memory (the native decoder's ``out=``
        lands the pixels here, so a batch crosses the process
        boundary with ONE consumer-side memcpy total).  None when
        teardown interrupted the wait."""
        if not self._acquire_free():
            return None
        _, dview, lview = self._views(self._wseq)
        return (dview.reshape((self.batch_size,) + self.data_shape),
                lview.reshape((self.batch_size, self.label_width)))

    def commit(self, filled, pad, consumed, bad, seq):
        """Publish the slot returned by :meth:`produce_slot`."""
        hdr, _, _ = self._views(self._wseq)
        hdr[:] = (KIND_DATA, filled, pad, consumed, bad, seq, 0, 0)
        self._wseq += 1
        self._filled.release()

    def put_end(self, consumed, bad):
        if not self._acquire_free():
            return False
        hdr, _, _ = self._views(self._wseq)
        hdr[:] = (KIND_END, 0, 0, consumed, bad, 0, 0, 0)
        self._wseq += 1
        self._filled.release()
        return True

    def put_error(self, exc, consumed=0, bad=0):
        """Ship a worker exception to the consumer through the data
        area (self-contained: no side channel to race the ring)."""
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(DataPipelineError(
                f"data-service worker raised unpicklable "
                f"{type(exc).__name__}: {exc}"))
        if len(payload) > self._data_bytes:
            # a slot-truncated pickle would unpickle to a bare
            # UnpicklingError masking the real failure — ship a
            # compact typed summary that FITS instead
            msg = (f"data-service worker raised "
                   f"{type(exc).__name__}: {exc}")
            while True:
                payload = pickle.dumps(DataPipelineError(msg))
                if len(payload) <= self._data_bytes or not msg:
                    break
                msg = msg[:len(msg) // 2]
            payload = payload[:self._data_bytes]   # tiny-slot floor
        if not self._acquire_free():
            return False
        hdr, dview, _ = self._views(self._wseq)
        dview.view(np.uint8)[:len(payload)] = np.frombuffer(
            payload, np.uint8)
        hdr[:] = (KIND_ERROR, 0, 0, consumed, bad, 0, len(payload), 0)
        self._wseq += 1
        self._filled.release()
        return True

    # ------------------------------------------------- consumer side
    def get(self, source, alive, timeout):
        """Deadline-aware take (io.io._bounded_get equivalent for
        rings): poll-acquire ``filled`` in short slices; a producer
        observed dead with nothing left to drain raises
        :class:`RingProducerDead` (the supervisor restarts it), and
        nothing arriving within ``timeout`` raises
        :class:`DataPipelineError` naming the source.

        Returns ``(kind, filled, pad, consumed, bad, seq, payload)``
        where payload is ``(data, label)`` copies for DATA slots, the
        unpickled exception for ERROR slots, else None."""
        deadline = time.monotonic() + timeout \
            if timeout and timeout > 0 else None
        while True:
            if self._filled.acquire(timeout=_POLL_S):
                return self._take()
            if not alive():
                # the final release may have landed after our slice
                if self._filled.acquire(timeout=0.05):
                    return self._take()
                raise RingProducerDead(
                    f"{source}: decode worker process died without "
                    "delivering a batch, end-of-shard, or error")
            if deadline is not None and time.monotonic() >= deadline:
                raise DataPipelineError(
                    f"{source} stalled: no batch arrived within "
                    f"{timeout:g}s (MXTPU_DATA_TIMEOUT); the decode "
                    "worker or its storage is wedged — raise the "
                    "timeout for slow sources, or inspect the shard "
                    "named above") from None

    def _take(self):
        hdr, dview, lview = self._views(self._rseq)
        kind, filled, pad, consumed, bad, seq, plen, _ = \
            (int(x) for x in hdr)
        payload = None
        if kind == KIND_DATA:
            data = dview.reshape(
                (self.batch_size,) + self.data_shape).copy()
            label = lview.reshape(
                (self.batch_size, self.label_width)).copy()
            payload = (data, label)
        elif kind == KIND_ERROR:
            payload = pickle.loads(
                dview.view(np.uint8)[:plen].tobytes())
        self._rseq += 1
        self._free.release()
        return kind, filled, pad, consumed, bad, seq, payload

    # ------------------------------------------------------ teardown
    def close(self):
        """Parent-side: unmap AND unlink.  Idempotent; the segment is
        parent-owned, so this is the single point that decides no
        orphan ever survives in /dev/shm."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            self._seg.close()
        except Exception:
            pass
        try:
            self._seg.unlink()
        except Exception:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
