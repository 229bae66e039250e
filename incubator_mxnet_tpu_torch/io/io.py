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
straight to CSR.  Not in this slice: ``ImageRecordIter``,
``DataServiceIter`` and ``DevicePrefetchIter`` (the input pipeline,
ROADMAP item A10); each raises.
``PrefetchingIter`` has no data deadline (``MXTPU_DATA_TIMEOUT``), no
fault injection (item A11) and no resumable state (``state_dict``, the
JAX package's, comes with A10's pipeline): a worker that dies is
reported, a wedged one waits.
"""
import gzip
import queue
import struct
import threading

import numpy as np

from ..context import cpu
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "CSVIter", "MNISTIter", "LibSVMIter", "ImageRecordIter",
           "DataServiceIter"]

_GET_POLL_S = 0.2


def _get(q, thread, source):
    """``q.get()`` that notices a producer thread that died without
    delivering."""
    while True:
        try:
            return q.get(timeout=_GET_POLL_S)
        except queue.Empty:
            pass
        if thread is not None and not thread.is_alive():
            try:  # the final put may have landed after our get timed out
                return q.get_nowait()
            except queue.Empty:
                raise RuntimeError(
                    f"{source}: prefetch worker thread died without "
                    "delivering a batch, end-of-epoch, or error") from None


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


def _halt_worker_thread(thread, q, stop):
    """Stop and join a producer, draining its queue while joining (a
    producer mid-put needs a slot to see the stop) and after."""
    stop.set()
    if thread is not None:
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
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
    preparation overlaps the device's step."""

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
        self._start()

    def _start(self):
        # the worker keeps ITS queue and stop event: one that outlives
        # a reset() must not write into the replacement queue
        q, stop = self._queue, self._stop

        def worker():
            while not stop.is_set():
                try:
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
        _halt_worker_thread(self._thread, self._queue, self._stop)
        self._thread = None

    def reset(self):
        self._halt_worker()
        for it in self.iters:
            it.reset()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)
        self._exhausted = False
        self._error = None
        self._start()

    def next(self):
        if self._exhausted:
            raise StopIteration
        if self._error is not None:
            raise self._error
        item = _get(self._queue, self._thread, "PrefetchingIter")
        if item is None:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "err":
            self._error = RuntimeError(
                f"PrefetchingIter worker raised {type(item[1]).__name__}: "
                f"{item[1]}")
            self._error.__cause__ = item[1]
            raise self._error
        data = [d for b in item for d in b.data]
        label = [lb for b in item for lb in b.label]
        return DataBatch(data, label, pad=item[0].pad)

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


def _not_ported(name, item, why=""):
    def ctor(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet{why} (ROADMAP item {item})")
    ctor.__name__ = ctor.__qualname__ = name
    ctor.__doc__ = f"Raises: {name} comes with ROADMAP item {item}."
    return ctor


ImageRecordIter = _not_ported("ImageRecordIter", "A10")
DataServiceIter = _not_ported("DataServiceIter", "A10")
DevicePrefetchIter = _not_ported("DevicePrefetchIter", "A10")
