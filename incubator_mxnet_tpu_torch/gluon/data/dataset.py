"""Datasets (twin of ``incubator_mxnet_tpu/gluon/data/dataset.py``;
ref: python/mxnet/gluon/data/dataset.py).  ``ArrayDataset`` keeps a
numpy array as a host (``cpu()``) NDArray, so its samples are host
arrays, as the DataLoader's workers need."""
import os
import threading

import numpy as np

from ...context import cpu
from ...ndarray import array as _array

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of arrays (ref: dataset.py ArrayDataset)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise ValueError("arrays must match in length")
            if isinstance(a, np.ndarray):
                a = _array(a, ctx=cpu())
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file (ref: dataset.py
    RecordFileDataset; format: recordio.py).  A read is a seek and a
    read of one handle, so thread workers take turns at it (a lock); a
    forked worker makes a lock of its own, and its reader reopens the
    file (``recordio``)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._lock, self._pid = threading.Lock(), os.getpid()

    def __getitem__(self, idx):
        if self._pid != os.getpid():
            self._lock, self._pid = threading.Lock(), os.getpid()
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
