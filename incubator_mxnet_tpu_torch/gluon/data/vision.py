"""Vision datasets and transforms (twin of
``incubator_mxnet_tpu/gluon/data/vision.py``; ref:
python/mxnet/gluon/data/vision.py).

Nothing downloads: the datasets read files already on disk (MNIST's
idx files, CIFAR-10's binary batches, a folder per class).  Samples
are host (``cpu()``) NDArrays.
"""
import os

import numpy as np

from ...context import cpu
from ...ndarray import array as _array
from .dataset import Dataset


def nd_array(arr):
    return _array(arr, ctx=cpu())

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "ImageFolderDataset",
           "transforms"]


class MNIST(Dataset):
    """MNIST from local idx files (ref: vision.py MNIST)."""

    def __init__(self, root="data/mnist", train=True, transform=None):
        self._transform = transform
        part = "train" if train else "t10k"
        img = os.path.join(root, f"{part}-images-idx3-ubyte")
        lbl = os.path.join(root, f"{part}-labels-idx1-ubyte")
        from ...io.io import _read_idx_images, _read_idx_labels
        self._data = _read_idx_images(
            img if os.path.exists(img) else img + ".gz")
        self._label = _read_idx_labels(
            lbl if os.path.exists(lbl) else lbl + ".gz")

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        data = nd_array(self._data[idx][:, :, None].astype(np.float32))
        label = float(self._label[idx])
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


class FashionMNIST(MNIST):
    def __init__(self, root="data/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(Dataset):
    """CIFAR-10 from local binary batches (ref: vision.py CIFAR10)."""

    def __init__(self, root="data/cifar10", train=True, transform=None):
        self._transform = transform
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] \
            if train else ["test_batch.bin"]
        data, labels = [], []
        for fname in files:
            raw = np.fromfile(os.path.join(root, fname), dtype=np.uint8)
            raw = raw.reshape(-1, 3073)
            labels.append(raw[:, 0])
            data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                        .transpose(0, 2, 3, 1))
        self._data = np.concatenate(data)
        self._label = np.concatenate(labels)

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        data = nd_array(self._data[idx].astype(np.float32))
        label = float(self._label[idx])
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


class ImageFolderDataset(Dataset):
    """Folder-per-class image dataset (ref: vision.py
    ImageFolderDataset); decoding via image package."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fn in sorted(os.listdir(path)):
                if fn.lower().endswith((".jpg", ".jpeg", ".png",
                                        ".bmp", ".npy")):
                    self.items.append((os.path.join(path, fn), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        from ...image import imread
        img = imread(fname, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class transforms:
    """Minimal transform zoo (later reference versions' gluon.data
    .vision.transforms surface)."""

    class Compose:
        def __init__(self, trans):
            self._trans = trans

        def __call__(self, x):
            for t in self._trans:
                x = t(x)
            return x

    class ToTensor:
        """HWC uint8 [0,255] -> CHW float32 [0,1]."""

        def __call__(self, x):
            arr = x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
            return nd_array(arr.transpose(2, 0, 1).astype(np.float32)
                            / 255.0)

    class Normalize:
        def __init__(self, mean, std):
            self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
            self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

        def __call__(self, x):
            arr = x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
            return nd_array((arr - self._mean) / self._std)
