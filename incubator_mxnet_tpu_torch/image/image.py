"""Image utilities, the augmenter zoo and the Python image iterator
(twin of ``incubator_mxnet_tpu/image/image.py``; ref:
python/mxnet/image/image.py — imdecode, resize_short, center/random
crop, Augmenter:482 zoo, ImageIter:999).

Host-side work is numpy and PIL, as in the JAX package, so under the
same ``random.seed`` the same images come out bit for bit.  The
functions return NDArrays on the host (``cpu()``): decode and
augmentation stay off the card, and a batch crosses to it once, where
the executor binds it or a ``DevicePrefetchIter`` stages it.
"""
import io as _io
import os
import random as pyrandom

import numpy as np

from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import NDArray, array as _array

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize",
           "Augmenter", "ResizeAug", "ForceResizeAug", "CastAug",
           "HorizontalFlipAug", "RandomCropAug", "CenterCropAug",
           "ColorNormalizeAug", "BrightnessJitterAug",
           "CreateAugmenter", "augment_to_chw", "ImageIter"]


def nd_array(arr):
    """A host NDArray of ``arr``."""
    return _array(arr, ctx=cpu())


def _pil_image():
    """PIL's ``Image`` module; without PIL, an error that names both
    decoders this host lacks."""
    try:
        from PIL import Image
    except ImportError as exc:
        from . import native_dec
        raise RuntimeError(
            "no JPEG decoder on this host: PIL is not installed and the "
            "native decoder (src/imgdec/imgdec.cc on libjpeg) is "
            + ("built, but serves only ImageRecordIter's fast path"
               if native_dec.available() else
               f"not built ({native_dec.why()})")) from exc
    return Image


def _imdecode_np(buf, to_rgb=True, flag=1):
    """:func:`imdecode` as a numpy HWC uint8 array."""
    Image = _pil_image()
    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        img = img.convert("L")
        return np.asarray(img)[:, :, None]
    img = img.convert("RGB")
    arr = np.asarray(img)
    if not to_rgb:
        arr = arr[:, :, ::-1]
    return arr


def imdecode(buf, to_rgb=True, flag=1):
    """Decode an encoded image buffer to HWC uint8 (ref: image.py
    imdecode; native ref: src/io/image_io.cc)."""
    return nd_array(_imdecode_np(buf, to_rgb, flag))


def imread(filename, flag=1, to_rgb=True):
    """Read and decode an image file (ref: image.py imread); a ``.npy``
    file is loaded as the HWC array it holds."""
    if filename.lower().endswith(".npy"):
        arr = np.load(filename)
        return nd_array(arr if arr.ndim == 3 else arr[:, :, None])
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


def _to_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


# Each function below is a numpy core (``_*_np``: array in, array out)
# and its NDArray face.  ``augment_to_chw`` chains the cores, so a
# decode worker process augments without building a tensor.


def _imresize_np(arr, w, h):
    Image = _pil_image()
    if np.issubdtype(arr.dtype, np.floating):
        in_dtype = arr.dtype
        if arr.ndim == 2:
            arr = arr[:, :, None]
        chans = [np.asarray(
            Image.fromarray(arr[:, :, c].astype(np.float32), mode="F")
            .resize((w, h), Image.BILINEAR))
            for c in range(arr.shape[-1])]
        return np.stack(chans, axis=-1).astype(in_dtype)
    arr = arr.astype(np.uint8)
    pil = Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr)
    out = np.asarray(pil.resize((w, h), Image.BILINEAR))
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def imresize(src, w, h, interp=2):
    """Bilinear resize preserving the input dtype (float pixel data
    from CastAug/ColorNormalizeAug must not be truncated to uint8)."""
    return nd_array(_imresize_np(_to_np(src), w, h))


def _resize_short_np(arr, size):
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return _imresize_np(arr, new_w, new_h)


def resize_short(src, size, interp=2):
    """Resize so the shorter side == size (ref: image.py
    resize_short)."""
    return nd_array(_resize_short_np(_to_np(src), size))


def _fixed_crop_np(arr, x0, y0, w, h, size=None):
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _imresize_np(out, size[0], size[1])
    return out


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    return nd_array(_fixed_crop_np(_to_np(src), x0, y0, w, h, size))


def _center_crop_np(arr, size):
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return _fixed_crop_np(arr, x0, y0, min(new_w, w), min(new_h, h),
                          size), (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    out, box = _center_crop_np(_to_np(src), size)
    return nd_array(out), box


def _random_crop_np(arr, size):
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return _fixed_crop_np(arr, x0, y0, new_w, new_h, size), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    out, box = _random_crop_np(_to_np(src), size)
    return nd_array(out), box


def _color_normalize_np(arr, mean, std=None):
    arr = arr.astype(np.float32)
    arr = arr - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return arr


def color_normalize(src, mean, std=None):
    return nd_array(_color_normalize_np(_to_np(src), mean, std))


# ---------------------------------------------------------------------------
# augmenters (ref: image.py Augmenter:482; native ref:
# src/io/image_aug_default.cc)
# ---------------------------------------------------------------------------


class Augmenter:
    """Image augmenter base (ref: image.py Augmenter:482).  A subclass
    defines ``_np`` (numpy HWC in and out); calling it on an NDArray
    or an array returns an NDArray.  A user's subclass may define
    ``__call__`` alone."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        return nd_array(self._np(_to_np(src)))

    def _np(self, arr):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def _np(self, arr):
        return _resize_short_np(arr, self.size)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def _np(self, arr):
        return _imresize_np(arr, self.size[0], self.size[1])


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def _np(self, arr):
        return _random_crop_np(arr, self.size)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def _np(self, arr):
        return _center_crop_np(arr, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def _np(self, arr):
        if pyrandom.random() < self.p:
            return arr[:, ::-1]
        return arr


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness=0.0):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def _np(self, arr):
        alpha = 1.0 + pyrandom.uniform(-self.brightness,
                                       self.brightness)
        return np.clip(arr.astype(np.float32) * alpha, 0, 255)


class CastAug(Augmenter):
    def _np(self, arr):
        return arr.astype(np.float32)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean, self.std = mean, std

    def _np(self, arr):
        return _color_normalize_np(arr, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False,
                    rand_mirror=False, mean=None, std=None,
                    brightness=0, **kwargs):
    """Standard augmenter chain (ref: image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    auglist.append(CastAug())
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and mean is not False:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def augment_to_chw(img, auglist):
    """Run the augmenter chain and emit CHW float32 (shared by
    ImageIter, ImageRecordIter and the data service's workers so the
    pipelines can't drift).  Augmenters with a numpy core run on the
    array itself; a user's augmenter gets and returns an NDArray."""
    arr = _to_np(img)
    for aug in auglist:
        if type(aug).__call__ is Augmenter.__call__:
            arr = aug._np(arr)
        else:
            arr = _to_np(aug(nd_array(arr)))
    return arr.transpose(2, 0, 1)


class ImageIter(DataIter):
    """Python-side image iterator over .rec or a directory + .lst
    (ref: image.py ImageIter:999)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist):
            raise ValueError("ImageIter needs path_imgrec or "
                             "path_imglist")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self.shuffle = shuffle
        self._recordio = None
        self._imglist = None
        if path_imgrec:
            from .. import recordio as rio
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self._recordio = rio.MXIndexedRecordIO(
                    idx_path, path_imgrec, "r")
                self._seq = list(self._recordio.keys)
            else:
                if shuffle:
                    raise ValueError(
                        "shuffle=True needs an .idx next to "
                        f"{path_imgrec} for random access "
                        "(write one with recordio.MXIndexedRecordIO)")
                self._recordio = rio.MXRecordIO(path_imgrec, "r")
                self._seq = None
        else:
            self._imglist = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    labels = [float(x) for x in parts[1:-1]]
                    self._imglist.append(
                        (os.path.join(path_root, parts[-1]), labels))
            self._seq = list(range(len(self._imglist)))
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self._cursor = 0
        self.reset()

    def reset(self):
        self._cursor = 0
        if self._seq is not None and self.shuffle:
            pyrandom.shuffle(self._seq)
        if self._recordio is not None and self._seq is None:
            self._recordio.reset()

    def _next_sample(self, decode=True):
        """Next (label, image) pair; ``decode=False`` skips the image
        entirely (label-only scans, e.g. detection shape
        estimation)."""
        from .. import recordio as rio
        if self._recordio is not None:
            if self._seq is not None:
                if self._cursor >= len(self._seq):
                    return None
                rec = self._recordio.read_idx(self._seq[self._cursor])
            else:
                rec = self._recordio.read()
                if rec is None:
                    return None
            self._cursor += 1
            header, img_bytes = rio.unpack(rec)
            label = header.label
            return label, imdecode(img_bytes) if decode else None
        if self._cursor >= len(self._seq):
            return None
        path, labels = self._imglist[self._seq[self._cursor]]
        self._cursor += 1
        if not decode:
            return np.asarray(labels, np.float32), None
        with open(path, "rb") as f:
            return np.asarray(labels, np.float32), imdecode(f.read())

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        i = 0
        while i < self.batch_size:
            sample = self._next_sample()
            if sample is None:
                break
            label, img = sample
            batch_data[i] = augment_to_chw(img, self.auglist)
            lab = np.atleast_1d(np.asarray(label, np.float32))
            batch_label[i] = lab[:self.label_width]
            i += 1
        if i == 0:
            raise StopIteration
        pad = self.batch_size - i
        label_out = batch_label[:, 0] if self.label_width == 1 \
            else batch_label
        return DataBatch([nd_array(batch_data)],
                         [nd_array(label_out)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
