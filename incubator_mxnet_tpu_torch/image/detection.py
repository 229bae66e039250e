"""Detection image pipeline (twin of
``incubator_mxnet_tpu/image/detection.py``; ref:
python/mxnet/image/detection.py — ImageDetIter:624 and the DetAug*
family).

Label wire format matches the reference (detection.py:714-728): a flat
float vector ``[header_width, obj_width, <extra header...>,
obj0..objN]`` where each object is ``[cls_id, xmin, ymin, xmax, ymax,
...]`` with coordinates normalized to [0, 1].  The iterator emits a
fixed-shape (batch, max_objs, obj_width) label tensor padded with -1
rows: one shape for every batch, so the SSD step is captured once.

Augmenters transform (image HWC uint8/float, boxes (N, obj_width))
pairs so geometry stays consistent with the boxes.
"""
import random as pyrandom

import numpy as np

from ..io.io import DataBatch, DataDesc
from .image import ImageIter, imresize, nd_array

__all__ = ["ImageDetIter", "CreateDetAugmenter", "DetBorrowAug",
           "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomPadAug"]


def _parse_det_label(raw):
    """Flat label vector -> (N, obj_width) object array
    (ref: detection.py _check_valid_label/_estimate_label_shape)."""
    raw = np.asarray(raw, np.float32).ravel()
    if raw.size < 2:
        raise ValueError("detection label must start with "
                         "[header_width, obj_width]")
    header_width = int(raw[0])
    obj_width = int(raw[1])
    if header_width < 2 or obj_width < 5:
        raise ValueError(
            f"invalid detection header {raw[:2]} (need header>=2, "
            f"obj_width>=5)")
    body = raw[header_width:]
    if body.size % obj_width != 0:
        raise ValueError(
            f"label body of {body.size} not divisible by obj_width "
            f"{obj_width}")
    return body.reshape(-1, obj_width)


class DetBorrowAug:
    """Wrap an image-only augmenter (color jitter, cast...) for use in
    a detection pipeline (ref: detection.py DetBorrowAug)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, img, label):
        return self.augmenter(img), label


class DetHorizontalFlipAug:
    """Mirror the image and the x-coordinates (ref: detection.py
    DetHorizontalFlipAug)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, label):
        if pyrandom.random() < self.p:
            img = img[:, ::-1]
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return img, label


class DetRandomCropAug:
    """IoU-constrained random crop (ref: detection.py
    DetRandomCropAug): sample a crop whose overlap with at least one
    object satisfies min_object_covered; keep objects whose centers
    fall inside; re-normalize coordinates to the crop."""

    def __init__(self, min_object_covered=0.3,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), max_attempts=25, p=1.0):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.p = p

    def _coverage(self, crop, boxes):
        cx0, cy0, cx1, cy1 = crop
        ix0 = np.maximum(boxes[:, 1], cx0)
        iy0 = np.maximum(boxes[:, 2], cy0)
        ix1 = np.minimum(boxes[:, 3], cx1)
        iy1 = np.minimum(boxes[:, 4], cy1)
        inter = np.clip(ix1 - ix0, 0, None) * \
            np.clip(iy1 - iy0, 0, None)
        area = (boxes[:, 3] - boxes[:, 1]) * \
            (boxes[:, 4] - boxes[:, 2])
        return inter / np.maximum(area, 1e-12)

    def __call__(self, img, label):
        if label.shape[0] == 0 or pyrandom.random() >= self.p:
            return img, label
        h, w = img.shape[:2]
        for _ in range(self.max_attempts):
            scale = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(scale * ratio))
            ch = min(1.0, np.sqrt(scale / ratio))
            cx0 = pyrandom.uniform(0, 1 - cw)
            cy0 = pyrandom.uniform(0, 1 - ch)
            crop = (cx0, cy0, cx0 + cw, cy0 + ch)
            cov = self._coverage(crop, label)
            centers_x = (label[:, 1] + label[:, 3]) / 2
            centers_y = (label[:, 2] + label[:, 4]) / 2
            inside = ((centers_x > crop[0]) & (centers_x < crop[2]) &
                      (centers_y > crop[1]) & (centers_y < crop[3]))
            # acceptance requires a SURVIVING box meeting the
            # coverage bar (not merely any box), and slivers that
            # are mostly outside the crop are dropped with it
            keep = inside & (cov >= min(self.min_object_covered,
                                        0.25))
            if not (inside & (cov >= self.min_object_covered)).any():
                continue
            new = label[keep].copy()
            new[:, 1] = np.clip((new[:, 1] - crop[0]) / cw, 0, 1)
            new[:, 3] = np.clip((new[:, 3] - crop[0]) / cw, 0, 1)
            new[:, 2] = np.clip((new[:, 2] - crop[1]) / ch, 0, 1)
            new[:, 4] = np.clip((new[:, 4] - crop[1]) / ch, 0, 1)
            x0 = int(crop[0] * w)
            y0 = int(crop[1] * h)
            x1 = max(x0 + 1, int(crop[2] * w))
            y1 = max(y0 + 1, int(crop[3] * h))
            return img[y0:y1, x0:x1], new
        return img, label


class DetRandomPadAug:
    """Zoom-out: place the image on a larger canvas (ref:
    detection.py DetRandomPadAug)."""

    def __init__(self, area_range=(1.0, 4.0), fill=127, p=0.5):
        self.area_range = area_range
        self.fill = fill
        self.p = p

    def __call__(self, img, label):
        if pyrandom.random() >= self.p:
            return img, label
        h, w = img.shape[:2]
        scale = pyrandom.uniform(*self.area_range)
        side = np.sqrt(scale)
        nh, nw = int(h * side), int(w * side)
        y0 = pyrandom.randint(0, nh - h)
        x0 = pyrandom.randint(0, nw - w)
        canvas = np.full((nh, nw) + img.shape[2:], self.fill,
                         img.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = img
        label = label.copy()
        label[:, 1] = (label[:, 1] * w + x0) / nw
        label[:, 3] = (label[:, 3] * w + x0) / nw
        label[:, 2] = (label[:, 2] * h + y0) / nh
        label[:, 4] = (label[:, 4] * h + y0) / nh
        return canvas, label


class _DetResizeAug:
    """Force resize to the network input (geometry-free for
    normalized boxes)."""

    def __init__(self, width, height):
        self.width = width
        self.height = height

    def __call__(self, img, label):
        return np.asarray(imresize(img, self.width, self.height)), \
            label


def CreateDetAugmenter(data_shape, resize=True, rand_crop=0.0,
                       rand_pad=0.0, rand_mirror=False, mean=None,
                       std=None, min_object_covered=0.3,
                       area_range=(0.3, 3.0)):
    """Standard detection pipeline (ref: detection.py
    CreateDetAugmenter): [crop] -> [pad] -> resize -> [mirror] ->
    normalize."""
    augs = []
    if rand_crop > 0:
        augs.append(DetRandomCropAug(
            min_object_covered=min_object_covered,
            area_range=(area_range[0], min(1.0, area_range[1])),
            p=rand_crop))
    if rand_pad > 0:
        augs.append(DetRandomPadAug(
            area_range=(1.0, max(1.0, area_range[1])), p=rand_pad))
    if resize:
        augs.append(_DetResizeAug(data_shape[2], data_shape[1]))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    if mean is not None or std is not None:
        mean = np.asarray(mean if mean is not None else 0.0,
                          np.float32)
        std = np.asarray(std if std is not None else 1.0, np.float32)
        augs.append(DetBorrowAug(
            lambda im: (im.astype(np.float32) - mean) / std))
    return augs


class ImageDetIter(ImageIter):
    """Detection iterator over .rec/.lst (ref: detection.py
    ImageDetIter:624): yields data (B, C, H, W) and label
    (B, max_objs, obj_width) padded with -1 rows."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, data_name="data", label_name="label",
                 max_objects=None, **kwargs):
        super().__init__(batch_size, data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=[],    # image augs replaced by det
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        self.det_auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape)
        self._max_objs, self._obj_width = self._estimate_label_shape(
            max_objects)
        self.provide_label = [DataDesc(
            label_name,
            (batch_size, self._max_objs, self._obj_width))]

    def _estimate_label_shape(self, max_objects):
        """(max objects, obj width) for the padded label.

        With ``max_objects`` given, only the first sample is read (for
        obj_width) — the runtime overflow check in :meth:`next` is the
        safety net, so a large .rec file pays no extra full pass.
        Without it, scan the WHOLE dataset's labels (no image decode):
        a partial window would make a crowded late sample overflow the
        padded label mid-epoch (ref: detection.py
        _estimate_label_shape)."""
        max_objs, obj_width = 1, 5
        while True:
            sample = self._next_sample(decode=False)
            if sample is None:
                break
            objs = _parse_det_label(sample[0])
            max_objs = max(max_objs, objs.shape[0])
            obj_width = max(obj_width, objs.shape[1])
            if max_objects is not None:
                break       # first sample fixes obj_width; cap given
        self.reset()
        if max_objects is not None:
            # floor, not exact cap: an overcrowded first sample (which
            # was parsed anyway) must widen the padding rather than
            # fail mid-epoch in next()
            max_objs = max(max_objs, int(max_objects))
        return max_objs, obj_width

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.full(
            (self.batch_size, self._max_objs, self._obj_width), -1.0,
            np.float32)
        i = 0
        while i < self.batch_size:
            sample = self._next_sample()
            if sample is None:
                break
            raw, img = sample
            objs = _parse_det_label(raw)
            img = np.asarray(img)
            for aug in self.det_auglist:
                img, objs = aug(img, objs)
            if img.shape[:2] != (h, w):
                img = np.asarray(imresize(img, w, h))
            img = img.astype(np.float32)
            batch_data[i] = np.transpose(np.atleast_3d(img),
                                         (2, 0, 1))[:c]
            if objs.shape[1] != self._obj_width:
                raise ValueError(
                    f"sample has obj_width {objs.shape[1]} but the "
                    f"dataset was estimated at {self._obj_width}; "
                    "object width must be uniform")
            if objs.shape[0] > self._max_objs:
                raise ValueError(
                    f"sample has {objs.shape[0]} objects > padded "
                    f"capacity {self._max_objs}; pass "
                    "max_objects=<dataset max> to ImageDetIter")
            n = objs.shape[0]
            if n:
                batch_label[i, :n] = objs
            i += 1
        if i == 0:
            raise StopIteration
        return DataBatch([nd_array(batch_data)],
                         [nd_array(batch_label)],
                         pad=self.batch_size - i,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
