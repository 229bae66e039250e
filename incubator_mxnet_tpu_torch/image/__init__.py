"""The image pipeline (twin of ``incubator_mxnet_tpu/image``; ref:
python/mxnet/image/ and the src/io/ image stack): decode, augment and
batch on the host, in numpy, PIL and the native JPEG decoder."""
from .image import (imdecode, imread, imresize, resize_short, fixed_crop,
                    center_crop, random_crop, color_normalize,
                    Augmenter, ResizeAug, ForceResizeAug, CastAug,
                    HorizontalFlipAug, RandomCropAug, CenterCropAug,
                    ColorNormalizeAug, BrightnessJitterAug,
                    CreateAugmenter, augment_to_chw, ImageIter)
from . import native_dec
from .record_iter import ImageRecordIter
from .detection import (ImageDetIter, CreateDetAugmenter,
                        DetBorrowAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug)

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize",
           "Augmenter", "ResizeAug", "ForceResizeAug", "CastAug",
           "HorizontalFlipAug", "RandomCropAug", "CenterCropAug",
           "ColorNormalizeAug", "BrightnessJitterAug",
           "CreateAugmenter", "augment_to_chw", "ImageIter",
           "ImageRecordIter", "ImageDetIter", "CreateDetAugmenter",
           "DetBorrowAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomPadAug"]
