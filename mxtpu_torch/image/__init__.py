"""mx.image: image IO and the augmentation pipeline (counterpart of
``mxtpu/image``; ref: python/mxnet/image/)."""
from .image import (imread, imdecode, imresize, fixed_crop, center_crop,
                    random_crop, resize_short, color_normalize, ImageIter,
                    CreateAugmenter, Augmenter, ResizeAug, ForceResizeAug,
                    RandomCropAug, CenterCropAug, HorizontalFlipAug, CastAug,
                    ColorNormalizeAug, BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug)
from .detection import (CreateDetAugmenter, DetAugmenter, DetBorrowAug,
                        DetHorizontalFlipAug, DetRandomCropAug, ImageDetIter)

__all__ = ["imread", "imdecode", "imresize", "fixed_crop", "center_crop",
           "random_crop", "resize_short", "color_normalize", "ImageIter",
           "CreateAugmenter", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ImageDetIter", "CreateDetAugmenter", "DetAugmenter",
           "DetBorrowAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug"]
