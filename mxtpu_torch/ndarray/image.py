"""The ``mx.nd.image`` namespace (counterpart of ``mxtpu/ndarray/image.py``;
ref: mx.nd.image, generated from the _image_* ops of
src/operator/image/): the NDArray-level wrappers of ``ops/image_ops.py``."""
from ..ops import registry as _reg

_NAMES = ["to_tensor", "normalize", "resize", "crop", "center_crop",
          "flip_left_right", "flip_top_bottom", "random_flip_left_right",
          "random_flip_top_bottom", "brightness", "contrast", "saturation",
          "hue"]

for _n in _NAMES:
    globals()[_n] = _reg.get_op("_image_" + _n).wrapper
del _n

__all__ = list(_NAMES)
