"""Vision model zoo of the port (counterpart of
``mxtpu/gluon/model_zoo/vision/__init__.py``): ResNet v1/v2, AlexNet, VGG
with and without BatchNorm, SqueezeNet, MobileNet v1/v2, DenseNet and
Inception v3, under the reference's 34 names. ``get_model(name,
**kwargs)`` takes any of them, and the dotted spellings
(``mobilenet1.0``)."""
from ....base import MXNetError
# the modules first: a star-imported function would shadow its module
from . import alexnet as _alexnet
from . import densenet as _densenet
from . import inception as _inception
from . import mobilenet as _mobilenet
from . import resnet as _resnet
from . import squeezenet as _squeezenet
from . import vgg as _vgg
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

_models = {}
for _mod in (_alexnet, _densenet, _inception, _mobilenet, _resnet,
             _squeezenet, _vgg):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower() \
                and not _name.startswith("get_"):
            _models[_name] = _obj


def get_model(name, **kwargs):
    """The zoo model ``name`` (ref: vision/__init__.py:get_model), built
    with ``kwargs`` (``classes``, ``pretrained``, ``root``, ``ctx``, ...)."""
    name = name.lower().replace(".", "_")
    if name not in _models:
        raise MXNetError("model %s not supported; available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
