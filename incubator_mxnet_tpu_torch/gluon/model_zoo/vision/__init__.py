"""Vision models of the port (twin of
``incubator_mxnet_tpu/gluon/model_zoo/vision``): ResNet v1/v2, AlexNet,
VGG, SqueezeNet, DenseNet, MobileNet and Inception3, and ``get_model``
over the reference's names."""
from .resnet import *    # noqa: F401,F403
from .alexnet import *   # noqa: F401,F403
from .vgg import *       # noqa: F401,F403
from .others import *    # noqa: F401,F403

from .resnet import __all__ as _r
from .alexnet import __all__ as _a
from .vgg import __all__ as _v
from .others import __all__ as _o

__all__ = list(_r) + list(_a) + list(_v) + list(_o) + ["get_model"]

# every lower-case callable the families export, as the reference
# collects them (get_resnet and get_vgg among them)
_models = {name: globals()[name] for name in __all__[:-1]
           if name[0].islower() and callable(globals()[name])}


def get_model(name, **kwargs):
    """A model by name (``"resnet50_v1"``, ``"vgg16_bn"``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"unknown model '{name}'; available: {sorted(_models)}")
    return _models[name](**kwargs)
