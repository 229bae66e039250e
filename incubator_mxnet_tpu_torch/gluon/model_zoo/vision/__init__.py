"""Vision models of the port (twin of
``incubator_mxnet_tpu/gluon/model_zoo/vision``): the ResNet family.
AlexNet, VGG and the others come with ROADMAP item A8."""
from .resnet import *    # noqa: F401,F403

from .resnet import __all__ as _r

__all__ = list(_r) + ["get_model"]

_models = {name: globals()[name] for name in _r
           if name[0].islower() and name != "get_resnet"}


def get_model(name, **kwargs):
    """A model by name (``"resnet50_v1"``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"unknown model '{name}'; the port has {sorted(_models)}")
    return _models[name](**kwargs)
