"""Module API (twin of ``incubator_mxnet_tpu/module``): ``BaseModule``
and ``Module``.  The bucketing, sequential and Python modules come with
ROADMAP item A8."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
