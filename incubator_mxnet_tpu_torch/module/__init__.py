"""Module API (twin of ``incubator_mxnet_tpu/module``): ``BaseModule``,
``Module`` and ``BucketingModule``.  The sequential and Python modules
come with ROADMAP item A8."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
