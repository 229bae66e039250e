"""Contrib gluon APIs (twin of ``incubator_mxnet_tpu/gluon/contrib``;
ref: python/mxnet/gluon/contrib/)."""
from . import rnn

__all__ = ["rnn"]
