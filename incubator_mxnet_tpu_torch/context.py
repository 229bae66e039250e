"""Devices (twin of ``incubator_mxnet_tpu/context.py``).

Entry points take ``device=None``, which means the first CUDA card.
On a host without one, ``None`` raises: the port never drops to the
CPU on its own.  Callers that want the plain CPU path ask for it with
``device="cpu"``.
"""
import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve"]


def cpu():
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", device_id)


def default_device():
    """The first CUDA card; raises if the host has none."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device on this host: pass device='cpu' to run the "
            "plain PyTorch path explicitly")
    return gpu(0)


def resolve(device):
    """``device`` as a torch.device; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)
