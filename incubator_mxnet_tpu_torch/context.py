"""Devices (twin of ``incubator_mxnet_tpu/context.py``; ref:
python/mxnet/context.py — mx.cpu()/mx.gpu(), the ``with ctx:`` stack).

A ``Context`` names a device as the reference does (``device_type``,
``device_id``, ``with ctx:``) and converts to the ``torch.device`` it
denotes (``ctx.device``, ``resolve(ctx)``): ``gpu(i)`` is CUDA card i,
and every CPU context (``cpu(i)``, ``cpu_pinned``) is the host.  An
NDArray made on ``cpu(1)`` remembers that context, as the reference's
does, though its tensor lies on the one host device.

Entry points take ``device=None`` (or ``ctx=None``), which means the
innermost ``with ctx:`` scope, else the first CUDA card.  On a host
without one, ``None`` raises: the port never drops to the CPU on its
own.  Callers that want the plain CPU path ask for it with
``device="cpu"`` or ``ctx=cpu()``.  Wherever a device is taken, a
``Context``, a ``torch.device`` and a string all do.
"""
import os
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "default_context", "num_gpus", "gpu_memory_info",
           "default_device", "resolve", "as_device", "current_scope",
           "pin_default"]

_TYPES = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu", "tpu": "gpu",
          "cpu_pinned": "cpu_pinned", "cpu_shared": "cpu_shared"}


class Context:
    """A device context: ``device_type`` 'cpu', 'gpu', 'cpu_pinned' or
    'cpu_shared' ('cuda' and the JAX package's 'tpu' are read as 'gpu'),
    and ``device_id``."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in _TYPES:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = _TYPES[device_type]
        self.device_id = int(device_id)

    @classmethod
    def from_device(cls, device):
        """The Context of a ``torch.device``."""
        device = torch.device(device)
        if device.type == "cuda":
            return cls("gpu", device.index if device.index is not None
                       else torch.cuda.current_device())
        return cls("cpu", 0)

    @property
    def device(self):
        """The ``torch.device`` this context denotes."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    # -- identity --------------------------------------------------------
    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_type == other.device_type
                    and self.device_id == other.device_id)
        if isinstance(other, (torch.device, str)):
            try:
                return self.device == as_device(other)
            except (RuntimeError, ValueError):
                return False
        return NotImplemented

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    # -- memory ----------------------------------------------------------
    def empty_cache(self):
        """Release the card's cached blocks (no-op for the host)."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device):
                torch.cuda.empty_cache()

    def memory_info(self):
        """(free_bytes, total_bytes) of this context's memory: the
        card's, or the host's for a CPU context and on a host without a
        card (as the reference reports host memory off-device)."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            return torch.cuda.mem_get_info(self.device)
        page = os.sysconf("SC_PAGE_SIZE")
        return (os.sysconf("SC_AVPHYS_PAGES") * page,
                os.sysconf("SC_PHYS_PAGES") * page)

    # -- with-statement stack -------------------------------------------
    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def _stack():
    if not hasattr(Context._default_ctx, "stack"):
        Context._default_ctx.stack = []
    return Context._default_ctx.stack


def cpu(device_id=0):
    """The host."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


tpu = gpu   # the JAX package's accelerator context, so its scripts run


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def num_gpus():
    """Number of CUDA cards (0 on a host without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id=0):
    """(free_bytes, total_bytes) of card ``device_id``."""
    return gpu(device_id).memory_info()


num_tpus = num_gpus                 # the JAX package's names for the card
tpu_memory_info = gpu_memory_info


def current_scope():
    """The innermost ``with ctx:`` scope's Context, or None."""
    stack = _stack()
    return stack[-1] if stack else None


# the process-wide default a caller pinned (utils.platform's
# MXTPU_FORCE_CPU), below every ``with ctx:`` scope
_PINNED = {"ctx": None}


def pin_default(ctx):
    """Make ``ctx`` (a Context, or None to unpin) the default where no
    ``with ctx:`` scope is open, in every thread."""
    _PINNED["ctx"] = ctx


def current_context():
    """The innermost ``with ctx:`` scope, else the pinned default, else
    gpu(0) with a card, else cpu(0)."""
    stack = _stack()
    if stack:
        return stack[-1]
    if _PINNED["ctx"] is not None:
        return _PINNED["ctx"]
    return gpu(0) if num_gpus() else cpu(0)


default_context = current_context


def default_device():
    """The innermost ``with ctx:`` scope's device, else the pinned
    default's, else the first CUDA card; raises if there is none."""
    stack = _stack()
    if stack:
        return stack[-1].device
    if _PINNED["ctx"] is not None:
        return _PINNED["ctx"].device
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device on this host: pass device='cpu' to run the "
            "plain PyTorch path explicitly")
    return torch.device("cuda", 0)


def as_device(device):
    """A Context, torch.device or string as a torch.device."""
    if isinstance(device, Context):
        return device.device
    return torch.device(device)


def resolve(device):
    """``device`` as a torch.device; None means ``default_device()``."""
    return default_device() if device is None else as_device(device)
