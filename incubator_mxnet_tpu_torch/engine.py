"""Execution-ordering surface (twin of ``incubator_mxnet_tpu/engine.py``).

MXNet schedules every kernel through a dependency engine; PyTorch's
CUDA streams give the same asynchronous, ordered execution, so what is
left is the control surface:

- ``wait_all()``      — block until every card the process used is idle
- ``wait(values)``    — block until the given tensors' devices are idle
- naive mode          — synchronize after every eager op, for debugging
                        (``set_engine_type("naive")``, or the environment
                        variable ``MXTPU_ENGINE_TYPE=naive``, else the
                        reference's ``MXNET_ENGINE_TYPE=naive``)
- ``bulk(size)``      — a no-op scope kept for API parity
"""
import contextlib
import os

import torch

__all__ = ["set_engine_type", "maybe_block", "wait_all", "wait", "bulk"]

_state = {"naive": None}


def get_env(name):
    """The environment flag ``name`` (``MXTPU_...``), else the same flag
    under the reference's ``MXNET_`` prefix, else None: the rule of the
    JAX package's ``utils/env.py``."""
    raw = os.environ.get(name)
    if raw is None and name.startswith("MXTPU_"):
        raw = os.environ.get("MXNET_" + name[len("MXTPU_"):])
    return raw


def _is_naive():
    if _state["naive"] is None:
        _state["naive"] = get_env("MXTPU_ENGINE_TYPE") == "naive"
    return _state["naive"]


def set_engine_type(kind):
    """'async' or 'naive' (serial, synchronize after each op)."""
    if kind not in ("async", "naive"):
        raise ValueError(kind)
    _state["naive"] = kind == "naive"


def _devices(values):
    return {t.device for t in values
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"}


def maybe_block(values):
    """Called after each eager op on its output tensors; synchronizes
    their devices in naive mode."""
    if _is_naive():
        wait(values)
    return values


def wait_all():
    """Block until all pending work on every card is complete.  A
    process that never initialized CUDA has none."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def wait(values):
    """Block until the devices of the given tensors are idle."""
    for dev in _devices(values):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def bulk(size=None):
    """API-parity scope for engine op bulking: PyTorch launches each op
    as it comes."""
    yield
