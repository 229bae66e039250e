"""Gluon Trainer (twin of ``incubator_mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` applies the optimizer to every parameter with a
gradient, with ``rescale_grad = 1 / batch_size`` (a loss summed over
the batch becomes a mean).  Two routes, as in the reference:

- the whole-tree update: an optimizer with a functional twin
  (``parallel.optim.from_imperative``: SGD, NAG, Adam) updates every
  parameter in one call, in place, with the reference's lr_mult and
  wd_mult (``default_wd_mults``: 0 for names ending in neither
  ``_weight`` nor ``_gamma``);
- the per-parameter ``Updater`` loop for the rest (and
  ``multi_precision``), through the ``optimizer_op`` ops.

A parameter whose gradient buffer was never made (``_grad is None``) is
stale: ``step`` raises unless ``ignore_stale_grad``, and then leaves its
weight and optimizer state alone.

On one card the kvstore types 'device', 'local' and None need no
KVStore, the reference's single-device rule.  'tpu' and the 'dist_*'
types need the multi-card half of ROADMAP item A4 (kvstore.py, dist.py,
parallel/mesh.py over NCCL) and raise.  So do the environment settings
that would turn on the step guard or loss scaling
(``MXTPU_NONFINITE_POLICY``, ``MXTPU_LOSS_SCALE*``), which come with
ROADMAP item A11, as do telemetry, tracing and ``arm_perf``.
"""
import os
import pickle

import numpy as np
import torch

from .. import optimizer as opt_mod
from .. import resilience
from ..parallel import optim as foptim

__all__ = ["Trainer"]

_ONE_CARD_KVSTORES = ("device", "local", None)


def _check_env():
    """Raise on an environment setting that would turn on the step
    guard or loss scaling, which the port does not have yet."""
    policy = os.environ.get("MXTPU_NONFINITE_POLICY", "off").lower()
    scale = os.environ.get("MXTPU_LOSS_SCALE", "1")
    dynamic = os.environ.get("MXTPU_LOSS_SCALE_DYNAMIC", "0").lower()
    if policy not in ("", "off") or float(scale or 1) != 1.0 \
            or dynamic in ("1", "true", "yes", "on"):
        raise NotImplementedError(
            "MXTPU_NONFINITE_POLICY / MXTPU_LOSS_SCALE*: the step guard "
            "and loss scaling are not ported yet (ROADMAP item A11)")


class Trainer:
    """Applies an optimizer to a set of Gluon Parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        _check_env()
        if kvstore not in _ONE_CARD_KVSTORES:
            raise NotImplementedError(
                f"kvstore={kvstore!r}: the multi-card kvstores need "
                "kvstore.py, dist.py and parallel/mesh.py over NCCL, the "
                "second half of ROADMAP item A4; on one card use "
                "'device', 'local' or None")
        if hasattr(params, "values"):
            params = list(params.values())
        self._params = [p for p in params if p.grad_req != "null"]
        for p in self._params:
            if p._allocated() and p._grad is None:
                p._init_grad()
        self._scale = 1.0
        optimizer_params = dict(optimizer_params or {})
        if isinstance(optimizer, str):
            idx2name = {i: p.name for i, p in enumerate(self._params)}
            self._optimizer = opt_mod.create(
                optimizer, param_idx2name=idx2name, **optimizer_params)
        else:
            self._optimizer = optimizer
        for p in self._params:
            self._optimizer.set_lr_mult({p.name: p.lr_mult})
            self._optimizer.set_wd_mult({p.name: p.wd_mult})
        self._updater = opt_mod.get_updater(self._optimizer)
        self._kvstore_spec = kvstore
        self._fopt = None          # functional optimizer (whole tree)
        self._fstate = None
        self._fused = None         # None: undecided, then True / False

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_fused(self):
        """Pick the route: the functional twin of the optimizer, if it
        has one, for the whole-tree update."""
        self._fopt = foptim.from_imperative(self._optimizer)
        self._fused = self._fopt is not None
        if self._fused:
            self._fstate = self._fopt.init(
                {p.name: p._var for p in self._params})

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step, gradients scaled by 1 / batch_size."""
        if self._fused is None:
            self._init_fused()
        self._optimizer.rescale_grad = self._scale / batch_size
        for p in self._params:
            if p._grad is None and p._allocated():
                p._init_grad()
        missing = [p for p in self._params if p._grad is None]
        if missing and not ignore_stale_grad:
            raise UserWarning(
                f"Gradient of Parameter `{missing[0].name}` not set; "
                "call backward first, or set ignore_stale_grad=True")
        live = [p for p in self._params if p._grad is not None]
        if self._fused:
            self._fused_step(live)
            return
        for i, p in enumerate(self._params):
            if p._grad is not None:
                self._updater(i, p.grad(), p.data())

    def _fused_step(self, live):
        """The whole-tree update of the parameters in ``live``, in
        place; the others (stale) keep weight and state."""
        opt = self._optimizer
        names = [p.name for p in live]
        self._fopt.update(
            {p.name: p._var for p in live},
            {p.name: p._grad._data for p in live},
            self._fstate, scale=opt.rescale_grad,
            lr=foptim.scheduled_lr(opt),
            lr_mults={n: opt.lr_mult.get(n, 1.0) for n in names},
            wd_mults=foptim.default_wd_mults(names, opt.wd_mult))

    def allreduce_grads(self):
        """Gradient reduction without an update: on one card there is
        nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def save_states(self, fname):
        """Write the optimizer state (either route) to ``fname``."""
        if self._fused and self._fstate is not None:
            tree = _tree_to_numpy(self._fstate)
            resilience.atomic_save(
                fname, lambda f: pickle.dump({"fused": tree}, f))
            return
        data = self._updater.get_states()
        resilience.atomic_save(fname, lambda f: f.write(data))

    def load_states(self, fname):
        raw = resilience.read_validated_bytes(fname)
        obj = resilience.decode_or_corrupt(fname, lambda: pickle.loads(raw))
        if isinstance(obj, dict) and "fused" in obj:
            if self._fused is None:
                self._init_fused()
            if not self._fused:
                raise ValueError(
                    "states file was saved by the whole-tree update but "
                    "this Trainer's optimizer has no functional twin")
            device = self._params[0]._var.device if self._params \
                else torch.device("cpu")
            self._fstate = _tree_to_torch(obj["fused"], device)
            return
        self._updater.set_states(obj)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    return tree
