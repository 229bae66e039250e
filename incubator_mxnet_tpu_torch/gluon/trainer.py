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

The kvstore (``_init_kvstore`` at the first step, ``model.
_create_kvstore``): on one device 'device', 'local' and None need no
store; a ``KVStore`` object, a 'dist_*' name or 'tpu' give one.
``'tpu'`` takes the ambient mesh (``parallel.use_mesh``) when the
Trainer is made, as the reference does; the gradients come reduced from
the step that made them, so no store is needed.  The whole-tree update
runs whatever the store, on one process; the per-parameter route pushes
and pulls through the store where there is one.  A mesh or store over
several devices or processes raises (ROADMAP item A9).  The environment
settings that would turn on the step guard or loss scaling
(``MXTPU_NONFINITE_POLICY``, ``MXTPU_LOSS_SCALE*``) raise; they come
with ROADMAP item A11, as do telemetry, tracing and ``arm_perf``.
"""
import os
import pickle

from .. import optimizer as opt_mod
from .. import resilience
from ..model import _create_kvstore
from ..parallel import optim as foptim

__all__ = ["Trainer"]


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
        self._kvstore = None
        self._update_on_kvstore = False
        self._kv_initialized = False
        self._fopt = None          # functional optimizer (whole tree)
        self._fstate = None
        self._fused = None         # None: undecided, then True / False
        self._mesh = None
        if isinstance(kvstore, str) and kvstore == "tpu":
            # the ambient mesh now: step() may run outside use_mesh()
            from ..parallel import current_mesh, make_mesh
            self._mesh = current_mesh() or make_mesh()
            self._mesh.device        # one device, or A9 raises

    def _init_kvstore(self):
        """(ref: trainer.py:102) the store, at the first step."""
        if self._kvstore_spec != "tpu":
            kv, on_kv = _create_kvstore(
                self._kvstore_spec, 1,
                {p.name: p.data() for p in self._params if p._allocated()})
            self._kvstore = kv
            self._update_on_kvstore = on_kv and kv is not None
            if kv is not None:
                for i, p in enumerate(self._params):
                    kv.init(i, p.data())
                if self._update_on_kvstore:
                    kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

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
        if not self._kv_initialized:
            self._init_kvstore()
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
        kv = self._kvstore
        for i, p in enumerate(self._params):
            if p._grad is None:
                continue
            if kv is not None and self._update_on_kvstore:
                kv.push(i, p.grad(), priority=-i)
                kv.pull(i, out=p.data(), priority=-i)
            elif kv is not None:
                kv.push(i, p.grad(), priority=-i)
                kv.pull(i, out=p.grad(), priority=-i)
                self._updater(i, p.grad(), p.data())
            else:
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
        """Gradient reduction without an update: on one device there is
        nothing to reduce."""
        if not self._kv_initialized:
            self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def save_states(self, fname):
        """Write the optimizer state (either route) to ``fname``."""
        if self._fused and self._fstate is not None:
            tree = foptim.state_to_numpy(self._fstate)
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
            foptim.load_state(self._fstate, obj["fused"])
            return
        self._updater.set_states(obj)
