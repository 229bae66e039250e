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
and pulls through the store where there is one.  On a store over
several processes (``dist_sync`` under ``tools/launch.py``) the step
takes the per-parameter route, whose push allreduces each gradient over
the workers, as the JAX Trainer does; ``'tpu'`` over a world of several
ranks takes the world's mesh (one device a rank).

The step sentinel (``MXTPU_NONFINITE_POLICY``, ``MXTPU_GUARD_INTERVAL``,
``MXTPU_MAX_BAD_STEPS``) and the loss scale (``MXTPU_LOSS_SCALE*``) are
the JAX package's.  On the whole-tree route a guarded step reduces the
gradients to one on-device finiteness scalar (``optimizer.all_finite``);
under ``skip`` and ``raise`` the update runs in place and then every
parameter and optimizer-state tensor (Adam's step count included) is
selected against a copy taken before it, ``torch.where(finite, new,
old)``, so a bad step leaves them bit for bit as they were, with no host
read.  The step's bad flag is added to a device counter that the host
reads once every ``MXTPU_GUARD_INTERVAL`` steps; at that read the
learning-rate schedule's count is wound back by the steps dropped.  The
per-parameter route decides at the read before it updates
(``optimizer.GuardedUpdater``), as the JAX route does.  ``arm_perf``
arms the MFU clock (``perf.TrainPerfClock``).  Telemetry is the JAX
package's: ``step`` counts ``train_steps_total`` and times the update as
the ``optimizer`` span, and the parameters and optimizer state are
attributed to the tracing layer's memory gauges.
"""
import pickle

import torch

from .. import optimizer as opt_mod
from .. import resilience, telemetry, tracing
from ..model import _create_kvstore
from ..parallel import optim as foptim

__all__ = ["Trainer"]


class Trainer:
    """Applies an optimizer to a set of Gluon Parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
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
        # step sentinel: guard policy and loss scaler come from the
        # MXTPU_NONFINITE_POLICY / MXTPU_LOSS_SCALE* settings, both
        # inert by default
        self._scaler = opt_mod.LossScaler()
        self._guard = resilience.NumericGuard(name="gluon.Trainer")
        if self._scaler.dynamic and not self._guard.enabled:
            # dynamic loss scaling IS skip-on-overflow: the scaler's
            # overflow signal is the guard's finiteness flag, and an
            # overflow step must not reach the weights
            self._guard.policy = "skip"
        self._perf_clock = None
        self._snapshot = None      # the select's copies (whole tree)
        telemetry.maybe_start_emitter()

        # device-memory attribution (docs/observability.md): weakref
        # providers so a dropped Trainer stops being counted
        def _param_arrays(tr):
            return [p._var for p in tr._params if p._allocated()]

        def _opt_arrays(tr):
            leaves = []
            fstate = getattr(tr, "_fstate", None)
            if fstate is not None:
                leaves += tracing.updater_state_arrays(fstate)
            states = getattr(tr._updater, "states", None)
            if states:
                leaves += tracing.updater_state_arrays(states)
            return leaves

        self._mem_unregister = tracing.register_param_opt_providers(
            self, _param_arrays, _opt_arrays)
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
            self._mesh.device        # this process's one device

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

    @property
    def loss_scale(self):
        """The current loss scale: with loss scaling on
        (MXTPU_LOSS_SCALE*), multiply the loss by this before
        ``backward()``; ``step()`` scales the gradients back."""
        return self._scaler.scale

    @property
    def guard(self):
        """The step sentinel's NumericGuard (skip and bad-step counters,
        host-read accounting)."""
        return self._guard

    def arm_perf(self, flops_per_step=0.0, bytes_per_step=0.0,
                 tokens_per_step=0.0, dtype=None):
        """Arm the MFU/roofline gauges.  The Trainer has no graph to
        cost, so the caller gives the per-step work (e.g.
        ``perf.transformer_train_flops_per_token`` times tokens per
        step).  ``step()`` ticks the clock, which publishes
        ``train_mfu`` / ``train_mbu`` / ``train_tokens_per_sec`` every
        MXTPU_PERF_INTERVAL steps from device time on a card, with no
        device read."""
        from ..perf import TrainPerfClock
        live = [p for p in self._params if p._allocated()]
        dev = live[0]._var.device if live else None
        self._perf_clock = TrainPerfClock(
            flops_per_step=flops_per_step, bytes_per_step=bytes_per_step,
            tokens_per_step=tokens_per_step, device=dev,
            dtype=dtype or "float32")
        return self._perf_clock

    def _init_fused(self):
        """Pick the route: the functional twin of the optimizer, if it
        has one, for the whole-tree update."""
        self._fopt = foptim.from_imperative(self._optimizer)
        kv = self._kvstore
        # a store over several workers reduces per parameter in push
        self._fused = self._fopt is not None and not (
            kv is not None and getattr(kv, "num_workers", 1) > 1)
        if self._fused:
            self._fstate = self._fopt.init(
                {p.name: p._var for p in self._params})

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step, gradients scaled by 1 / batch_size.

        With the step sentinel on (MXTPU_NONFINITE_POLICY=skip, or
        dynamic loss scaling), a step whose gradients are non-finite is
        dropped whole: weights, optimizer state and the LR-schedule step
        count stay untouched."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._fused is None:
            self._init_fused()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._scaler.active:
            # the gradients come from a loss multiplied by loss_scale:
            # scale them back in the same rescale
            self._optimizer.rescale_grad /= self._scaler.scale
        for p in self._params:
            if p._grad is None and p._allocated():
                p._init_grad()
        missing = [p for p in self._params if p._grad is None]
        if missing and not ignore_stale_grad:
            raise UserWarning(
                f"Gradient of Parameter `{missing[0].name}` not set; "
                "call backward first, or set ignore_stale_grad=True")
        live = [p for p in self._params if p._grad is not None]
        telemetry.counter("train_steps_total").inc()
        if self._perf_clock is not None:
            self._perf_clock.tick()
        guarded = self._guard.enabled
        if self._fused:
            with telemetry.span("optimizer"):
                flag = self._fused_step(live, guarded)
            if guarded:
                self._guard_read(flag)
            return
        if guarded:
            grads = [p._grad for p in live]
            if not opt_mod.guarded_step_begin(self._guard, self._scaler,
                                              grads):
                return
        with telemetry.span("optimizer"):
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

    def _guard_read(self, flag):
        """Fold the fused step's finiteness scalar into the guard's
        device counter; on a due step read it (the one host read of the
        interval), wind the LR schedule back by the steps the select
        dropped, feed the scaler and apply the policy."""
        due = self._guard.begin_step()
        opt_mod.accumulate_window(self._guard, flag)
        if not due:
            return
        with telemetry.span("host_sync"):
            bad = opt_mod.read_window_bad(self._guard)
        if bad and self._guard.drops_updates:
            # before record, which may raise under policy=raise
            self._optimizer.num_update -= bad
        self._scaler.update(overflow=bad > 0)
        self._guard.record(bad == 0, dropped=max(bad, 1))

    def _fused_step(self, live, guarded=False):
        """The whole-tree update of the parameters in ``live``, in
        place; the others (stale) keep weight and state.  Guarded, it
        returns the gradients' finiteness scalar, and under a policy
        that drops bad updates every parameter and state tensor is
        selected against its value before the update."""
        opt = self._optimizer
        names = [p.name for p in live]
        params = {p.name: p._var for p in live}
        grads = {p.name: p._grad._data for p in live}
        flag = None
        select = False
        if guarded and grads:
            poison = opt_mod.grad_poison()
            if poison is not None:
                first = names[0]
                grads[first] = grads[first] * poison
            flag = opt_mod.all_finite(list(grads.values()))
            select = self._guard.drops_updates
        if select:
            touched = list(params.values()) + _state_tensors(
                self._fstate, names)
            snap = self._snapshot_of(touched)
        self._fopt.update(
            params, grads, self._fstate, scale=opt.rescale_grad,
            lr=foptim.scheduled_lr(opt),
            lr_mults={n: opt.lr_mult.get(n, 1.0) for n in names},
            wd_mults=foptim.default_wd_mults(names, opt.wd_mult))
        if select:
            with torch.no_grad():
                for t, old in zip(touched, snap):
                    torch.where(flag, t, old, out=t)
        return flag

    def _snapshot_of(self, tensors):
        """Copies of ``tensors`` in buffers kept from step to step (one
        multi-tensor copy)."""
        key = tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors)
        if self._snapshot is None or self._snapshot[0] != key:
            self._snapshot = (key, [torch.empty_like(t) for t in tensors])
        bufs = self._snapshot[1]
        with torch.no_grad():
            torch._foreach_copy_(bufs, tensors)
        return bufs

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


def _state_tensors(fstate, names):
    """The functional optimizer state's tensors that an update of
    ``names`` changes: each name's entry of every per-name dict (the
    momentum, Adam's moments) and every shared tensor (Adam's step
    count)."""
    out = []
    for v in fstate.values():
        if isinstance(v, dict):
            out += [v[n] for n in names if n in v]
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out
