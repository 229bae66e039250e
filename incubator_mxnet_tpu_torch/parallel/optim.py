"""Functional optimizers for the train step (twin of
``incubator_mxnet_tpu/parallel/optim.py``).

An optimizer is ``init(params) -> state`` and ``update(params, grads,
state, scale=1.0, lr=None, lr_mults=None, wd_mults=None)``, over flat
``{name: tensor}`` dicts, with the JAX package's arithmetic term for
term.  Where the JAX update returns new pytrees, the port updates the
parameters and the state in place, under ``torch.no_grad()``: no second
copy of the weights or the moments is made, which at the full model
saves a parameter-sized buffer per tensor of state.  ``update`` returns
the same (params, state) objects, so code written for the functional
form runs unchanged.

The schedules (``warmup_cosine``, ``warmup_linear``) map an update
count to a learning rate, as plain Python floats.

``from_imperative(opt)`` maps an imperative ``optimizer.Optimizer`` onto
its functional twin, for the Trainer's whole-tree update, which gives
names by ``default_wd_mults`` the reference's wd_mult default (0 for a
name ending in neither ``_weight`` nor ``_gamma``).  ``ShardedTrainStep``
passes no wd_mults: it decays every trainable parameter, as the JAX
step does.
"""
import math

import numpy as np
import torch

__all__ = ["FunctionalOptimizer", "sgd", "adam", "nag", "create",
           "warmup_cosine", "warmup_linear", "default_wd_mults",
           "scheduled_lr", "from_imperative"]


def default_wd_mults(names, overrides=None):
    """The reference's wd_mult default: 1 for names ending in
    ``_weight`` or ``_gamma``, 0 for the rest; ``overrides`` (an
    optimizer's ``wd_mult``) win."""
    overrides = overrides or {}
    return {n: overrides.get(
        n, 1.0 if (n.endswith("_weight") or n.endswith("_gamma"))
        else 0.0) for n in names}


def scheduled_lr(opt):
    """Advance ``opt.num_update`` and return the lr for this update, in
    the order of the imperative path (count, then read the
    scheduler)."""
    opt.num_update += 1
    if opt.lr_scheduler is not None:
        return opt.lr_scheduler(opt.num_update)
    return opt.lr


def _warmup_then(peak_lr, warmup_steps, total_steps, decay_fn):
    """Linear warmup to ``peak_lr`` over ``warmup_steps`` updates, then
    ``decay_fn(frac)`` with frac running 0 -> 1 over the remaining
    steps.  (t+1), so the first update already has a non-zero lr."""
    def lr(t):
        u = float(t) + 1.0
        if u < warmup_steps:
            return peak_lr * u / max(1.0, warmup_steps)
        frac = (u - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return decay_fn(min(1.0, max(0.0, frac)))
    return lr


def warmup_cosine(peak_lr, warmup_steps, total_steps, end_lr=0.0):
    """Linear warmup then cosine decay to ``end_lr``."""
    return _warmup_then(
        peak_lr, warmup_steps, total_steps,
        lambda f: end_lr + 0.5 * (peak_lr - end_lr)
        * (1.0 + math.cos(math.pi * f)))


def warmup_linear(peak_lr, warmup_steps, total_steps, end_lr=0.0):
    """Linear warmup then linear decay to ``end_lr``."""
    return _warmup_then(
        peak_lr, warmup_steps, total_steps,
        lambda f: peak_lr + (end_lr - peak_lr) * f)


class FunctionalOptimizer:
    """``init(params) -> state``; ``update(...)`` changes params and
    state in place and returns them."""

    def __init__(self, init_fn, update_fn, hyper):
        self._init = init_fn
        self._update = update_fn
        self.hyper = hyper

    def init(self, params):
        return self._init(params)

    @torch.no_grad()
    def update(self, params, grads, state, scale=1.0, lr=None,
               lr_mults=None, wd_mults=None):
        """One update of every parameter, in place.  ``lr`` overrides
        the constructed learning rate (a schedule's value);
        ``lr_mults`` / ``wd_mults`` are per-name multipliers (default
        1), the reference's lr_mult / wd_mult."""
        return self._update(params, grads, state, float(scale),
                            None if lr is None else float(lr),
                            lr_mults or {}, wd_mults or {})


def _zeros(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _prepared_grad(g, w, scale, clip, wd):
    """scale * g, clipped, plus wd * w: the gradient both updates
    start from (a new tensor; the caller's g is left as it is)."""
    g = g * scale
    if clip is not None:
        g = g.clamp(-clip, clip)
    if wd:
        g = g + wd * w
    return g


def sgd(learning_rate=0.01, momentum=0.0, wd=0.0, clip_gradient=None,
        nesterov=False):
    """SGD(+momentum, +wd), the reference's sgd_update / sgd_mom_update:
    grad = scale*grad [clipped] + wd*weight; mom = m*mom - lr*grad;
    weight += mom.  With ``nesterov=True``, NAG: mom = m*mom + grad;
    weight -= lr*(grad + m*mom)."""
    mom = momentum

    def init_fn(params):
        return {"mom": _zeros(params)} if mom != 0.0 else {}

    def update_fn(params, grads, state, scale, lr, lr_mults, wd_mults):
        base_lr = learning_rate if lr is None else lr
        for n, w in params.items():
            g = _prepared_grad(grads[n], w, scale, clip_gradient,
                               wd * wd_mults.get(n, 1.0))
            lr_e = base_lr * lr_mults.get(n, 1.0)
            if mom == 0.0:
                w.sub_(lr_e * g)
            elif nesterov:
                m = state["mom"][n].mul_(mom).add_(g)
                w.sub_(lr_e * (g + mom * m))
            else:
                m = state["mom"][n].mul_(mom).sub_(lr_e * g)
                w.add_(m)
        return params, state

    return FunctionalOptimizer(init_fn, update_fn,
                               dict(lr=learning_rate, momentum=mom,
                                    wd=wd))


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
         wd=0.0, clip_gradient=None):
    """Adam, the reference's adam_update: bias correction folded into
    the step size, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t) (in
    fp32, as the JAX package computes it), and epsilon outside the
    square root: w -= lr_t * m / (sqrt(v) + epsilon)."""

    def init_fn(params):
        return {"mean": _zeros(params), "var": _zeros(params), "t": 0}

    def update_fn(params, grads, state, scale, lr, lr_mults, wd_mults):
        t = state["t"] + 1
        one = np.float32(1.0)
        coef1 = one - np.float32(beta1) ** np.float32(t)
        coef2 = one - np.float32(beta2) ** np.float32(t)
        base_lr = learning_rate if lr is None else lr
        lr_t = float(np.float32(base_lr) * np.sqrt(coef2) / coef1)
        for n, w in params.items():
            g = _prepared_grad(grads[n], w, scale, clip_gradient,
                               wd * wd_mults.get(n, 1.0))
            m = state["mean"][n].mul_(beta1).add_((1 - beta1) * g)
            v = state["var"][n].mul_(beta2).add_((1 - beta2) * g * g)
            w.sub_((lr_t * lr_mults.get(n, 1.0)) * m
                   / (v.sqrt() + epsilon))
        state["t"] = t
        return params, state

    return FunctionalOptimizer(init_fn, update_fn,
                               dict(lr=learning_rate, beta1=beta1,
                                    beta2=beta2))


def nag(**kwargs):
    """SGD with Nesterov momentum (``sgd(nesterov=True)``)."""
    return sgd(nesterov=True, **kwargs)


_REGISTRY = {"sgd": sgd, "adam": adam, "nag": nag}


def create(name, **kwargs):
    """An optimizer by name ('sgd', 'adam', 'nag') or factory."""
    if callable(name):
        return name(**kwargs)
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"no functional optimizer '{name}'; available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def from_imperative(opt):
    """The functional twin of an imperative ``optimizer.Optimizer``
    (SGD, NAG, Adam), or None where there is none (multi_precision
    included): the caller then runs the per-parameter updater."""
    from .. import optimizer as opt_mod
    common = dict(learning_rate=opt.lr, wd=opt.wd,
                  clip_gradient=opt.clip_gradient)
    if getattr(opt, "multi_precision", False):
        return None
    if isinstance(opt, opt_mod.NAG):
        return create("nag", momentum=opt.momentum, **common)
    if type(opt) is opt_mod.SGD:
        return create("sgd", momentum=opt.momentum, **common)
    if type(opt) is opt_mod.Adam:
        return create("adam", beta1=opt.beta1, beta2=opt.beta2,
                      epsilon=opt.epsilon, **common)
    return None
