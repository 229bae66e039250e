"""Functional optimizers for the train step (twin of
``incubator_mxnet_tpu/parallel/optim.py``).

An optimizer is ``init(params) -> state`` and ``update(params, grads,
state, scale=1.0, lr=None, lr_mults=None, wd_mults=None)``, over flat
``{name: tensor}`` dicts, with the JAX package's arithmetic term for
term.  Where the JAX update returns new pytrees, the port updates the
parameters and the state in place, under ``torch.no_grad()``, with
multi-tensor ops (``torch._foreach_*``): a handful of launches for the
whole tree (per group of equal lr/wd multipliers) instead of several a
tensor.  ``update`` returns the same (params, state) objects, so code
written for the functional form runs unchanged.

Nothing the update reads per step is a Python number baked into a
launch: the learning rate is a 0-dim fp32 device tensor (a number given
as ``lr`` becomes one), and Adam's step count and bias correction live
on the device, so a captured CUDA graph of the update stays right from
replay to replay (``parallel/_graph.py``).

The schedules (``warmup_cosine``, ``warmup_linear``) map an update
count to a learning rate, as plain Python floats; a captured step writes
the value into its learning-rate tensor before each replay.

``from_imperative(opt)`` maps an imperative ``optimizer.Optimizer`` onto
its functional twin, for the Trainer's whole-tree update, which gives
names by ``default_wd_mults`` the reference's wd_mult default (0 for a
name ending in neither ``_weight`` nor ``_gamma``).  ``ShardedTrainStep``
passes no wd_mults: it decays every trainable parameter, as the JAX
step does.
"""
import math

import torch

__all__ = ["FunctionalOptimizer", "sgd", "adam", "nag", "create",
           "warmup_cosine", "warmup_linear", "default_wd_mults",
           "scheduled_lr", "from_imperative", "state_to_numpy",
           "load_state", "state_structure", "checkpoint_state"]


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
        the constructed learning rate (a schedule's value): a number, or
        a 0-dim fp32 tensor on the parameters' device, which a captured
        step passes so that each replay reads the value written for its
        step.  ``scale`` is a number or such a tensor too.
        ``lr_mults`` / ``wd_mults`` are per-name multipliers (default
        1), the reference's lr_mult / wd_mult."""
        return self._update(params, grads, state, scale, lr,
                            lr_mults or {}, wd_mults or {})


def _zeros(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _lr_tensor(lr, default, like):
    """The learning rate as a 0-dim fp32 tensor on ``like``'s device
    (a tensor passes through)."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), default if lr is None else float(lr),
                      dtype=torch.float32, device=like.device)


def _groups(names, lr_mults, wd_mults):
    """Names grouped by their (lr_mult, wd_mult), in order."""
    out = {}
    for n in names:
        key = (float(lr_mults.get(n, 1.0)), float(wd_mults.get(n, 1.0)))
        out.setdefault(key, []).append(n)
    return out.items()


def _prepared_grads(gs, ws, scale, clip, wd):
    """scale * g, clipped, plus wd * w, for every tensor of a group: the
    gradients both updates start from (new tensors; the caller's are
    left as they are)."""
    gs = torch._foreach_mul(gs, scale)
    if clip is not None:
        torch._foreach_clamp_min_(gs, -clip)
        torch._foreach_clamp_max_(gs, clip)
    if wd:
        torch._foreach_add_(gs, torch._foreach_mul(ws, wd))
    return gs


def sgd(learning_rate=0.01, momentum=0.0, wd=0.0, clip_gradient=None,
        nesterov=False):
    """SGD(+momentum, +wd), the reference's sgd_update / sgd_mom_update:
    grad = scale*grad [clipped] + wd*weight; mom = m*mom - lr*grad;
    weight += mom.  With ``nesterov=True``, NAG: mom = m*mom + grad;
    weight -= lr*(grad + m*mom).  Multi-tensor (``torch._foreach_*``),
    one set of launches per (lr_mult, wd_mult) group."""
    mom = momentum

    def init_fn(params):
        return {"mom": _zeros(params)} if mom != 0.0 else {}

    def update_fn(params, grads, state, scale, lr, lr_mults, wd_mults):
        lr_t = _lr_tensor(lr, learning_rate, next(iter(params.values())))
        for (lm, wm), names in _groups(params, lr_mults, wd_mults):
            ws = [params[n] for n in names]
            g = _prepared_grads([grads[n] for n in names], ws, scale,
                                clip_gradient, wd * wm)
            lr_e = lr_t if lm == 1.0 else lr_t * lm
            if mom == 0.0:
                torch._foreach_sub_(ws, torch._foreach_mul(g, lr_e))
                continue
            ms = [state["mom"][n] for n in names]
            torch._foreach_mul_(ms, mom)
            if nesterov:
                torch._foreach_add_(ms, g)
                step = torch._foreach_mul(ms, mom)
                torch._foreach_add_(step, g)
                torch._foreach_mul_(step, lr_e)
                torch._foreach_sub_(ws, step)
            else:
                torch._foreach_sub_(ms, torch._foreach_mul(g, lr_e))
                torch._foreach_add_(ws, ms)
        return params, state

    return FunctionalOptimizer(init_fn, update_fn,
                               dict(lr=learning_rate, momentum=mom,
                                    wd=wd))


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
         wd=0.0, clip_gradient=None):
    """Adam, the reference's adam_update: bias correction folded into
    the step size, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t), and
    epsilon outside the square root: w -= lr_t * m / (sqrt(v) +
    epsilon).  The step count ``t`` is a 0-dim fp32 tensor on the
    parameters' device and the bias correction is computed there in
    fp32, as the JAX step computes them in-jit."""

    def init_fn(params):
        like = next(iter(params.values()))
        return {"mean": _zeros(params), "var": _zeros(params),
                "t": torch.zeros((), dtype=torch.float32,
                                 device=like.device)}

    def update_fn(params, grads, state, scale, lr, lr_mults, wd_mults):
        t = state["t"]
        t.add_(1)
        tf = t.to(torch.float32)
        coef1 = 1.0 - torch.pow(beta1, tf)
        coef2 = 1.0 - torch.pow(beta2, tf)
        lr_t = _lr_tensor(lr, learning_rate, t) * torch.sqrt(coef2) / coef1
        for (lm, wm), names in _groups(params, lr_mults, wd_mults):
            ws = [params[n] for n in names]
            g = _prepared_grads([grads[n] for n in names], ws, scale,
                                clip_gradient, wd * wm)
            ms = [state["mean"][n] for n in names]
            vs = [state["var"][n] for n in names]
            torch._foreach_mul_(ms, beta1)
            torch._foreach_add_(ms, torch._foreach_mul(g, 1 - beta1))
            g2 = torch._foreach_mul(g, 1 - beta2)
            torch._foreach_mul_(g2, g)
            torch._foreach_mul_(vs, beta2)
            torch._foreach_add_(vs, g2)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, epsilon)
            step = torch._foreach_mul(ms, lr_t if lm == 1.0 else lr_t * lm)
            torch._foreach_div_(step, denom)
            torch._foreach_sub_(ws, step)
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


def state_to_numpy(tree):
    """An optimizer state as numpy arrays (the picklable tree both
    packages write)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


@torch.no_grad()
def load_state(state, tree):
    """Copy ``tree`` (from ``state_to_numpy`` of either package) into
    ``state``'s tensors, in place: a captured step keeps reading
    them."""
    for k, v in tree.items():
        if isinstance(state[k], dict):
            load_state(state[k], v)
            continue
        local = getattr(v, "_local_tensor", None)   # a DTensor's slice
        state[k].copy_(local if local is not None else torch.as_tensor(v))


def state_structure(state):
    """JSON-able description of an optimizer state, ``{keystr path:
    [shape, dtype]}``, recorded in a sharded checkpoint's manifest
    (``extra['optimizer']``) for operators and tooling; loading checks
    the structure by its own key, shape and dtype tests."""
    from .checkpoint import _dtype_name, _flatten, _shape
    return {k: [list(_shape(leaf)), _dtype_name(leaf)]
            for k, leaf in _flatten(state)}


def checkpoint_state(state):
    """Copies of an optimizer state in the JAX package's layout, as a
    sharded checkpoint holds it: Adam's step count ``t`` as int32 (the
    port keeps it fp32 on the device, read by a captured update)."""
    return {k: checkpoint_state(v) if isinstance(v, dict)
            else v.detach().to(torch.int32) if k == "t"
            else v.detach().clone() for k, v in state.items()}
