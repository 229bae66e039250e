"""Imperative optimizers (twin of ``incubator_mxnet_tpu/optimizer.py``):
``Optimizer`` and its registry, SGD (with momentum and multi-precision),
NAG, SGLD, DCASGD, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax,
Nadam, Signum and Test, and ``Updater``.

An update is ``optimizer.update(index, weight, grad, state)`` on
NDArrays; it writes the new weight and state into the arrays given
(``out=``, ``-=``), which for a Gluon Parameter's ``data()`` lands in
the parameter in place.  The fused ones run through the port's
``optimizer_op`` registry ops (``sgd_update``, ``sgd_mom_update``,
``mp_sgd_*``, ``adam_update``, ...); the rest are NDArray arithmetic,
with the reference's formulas.  ``Optimizer._get_wd`` keeps the
reference's default: a name ending in neither ``_weight`` nor ``_gamma``
gets wd_mult 0.

Not in this slice (ROADMAP item A11): ``LossScaler``, ``GuardedUpdater``
and the step-guard helpers.
"""
import math
import pickle

import numpy as np
import torch

from . import ndarray as nd
from . import random as _random
from .ndarray.ndarray import NDArray
from .utils.registry import get_registry

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "Signum",
           "Test", "Updater", "get_updater", "create", "register"]

_REG = get_registry("optimizer")
# register(name=None, obj=None, aliases=()): a bare @register takes the
# class's own name
register = _REG.register


def create(name, **kwargs):
    """Instantiate a registered optimizer by name."""
    return _REG.get(name)(**kwargs)


def _zeros_like(weight, dtype=None):
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=dtype or weight.dtype)


class Optimizer:
    """Base optimizer: learning rate (or scheduler), weight decay,
    gradient rescale and clip, per-name lr_mult / wd_mult."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}
        if sym is not None:
            # only the dunder spellings count (the reference's
            # set_lr_mult reads '__lr_mult__'): AttrScope(__lr_mult__=)
            # and Variable(lr_mult=), which Variable dunder-wraps
            for name, a in sym.attr_dict().items():
                if "__lr_mult__" in a:
                    self.lr_mult[name] = float(a["__lr_mult__"])
                if "__wd_mult__" in a:
                    self.wd_mult[name] = float(a["__wd_mult__"])

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        name = self.idx2name.get(index, index)
        return lr * self.lr_mult.get(name, 1.0)

    def _get_wd(self, index):
        name = self.idx2name.get(index, index)
        # the reference's default: names not ending in _weight or
        # _gamma (biases, beta) get wd_mult 0
        if isinstance(name, str) and not (
                name.endswith("_weight") or name.endswith("_gamma")):
            default_mult = 0.0
        else:
            default_mult = 1.0
        return self.wd * self.wd_mult.get(name, default_mult)

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult.update(args_wd_mult)

    def _clip(self):
        return -1.0 if self.clip_gradient is None else self.clip_gradient

    def _prepared(self, grad):
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clip(-self.clip_gradient, self.clip_gradient)
        return grad


@register("sgd")
class SGD(Optimizer):
    """SGD with momentum; ``multi_precision`` keeps fp32 master weights
    for bf16/fp16 parameters (mp_sgd_update / mp_sgd_mom_update)."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        w32 = None
        if self.multi_precision and weight.dtype != np.float32:
            w32 = weight.astype("float32")
        mom = None
        if self.momentum != 0.0:
            ref = w32 if w32 is not None else weight
            mom = _zeros_like(ref)
        if w32 is not None:
            return (mom, w32)
        return mom

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip())
        if isinstance(state, tuple):
            mom, w32 = state
            if mom is None:
                nd._internal.mp_sgd_update(weight, grad, w32,
                                           out=(weight, w32), **kw)
            else:
                nd._internal.mp_sgd_mom_update(
                    weight, grad, mom, w32, momentum=self.momentum,
                    out=(weight, mom, w32), **kw)
        elif state is None:
            nd._internal.sgd_update(weight, grad, out=weight, **kw)
        else:
            nd._internal.sgd_mom_update(weight, grad, state,
                                        momentum=self.momentum,
                                        out=(weight, state), **kw)


@register("nag")
class NAG(SGD):
    """Nesterov accelerated SGD: mom = m * mom + g;
    w -= lr * (g + m * mom)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prepared(grad) + wd * weight
        if state is not None:
            state *= self.momentum
            state += grad
            weight -= lr * (grad + self.momentum * state)
        else:
            weight -= lr * grad


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a step, plus
    normal(0, sqrt(lr)) noise from the package's default generator on
    the weight's device."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prepared(grad)
        dev = weight._data.device
        gen = _random.default_generator(dev)
        noise = NDArray(torch.randn(weight.shape, generator=gen,
                                    device=dev)
                        * math.sqrt(lr))
        weight -= lr / 2 * (grad + wd * weight)
        weight += noise


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prepared(grad)
        mom, prev = state
        comp = grad + wd * weight + self.lamda * grad * grad * \
            (weight - prev)
        if mom is not None:
            mom *= self.momentum
            mom -= lr * comp
            prev[:] = weight
            weight += mom
        else:
            prev[:] = weight
            weight -= lr * comp


@register("adam")
class Adam(Optimizer):
    """Adam, bias correction folded into the step size."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) * (
            math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t))
        mean, var = state
        nd._internal.adam_update(
            weight, grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            wd=self._get_wd(index), rescale_grad=self.rescale_grad,
            clip_gradient=self._clip(), out=(weight, mean, var))


@register("adagrad")
class AdaGrad(Optimizer):
    """AdaGrad: state += g^2; w -= lr * (g / sqrt(state + eps) + wd w)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prepared(grad)
        state += grad * grad
        weight -= lr * (grad / (state + self.float_stable_eps).sqrt()
                        + wd * weight)


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp; ``centered`` is Graves' variant (rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip(),
                  clip_weights=self.clip_weights or -1.0,
                  gamma1=self.gamma1, epsilon=self.epsilon)
        if self.centered:
            n, g, delta = state
            nd._internal.rmspropalex_update(
                weight, grad, n, g, delta, gamma2=self.gamma2,
                out=(weight, n, g, delta), **kw)
        else:
            nd._internal.rmsprop_update(weight, grad, state,
                                        out=(weight, state), **kw)


@register("adadelta")
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = self._prepared(grad)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1 - self.rho) * grad * grad
        delta = ((acc_delta + self.epsilon).sqrt()
                 / (acc_g + self.epsilon).sqrt()) * grad
        acc_delta[:] = self.rho * acc_delta + (1 - self.rho) * \
            delta * delta
        weight -= delta + wd * weight


@register("ftrl")
class Ftrl(Optimizer):
    """Follow the regularized leader (ftrl_update)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        nd._internal.ftrl_update(
            weight, grad, z, n, lr=self._get_lr(index),
            lamda1=self.lamda1, beta=self.beta, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self._clip(), out=(weight, z, n))


@register("adamax")
class Adamax(Optimizer):
    """AdaMax: Adam with the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clip(-self.clip_gradient, self.clip_gradient)
        m, u = state
        m[:] = self.beta1 * m + (1.0 - self.beta1) * grad
        u[:] = nd.maximum(self.beta2 * u, grad.abs())
        weight -= lr * m / u


@register("nadam")
class Nadam(Optimizer):
    """Adam with Nesterov momentum and a momentum schedule."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clip(-self.clip_gradient, self.clip_gradient)
        m_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        m_t1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                  * self.schedule_decay))
        self.m_schedule *= m_t
        m_sched_next = self.m_schedule * m_t1
        m, v = state
        m[:] = self.beta1 * m + (1.0 - self.beta1) * grad
        v[:] = self.beta2 * v + (1.0 - self.beta2) * grad * grad
        g_prime = grad / (1.0 - self.m_schedule)
        m_prime = m / (1.0 - m_sched_next)
        v_prime = v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - m_t) * g_prime + m_t1 * m_prime
        weight -= lr * m_bar / (v_prime.sqrt() + self.epsilon)


@register("signum")
class Signum(Optimizer):
    """SignSGD (momentum 0) or Signum: steps by the sign."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip())
        if state is None:
            nd._internal.signsgd_update(weight, grad, out=weight, **kw)
        else:
            nd._internal.signum_update(weight, grad, state,
                                       momentum=self.momentum,
                                       wd_lh=self.wd_lh,
                                       out=(weight, state), **kw)


@register("test")
class Test(Optimizer):
    """w += rescale_grad * g; the state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight


ccSGD = SGD


def _to_np(s):
    if isinstance(s, NDArray):
        return s.asnumpy()
    if isinstance(s, tuple):
        return tuple(_to_np(x) for x in s)
    return s


def _to_nd(s, device):
    if isinstance(s, np.ndarray):
        return nd.array(s, ctx=device)
    if isinstance(s, tuple):
        return tuple(_to_nd(x, device) for x in s)
    return s


class Updater:
    """Applies an optimizer per key, making each key's state at its
    first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index,
                                                             weight)
        elif not self.states_synced.get(index, True):
            # restored by set_states as numpy: onto the weight's device
            self.states[index] = _to_nd(self.states[index],
                                        weight.context)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        states = {k: _to_np(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states):
        """Restore states from ``get_states``'s bytes (or the decoded
        object); they move onto each weight's device at its next
        update."""
        loaded = pickle.loads(states) \
            if isinstance(states, (bytes, bytearray)) else states
        if isinstance(loaded, tuple) and len(loaded) == 2 and \
                isinstance(loaded[1], Optimizer):
            loaded, self.optimizer = loaded
        self.states = dict(loaded)
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer):
    return Updater(optimizer)
