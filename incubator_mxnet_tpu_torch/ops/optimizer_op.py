"""Fused optimizer update ops (twin of
``incubator_mxnet_tpu/ops/optimizer_op.py``): the same 10 names.

Functional, as in the JAX package: each returns the new values, and
``nd``'s ``out=`` writes them back into the caller's arrays
(``nd.sgd_update(w, g, lr=0.1, out=w)``).
"""
import torch

from .registry import defop


def _rescale_clip(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd and weight is not None:
        g = g + wd * weight
    return g


@defop("sgd_update", differentiable=False)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * g


@defop("sgd_mom_update", differentiable=False, num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = momentum * mom - lr * g
    return weight + mom_new, mom_new


@defop("mp_sgd_update", differentiable=False, num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    """Multi-precision SGD: fp32 master weights for bf16/fp16 params."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@defop("mp_sgd_mom_update", differentiable=False, num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    mom_new = momentum * mom - lr * g
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


@defop("adam_update", differentiable=False, num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * m / (torch.sqrt(v) + epsilon)
    return w, m, v


@defop("rmsprop_update", differentiable=False, num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    n_new = (1 - gamma1) * torch.square(g) + gamma1 * n
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new


@defop("rmspropalex_update", differentiable=False, num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    gr = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    n_new = (1 - gamma1) * torch.square(gr) + gamma1 * n
    g_new = (1 - gamma1) * gr + gamma1 * g
    delta_new = (gamma2 * delta
                 - lr * gr / torch.sqrt(n_new - torch.square(g_new)
                                        + epsilon))
    w = weight + delta_new
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new, g_new, delta_new


@defop("ftrl_update", differentiable=False, num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(weight),
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd))
    return w, z_new, n_new


@defop("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * torch.sign(g)


@defop("signum_update", differentiable=False, num_outputs=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = momentum * mom - (1 - momentum) * g
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(mom_new)
    return w, mom_new
