"""Mixture-of-Experts FFN with top-2 routing, GShard style (twin of
``incubator_mxnet_tpu/ops/moe.py``).

Routing is dense dispatch, as in the JAX package: fixed-capacity
one-hot dispatch and combine tensors of shape (T, E, C) contracted with
einsums, so every shape is static (a CUDA graph captures it) and the
expert products are batched over the expert dimension.  The einsums are
large products that the reference leaves to XLA; here they are torch
ops (cuBLAS), not hand kernels.  The gating (router product, softmax,
argmax, cumsum) and the expert products run in float32 whatever the
data's dtype; the output is cast back to it.

Registered as the differentiable two-output op ``_moe_ffn`` (``nd`` and
``sym`` reach it): outputs (tokens_out, aux_loss), aux_loss the
load-balance penalty E * sum_e f_e * P_e (f_e the top-1 dispatch
fraction, P_e the mean router probability) that training adds with a
small weight (~1e-2).

Tokens over capacity (C = ceil(cf * 2 * T / E) per expert, T the tokens
of one call) are dropped: their expert contribution is zero and the
residual stream carries them.

The one-hot tensors are kept as booleans and the gates placed with
``torch.where``: the values are the JAX package's products by 0/1 (the
two choices of a token never share a slot).  The dispatch and combine
einsums are autograd Functions whose backward rebuilds the float
(T, E, C) tensors from the saved booleans and gates: at bench.py's
width (T = 8192, E = 8, C = 2560) each float one is 671 MB a layer,
which a train step would otherwise keep for the backward.
"""
import math

import torch

from .registry import defop

__all__ = ["moe_ffn_fn", "top2_gating"]


def _route(logits, capacity, renorm=True):
    """Top-2 routing: (oh1, oh2) boolean (T, E, C) one-hots of each
    token's first and second choice in its expert's buffer (an
    overflowed choice has none), their gates (g1, g2) of shape (T,), and
    the aux loss."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    # argmax takes the first index on ties, as jnp.argmax does
    idx1 = probs.argmax(-1)                              # (T,)
    mask1 = torch.nn.functional.one_hot(idx1, e).float()  # (T, E)
    p1 = (probs * mask1).sum(-1)
    idx2 = (probs * (1.0 - mask1)).argmax(-1)
    mask2 = torch.nn.functional.one_hot(idx2, e).float()
    p2 = (probs * mask2).sum(-1)
    if renorm:
        denom = p1 + p2 + 1e-9
        g1, g2 = p1 / denom, p2 / denom
    else:
        g1, g2 = p1, p2

    # position of each token in its expert's buffer; second choices
    # queue behind all first choices (GShard's ordering); the cumsums
    # run in fp32, as the JAX package's do
    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1    # (T, E)
    count1 = mask1.sum(0, keepdim=True)                  # (1, E)
    pos2 = (torch.cumsum(mask2, dim=0) - 1.0 + count1) * mask2
    keep1 = (mask1 > 0) & (pos1 < capacity)
    keep2 = (mask2 > 0) & (pos2 < capacity)
    slots = torch.arange(capacity, device=logits.device)
    oh1 = (pos1.long()[..., None] == slots) & keep1[..., None]
    oh2 = (pos2.long()[..., None] == slots) & keep2[..., None]

    # load-balance aux: E * sum_e (top-1 dispatch fraction * mean prob)
    aux = e * (mask1.mean(0) * probs.mean(0)).sum()
    return oh1, oh2, g1, g2, aux


def _combine(oh1, oh2, g1, g2):
    """The (T, E, C) combine weights: g1 at the first choice's slot, g2
    at the second's (never the same slot), 0 elsewhere."""
    zero = torch.zeros((), dtype=g1.dtype, device=g1.device)
    return torch.where(oh1, g1[:, None, None],
                       torch.where(oh2, g2[:, None, None], zero))


def top2_gating(logits, capacity, renorm=True):
    """GShard top-2 gating with fixed expert capacity.

    logits : (T, E) router scores (any float dtype; gating runs fp32)
    returns (combine (T, E, C) f32, dispatch (T, E, C) f32 0/1,
             aux_loss 0-dim f32)
    """
    oh1, oh2, g1, g2, aux = _route(logits, capacity, renorm)
    return _combine(oh1, oh2, g1, g2), (oh1 | oh2).float(), aux


class _Dispatch(torch.autograd.Function):
    """expert_in = einsum("tec,td->ecd", dispatch, x), dispatch the 0/1
    float of the two one-hots; the backward rebuilds it from the saved
    booleans instead of keeping the float (T, E, C) tensor."""

    @staticmethod
    def forward(ctx, oh1, oh2, x):
        ctx.save_for_backward(oh1, oh2)
        return torch.einsum("tec,td->ecd", (oh1 | oh2).to(x.dtype), x)

    @staticmethod
    def backward(ctx, grad):
        oh1, oh2 = ctx.saved_tensors
        return None, None, torch.einsum(
            "tec,ecd->td", (oh1 | oh2).to(grad.dtype), grad)


class _Combine(torch.autograd.Function):
    """out = einsum("tec,ecd->td", combine, expert_out) with combine
    rebuilt from the booleans and gates in the backward."""

    @staticmethod
    def forward(ctx, oh1, oh2, g1, g2, expert_out):
        ctx.save_for_backward(oh1, oh2, g1, g2, expert_out)
        return torch.einsum("tec,ecd->td", _combine(oh1, oh2, g1, g2),
                            expert_out)

    @staticmethod
    def backward(ctx, grad):
        oh1, oh2, g1, g2, expert_out = ctx.saved_tensors
        g_comb = torch.einsum("td,ecd->tec", grad, expert_out)
        zero = torch.zeros((), dtype=g_comb.dtype, device=g_comb.device)
        g_g1 = torch.where(oh1, g_comb, zero).sum((1, 2))
        g_g2 = torch.where(oh2, g_comb, zero).sum((1, 2))
        del g_comb
        g_out = torch.einsum("tec,td->ecd", _combine(oh1, oh2, g1, g2),
                             grad)
        return None, None, g_g1, g_g2, g_out


def moe_ffn_fn(data, router_weight, up_weight, up_bias, down_weight,
               down_bias, capacity_factor=1.25, renorm=True):
    """MoE FFN on flattened tokens.

    data          : (T, D)
    router_weight : (E, D)   (FullyConnected's (out, in) layout)
    up_weight     : (E, H, D);  up_bias (E, H)
    down_weight   : (E, D, H); down_bias (E, D)
    returns (out (T, D) in data.dtype, aux_loss 0-dim f32)
    """
    t, _ = data.shape
    e = router_weight.shape[0]
    capacity = max(1, math.ceil(float(capacity_factor) * 2 * t / e))
    xf = data.float()
    logits = xf @ router_weight.float().T
    oh1, oh2, g1, g2, aux = _route(logits, capacity, renorm=renorm)
    expert_in = _Dispatch.apply(oh1, oh2, xf)
    hmid = torch.relu(
        torch.einsum("ecd,ehd->ech", expert_in, up_weight.float())
        + up_bias.float()[:, None, :])
    expert_out = torch.einsum("ech,edh->ecd", hmid, down_weight.float()) \
        + down_bias.float()[:, None, :]
    out = _Combine.apply(oh1, oh2, g1, g2, expert_out)
    return out.to(data.dtype), aux


@defop("_moe_ffn", num_outputs=2,
       arg_names=["data", "router_weight", "up_weight", "up_bias",
                  "down_weight", "down_bias"])
def _moe_ffn(data, router_weight, up_weight, up_bias, down_weight,
             down_bias, capacity_factor=1.25, renorm=True):
    """Registry surface of :func:`moe_ffn_fn` (see the module)."""
    return moe_ffn_fn(data, router_weight, up_weight, up_bias,
                      down_weight, down_bias,
                      capacity_factor=float(capacity_factor),
                      renorm=bool(renorm))
