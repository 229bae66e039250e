"""Ordering ops (twin of ``incubator_mxnet_tpu/ops/order.py``; ref:
src/operator/tensor/ordering_op.cc): ``sort``, ``argsort`` and ``topk``
over ``torch.sort``, stable, so ties keep their order.

The JAX package's conventions hold: a descending ``sort`` is the
ascending sort flipped, ``argsort`` and ``topk``'s indices come back in
the data's dtype whatever ``dtype`` says, and ``topk`` breaks ties
toward the lower index, as ``lax.top_k`` does (a stable descending
sort; ``torch.topk``'s order on ties is unspecified on CUDA).
"""
import torch

from .registry import defop


def _flat_axis(data, axis):
    """(tensor, dim): the whole array flattened when ``axis`` is None."""
    if axis is None:
        return data.reshape(-1), 0
    return data, int(axis)


@defop("sort")
def sort(data, axis=-1, is_ascend=True):
    d, ax = _flat_axis(data, axis)
    out = torch.sort(d, dim=ax, stable=True).values
    if not is_ascend:
        out = torch.flip(out, dims=(ax,))
    return out


@defop("argsort", differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    d, ax = _flat_axis(data if is_ascend else -data, axis)
    return torch.sort(d, dim=ax, stable=True).indices.to(data.dtype)


def _topk_nout(params):
    rt = params.get("ret_typ", "indices")
    return 2 if rt == "both" else 1


@defop("topk", num_outputs=_topk_nout, differentiable=False)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """Top-k along an axis (ref: ordering_op-inl.h TopKParam)."""
    ax = data.ndim - 1 if axis is None else int(axis) % data.ndim
    k = int(k)
    d = torch.movedim(data, ax, -1)
    key = -d if is_ascend else d
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if is_ascend:
        vals = -vals
    if ret_typ == "mask":
        mask = torch.zeros_like(d).scatter_(-1, idx, 1)
        return torch.movedim(mask, -1, ax)
    vals = torch.movedim(vals, -1, ax)
    idx = torch.movedim(idx, -1, ax).to(data.dtype)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx
