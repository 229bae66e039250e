"""Indexing ops (twin of ``incubator_mxnet_tpu/ops/indexing.py``):
Embedding, take, batch_take, one_hot, pick, gather_nd, scatter_nd and
_scatter_set_nd.  ``_contrib_SparseEmbedding`` comes with the sparse
storage types (ROADMAP item 8)."""
import torch

from ..base import torch_dtype
from .registry import defop


@defop("Embedding")
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Row lookup into an (input_dim, output_dim) table."""
    return weight[data.long()]


@defop("take")
def take(a, indices, axis=0, mode="clip"):
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" \
        else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@defop("batch_take")
def batch_take(a, indices):
    """a[i, indices[i]]."""
    idx = indices.long().reshape(-1)
    return a[torch.arange(a.shape[0], device=a.device), idx]


@defop("one_hot", differentiable=False)
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    idx = indices.long()
    eye = torch.arange(int(depth), device=indices.device)
    out = torch.where(idx[..., None] == eye,
                      torch.tensor(on_value, device=indices.device),
                      torch.tensor(off_value, device=indices.device))
    return out.to(torch_dtype(dtype))


@defop("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    ax = int(axis) % data.ndim
    idx = index.long().clamp(0, data.shape[ax] - 1)
    picked = torch.gather(data, ax, idx.unsqueeze(ax))
    return picked if keepdims else picked.squeeze(ax)


def _nd_key(indices):
    idx = indices.long()
    return tuple(idx[i] for i in range(idx.shape[0]))


@defop("gather_nd")
def gather_nd(data, indices):
    """indices of shape (M, ...) index the first M dims of data."""
    return data[_nd_key(indices)]


@defop("scatter_nd")
def scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(int(s) for s in shape), dtype=data.dtype,
                      device=data.device)
    return out.index_put(_nd_key(indices), data, accumulate=True)


@defop("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    return lhs.index_put(_nd_key(indices), rhs)
