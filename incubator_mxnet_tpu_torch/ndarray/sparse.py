"""Sparse NDArray storage types (twin of
``incubator_mxnet_tpu/ndarray/sparse.py``; ref: include/mxnet/ndarray.h:59-64
storage-type enum, python/mxnet/ndarray/sparse.py).

The reference's design, on torch tensors: a CSR or row-sparse array holds
only its index and value buffers, and no dense mirror is made at
construction.  The kernels (``dot``, ``retain``, ``elemwise_add``, the
lazy optimizer updates) read the buffers with ``index_select``,
``index_add_``, ``searchsorted`` and ``torch.unique``, all on the device:
O(nnz) work, no step on the host.  A dense view is built lazily, and
cached, when a dense-only consumer reads ``_data``; ``cast_storage``
converts explicitly.

Index buffers are int32, as the JAX package's are (its int64 narrows with
64-bit types off), in the same order: CSR columns in row-major order of
the nonzeros, row-sparse rows ascending where the array is made from a
dense one or by a kernel that deduplicates.

Devices: an array's buffers live where they were made (``ctx``; the
iterators give host batches).  A kernel runs on the device of its dense
operand, or of the weight it updates, and copies a sparse operand's
buffers there once: a CSR array keeps its buffers and row ids per device,
so a batch reused every epoch crosses to the card once.  The lazy
updates write the touched rows of the weight in place and leave every
other row unread and unwritten.
"""
import numpy as np
import torch

from .. import autograd
from ..context import Context, resolve
from .ndarray import NDArray, _as_tensor, _np_dtype, array as _dense_array

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array", "cast_storage", "zeros"]

_IDX = torch.int32


class BaseSparseNDArray(NDArray):
    """The lazy dense view shared by both storage types.

    ``_data`` is a property: reading it builds (and caches) the dense
    view for dense-only code; writing it (a mutation, ``kvstore.pull``
    into a sparse ``out``) stores the dense value and marks the sparse
    buffers for a lazy rebuild from it."""

    def __init__(self, shape, ctx=None):
        self._sp_shape = tuple(int(s) for s in shape)
        self._ctx = ctx if isinstance(ctx, Context) else None
        self._dense_cache = None
        self._sp_stale = False

    # -- the NDArray surface without a dense view ----------------------
    @property
    def shape(self):
        return self._sp_shape

    @property
    def size(self):
        n = 1
        for s in self._sp_shape:
            n *= s
        return n

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def dtype(self):
        if self._sp_stale:
            return _np_dtype(self._dense_cache)
        return self._sp_data.dtype

    @property
    def context(self):
        dev = self._dense_cache.device if self._sp_stale \
            else self._sp_data._data.device
        if self._ctx is not None and self._ctx.device == dev:
            return self._ctx
        return Context.from_device(dev)

    ctx = context

    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._todense_impl()
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        self._dense_cache = value
        self._sp_stale = True

    def _ensure_fresh(self):
        if self._sp_stale:
            self._refresh_from_dense(self._dense_cache)
            self._sp_stale = False

    def has_dense_mirror(self):
        """True if a dense buffer of the full shape exists now."""
        return self._dense_cache is not None


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix: ``data`` (nnz,), ``indices`` (nnz,)
    column ids and ``indptr`` (rows + 1,)."""

    def __init__(self, data, indices, indptr, shape):
        super().__init__(shape, data._ctx)
        self._sp_data = data
        self._sp_indices = indices
        self._sp_indptr = indptr
        self._moved = {}

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        self._ensure_fresh()
        return self._sp_data

    @property
    def indices(self):
        self._ensure_fresh()
        return self._sp_indices

    @property
    def indptr(self):
        self._ensure_fresh()
        return self._sp_indptr

    def _refresh_from_dense(self, dense):
        fresh = _dense_to_csr(dense, self._sp_shape)
        self._sp_data = fresh._sp_data
        self._sp_indices = fresh._sp_indices
        self._sp_indptr = fresh._sp_indptr
        self._moved = {}

    def _buffers(self, device):
        """(values, column ids, row ids) on ``device``: the row id of
        each nonzero expanded from ``indptr`` by ``repeat_interleave``
        there.  Kept per device while the buffers stay the same."""
        self._ensure_fresh()
        device = torch.device(device)
        src = (self._sp_data._data, self._sp_indices._data,
               self._sp_indptr._data)
        got = self._moved.get(device)
        if got is None or any(a is not b for a, b in zip(got[3], src)):
            vals, cols, indptr = (t.to(device) for t in src)
            counts = (indptr[1:] - indptr[:-1]).long()
            rows = torch.repeat_interleave(
                torch.arange(counts.shape[0], dtype=_IDX, device=device),
                counts, output_size=vals.shape[0])
            got = self._moved[device] = (vals, cols, rows, src)
        return got[:3]

    def _todense_impl(self):
        vals, cols, rows = self._buffers(self._sp_data._data.device)
        out = torch.zeros(self._sp_shape, dtype=vals.dtype,
                          device=vals.device)
        out[rows.long(), cols.long()] = vals
        return out

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return NDArray(self._data)
        raise ValueError(f"cast csr->{stype} unsupported")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse tensor: ``data`` (k, *shape[1:]) holds the rows
    ``indices`` (k,) of the full shape; every other row is zero (ref:
    src/kvstore/kvstore_dist_server.h:212, the server's O(k) rows)."""

    def __init__(self, data, indices, shape):
        super().__init__(shape, data._ctx)
        self._sp_data = data
        self._sp_indices = indices

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        self._ensure_fresh()
        return self._sp_data

    @property
    def indices(self):
        self._ensure_fresh()
        return self._sp_indices

    def _refresh_from_dense(self, dense):
        rows = _nonzero_rows(dense)
        self._sp_data = NDArray(dense.index_select(0, rows))
        self._sp_indices = NDArray(rows.to(_IDX))

    def _todense_impl(self):
        self._ensure_fresh()
        vals = self._sp_data._data
        idx = self._sp_indices._data.to(vals.device)
        # scatter-add, so an index buffer with duplicates (gradients not
        # deduplicated) densifies to their sum
        return torch.zeros(self._sp_shape, dtype=vals.dtype,
                           device=vals.device).index_add_(0, idx, vals)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return NDArray(self._data)
        raise ValueError(f"cast row_sparse->{stype} unsupported")


def _as_dense_tensor(arg, ctx):
    if isinstance(arg, NDArray):
        return arg._data
    if isinstance(arg, torch.Tensor):
        return arg
    return _as_tensor(np.asarray(arg), resolve(ctx))


def _nonzero_rows(dense):
    return torch.nonzero((dense.reshape(dense.shape[0], -1) != 0)
                         .any(dim=1)).reshape(-1)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense
    array (numpy, NDArray or tensor), on ``ctx`` (default: the card)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(_dense_array(data, ctx, dtype),
                          _dense_array(indices, ctx, "int64"),
                          _dense_array(indptr, ctx, "int64"), shape)
    dense = _as_dense_tensor(arg1, ctx)
    return _dense_to_csr(dense, shape or tuple(dense.shape))


def _dense_to_csr(dense, shape):
    nz = torch.nonzero(dense)                    # row-major, as numpy's
    rows, cols = nz[:, 0], nz[:, 1]
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.zeros(dense.shape[0] + 1, dtype=_IDX,
                         device=dense.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CSRNDArray(NDArray(dense[rows, cols]), NDArray(cols.to(_IDX)),
                      NDArray(indptr), shape)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or from a dense array
    (its rows with a nonzero), on ``ctx`` (default: the card)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(_dense_array(data, ctx, dtype),
                                _dense_array(indices, ctx, "int64"),
                                shape)
    dense = _as_dense_tensor(arg1, ctx)
    rows = _nonzero_rows(dense)
    return RowSparseNDArray(NDArray(dense.index_select(0, rows)),
                            NDArray(rows.to(_IDX)),
                            shape or tuple(dense.shape))


def cast_storage(arr, stype):
    """(ref: src/operator/tensor/cast_storage.cc)"""
    if stype == "default":
        return NDArray(arr._data)
    dense = arr._data
    if stype == "csr":
        return _dense_to_csr(dense, tuple(dense.shape))
    if stype == "row_sparse":
        return row_sparse_array(dense)
    raise ValueError(stype)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of storage type ``stype`` (no stored rows)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            _dense_array(np.zeros((0,) + shape[1:], dtype), ctx),
            _dense_array(np.zeros((0,), np.int64), ctx), shape)
    if stype == "csr":
        return CSRNDArray(
            _dense_array(np.zeros((0,), dtype), ctx),
            _dense_array(np.zeros((0,), np.int64), ctx),
            _dense_array(np.zeros((shape[0] + 1,), np.int64), ctx), shape)
    from .ndarray import zeros as dzeros
    return dzeros(shape, ctx, dtype)


# ---------------------------------------------------------------------------
# sparse kernels (ref: src/operator/tensor/dot.cc CSR paths,
# sparse_retain.cc, optimizer_op.cc MXNET_ADD_SPARSE_OP_ALIAS lazy
# updates), on the device of the dense operand
# ---------------------------------------------------------------------------


def dot(lhs, rhs, transpose_a=False, forward_stype=None):
    """Sparse-aware dot (ref: dot.cc dot(csr, dense), dot(csr.T, dense)).

    dot(csr, dense) -> dense; dot(csr.T, dense) -> dense, or row-sparse
    over the columns the batch touched with ``forward_stype=
    'row_sparse'`` (the embedding-gradient path, ref: dot.cc
    DotCsrTDnsRspImpl); dot(row_sparse, dense) -> dense; otherwise the
    dense product.  A row-sparse ``rhs`` is read through its dense view,
    as the reference reads it."""
    if isinstance(lhs, CSRNDArray):
        d = rhs._data
        vals, cols, rows = lhs._buffers(d.device)
        n_rows, n_cols = lhs._sp_shape
        if not transpose_a:
            # out[r] = sum over the row's nonzeros of vals * d[cols]
            contrib = vals[:, None] * d.index_select(0, cols)
            return NDArray(torch.zeros((n_rows, d.shape[1]), dtype=d.dtype,
                                       device=d.device)
                           .index_add_(0, rows, contrib))
        contrib = vals[:, None] * d.index_select(0, rows)
        if forward_stype == "row_sparse":
            # only the columns this batch touched get a row
            uniq, inv = torch.unique(cols, return_inverse=True)
            out_rows = torch.zeros((uniq.shape[0], d.shape[1]),
                                   dtype=d.dtype, device=d.device) \
                .index_add_(0, inv.reshape(-1), contrib)
            return RowSparseNDArray(NDArray(out_rows), NDArray(uniq),
                                    (n_cols, d.shape[1]))
        # out[c] += vals * d[rows], a scatter-add over the columns
        return NDArray(torch.zeros((n_cols, d.shape[1]), dtype=d.dtype,
                                   device=d.device)
                       .index_add_(0, cols, contrib))
    if isinstance(lhs, RowSparseNDArray) and not transpose_a:
        lhs._ensure_fresh()
        d = rhs._data
        idx = lhs._sp_indices._data.to(d.device).long()
        out = torch.zeros((lhs._sp_shape[0], d.shape[1]), dtype=d.dtype,
                          device=d.device)
        out[idx] = lhs._sp_data._data.to(d.device) @ d
        return NDArray(out)
    a = lhs._data
    return NDArray(torch.matmul(a.T if transpose_a else a, rhs._data))


def retain(data, indices):
    """Only the requested rows of a row-sparse array, in the order asked
    for (ref: src/operator/tensor/sparse_retain.cc).

    A row absent from ``data`` comes back zero; duplicates in the stored
    buffer sum (the array's scatter-add semantics).  Each stored row
    finds its slot by ``searchsorted`` in the sorted request and is
    summed there by ``index_add_``: no dense buffer, no loop."""
    assert isinstance(data, RowSparseNDArray), "retain needs row_sparse"
    data._ensure_fresh()
    vals = data._sp_data._data
    dev = vals.device
    want = indices._data if isinstance(indices, NDArray) \
        else torch.as_tensor(np.asarray(indices, np.int64))
    want = want.to(dev).reshape(-1).long()
    k = want.shape[0]
    want_sorted, order = torch.sort(want, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k, device=dev)
    have = data._sp_indices._data.to(dev).long()
    if k:
        pos = torch.searchsorted(want_sorted, have)
        valid = (pos < k) & (want_sorted[pos.clamp(max=k - 1)] == have)
    else:
        pos = valid = torch.zeros_like(have, dtype=torch.bool)
    seg = torch.where(valid, pos, k)
    summed = torch.zeros((k + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                         device=dev).index_add_(0, seg, vals)[:k]
    return RowSparseNDArray(NDArray(summed.index_select(0, rank)),
                            NDArray(want.to(_IDX)), data._sp_shape)


def elemwise_add(lhs, rhs):
    """row_sparse + row_sparse -> row_sparse over the sorted union of
    their rows, by ``torch.unique`` and ``index_add_`` on the buffers
    (ref: src/operator/tensor/elemwise_binary_op_basic.cc rsp+rsp);
    otherwise the dense sum."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        lhs._ensure_fresh()
        rhs._ensure_fresh()
        lv = lhs._sp_data._data
        dev = lv.device
        all_idx = torch.cat([lhs._sp_indices._data.to(dev, _IDX),
                             rhs._sp_indices._data.to(dev, _IDX)])
        uniq, inv = torch.unique(all_idx, return_inverse=True)
        vals = torch.cat([lv, rhs._sp_data._data.to(dev)], dim=0)
        summed = torch.zeros((uniq.shape[0],) + tuple(vals.shape[1:]),
                             dtype=vals.dtype, device=dev) \
            .index_add_(0, inv.reshape(-1), vals)
        return RowSparseNDArray(NDArray(summed), NDArray(uniq),
                                lhs._sp_shape)
    return NDArray(lhs._data + rhs._data)


add = elemwise_add


def _sparse_grad(grad, weight, rescale_grad, clip_gradient):
    """The touched rows' ids (int64) and gradient rows on the weight's
    device, rescaled and clipped."""
    grad._ensure_fresh()
    dev = weight._data.device
    idx = grad._sp_indices._data.to(dev).long()
    g = grad._sp_data._data.to(dev) * rescale_grad
    if clip_gradient is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    return idx, g


def _write_rows(target, src, idx, rows):
    """Write ``rows`` at ``idx`` into ``target``: in place where target
    holds ``src`` itself (no other row is read or written), else into a
    copy of ``src`` that ``target`` is rebound to."""
    if target._data is src:
        src.index_copy_(0, idx, rows)
    else:
        autograd.rebind(target, src.clone().index_copy_(0, idx, rows))


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None, out=None):
    """Lazy SGD: with a row-sparse ``grad`` only its rows of the weight
    are read and updated (ref: optimizer_op.cc sparse sgd_update alias,
    'lazy update')."""
    target = out if out is not None else weight
    with torch.no_grad():
        w = weight._data
        if isinstance(grad, RowSparseNDArray):
            idx, g = _sparse_grad(grad, weight, rescale_grad,
                                  clip_gradient)
            rows = w.index_select(0, idx)
            _write_rows(target, w, idx, rows - lr * (g + wd * rows))
            return target
        g = grad._data * rescale_grad
        if clip_gradient is not None:
            g = g.clamp(-clip_gradient, clip_gradient)
        autograd.rebind(target, w - lr * (g + wd * w))
    return target


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=None, t=1, out=None):
    """Lazy Adam: with a row-sparse ``grad`` only its rows of the
    weight, mean and var are read and updated (ref: optimizer_op.cc
    adam_update sparse alias)."""
    coef1 = 1.0 - beta1 ** t
    coef2 = 1.0 - beta2 ** t
    lr_t = lr * (coef2 ** 0.5) / coef1
    target = out if out is not None else weight
    with torch.no_grad():
        w, m, v = weight._data, mean._data, var._data
        if isinstance(grad, RowSparseNDArray):
            idx, g = _sparse_grad(grad, weight, rescale_grad,
                                  clip_gradient)
            w_rows = w.index_select(0, idx)
            g = g + wd * w_rows
            m_rows = beta1 * m.index_select(0, idx) + (1 - beta1) * g
            v_rows = beta2 * v.index_select(0, idx) + (1 - beta2) * g * g
            w_rows = w_rows - lr_t * m_rows / (torch.sqrt(v_rows)
                                               + epsilon)
            _write_rows(mean, m, idx, m_rows)
            _write_rows(var, v, idx, v_rows)
            _write_rows(target, w, idx, w_rows)
            return target
        g = grad._data * rescale_grad
        if clip_gradient is not None:
            g = g.clamp(-clip_gradient, clip_gradient)
        g = g + wd * w
        m_new = beta1 * m + (1 - beta1) * g
        v_new = beta2 * v + (1 - beta2) * g * g
        autograd.rebind(mean, m_new)
        autograd.rebind(var, v_new)
        autograd.rebind(target, w - lr_t * m_new / (torch.sqrt(v_new)
                                                    + epsilon))
    return target
