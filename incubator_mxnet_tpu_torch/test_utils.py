"""Testing helpers (twin of ``incubator_mxnet_tpu/test_utils.py``;
ref: python/mxnet/test_utils.py — check_numeric_gradient:789,
check_symbolic_forward:921, check_symbolic_backward:995,
check_consistency:1203, assert_almost_equal, rand_ndarray).

The numeric-gradient oracle is the reference's: a random-projection
scalar head, central finite differences per input element, compared
with the framework's own backward (torch's autograd through the bound
Executor).  ``check_consistency(sym, ctx_list)`` runs one graph under
every (context, dtype) entry and compares outputs and gradients: the
reference's way to hold a GPU op against its CPU run, here
``cpu()`` against the card.

``ctx=None`` means the card, as everywhere in the port (it raises on a
host without one); ``default_context`` is exported for the reference's
surface.
"""
import numpy as np

from .context import default_context, resolve
from .executor import Executor
from .ndarray.ndarray import NDArray, array as _nd_array

__all__ = ["assert_almost_equal", "same", "rand_shape_2d",
           "rand_shape_3d", "rand_ndarray", "random_arrays",
           "numeric_grad", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "default_context"]

_RNG = np.random.RandomState(12345)


# ---------------------------------------------------------------------------
# comparison / data helpers
# ---------------------------------------------------------------------------


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20,
                        names=("a", "b"), equal_nan=False):
    """(ref: test_utils.py assert_almost_equal)"""
    a = np.asarray(a.asnumpy() if isinstance(a, NDArray) else a)
    b = np.asarray(b.asnumpy() if isinstance(b, NDArray) else b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               equal_nan=equal_nan,
                               err_msg=f"{names[0]} != {names[1]}")


def rand_shape_2d(dim0=10, dim1=10):
    return (_RNG.randint(1, dim0 + 1), _RNG.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_RNG.randint(1, dim0 + 1), _RNG.randint(1, dim1 + 1),
            _RNG.randint(1, dim2 + 1))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None):
    """(ref: test_utils.py rand_ndarray) dense / csr / row_sparse."""
    dtype = np.dtype(dtype or np.float32)
    dense = _RNG.uniform(-1, 1, shape).astype(dtype)
    if stype == "default":
        return _nd_array(dense, ctx=ctx)
    density = 0.3 if density is None else density
    mask = _RNG.rand(*shape) < density
    dense = dense * mask
    from .ndarray import sparse
    if stype == "csr":
        return sparse.csr_matrix(dense, shape=shape, ctx=ctx)
    if stype == "row_sparse":
        return sparse.row_sparse_array(dense, shape=shape, ctx=ctx)
    raise ValueError(stype)


def random_arrays(*shapes):
    arrays = [_RNG.standard_normal(s).astype(np.float32)
              for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


# ---------------------------------------------------------------------------
# executor plumbing
# ---------------------------------------------------------------------------


def _as_np_dict(sym, location):
    names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(names, location))
    return {k: np.asarray(v.asnumpy() if isinstance(v, NDArray)
                          else v) for k, v in location.items()}


def _bind(sym, location, aux_states=None, grad_req="write", ctx=None,
          dtype=np.float32):
    """``dtype=None`` keeps each location entry's own dtype (the
    check_consistency path); otherwise float entries are cast."""
    resolve(ctx)        # None means the card: raise here without one
    loc = _as_np_dict(sym, location)

    def _in(v):
        if dtype is not None and np.issubdtype(
                np.asarray(v).dtype, np.floating):
            return v.astype(dtype)
        return v
    args = {k: _nd_array(_in(v), ctx=ctx) for k, v in loc.items()}
    aux = {k: _nd_array(np.asarray(
        v.asnumpy() if isinstance(v, NDArray) else v), ctx=ctx)
        for k, v in (aux_states or {}).items()}
    aux_names = sym.list_auxiliary_states()
    if any(n not in aux for n in aux_names):
        # auxiliary states not given (BatchNorm's moving stats) start as
        # the op initializes them: variances at one, the rest at zero
        _, _, aux_shapes = sym.infer_shape(
            **{k: np.shape(v) for k, v in loc.items()})
        for n, shape in zip(aux_names, aux_shapes):
            if n not in aux:
                aux[n] = _nd_array(np.ones(shape, np.float32)
                                   if n.endswith("var") else
                                   np.zeros(shape, np.float32), ctx=ctx)
    if isinstance(grad_req, str):
        req = {n: grad_req for n in args}
    else:
        req = dict(grad_req)
    for n, v in loc.items():  # integer inputs carry no gradient
        if not np.issubdtype(np.asarray(v).dtype, np.floating):
            req[n] = "null"
    grads = {n: _nd_array(np.zeros_like(np.asarray(args[n].asnumpy())),
                          ctx=ctx)
             for n in args if req.get(n, "null") != "null"}
    return Executor(sym, ctx, args, grads, req, aux), loc


# ---------------------------------------------------------------------------
# numeric gradient
# ---------------------------------------------------------------------------


def numeric_grad(f, loc, eps=1e-4):
    """Central-difference gradients of scalar ``f(dict)->float`` w.r.t.
    every element of every float entry of ``loc``."""
    grads = {}
    for name, v in loc.items():
        if not np.issubdtype(np.asarray(v).dtype, np.floating):
            continue
        v = np.array(v, np.float64)
        g = np.zeros_like(v)
        flat = v.ravel()
        gflat = g.ravel()
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            fp = f({**loc, name: v.astype(np.float32)})
            flat[i] = orig - eps
            fm = f({**loc, name: v.astype(np.float32)})
            flat[i] = orig
            gflat[i] = (fp - fm) / (2 * eps)
        grads[name] = g
    return grads


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps=1e-4, rtol=1e-2, atol=1e-4,
                           grad_nodes=None, ctx=None):
    """Finite differences vs the framework backward
    (ref: test_utils.py:789).  Uses a fixed random projection of the
    outputs as the scalar head, like the reference."""
    exe, loc = _bind(sym, location, aux_states, ctx=ctx)
    outs = exe.forward(is_train=True)
    projs = [np.asarray(
        _RNG.standard_normal(o.shape), np.float32) for o in outs]

    def head(loc_np):
        # route through Executor._set_inputs so the bound dtype is
        # preserved (it casts, validates names)
        outs = exe.forward(is_train=True, **loc_np)
        return float(sum((np.asarray(o.asnumpy(), np.float64) * p).sum()
                         for o, p in zip(outs, projs)))

    num = numeric_grad(head, loc, eps=numeric_eps)
    # symbolic: backward with the projection as head gradients
    exe.forward_backward(out_grads=[_nd_array(p, ctx=ctx)
                                    for p in projs], **loc)
    grad_nodes = grad_nodes or [n for n in num]
    for name in grad_nodes:
        if name not in num:
            continue
        sym_grad = exe.grad_dict[name].asnumpy()
        assert_almost_equal(num[name], sym_grad, rtol=rtol, atol=atol,
                            names=(f"numeric[{name}]",
                                   f"symbolic[{name}]"))


def check_symbolic_forward(sym, location, expected, rtol=1e-4,
                           atol=1e-6, aux_states=None, ctx=None):
    """(ref: test_utils.py:921)"""
    exe, _ = _bind(sym, location, aux_states, grad_req="null",
                   ctx=ctx)
    outs = exe.forward(is_train=False)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol=rtol, atol=atol,
                            names=("forward", "expected"))
    return outs


def check_symbolic_backward(sym, location, out_grads, expected,
                            rtol=1e-4, atol=1e-6, aux_states=None,
                            grad_req="write", ctx=None):
    """(ref: test_utils.py:995)"""
    exe, _ = _bind(sym, location, aux_states, grad_req=grad_req,
                   ctx=ctx)
    exe.forward(is_train=True)
    ogs = [_nd_array(np.asarray(
        g.asnumpy() if isinstance(g, NDArray) else g), ctx=ctx)
        for g in (out_grads if isinstance(out_grads, (list, tuple))
                  else [out_grads])]
    exe.forward_backward(out_grads=ogs)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    for name, e in expected.items():
        if e is None:
            continue
        assert_almost_equal(exe.grad_dict[name], e, rtol=rtol,
                            atol=atol,
                            names=(f"grad[{name}]", "expected"))
    return {n: g.asnumpy() for n, g in exe.grad_dict.items()}


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      tol=None, rtol=1e-4, atol=1e-5):
    """Run the same graph under every (ctx, dtype) spec and compare
    forward outputs + gradients pairwise (ref: test_utils.py:1203).

    ctx_list entries: dict(ctx=Context, type_dict={name: dtype}) —
    the reference's format.  bf16/fp16 entries get relaxed tolerance.
    """
    from .base import np_dtype
    if len(ctx_list) < 2:
        raise ValueError("check_consistency needs two or more entries")
    arg_names = sym.list_arguments()
    shapes = ctx_list[0].get("shapes") or {
        k: v for k, v in ctx_list[0].items()
        if isinstance(v, tuple) and k != "ctx"}
    base = {n: (_RNG.standard_normal(shapes[n]) * scale
                ).astype(np.float32) for n in arg_names
            if n in shapes}
    results = []
    for spec in ctx_list:
        ctx = spec.get("ctx")
        type_dict = spec.get("type_dict", {})
        # np_dtype resolves 'bfloat16' (ml_dtypes) too
        loc = {n: v.astype(np_dtype(type_dict.get(n, np.float32)))
               for n, v in base.items()}
        exe, _ = _bind(sym, loc, grad_req=grad_req, ctx=ctx,
                       dtype=None)  # keep the spec's dtypes
        outs = exe.forward_backward()  # one pass: outputs AND grads
        results.append((
            [np.asarray(o.asnumpy(), np.float64) for o in outs],
            {n: np.asarray(g.asnumpy(), np.float64)
             for n, g in exe.grad_dict.items()},
            any(np_dtype(t).itemsize < 4
                for t in type_dict.values())))
    ref_outs, ref_grads, ref_low = results[0]
    for outs, grads, lowprec in results[1:]:
        low = lowprec or ref_low  # either side low-precision
        r = 2e-2 if low else (tol or rtol)
        a = 1e-2 if low else atol
        for o, ro in zip(outs, ref_outs):
            np.testing.assert_allclose(o, ro, rtol=r, atol=a)
        for n in grads:
            np.testing.assert_allclose(grads[n], ref_grads[n],
                                       rtol=r, atol=a)
    return results
