"""The port's remaining contrib ops (``ops/contrib_misc.py``) and the
contrib namespaces against the JAX package's, on the CPU with the same
numpy inputs.

- Each of the 18 names of ``contrib_misc.py``: the forward within 1e-5
  (``_contrib_quantize`` and ``_contrib_dequantize`` bit for bit, the
  FFTs within 1e-4 of values up to ~30), and the gradient of a weighted
  sum with respect to every float input where the op is differentiable
  within 1e-5 (``Correlation`` at a kernel of 1, displacement 2 on a
  stride-2 grid, stride 2, padded, and at a kernel of 3, displacement 0,
  ``is_multiply=False``; ``DeformablePSROIPooling``
  with and without offsets; ``IdentityAttachKLSparseReg``'s penalty).
- ``nd.cast_storage`` to a sparse type gives the sparse array, and the
  registry op, inside a graph, raises as the reference's does;
  ``_NDArray`` and ``_Native`` raise ``NotImplementedError`` naming the
  Custom op, the extension point the port has.
- ``mt.contrib.nd``/``sym`` and ``mt.nd.contrib``/``sym.contrib`` hold the
  ``_contrib_*`` ops without the prefix, the JAX package's names; ``import
  incubator_mxnet_tpu_torch.ndarray.contrib`` works.
- A Symbol of MultiBoxPrior, MultiBoxTarget and MultiBoxDetection binds
  (shape inference on ``meta``) and its outputs equal the ``nd`` path's.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
RS = np.random.RandomState(0)


def _r(*shape, scale=1.0):
    return (RS.randn(*shape) * scale).astype(np.float32)


_DATA = _r(1, 2 * 4, 9, 10)
_ROIS = np.array([[0, 1, 2, 12, 14], [0, 6.5, 0, 19, 9.5],
                  [0, 3, 3, 3, 3]], np.float32)

# name -> (inputs, params, differentiable inputs, tolerance)
CASES = {
    "_contrib_fft": ([_r(3, 16)], {}, [0], 1e-4),
    "_contrib_ifft": ([_r(2, 3, 16)], {}, [0], 1e-4),
    "_contrib_count_sketch": (
        [_r(4, 10), np.array([0, 3, 1, 3, 4, 0, 2, 2, 4, 1], np.float32),
         np.array([1, -1, 1, 1, -1, 1, -1, 1, 1, -1], np.float32)],
        dict(out_dim=5), [0], 1e-5),
    "_contrib_quantize": (
        [np.array([[-1.2, -0.5, 0.0, 0.3], [0.5, 0.75, 1.0, 2.0],
                   [0.25, 0.625, -0.875, 0.1]], np.float32),
         np.array([-1.0], np.float32), np.array([1.0], np.float32)],
        {}, [], 0),
    "_contrib_dequantize": (
        [np.arange(0, 256, 17).astype(np.uint8)[:15].reshape(3, 5),
         np.array([-1.0], np.float32), np.array([1.5], np.float32)],
        {}, [], 0),
    "Correlation": (
        [_r(2, 3, 9, 11), _r(2, 3, 9, 11)],
        dict(kernel_size=1, max_displacement=2, stride1=2, stride2=2,
             pad_size=2), [0, 1], 1e-5),
    "_contrib_DeformablePSROIPooling": (
        [_DATA, _ROIS, _r(3, 4, 3, 3, scale=0.5)],
        dict(spatial_scale=0.5, output_dim=2, group_size=2, pooled_size=2,
             part_size=3, sample_per_part=1, trans_std=0.1), [0, 2], 1e-5),
    "IdentityAttachKLSparseReg": (
        [np.clip(_r(6, 4, scale=0.3) + 0.5, 0.05, 0.95)],
        dict(sparseness_target=0.2, penalty=0.5), [0], 1e-5),
    "cast_storage": ([_r(3, 4)], {}, [0], 1e-5),
    "reshape_like": ([_r(2, 6), _r(3, 4)], {}, [0], 1e-5),
    "_sparse_retain": ([_r(5, 3), np.array([4, 1], np.float32)], {}, [0],
                       1e-5),
    "_square_sum": ([_r(3, 4)], dict(keepdims=True), [0], 1e-5),
    "_scatter_elemwise_div": ([_r(3, 4), _r(3, 4) + 3.0], {}, [0, 1], 1e-5),
    "_scatter_plus_scalar": ([_r(3, 4)], dict(scalar=1.5), [0], 1e-5),
    "_scatter_minus_scalar": ([_r(3, 4)], dict(scalar=0.5), [0], 1e-5),
}
# the same ops by their other names, and other settings
ALIASES = {
    "_sparse_cast_storage": "cast_storage",
}
VARIANTS = {
    "Correlation-abs": ("Correlation", dict(
        kernel_size=3, max_displacement=0, pad_size=1, is_multiply=False)),
    "_contrib_DeformablePSROIPooling-no_trans": (
        "_contrib_DeformablePSROIPooling", dict(
            spatial_scale=0.5, output_dim=2, group_size=2, pooled_size=1,
            sample_per_part=2, no_trans=True)),
    "_square_sum-axis": ("_square_sum", dict(axis=0)),
}


def _port_fn(name):
    return getattr(mt.nd, name, None) or getattr(mt.nd._internal, name)


def _check(name, inputs, params, wrt, tol):
    jfn = JOPS[name].fn
    wrt = wrt if JOPS[name].differentiable else []

    def jf(*diff):
        args = [jnp.asarray(a) for a in inputs]
        for i, d in zip(wrt, diff):
            args[i] = d
        return jfn(*args, **params)

    # one compiled function gives the outputs and their vjp
    diff = [jnp.asarray(inputs[i]) for i in wrt]
    shapes = jax.eval_shape(jf, *diff)
    shapes = list(shapes) if isinstance(shapes, (tuple, list)) else [shapes]
    cts = [np.random.RandomState(1).randn(*s.shape).astype(np.float32)
           for s in shapes]
    ct = cts[0] if len(cts) == 1 else tuple(cts)
    if wrt:
        jout, jgrads = jax.jit(lambda c, *d: (jf(*d), jax.vjp(jf, *d)[1](c)))(
            ct, *diff)
    else:
        jout = jax.jit(jf)()
    jouts = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    xs = [mt.nd.array(a, ctx=CPU, dtype=a.dtype) for a in inputs]
    for i in wrt:
        xs[i].attach_grad()
    with mt.autograd.record():
        out = _port_fn(name)(*xs, **params)
    outs = out if isinstance(out, list) else [out]
    assert len(outs) == len(jouts)
    for t, j in zip(outs, jouts):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, name
        if tol == 0:
            np.testing.assert_array_equal(t.asnumpy(), j, err_msg=name)
        else:
            np.testing.assert_allclose(t.asnumpy(), j, rtol=0, atol=tol,
                                       err_msg=name)
    if not wrt:
        return outs
    mt.autograd.backward(outs, [mt.nd.array(c, ctx=CPU) for c in cts])
    for i, jg in zip(wrt, jgrads):
        np.testing.assert_allclose(xs[i].grad.asnumpy(), np.asarray(jg),
                                   rtol=0, atol=tol, err_msg=f"{name} d{i}")
    return outs


@pytest.mark.parametrize("name", sorted(CASES) + sorted(ALIASES)
                         + sorted(VARIANTS))
def test_contrib_misc_matches_jax(name):
    if name in VARIANTS:
        base, params = VARIANTS[name]
        inputs, _, wrt, tol = CASES[base]
        if params.get("no_trans"):
            inputs, wrt = inputs[:2], [0]
        _check(base, inputs, params, wrt, tol)
        return
    inputs, params, wrt, tol = CASES[ALIASES.get(name, name)]
    outs = _check(name, inputs, params, wrt, tol)
    if name == "_contrib_quantize":
        assert outs[0].dtype == np.uint8
        assert {0, 255} <= set(outs[0].asnumpy().ravel().tolist())


def test_every_contrib_misc_name_is_covered():
    names = {n for n, op in JOPS.items()
             if op.fn.__module__.endswith("contrib_misc")}
    names -= {"make_loss", "MakeLoss"}           # elemwise.py's, swept
    assert names == set(CASES) | set(ALIASES) | {"_NDArray", "_Native"}


def test_storage_and_plugin_hooks_raise():
    x = mt.nd.array(np.ones((2, 2), np.float32), ctx=CPU)
    # the imperative cast takes the sparse types (nd.sparse); inside a
    # graph, as on the reference, only 'default'
    assert mt.nd.cast_storage(x, stype="csr").stype == "csr"
    with pytest.raises(ValueError, match="sparse"):
        mt.nd._internal._sparse_cast_storage(x, stype="csr")
    for name in ("_NDArray", "_Native"):
        with pytest.raises(NotImplementedError, match="Custom"):
            getattr(mt.nd._internal, name)(x)


def test_contrib_namespaces():
    want = {n for n in dir(mx.nd.contrib) if not n.startswith("__")}
    for ns in (mt.nd.contrib, mt.contrib.nd, mt.sym.contrib,
               mt.contrib.sym):
        assert {n for n in dir(ns) if not n.startswith("__")} == want
    assert mt.contrib.nd is mt.nd.contrib and mt.contrib.sym is \
        mt.sym.contrib
    mod = importlib.import_module("incubator_mxnet_tpu_torch.ndarray.contrib")
    assert mod is mt.nd.contrib
    assert importlib.import_module(
        "incubator_mxnet_tpu_torch.symbol.contrib") is mt.sym.contrib
    assert mt.nd.contrib.MultiBoxPrior is \
        mt.nd._internal._contrib_MultiBoxPrior


def test_detection_symbol_binds_and_equals_nd():
    rs = np.random.RandomState(2)
    feat = rs.rand(2, 4, 5, 5).astype(np.float32)
    label = np.full((2, 3, 5), -1, np.float32)
    label[0, :2] = [[0, 0.1, 0.1, 0.6, 0.5], [1, 0.5, 0.5, 0.9, 0.8]]
    label[1, 0] = [1, 0.2, 0.3, 0.7, 0.9]
    A = 5 * 5 * 3
    cls = rs.randn(2, 3, A).astype(np.float32)
    loc = (rs.randn(2, 4 * A) * 0.1).astype(np.float32)
    prior = dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0))
    S = mt.sym
    cls_v = S.var("cls")
    anchor = S.contrib.MultiBoxPrior(S.var("feat"), **prior)
    target = S.contrib.MultiBoxTarget(anchor, S.var("label"), cls_v,
                                      negative_mining_ratio=3.0)
    det = S.contrib.MultiBoxDetection(S.softmax(cls_v, axis=1),
                                      S.var("loc"), anchor,
                                      nms_threshold=0.45)
    group = S.Group(list(target) + [det])
    exe = group.simple_bind(CPU, grad_req="null", feat=feat.shape,
                            label=label.shape, cls=cls.shape, loc=loc.shape)
    outs = exe.forward(is_train=False, feat=feat, label=label, cls=cls,
                       loc=loc)
    nd = mt.nd
    a = nd.contrib.MultiBoxPrior(nd.array(feat, ctx=CPU), **prior)
    want = nd.contrib.MultiBoxTarget(a, nd.array(label, ctx=CPU),
                                     nd.array(cls, ctx=CPU),
                                     negative_mining_ratio=3.0)
    want.append(nd.contrib.MultiBoxDetection(
        nd.softmax(nd.array(cls, ctx=CPU), axis=1), nd.array(loc, ctx=CPU),
        a, nms_threshold=0.45))
    assert len(outs) == 4
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.asnumpy(), w.asnumpy())
