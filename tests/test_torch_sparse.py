"""The port's sparse storage (``ndarray/sparse.py``), its consumers and
config 5 against the JAX package's, on the CPU with the same
seeded numpy inputs: every case of ``tests/test_sparse.py`` and more.

- CSR and row-sparse arrays from dense arrays and from buffers: the
  index buffers bit for bit (int32, the JAX package's narrowed int64),
  values and dense views equal, no dense buffer made at construction;
  ``tostype``, ``nd.cast_storage``, ``nd.zeros(stype=)``.
- ``sparse.dot`` in its three forms (csr, csr transposed to dense and
  to row-sparse, row-sparse): rel 1e-5, row-sparse indices bit for bit.
- ``retain`` and ``elemwise_add``: equal values, indices bit for bit.
- The lazy ``sgd_update`` and ``adam_update``: touched rows within rel
  1e-5, untouched rows bit-unchanged (and written in place).
- ``KVStore.row_sparse_pull`` into a row-sparse and a dense ``out``.
- ``io.LibSVMIter``: batches bit-identical (data, indices, indptr,
  labels, pad), the padded tail and ``num_parts`` included, on a file
  with duplicate, zero and negative feature ids.
- Config 5 (``examples/linear_classification.py``'s loop, through
  ``tools/linear_classification.py``) at the example's ``--quick`` size:
  its first 2 steps' weights against the JAX run, rel 1e-5, and the
  port's full run, which must pass the example's gate.  The JAX package
  compiles anew for each batch's nonzero count (about 1.5 s a step), so
  its side is cut to those steps.
- The four sparse op names are the reference's aliases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402
from incubator_mxnet_tpu_torch.ops.registry import OPS as TOPS  # noqa: E402
from incubator_mxnet_tpu_torch.tools import linear_classification as lc  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
PKGS = (mx, mt)
RTOL = 1e-5


def _kw(P):
    return {} if P is mx else {"ctx": CPU}


def _sp(P):
    return P.nd.sparse


def _rand_dense(rs, shape, density=0.3):
    dense = rs.rand(*shape).astype(np.float32)
    dense[rs.rand(*shape) > density] = 0
    return dense


def _rsp_dense(rs, shape, rows):
    dense = np.zeros(shape, np.float32)
    dense[rows] = rs.rand(len(rows), *shape[1:])
    return dense


def _same_index(a, b):
    a, b = a.asnumpy(), b.asnumpy()
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def _csr_fields(csr):
    return [csr.data, csr.indices, csr.indptr]


def test_csr_roundtrip_matches_jax():
    dense = _rand_dense(np.random.RandomState(0), (6, 9))
    got = {}
    for P in PKGS:
        csr = _sp(P).csr_matrix(dense, **_kw(P))
        assert csr.stype == "csr" and csr.shape == (6, 9)
        assert not csr.has_dense_mirror()
        np.testing.assert_array_equal(csr.asnumpy(), dense)
        np.testing.assert_array_equal(csr.tostype("default").asnumpy(),
                                      dense)
        csr2 = P.nd.cast_storage(P.nd.array(dense, **_kw(P)), "csr")
        np.testing.assert_array_equal(csr2.asnumpy(), dense)
        got[P] = csr
    j, p = got[mx], got[mt]
    np.testing.assert_array_equal(p.data.asnumpy(), j.data.asnumpy())
    _same_index(p.indices, j.indices)
    _same_index(p.indptr, j.indptr)
    # from its buffers
    bufs = (j.data.asnumpy(), j.indices.asnumpy().astype(np.int64),
            j.indptr.asnumpy().astype(np.int64))
    q = mt.nd.sparse.csr_matrix(bufs, shape=(6, 9), ctx=CPU)
    assert not q.has_dense_mirror()
    np.testing.assert_array_equal(q.asnumpy(), dense)
    _same_index(q.indices, j.indices)
    assert isinstance(mt.nd.array(dense, ctx=CPU).tostype("csr"),
                      mt.nd.CSRNDArray)


def test_row_sparse_roundtrip_matches_jax():
    dense = _rsp_dense(np.random.RandomState(1), (8, 4), [1, 3, 6])
    got = {}
    for P in PKGS:
        rsp = _sp(P).row_sparse_array(dense, **_kw(P))
        assert rsp.stype == "row_sparse" and not rsp.has_dense_mirror()
        np.testing.assert_array_equal(rsp.asnumpy(), dense)
        np.testing.assert_array_equal(
            P.nd.cast_storage(P.nd.array(dense, **_kw(P)),
                              "row_sparse").asnumpy(), dense)
        got[P] = rsp
    _same_index(got[mt].indices, got[mx].indices)
    np.testing.assert_array_equal(got[mt].data.asnumpy(),
                                  got[mx].data.asnumpy())
    # buffers with a duplicate row sum when densified, in both
    vals = np.arange(6, dtype=np.float32).reshape(3, 2)
    idx = np.array([4, 1, 4])
    for P in PKGS:
        d = _sp(P).row_sparse_array((vals, idx), shape=(6, 2),
                                    **_kw(P)).asnumpy()
        np.testing.assert_array_equal(d[4], vals[0] + vals[2])
    for stype in ("csr", "row_sparse"):
        z = mt.nd.zeros((5, 3), ctx=CPU, stype=stype)
        j = mx.nd.sparse.zeros(stype, (5, 3))
        assert z.stype == stype and z.shape == (5, 3)
        np.testing.assert_array_equal(z.asnumpy(), j.asnumpy())
        _same_index(z.indices, j.indices)


@pytest.mark.parametrize("form", ["csr", "csr_T", "csr_T_rsp", "rsp"])
def test_sparse_dot_matches_jax(form):
    rs = np.random.RandomState(2)
    dense = _rand_dense(rs, (5, 7)) if form != "rsp" \
        else _rsp_dense(rs, (5, 7), [0, 3])
    w = rs.rand(7 if form in ("csr", "rsp") else 5, 3).astype(np.float32)
    got = {}
    for P in PKGS:
        sp = _sp(P)
        lhs = sp.row_sparse_array(dense, **_kw(P)) if form == "rsp" \
            else sp.csr_matrix(dense, **_kw(P))
        got[P] = sp.dot(lhs, P.nd.array(w, **_kw(P)),
                        transpose_a=form.startswith("csr_T"),
                        forward_stype="row_sparse"
                        if form == "csr_T_rsp" else None)
    want = dense.T @ w if form.startswith("csr_T") else dense @ w
    np.testing.assert_allclose(got[mt].asnumpy(), want, rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(got[mt].asnumpy(), got[mx].asnumpy(),
                               rtol=RTOL, atol=1e-6)
    if form == "csr_T_rsp":
        assert got[mt].stype == "row_sparse"
        _same_index(got[mt].indices, got[mx].indices)


def test_retain_and_elemwise_add_match_jax():
    rs = np.random.RandomState(3)
    a = _rsp_dense(rs, (10, 3), [0, 2, 5, 9])
    b = _rsp_dense(rs, (10, 3), [2, 4, 9])
    want = np.array([9, 1, 5, 2])
    got = {}
    for P in PKGS:
        sp = _sp(P)
        ra, rb = (sp.row_sparse_array(d, **_kw(P)) for d in (a, b))
        got[P] = (sp.retain(ra, P.nd.array(want, **_kw(P))),
                  sp.elemwise_add(ra, rb))
    for g, j in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(g.data.asnumpy(), j.data.asnumpy())
        _same_index(g.indices, j.indices)
        np.testing.assert_array_equal(g.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(got[mt][1].asnumpy(), a + b)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_lazy_updates_match_jax_and_leave_other_rows(opt):
    rs = np.random.RandomState(4)
    w0 = rs.randn(12, 3).astype(np.float32)
    m0, v0 = rs.randn(12, 3).astype(np.float32), \
        rs.rand(12, 3).astype(np.float32)
    rows = [1, 7, 10]
    g = _rsp_dense(rs, (12, 3), rows)
    got = {}
    for P in PKGS:
        sp = _sp(P)
        w, m, v = (P.nd.array(a, **_kw(P)) for a in (w0, m0, v0))
        grad = sp.row_sparse_array(g, **_kw(P))
        if opt == "sgd":
            sp.sgd_update(w, grad, lr=0.3, wd=0.01, rescale_grad=0.5,
                          clip_gradient=0.4)
        else:
            sp.adam_update(w, grad, m, v, lr=0.1, wd=0.01, t=3,
                           clip_gradient=0.4)
        got[P] = [a.asnumpy() for a in (w, m, v)]
    other = [r for r in range(12) if r not in rows]
    for new, old in zip(got[mt], (w0, m0, v0)):
        np.testing.assert_array_equal(new[other], old[other])
    for new, ref in zip(got[mt], got[mx]):
        np.testing.assert_allclose(new, ref, rtol=RTOL, atol=1e-7)
    assert not np.array_equal(got[mt][0][rows], w0[rows])
    # the weight's own tensor took the rows: written in place
    w = mt.nd.array(w0, ctx=CPU)
    held = w._data
    mt.nd.sparse.sgd_update(w, mt.nd.sparse.row_sparse_array(g, ctx=CPU),
                            lr=0.1)
    assert w._data is held


def test_row_sparse_pull_matches_jax():
    rs = np.random.RandomState(5)
    w = rs.randn(9, 2).astype(np.float32)
    rid = np.array([7, 2, 7, 0])
    got = {}
    for P in PKGS:
        kv = P.kv.create("local")
        kv.init("w", P.nd.array(w, **_kw(P)))
        rsp = _sp(P).row_sparse_array(np.zeros((1, 2), np.float32),
                                      shape=(9, 2), **_kw(P))
        dense = P.nd.zeros((9, 2), **_kw(P))
        ids = P.nd.array(rid, **_kw(P))
        kv.row_sparse_pull("w", out=rsp, row_ids=ids)
        kv.row_sparse_pull("w", out=dense, row_ids=ids)
        got[P] = (rsp, dense)
    (pr, pd), (jr, jd) = got[mt], got[mx]
    _same_index(pr.indices, jr.indices)
    np.testing.assert_array_equal(pr.indices.asnumpy(), [0, 2, 7])
    np.testing.assert_array_equal(pr.data.asnumpy(), jr.data.asnumpy())
    np.testing.assert_array_equal(pr.data.asnumpy(), w[[0, 2, 7]])
    assert not pr.has_dense_mirror()
    np.testing.assert_array_equal(pd.asnumpy(), jd.asnumpy())


def _iter_batches(P, path, **kw):
    it = P.io.LibSVMIter(data_libsvm=path, **kw)
    return [(b.data[0], b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("kw", [dict(data_shape=(12,), batch_size=4),
                                dict(data_shape=(3, 4), batch_size=3,
                                     num_parts=2, part_index=1)],
                         ids=["tail", "parts"])
def test_libsvm_iter_batches_equal_jax(tmp_path, kw):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        f.write("1 3:0.5 0:1.25 7:2\n")
        f.write("0 11:0.1 3:0 5:-1.5\n")          # an explicit zero
        f.write("1\n")                             # no features
        f.write("0 2:1.0 2:3.0 -1:0.75\n")         # duplicate, negative
        f.write("1 4:0.2 9:0.3 1:0.4\n")
        f.write("\n")
        f.write("0 6:1e-50 8:7.5\n")               # zero as float32
        f.write("1 10:0.01\n")
    port, ref = _iter_batches(mt, path, **kw), _iter_batches(mx, path, **kw)
    assert len(port) == len(ref) and port[-1][2] == ref[-1][2]
    for (pd, pl, pp), (jd, jl, jp) in zip(port, ref):
        assert pp == jp and pd.shape == jd.shape
        np.testing.assert_array_equal(pl, jl)
        assert pl.dtype == jl.dtype == np.float32
        np.testing.assert_array_equal(pd.data.asnumpy(),
                                      jd.data.asnumpy())
        assert pd.data.dtype == jd.data.dtype == np.float32
        _same_index(pd.indices, jd.indices)
        _same_index(pd.indptr, jd.indptr)
        assert pd.context == CPU
    if kw["batch_size"] == 4:
        assert port[-1][2] == 4 * len(port) - 7    # the padded tail


@pytest.fixture(scope="module")
def quick_data():
    dim, n, epochs, batch, density = lc.sizes(quick=True)
    ex = lc.example()
    return {P: lc.make_batches(P, dim, n, batch, density, ex)
            for P in PKGS}, dim, epochs, ex


def test_config5_first_steps_match_jax(quick_data):
    batches, dim, _, ex = quick_data
    got = {}
    for P in PKGS:
        train, val = batches[P]
        with P.cpu():
            got[P] = lc.run_loop(P, train[:2], val[:1], dim, 1, ex=ex)
    p, j = got[mt], got[mx]
    assert p["rows_pulled_per_epoch"] == j["rows_pulled_per_epoch"]
    np.testing.assert_allclose(p["weight"], j["weight"], rtol=RTOL,
                               atol=RTOL * np.abs(j["weight"]).max())
    for k in ("first_nll", "final_nll", "val_acc", "bias"):
        np.testing.assert_allclose(p[k], j[k], rtol=RTOL)


def test_config5_quick_gate_on_the_port(quick_data):
    batches, dim, epochs, ex = quick_data
    train, val = batches[mt]
    with mt.cpu():
        out = lc.run_loop(mt, train, val, dim, epochs, ex=ex)
    lc.gate(out)
    assert out["steps"] == epochs * len(train)


def test_sparse_op_names_are_the_reference_aliases():
    pairs = {"_sparse_dot": "dot", "_sparse_zeros_like": "zeros_like",
             "_sparse_zeros": "_zeros",
             "_contrib_SparseEmbedding": "Embedding"}
    for alias, op in pairs.items():
        assert TOPS[alias] is TOPS[op] and JOPS[alias] is JOPS[op]
    assert set(TOPS) == set(JOPS)
    x = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    w = mt.nd.array(np.ones((3, 2), np.float32), ctx=CPU)
    np.testing.assert_array_equal(mt.nd._internal._sparse_dot(x, w)
                                  .asnumpy(), mt.nd.dot(x, w).asnumpy())
