"""The port's samplers, ordering ops and linear-algebra ops against the
JAX package's, on the CPU with the same numpy inputs.

- Samplers: each of the 26 names of ``ops/random_op.py`` (aliases
  counted), by distribution and never by value (the port draws from
  torch generators, the JAX package from threefry keys): the mean and
  variance of 20000 draws of each package within 5 standard errors of
  the analytic values (the variance's standard error from the
  distribution's fourth moment, estimated from the draws), and
  ``scipy.stats.ks_2samp`` of the port's draws against the JAX
  package's at p > 1e-4 (the seeds are fixed, so the p-values are too).
  The same seed repeats the port's draws, another seed does not; the
  dtype asked for is the dtype given.
- ``sort``, ``argsort`` and ``topk``: bit-equal to the JAX ops on small
  integers (ties everywhere), for every ``ret_typ``, both ``is_ascend``
  and several axes; ``sort``'s gradient equal.
- The ``_linalg_*`` ops and ``khatri_rao``: values within fp32
  tolerance (rtol 1e-4, atol 1e-5) and the gradients of a weighted sum
  (rtol 1e-3, atol 1e-4).  ``syevd`` and ``gelqf`` are compared through
  sign-free quantities (eigenvector rows and Q rows normalised to a
  positive largest entry, and squared entries in the gradient's loss),
  since LAPACK and cuSOLVER may pick other signs.  ``trmm`` multiplies
  by the whole of ``A`` whatever ``lower`` says, in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
N_DRAWS = 20000
KS_P = 1e-4
SE_BOUND = 5.0


# name -> (params, tensor inputs, analytic mean per row, variance per
# row): the scalar samplers draw (N_DRAWS,), the tensor-parameter ones
# (rows, N_DRAWS) with one parameter set a row
_SCALAR = {
    "_random_uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    "_random_normal": (dict(loc=1.0, scale=2.0), 1.0, 4.0),
    "_random_gamma": (dict(alpha=2.5, beta=1.5), 3.75, 2.5 * 1.5 ** 2),
    "_random_exponential": (dict(lam=2.0), 0.5, 0.25),
    "_random_poisson": (dict(lam=4.0), 4.0, 4.0),
    "_random_negative_binomial": (dict(k=3, p=0.4), 3 * 0.6 / 0.4,
                                  3 * 0.6 / 0.4 ** 2),
    "_random_generalized_negative_binomial": (dict(mu=2.0, alpha=0.5),
                                              2.0, 2.0 + 0.5 * 4.0),
    "_random_randint": (dict(low=-3, high=7), 1.5, (10 ** 2 - 1) / 12),
}
_ALIASES = {
    "uniform": "_random_uniform", "random_uniform": "_random_uniform",
    "normal": "_random_normal", "random_normal": "_random_normal",
    "random_gamma": "_random_gamma",
    "random_exponential": "_random_exponential",
    "random_poisson": "_random_poisson",
    "random_negative_binomial": "_random_negative_binomial",
    "random_generalized_negative_binomial":
        "_random_generalized_negative_binomial",
}
_TENSOR = {
    "_sample_uniform": ([np.array([-1.0, 2.0]), np.array([3.0, 2.5])],
                        [1.0, 2.25], [16 / 12, 0.25 / 12]),
    "_sample_normal": ([np.array([1.0, -2.0]), np.array([2.0, 0.5])],
                       [1.0, -2.0], [4.0, 0.25]),
    "_sample_gamma": ([np.array([2.5, 0.7]), np.array([1.5, 2.0])],
                      [3.75, 1.4], [2.5 * 1.5 ** 2, 0.7 * 4.0]),
    "_sample_exponential": ([np.array([2.0, 0.5])], [0.5, 2.0],
                            [0.25, 4.0]),
    "_sample_poisson": ([np.array([4.0, 0.5])], [4.0, 0.5], [4.0, 0.5]),
    # categorical over 0..3 with probabilities .1 .2 .3 .4
    "_sample_multinomial": ([np.array([[0.1, 0.2, 0.3, 0.4],
                                       [0.4, 0.3, 0.2, 0.1]])],
                            [2.0, 1.0], [1.0, 1.0]),
    "sample_multinomial": ([np.array([[0.1, 0.2, 0.3, 0.4],
                                      [0.4, 0.3, 0.2, 0.1]])],
                           [2.0, 1.0], [1.0, 1.0]),
}
ALL_NAMES = sorted(list(_SCALAR) + list(_ALIASES) + list(_TENSOR)
                   + ["_shuffle", "shuffle"])


def test_the_26_names_are_registered_as_in_the_jax_package():
    from incubator_mxnet_tpu.ops import registry as jreg
    jnames = {n for n, op in jreg.OPS.items()
              if op.fn.__module__.endswith("ops.random_op")}
    pnames = {n for n, op in mt.ops.OPS.items()
              if op.fn.__module__.endswith("ops.random_op")}
    assert len(jnames) == 26 and pnames == jnames == set(ALL_NAMES)
    for n in jnames:
        jop, pop = jreg.OPS[n], mt.ops.OPS[n]
        assert pop.param_defaults == {k: v for k, v in
                                      jop.param_defaults.items()}, n
        assert pop.arg_names == jop.arg_names, n
        assert pop.needs_rng and not pop.differentiable, n


def _draw(pkg, name, seed):
    """(N_DRAWS,) or (rows, N_DRAWS) draws of op ``name`` as numpy."""
    nd = pkg.nd
    pkg.random.seed(seed)
    ctx = dict(ctx=CPU) if pkg is mt else {}
    fn = getattr(nd._internal, name)
    base = _ALIASES.get(name, name)
    if base in _SCALAR:
        params = dict(_SCALAR[base][0])
        if base == "_random_randint":
            params["dtype"] = "int32"
        return fn(shape=(N_DRAWS,), **params, **ctx).asnumpy()
    if base in ("_shuffle", "shuffle"):
        return fn(nd.array(np.arange(N_DRAWS, dtype=np.float32),
                           **ctx)).asnumpy()
    arrays = [nd.array(a.astype(np.float32), **ctx)
              for a in _TENSOR[base][0]]
    return fn(*arrays, shape=(N_DRAWS,)).asnumpy()


def _check_moments(draws, mean, var):
    n = draws.shape[-1]
    d = draws.astype(np.float64)
    m, v = d.mean(), d.var()
    m4 = ((d - m) ** 4).mean()
    se_mean = np.sqrt(var / n)
    se_var = np.sqrt(max(m4 - v ** 2, 1e-12) / n)
    assert abs(m - mean) < SE_BOUND * se_mean, (m, mean, se_mean)
    assert abs(v - var) < SE_BOUND * se_var, (v, var, se_var)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_sampler_matches_jax_in_distribution(name):
    port = _draw(mt, name, 7)
    ref = _draw(mx, name, 7)
    assert port.shape == ref.shape and port.dtype == ref.dtype, \
        (port.shape, ref.shape, port.dtype, ref.dtype)
    base = _ALIASES.get(name, name)
    if base in _SCALAR:
        rows = [(port, ref, _SCALAR[base][1], _SCALAR[base][2])]
    elif base in ("_shuffle", "shuffle"):
        assert np.array_equal(np.sort(port), np.arange(N_DRAWS))
        # a uniform permutation: position and value uncorrelated
        assert abs(np.corrcoef(port, np.arange(N_DRAWS))[0, 1]) < 0.05
        rows = [(port, ref, (N_DRAWS - 1) / 2, (N_DRAWS ** 2 - 1) / 12)]
    else:
        _, means, vars_ = _TENSOR[base]
        rows = list(zip(port, ref, means, vars_))
    for p, r, mean, var in rows:
        _check_moments(p, mean, var)
        _check_moments(r, mean, var)
        if base not in ("_shuffle", "shuffle"):
            assert stats.ks_2samp(p, r).pvalue > KS_P


@pytest.mark.parametrize("name", ["_random_normal", "_random_poisson",
                                  "_sample_gamma", "_sample_multinomial",
                                  "_shuffle", "_random_randint"])
def test_sampler_seed_repeats_and_another_seed_differs(name):
    a, b, c = (_draw(mt, name, s) for s in (3, 3, 4))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_nd_random_and_mt_random_surface():
    """``nd.random.*`` and ``random.*`` (the same functions) take
    ``ctx`` and ``out``; integer dtypes come back as asked; the key
    provider's generator is the one drawn from."""
    assert mt.random.uniform is mt.nd.random.uniform
    for name in mx.nd.random.__all__:
        assert callable(getattr(mt.nd.random, name))
        assert getattr(mt.random, name) is getattr(mt.nd.random, name)
    x = mt.nd.random.poisson(3.0, shape=(5,), dtype="int32", ctx=CPU)
    assert x.dtype == np.int32 and x.context == CPU
    out = mt.nd.zeros((4,), ctx=CPU)
    mt.nd.random.normal(0, 1, shape=(4,), ctx=CPU, out=out)
    assert np.all(out.asnumpy() != 0)
    r = mt.nd.random.randint(0, 5, shape=(100,), ctx=CPU).asnumpy()
    assert r.dtype == np.int32 and r.min() >= 0 and r.max() < 5
    idx, logp = mt.nd.random.multinomial(
        mt.nd.array([[0.25, 0.75]], ctx=CPU), shape=(3,), get_prob=True)
    assert idx.shape == logp.shape == (1, 3)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(np.where(idx.asnumpy() == 1, .75, .25)),
        rtol=1e-6)
    g1, g2 = mt.random.generator(11), mt.random.generator(11)
    with mt.random.key_provider(g1):
        a = mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    with mt.random.key_provider(g2):
        b = mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    assert np.array_equal(a, b)
    # torch's global generator is never drawn from
    state = torch.random.get_rng_state()
    mt.nd.random.gamma(2.0, 1.0, shape=(16,), ctx=CPU)
    mt.nd.random.shuffle(mt.nd.arange(8, ctx=CPU))
    assert torch.equal(state, torch.random.get_rng_state())


def test_sampler_in_a_bound_graph_repeats_with_the_seed():
    s = mt.sym._internal._random_normal(shape=(4, 3)) + mt.sym.Variable("x")
    ex = s.simple_bind(CPU, grad_req="null", x=(4, 3))
    mt.random.seed(5)
    a = ex.forward(x=np.zeros((4, 3), np.float32))[0].asnumpy()
    mt.random.seed(5)
    b = ex.forward(x=np.zeros((4, 3), np.float32))[0].asnumpy()
    c = ex.forward(x=np.zeros((4, 3), np.float32))[0].asnumpy()
    assert np.array_equal(a, b) and not np.array_equal(b, c)


# ------------------------------------------------------------------ order
def _ties(shape=(5, 7), seed=0):
    return np.random.RandomState(seed).randint(0, 4, shape).astype(
        np.float32)


def _both(name, x, **params):
    j = getattr(mx.nd, name)(mx.nd.array(x), **params)
    p = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU), **params)
    js = j if isinstance(j, (list, tuple)) else [j]
    ps = p if isinstance(p, (list, tuple)) else [p]
    return [a.asnumpy() for a in js], [b.asnumpy() for b in ps]


def _bit_equal(js, ps):
    assert len(js) == len(ps)
    for a, b in zip(js, ps):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("axis", [-1, 0, None])
@pytest.mark.parametrize("is_ascend", [True, False])
def test_sort_and_argsort_bit_equal_on_ties(axis, is_ascend):
    x = _ties()
    _bit_equal(*_both("sort", x, axis=axis, is_ascend=is_ascend))
    _bit_equal(*_both("argsort", x, axis=axis, is_ascend=is_ascend,
                      dtype="int32"))
    # the NDArray methods
    a = mt.nd.array(x, ctx=CPU)
    assert np.array_equal(a.sort(axis=axis, is_ascend=is_ascend)
                          .asnumpy(),
                          mx.nd.array(x).sort(axis=axis,
                                              is_ascend=is_ascend)
                          .asnumpy())
    assert np.array_equal(a.argsort(axis=axis, is_ascend=is_ascend)
                          .asnumpy(),
                          mx.nd.array(x).argsort(axis=axis,
                                                 is_ascend=is_ascend)
                          .asnumpy())


@pytest.mark.parametrize("ret_typ", ["indices", "value", "mask", "both"])
@pytest.mark.parametrize("is_ascend", [True, False])
@pytest.mark.parametrize("axis", [-1, 0])
def test_topk_bit_equal_on_ties(ret_typ, is_ascend, axis):
    x = _ties(seed=1)
    kw = dict(axis=axis, k=3, ret_typ=ret_typ, is_ascend=is_ascend)
    _bit_equal(*_both("topk", x, **kw))
    m = mt.nd.array(x, ctx=CPU).topk(**kw)
    j = mx.nd.array(x).topk(**kw)
    ms = m if isinstance(m, list) else [m]
    js = j if isinstance(j, list) else [j]
    _bit_equal([a.asnumpy() for a in js], [b.asnumpy() for b in ms])


def test_sort_gradient_and_symbol_methods():
    x = _ties((4, 6), seed=2) + np.random.RandomState(3).rand(4, 6) \
        .astype(np.float32) * 0.5
    w = np.random.RandomState(4).rand(4, 6).astype(np.float32)
    grads = []
    for pkg, kw in ((mx, {}), (mt, dict(ctx=CPU))):
        a = pkg.nd.array(x, **kw)
        a.attach_grad()
        with pkg.autograd.record():
            y = (pkg.nd.sort(a, axis=-1, is_ascend=False)
                 * pkg.nd.array(w, **kw)).sum()
        y.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    s = mt.sym.Variable("x").topk(k=2, ret_typ="value")
    ex = s.simple_bind(CPU, grad_req="null", x=(4, 6))
    out = ex.forward(x=x)[0].asnumpy()
    np.testing.assert_array_equal(out, -np.sort(-x, axis=-1)[:, :2])


# ------------------------------------------------------------------ la
def _spd(rs, n, batch=(2,)):
    a = rs.rand(*batch, n, n).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)


def _la_cases():
    rs = np.random.RandomState(0)
    A = rs.rand(2, 4, 4).astype(np.float32) + np.eye(4, dtype=np.float32)
    B = rs.rand(2, 4, 3).astype(np.float32)
    Bt = rs.rand(2, 3, 4).astype(np.float32)
    C = rs.rand(2, 4, 3).astype(np.float32)
    L = np.linalg.cholesky(_spd(rs, 4)).astype(np.float32)
    return [
        ("gemm", [A, B, C], dict(alpha=0.7, beta=1.3)),
        ("gemm", [Bt, A, rs.rand(2, 3, 4).astype(np.float32)],
         dict(transpose_b=True, alpha=-1.0, beta=0.5)),
        ("gemm2", [A, B], dict(alpha=2.0)),
        ("gemm2", [B, A], dict(transpose_a=True)),
        ("potrf", [_spd(rs, 4)], {}),
        ("potri", [L], {}),
        ("trmm", [np.tril(A), B], dict(alpha=1.5)),
        ("trmm", [np.triu(A), Bt], dict(rightside=True, transpose=True,
                                        lower=False)),
        ("trsm", [L, B], dict(alpha=2.0)),
        ("trsm", [L, B], dict(transpose=True)),
        ("trsm", [L, Bt], dict(rightside=True)),
        ("trsm", [np.swapaxes(L, -1, -2).copy(), Bt],
         dict(rightside=True, transpose=True, lower=False)),
        ("sumlogdiag", [L], {}),
        ("syrk", [B], dict(alpha=0.5)),
        ("syrk", [B], dict(transpose=True)),
    ]


def _grad_both(name, arrays, params, loss_of):
    out = {}
    for pkg, kw in ((mx, {}), (mt, dict(ctx=CPU))):
        xs = [pkg.nd.array(a, **kw) for a in arrays]
        for x in xs:
            x.attach_grad()
        with pkg.autograd.record():
            y = getattr(pkg.nd.linalg, name)(*xs, **params)
            ys = y if isinstance(y, (list, tuple)) else [y]
            loss = loss_of(pkg, kw, ys)
        loss.backward()
        out[pkg] = ([v.asnumpy() for v in ys], [x.grad.asnumpy()
                                                 for x in xs])
    return out[mx], out[mt]


def _weighted(pkg, kw, ys):
    total = None
    for i, y in enumerate(ys):
        w = np.random.RandomState(10 + i).rand(*y.shape).astype(np.float32)
        t = (y * pkg.nd.array(w, **kw)).sum()
        total = t if total is None else total + t
    return total


@pytest.mark.parametrize("case", range(len(_la_cases())))
def test_linalg_values_and_gradients(case):
    name, arrays, params = _la_cases()[case]
    (jv, jg), (pv, pg) = _grad_both(name, arrays, params, _weighted)
    for a, b in zip(jv, pv):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    for a, b in zip(jg, pg):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)


def _rows_signed(m):
    """Each row of ``m`` (..., n, k) times the sign of its entry of
    largest magnitude."""
    idx = np.abs(m).argmax(-1)[..., None]
    return m * np.sign(np.take_along_axis(m, idx, -1))


def _squares(pkg, kw, ys):
    total = None
    for i, y in enumerate(ys):
        w = np.random.RandomState(20 + i).rand(*y.shape).astype(np.float32)
        t = (y * y * pkg.nd.array(w, **kw)).sum()
        total = t if total is None else total + t
    return total


def test_syevd_and_gelqf_sign_free():
    rs = np.random.RandomState(5)
    S = _spd(rs, 4)
    (jv, jg), (pv, pg) = _grad_both("syevd", [S], {}, _squares)
    np.testing.assert_allclose(_rows_signed(pv[0]), _rows_signed(jv[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pv[1], jv[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pg[0], jg[0], rtol=1e-3, atol=1e-3)
    # rows of U are eigenvectors: U S U^T = diag(w)
    u, w = pv
    np.testing.assert_allclose(u @ S @ np.swapaxes(u, -1, -2),
                               np.eye(4) * w[..., None, :], atol=1e-3)
    A = rs.rand(2, 3, 5).astype(np.float32)
    (jv, jg), (pv, pg) = _grad_both("gelqf", [A], {}, _squares)
    lq, q = pv
    np.testing.assert_allclose(lq @ q, A, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.tril(lq), lq, atol=0)
    np.testing.assert_allclose(_rows_signed(q), _rows_signed(jv[1]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.abs(lq), np.abs(jv[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pg[0], jg[0], rtol=1e-3, atol=1e-4)


def test_trmm_ignores_lower_in_both_packages():
    """``linalg_trmm`` multiplies by the whole of ``A``: the JAX
    package's defect (its ``lower`` is never read), pinned in both."""
    rs = np.random.RandomState(6)
    A = rs.rand(3, 3).astype(np.float32)
    B = rs.rand(3, 2).astype(np.float32)
    for lower in (True, False):
        j = mx.nd.linalg.trmm(mx.nd.array(A), mx.nd.array(B),
                              lower=lower).asnumpy()
        p = mt.nd.linalg.trmm(mt.nd.array(A, ctx=CPU),
                              mt.nd.array(B, ctx=CPU),
                              lower=lower).asnumpy()
        np.testing.assert_allclose(p, A @ B, rtol=1e-5)
        np.testing.assert_allclose(j, A @ B, rtol=1e-5)


def test_khatri_rao_and_names():
    rs = np.random.RandomState(7)
    arrays = [rs.rand(2, 3).astype(np.float32),
              rs.rand(4, 3).astype(np.float32),
              rs.rand(2, 3).astype(np.float32)]
    outs = []
    for pkg, kw in ((mx, {}), (mt, dict(ctx=CPU))):
        xs = [pkg.nd.array(a, **kw) for a in arrays]
        for x in xs:
            x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.khatri_rao(*xs)
            (y * y).sum().backward()
        outs.append([y.asnumpy()] + [x.grad.asnumpy() for x in xs])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    from incubator_mxnet_tpu.ops import registry as jreg
    jnames = {n for n, op in jreg.OPS.items()
              if op.fn.__module__.endswith("ops.la")}
    pnames = {n for n, op in mt.ops.OPS.items()
              if op.fn.__module__.endswith("ops.la")}
    assert len(jnames) == 21 and pnames == jnames
    assert sorted(n for n in dir(mt.nd.linalg) if not n.startswith("_")
                  and callable(getattr(mt.nd.linalg, n))) == sorted(
        n for n in dir(mx.nd.linalg) if not n.startswith("_")
        and callable(getattr(mx.nd.linalg, n)))
