"""The port's op registry, ``nd`` and ``autograd``
(incubator_mxnet_tpu_torch) against the JAX package's.

Registry: every name the port registers exists in the JAX registry with
the same ``arg_names``, parameter defaults and flags, with the two
stated exceptions (``cache_vjp``, an OpDef field for JAX's scan compile
cache, and ``_flash_attention``'s ``interpret``, which picks the Pallas
interpreter).  Ops: each case of ``tests/test_op_sweep.py``'s
``_build_cases()`` that the port registers runs forward, and backward
where the sweep differentiates it, through ``nd`` + ``autograd`` on the
CPU, against the JAX op's function and ``jax.vjp`` on the same numpy
inputs: fp32, atol 1e-5, rtol 1e-4 (the two libraries' math functions
differ in the last bits).  The rest are twins of ``tests/test_autograd.py``
and ``tests/test_ndarray.py`` that need no ``sym`` or Gluon: the same
program runs in both packages and their results are compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402
from incubator_mxnet_tpu_torch.ops.registry import OPS as TOPS  # noqa: E402
from test_op_sweep import CASES as SWEEP  # noqa: E402  (_build_cases())

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = mt.cpu()

# the JAX modules the port registers, and the names it leaves out with
# the sparse storage types (ROADMAP item 8)
PORTED_MODULES = ("elemwise", "reduce", "matrix", "indexing", "init_op",
                  "optimizer_op", "flash")
SPARSE_LATER = {"_sparse_dot", "_sparse_zeros_like",
                "_contrib_SparseEmbedding", "_sparse_zeros"}
PARAM_EXCEPTIONS = {"_flash_attention": {"interpret"}}

CASES = {n: spec for n, spec in SWEEP.items() if n in TOPS}


def test_registry_matches_jax():
    # make_loss is registered by elemwise.py; contrib_misc.py swaps in
    # its loss-head gradient and adds the alias MakeLoss
    want = {n for n, op in JOPS.items()
            if op.fn.__module__.rsplit(".", 1)[-1] in PORTED_MODULES} \
        - SPARSE_LATER | {"make_loss"}
    assert set(TOPS) == want
    for name, op in TOPS.items():
        jop = JOPS[name]
        assert op.arg_names == jop.arg_names, name
        jdefaults = {k: v for k, v in jop.param_defaults.items()
                     if k not in PARAM_EXCEPTIONS.get(name, ())}
        assert op.param_defaults == jdefaults, name
        for field in ("variadic", "needs_mode", "needs_rng", "num_aux",
                      "differentiable"):
            assert getattr(op, field) == getattr(jop, field), (name, field)
        if not callable(op.num_outputs):
            assert op.num_outputs == jop.num_outputs, name
        # aliases point at one op in both registries
        assert {n for n, o in TOPS.items() if o is op} == \
            {n for n, o in JOPS.items() if o is jop} & want, name
    assert not hasattr(TOPS["dot"], "cache_vjp")
    # the generated surface: public names on nd, '_' names on _internal
    assert mt.nd.broadcast_add is not None
    assert mt.nd._internal._plus_scalar is not None
    assert not hasattr(mt.nd, "_plus_scalar")


def _port_fn(name):
    return getattr(mt.nd, name, None) or getattr(mt.nd._internal, name)


def _grad_inputs(spec):
    nodes = spec.get("grad_nodes")
    return [i for i, a in enumerate(spec["inputs"])
            if np.issubdtype(a.dtype, np.floating)
            and (nodes is None or f"a{i}" in nodes)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    spec = CASES[name]
    inputs = spec["inputs"]
    params = spec.get("params", {})
    tparams = {k: v for k, v in params.items()
               if k not in PARAM_EXCEPTIONS.get(name, ())}
    jfn = JOPS[name].fn
    differentiate = JOPS[name].differentiable and not spec.get("fwd")
    wrt = _grad_inputs(spec) if differentiate else []

    def jax_f(*diff):
        args = [jnp.asarray(a) for a in inputs]
        for i, d in zip(wrt, diff):
            args[i] = d
        return jfn(*args, **params)

    jout, vjp = jax.vjp(jax_f, *(jnp.asarray(inputs[i]) for i in wrt))
    jouts = list(jout) if isinstance(jout, (tuple, list)) else [jout]

    xs = [mt.nd.array(a, ctx=CPU) for a in inputs]
    for i in wrt:
        xs[i].attach_grad()
    with mt.autograd.record():
        tout = _port_fn(name)(*xs, **tparams)
    touts = tout if isinstance(tout, list) else [tout]
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        j = np.asarray(j)
        assert t.shape == j.shape, name
        assert t.dtype == j.dtype, (name, t.dtype, j.dtype)
        np.testing.assert_allclose(t.asnumpy(), j, err_msg=name, **TOL)
    if not wrt:
        return
    rs = np.random.RandomState(11)
    cts = [rs.normal(0, 1, np.shape(j)).astype(np.float32) for j in jouts]
    jgrads = vjp(tuple(cts) if len(cts) > 1 else cts[0])
    mt.autograd.backward(touts, [mt.nd.array(c, ctx=CPU) for c in cts])
    for i, jg in zip(wrt, jgrads):
        np.testing.assert_allclose(xs[i].grad.asnumpy(), np.asarray(jg),
                                   err_msg=f"{name} d/da{i}", **TOL)


def test_sweep_covers_the_ported_modules():
    # every differentiable case the port registers, across its modules
    assert len(CASES) >= 140, len(CASES)


# ------------------------------------------------------- twins of the JAX
# package's autograd and ndarray tests: one program, run in both packages

def _both(prog, **tol):
    """Run ``prog(nd, autograd, ctx_kwargs)`` in both packages (the port
    on the CPU) and compare the numpy arrays it returns."""
    got = prog(mt.nd, mt.autograd, {"ctx": CPU})
    want = prog(mx.nd, mx.autograd, {})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g, w)
        np.testing.assert_allclose(g, w, **(tol or TOL))
    return got


def test_simple_backward():
    def prog(nd, ag, c):
        x = nd.array([1.0, 2.0, 3.0], **c)
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(_both(prog)[0], [2.0, 4.0, 6.0])


def test_chain_and_broadcast():
    xv = np.random.RandomState(0).rand(3, 4).astype("float32")
    wv = np.random.RandomState(1).rand(4, 2).astype("float32")

    def prog(nd, ag, c):
        x, w = nd.array(xv, **c), nd.array(wv, **c)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            z = nd.relu(nd.dot(x, w) - 0.5).sum()
        z.backward()
        return [z.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy()]
    _both(prog)


def test_head_gradient_of_ones_on_a_non_scalar_head():
    def prog(nd, ag, c):
        x = nd.array([1.0, 2.0, 3.0], **c)
        x.attach_grad()
        with ag.record():
            y = x * 4                  # (3,): torch alone would refuse
        y.backward()
        g1 = x.grad.asnumpy()
        with ag.record():
            y = x * 4
        y.backward(nd.array([1.0, 0.5, 0.25], **c))
        return [g1, x.grad.asnumpy()]
    got = _both(prog)
    np.testing.assert_allclose(got[0], [4.0, 4.0, 4.0])
    np.testing.assert_allclose(got[1], [4.0, 2.0, 1.0])


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    def prog(nd, ag, c):
        x = nd.array([1.0, 2.0], **c)
        buf = nd.array([7.0, 7.0], **c)
        ag.mark_variables([x], [buf], req)
        out = []
        for k in range(3):
            with ag.record():
                y = (x * x * (k + 1)).sum()
            y.backward()
            out.append(x.grad.asnumpy())
        return out
    got = _both(prog)
    first = {"write": [2.0, 4.0], "add": [9.0, 11.0], "null": [7.0, 7.0]}
    np.testing.assert_allclose(got[0], first[req])


def test_record_pause_and_modes():
    def prog(nd, ag, c):
        flags = []
        x = nd.array([1.0], **c)
        x.attach_grad()
        with ag.record():
            flags += [ag.is_recording(), ag.is_training()]
            with ag.pause():
                flags += [ag.is_recording(), ag.is_training()]
                z = x * 5                # not recorded
            y = x * 2
        with ag.record(train_mode=False):
            flags.append(ag.is_training())
            with ag.train_mode():
                flags.append(ag.is_training())
        with ag.predict_mode():
            flags.append(ag.is_training())
        flags += [ag.is_recording(), ag.is_training()]
        y.backward()
        prev = ag.set_recording(True)
        flags += [prev, ag.is_recording()]
        ag.set_recording(False)
        prev = ag.set_training(True)
        flags += [prev, ag.is_training()]
        ag.set_training(False)
        return [np.array(flags), x.grad.asnumpy(), z.asnumpy()]
    got = _both(prog)
    np.testing.assert_allclose(got[1], [2.0])


def test_pause_leaves_ops_unrecorded():
    x = mt.nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    with mt.autograd.record():
        with mt.autograd.pause():
            z = x * 5
        y = x * 2
    assert not z.handle.requires_grad and y.handle.requires_grad
    w = x * 3                          # outside record(): no_grad
    assert not w.handle.requires_grad
    u = mt.nd.array([1.0], ctx=CPU)    # unmarked: never recorded
    with mt.autograd.record():
        assert not (u * 2).handle.requires_grad


def test_autograd_grad_api():
    def prog(nd, ag, c):
        x = nd.array([2.0], **c)
        x.attach_grad()
        with ag.record():
            y = x * x * x
        (g,) = ag.grad(y, [x])
        return [g.asnumpy()]
    np.testing.assert_allclose(_both(prog)[0], [12.0])


def test_grad_create_graph_gives_second_order():
    x = mt.nd.array([2.0, -1.0], ctx=CPU)
    x.attach_grad()
    with mt.autograd.record():
        y = x * x * x
        (g,) = mt.autograd.grad(y, [x], create_graph=True)
        z = g.sum()
    z.backward()
    np.testing.assert_allclose(g.asnumpy(), [12.0, 3.0])
    np.testing.assert_allclose(x.grad.asnumpy(), [12.0, -6.0])  # 6x
    with pytest.raises(ValueError, match="does not participate"):
        u = mt.nd.array([1.0], ctx=CPU)
        u.attach_grad()
        with mt.autograd.record():
            y = x * 2
        mt.autograd.grad(y, [u])


def test_multi_output_op_backward():
    def prog(nd, ag, c):
        x = nd.array(np.arange(8, dtype="float32").reshape(2, 4), **c)
        x.attach_grad()
        with ag.record():
            a, b = nd.split(x, num_outputs=2, axis=1)
            y = (a * 2 + b * 3).sum()
        y.backward()
        return [x.grad.asnumpy()]
    _both(prog)


def test_detach_and_stop_gradient():
    def prog(nd, ag, c):
        x = nd.array([3.0], **c)
        x.attach_grad()
        with ag.record():
            y = x * 2
            z = nd.BlockGrad(y) + x + y.detach()
        z.backward()
        return [x.grad.asnumpy(), z.asnumpy()]
    np.testing.assert_allclose(_both(prog)[0], [1.0])


def test_custom_function():
    def prog(nd, ag, c):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y) * 10   # 10x: proves it is used

        x = nd.array([0.5, -1.0], **c)
        x.attach_grad()
        with ag.record():
            y = Sigmoid()(x)
        y.backward()
        return [y.asnumpy(), x.grad.asnumpy()]
    y, g = _both(prog)
    np.testing.assert_allclose(g, 10 * y * (1 - y), rtol=1e-5)


def test_attach_grad_survives_out_rebinding():
    # nd.sgd_update(w, w.grad, out=w) rebinds w's data to a new tensor;
    # the mark (buffer and grad_req) stays on w
    xv = np.random.RandomState(2).rand(4, 3).astype("float32")
    wv = np.random.RandomState(3).rand(3, 2).astype("float32")

    def prog(nd, ag, c):
        x, w = nd.array(xv, **c), nd.array(wv, **c)
        w.attach_grad()
        losses = []
        for _ in range(3):
            with ag.record():
                loss = nd.mean(nd.square(nd.dot(x, w) - 1.0))
            loss.backward()
            nd.sgd_update(w, w.grad, lr=0.5, out=w)
            losses.append(loss.asnumpy())
        return losses + [w.asnumpy(), w.grad.asnumpy()]
    got = _both(prog)
    assert got[2] < got[0]


def test_out_keeps_the_target_dtype():
    def prog(nd, ag, c):
        t = nd.zeros((2, 2), dtype="int32", **c)
        nd.broadcast_add(nd.ones((2, 2), **c) * 1.5,
                         nd.ones((2, 2), **c), out=t)
        return [t.asnumpy()]
    np.testing.assert_array_equal(_both(prog)[0], np.full((2, 2), 2))


def test_dtype_narrowing_matches_jax():
    for src in (np.arange(3), np.ones(3), np.arange(3, dtype=np.uint64),
                [1, 2], [1.5], np.float16([1.0])):
        assert mt.nd.array(src, ctx=CPU).dtype == mx.nd.array(src).dtype
    assert mt.nd.array(np.ones(3), ctx=CPU, dtype="float64").dtype == \
        mx.nd.array(np.ones(3), dtype="float64").dtype


def test_creation_arithmetic_and_inplace():
    def prog(nd, ag, c):
        a = nd.array([[1.0, 2.0], [3.0, 4.0]], **c)
        b = nd.array([[10.0, 20.0], [30.0, 40.0]], **c)
        out = [nd.zeros((2, 3), **c), nd.ones((4,), dtype="int32", **c),
               nd.full((2, 2), 7.5, **c), nd.arange(0, 10, 2, **c),
               nd.arange(5, **c), nd.empty((2,), **c),
               a + b, a - b, a * b, b / a, a + 1, 2 - a, 3 / a, a ** 2,
               2 ** a, -a, a > 2, a <= 2, a == b, a != 3, a % 3, 7 % a,
               abs(-a)]
        a += 1
        a *= 3
        a -= 1
        a /= 2
        out.append(a.copy())
        a[:] = 5
        out.append(a)
        return [o.asnumpy() for o in out]
    _both(prog)


def test_indexing_and_shape_methods():
    def prog(nd, ag, c):
        a = nd.array(np.arange(24, dtype="float32").reshape(2, 3, 4), **c)
        out = [a[1], a[0, 1:3], a.T, a.flatten(), a.expand_dims(0),
               a.transpose((1, 0, 2)), a.swapaxes(0, 2), a.flip(1),
               a.reshape((6, 4)), a.reshape((-1,)), a.reshape((0, -1)),
               a.reshape((-2,)), a.reshape((-3, 4)),
               a.reshape((-4, 1, 2, 3, 4)),
               nd.concatenate([a, a], axis=0), a.split(2, axis=2)[1],
               a.slice((0, 1), (2, 3)), a.slice_axis(2, 1, 3),
               a.clip(3, 9), a.repeat(2, axis=0), a.tile((1, 2, 1)),
               a.pad(pad_width=(0, 0, 1, 1, 0, 2)),
               a[:1].broadcast_to((2, 3, 4)), nd.moveaxis(a, 0, 2),
               a.sum(), a.mean(axis=1), a.max(axis=(0, 2)), a.min(),
               a.prod(axis=2), a.norm(), a.argmax(axis=2), a.argmin(),
               nd.sum(a, axis=1, exclude=True), a.astype("int32"),
               a.take(nd.array([0, 1, 1], **c)), a.abs(), a.sqrt(),
               a.square(), a.exp() * 0, a.sigmoid(), a.tanh(), a.relu()]
        a[0] = 0
        a[1, 2, 3] = -1
        out.append(a)
        rows = list(a)
        assert len(rows) == len(a) == 2 and rows[0].shape == (3, 4)
        return [o.asnumpy() for o in out]
    _both(prog)


def test_copy_and_copyto():
    def prog(nd, ag, c):
        a = nd.ones((2, 2), **c)
        cp = a.copy()
        cp[:] = 9
        d = nd.zeros((2, 2), dtype="int32", **c)
        a.copyto(d)
        return [a.asnumpy(), cp.asnumpy(), d.asnumpy()]
    _both(prog)


def test_wait_and_engine():
    a = mt.nd.ones((4, 2), ctx=CPU)
    assert a.wait_to_read() is a
    mt.nd.waitall()
    mt.engine.wait_all()
    mt.engine.set_engine_type("naive")
    try:
        np.testing.assert_allclose((a + 1).asnumpy(), 2.0)
    finally:
        mt.engine.set_engine_type("async")
    with mt.engine.bulk(16):
        assert (a * 2).shape == (4, 2)
    with pytest.raises(ValueError):
        mt.engine.set_engine_type("threaded")


@pytest.mark.parametrize("env,naive", [
    ({"MXNET_ENGINE_TYPE": "naive"}, True),
    ({"MXTPU_ENGINE_TYPE": "naive"}, True),
    ({"MXNET_ENGINE_TYPE": "async"}, False),
    ({"MXTPU_ENGINE_TYPE": "async", "MXNET_ENGINE_TYPE": "naive"}, False),
    ({}, False)])
def test_engine_type_from_the_environment(monkeypatch, env, naive):
    # MXTPU_ENGINE_TYPE, else the reference's MXNET_ENGINE_TYPE (the JAX
    # package's utils/env.py rule): both packages pick the same mode
    from incubator_mxnet_tpu import engine as jengine
    for name in ("MXTPU_ENGINE_TYPE", "MXNET_ENGINE_TYPE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setitem(mt.engine._state, "naive", None)
    monkeypatch.setitem(jengine._state, "naive", None)
    assert mt.engine._is_naive() is naive
    assert jengine._is_naive() is naive


def test_save_load_across_packages(tmp_path):
    w = np.arange(6, dtype="float32").reshape(2, 3)
    # the JAX package writes, the port reads (a dict, with bfloat16)
    fj = str(tmp_path / "jax.params")
    mx.nd.save(fj, {"w": mx.nd.array(w),
                    "w16": mx.nd.array(w).astype("bfloat16"),
                    "i": mx.nd.array(np.arange(3, dtype="int32"))})
    got = mt.nd.load(fj, ctx=CPU)
    assert set(got) == {"w", "w16", "i"}
    np.testing.assert_array_equal(got["w"].asnumpy(), w)
    assert got["w16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w16"].asnumpy(), w)
    assert got["i"].dtype == np.int32
    # the port writes over it, the JAX package reads (a list, bfloat16)
    mt.nd.save(fj, [mt.nd.array(w, ctx=CPU),
                    mt.nd.array(w, ctx=CPU, dtype="bfloat16")])
    back = mx.nd.load(fj)
    assert isinstance(back, list) and len(back) == 2
    np.testing.assert_array_equal(back[0].asnumpy(), w)
    assert str(back[1].dtype) == "bfloat16"
    np.testing.assert_array_equal(back[1].astype("float32").asnumpy(), w)
    # and the port reads its own
    mine = mt.nd.load(fj, ctx=CPU)
    np.testing.assert_array_equal(mine[0].asnumpy(), w)


def test_dlpack_across_packages():
    w = np.arange(6, dtype="float32").reshape(2, 3)
    t = mt.nd.from_dlpack(jnp.asarray(w))
    np.testing.assert_array_equal(t.asnumpy(), w)
    j = jnp.from_dlpack(mt.nd.array(w, ctx=CPU))
    np.testing.assert_array_equal(np.asarray(j), w)
    cap = mt.nd.to_dlpack_for_read(mt.nd.array(w, ctx=CPU))
    np.testing.assert_array_equal(mt.nd.from_dlpack(cap).asnumpy(), w)
    assert mt.nd.array(w, ctx=CPU).__dlpack_device__()[0] == 1   # kDLCPU


def test_creators_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: mt.nd.zeros((2,)), lambda: mt.nd.ones((2,)),
                 lambda: mt.nd.array([1.0]), lambda: mt.nd.full((1,), 2),
                 lambda: mt.nd.arange(3), lambda: mt.nd._internal._zeros(
                     shape=(2,))):
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            make()
    # an op on arrays runs where its inputs are
    x = mt.nd.array([1.0], ctx=CPU)
    assert (x + 1).context == torch.device("cpu")


def test_keyword_inputs_and_not_yet_ported_surfaces():
    x = mt.nd.array([[1.0, 2.0]], ctx=CPU)
    w = mt.nd.array([[1.0], [1.0]], ctx=CPU)
    np.testing.assert_allclose(mt.nd.dot(lhs=x, rhs=w).asnumpy(), [[3.0]])
    with pytest.raises(TypeError, match="earlier inputs"):
        mt.nd.dot(rhs=w)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        x.tostype("csr")
    assert x.tostype("default") is x and x.stype == "default"
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        mt.autograd.get_symbol(x)
    with pytest.raises(TypeError, match="differentiates floats only"):
        mt.nd.array([1, 2], ctx=CPU).attach_grad()
