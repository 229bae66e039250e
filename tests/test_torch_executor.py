"""The port's Executor (incubator_mxnet_tpu_torch/executor.py) against
the JAX package's, on the CPU with the same numpy inputs.

Twins of the 10 tests of ``tests/test_executor.py``, each also held
against the JAX executor's numbers: forward, backward, head gradients
(``out_grads``), grad_req 'add' and 'null', ``simple_bind``,
``forward_backward``, ``reshape``, ``copy_params_from``; then the
partial last batch, ``group2ctx`` with two CPU groups, and the monitor
callback.  Tolerances: forward rel 1e-5, gradients rel 1e-4, each of
the tensor's largest |value|.

BatchNorm's moving stats: the port's ``forward(is_train=True)`` +
``backward()`` updates them once, equal to the JAX package's
``forward_backward()`` within 1e-5; the JAX package's split route
replays the forward and updates them twice, which the test asserts in
so many words (a defect of the reference package, recorded in ROADMAP).
Dropout: the backward's mask is the forward's, checked within the port
only (the masks are torch's draws, not JAX's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402

CPU = mt.cpu()
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _rand(*shape, seed=3):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-6))


def _both(fn):
    """fn(M, ctx, arr) in the JAX package and in the port: (ref, got)."""
    ref = fn(mx, mx.cpu(), mx.nd.array)
    got = fn(mt, CPU, lambda a: mt.nd.array(a, ctx=CPU))
    return ref, got


def test_bind_forward():
    av, bv = _rand(3, 4), _rand(4, 5, seed=4)

    def run(M, ctx, arr):
        c = M.sym.dot(M.sym.Variable("a"), M.sym.Variable("b"))
        return c.bind(ctx, {"a": arr(av), "b": arr(bv)}).forward()[0] \
            .asnumpy()

    ref, got = _both(run)
    _close(got, av @ bv, FWD_TOL)
    _close(got, ref, FWD_TOL)


def test_backward_grads():
    av, bv = _rand(3, 3), _rand(3, 3, seed=4)

    def run(M, ctx, arr):
        a, b = M.sym.Variable("a"), M.sym.Variable("b")
        ga, gb = arr(np.zeros((3, 3), "float32")), \
            arr(np.zeros((3, 3), "float32"))
        ex = M.sym.sum(a * b).bind(ctx, {"a": arr(av), "b": arr(bv)},
                                   args_grad={"a": ga, "b": gb})
        ex.forward(is_train=True)
        ex.backward()
        return ga.asnumpy(), gb.asnumpy()

    ref, got = _both(run)
    _close(got[0], bv, GRAD_TOL)
    for g, r in zip(got, ref):
        _close(g, r, GRAD_TOL)


def test_grad_req_add_and_null():
    av = _rand(2, 2)

    def run(M, ctx, arr):
        a = M.sym.Variable("a")
        loss = M.sym.sum(a * a)
        ga = arr(np.zeros((2, 2), "float32"))
        ex = loss.bind(ctx, {"a": arr(av)}, args_grad={"a": ga},
                       grad_req="add")
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        ex2 = loss.bind(ctx, {"a": arr(av)}, grad_req="null")
        ex2.forward(is_train=True)
        ex2.backward()          # no gradient asked for; must not fail
        assert ex2.grad_dict == {}
        return ga.asnumpy()

    ref, got = _both(run)
    _close(got, 2 * 2 * av, GRAD_TOL)
    _close(got, ref, GRAD_TOL)


def test_simple_bind_allocates():
    def run(M, ctx, arr):
        net = M.sym.FullyConnected(M.sym.Variable("data"), num_hidden=8,
                                   name="fc")
        net = M.sym.SoftmaxOutput(net, M.sym.Variable("label"), name="sm")
        ex = net.simple_bind(ctx, data=(4, 12), label=(4,))
        assert ex.arg_dict["fc_weight"].shape == (8, 12)
        assert ex.grad_dict["fc_weight"].shape == (8, 12)
        ex.arg_dict["data"][:] = 1.0
        out = ex.forward(is_train=False)
        assert out[0].shape == (4, 8)
        return sorted(ex.arg_dict), sorted(ex.grad_dict), \
            ex.output_shapes, out[0].asnumpy()

    ref, got = _both(run)
    assert got[:3] == ref[:3]
    _close(got[3], ref[3], FWD_TOL)


def test_head_gradients():
    av = _rand(4)
    hg = np.array([1, 2, 3, 4], "float32")

    def run(M, ctx, arr):
        ga = arr(np.zeros(4, "float32"))
        ex = (M.sym.Variable("a") * 3.0).bind(ctx, {"a": arr(av)},
                                              args_grad={"a": ga})
        ex.forward(is_train=True)
        ex.backward(out_grads=arr(hg))
        return ga.asnumpy()

    ref, got = _both(run)
    _close(got, 3 * hg, GRAD_TOL)
    _close(got, ref, GRAD_TOL)


def test_forward_backward_fused():
    data, w = _rand(5, 7), _rand(3, 7, seed=5)
    label = np.array([0, 1, 2, 0, 1], "float32")

    def run(M, ctx, arr):
        net = M.sym.FullyConnected(M.sym.Variable("data"), num_hidden=3,
                                   name="fc")
        net = M.sym.SoftmaxOutput(net, M.sym.Variable("label"), name="sm")
        ex = net.simple_bind(ctx, data=(5, 7), label=(5,))
        ex.arg_dict["data"][:] = arr(data)
        ex.arg_dict["fc_weight"][:] = arr(w)
        ex.arg_dict["label"][:] = arr(label)
        outs = ex.forward_backward()
        return outs[0].asnumpy(), {k: v.asnumpy()
                                   for k, v in ex.grad_dict.items()}

    ref, got = _both(run)
    _close(got[0], ref[0], FWD_TOL)
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        _close(got[1][k], ref[1][k], GRAD_TOL)
    assert np.abs(got[1]["fc_weight"]).sum() > 0


def test_batchnorm_executor_aux_update():
    """One update per training step on either route in the port; the
    JAX package's split route replays the forward and updates twice."""
    x = _rand(8, 3) * 4
    w = _rand(2, 3, seed=6)

    def make(M, ctx, arr):
        net = M.sym.BatchNorm(M.sym.Variable("data"), name="bn",
                              momentum=0.5, fix_gamma=False)
        net = M.sym.square(M.sym.FullyConnected(net, num_hidden=2,
                                                name="fc"))
        ex = net.simple_bind(ctx, data=(8, 3))
        ex.arg_dict["data"][:] = arr(x)
        ex.arg_dict["bn_gamma"][:] = 1.0
        ex.arg_dict["fc_weight"][:] = arr(w)
        return ex

    def stats(ex):
        return [ex.aux_dict[k].asnumpy().copy()
                for k in ("bn_moving_mean", "bn_moving_var")]

    once = 0.5 * 0.0 + 0.5 * x.mean(0)
    twice = 0.5 * once + 0.5 * x.mean(0)
    routes = {}
    for M, ctx, arr in ((mx, mx.cpu(), mx.nd.array),
                        (mt, CPU, lambda a: mt.nd.array(a, ctx=CPU))):
        ex = make(M, ctx, arr)
        ex.forward_backward()
        fused = stats(ex), ex.grad_dict["bn_gamma"].asnumpy().copy()
        ex = make(M, ctx, arr)
        ex.forward(is_train=True)
        ex.backward()
        split = stats(ex), ex.grad_dict["bn_gamma"].asnumpy().copy()
        ex.forward(is_train=False)         # inference leaves the stats
        np.testing.assert_array_equal(stats(ex)[0], split[0][0])
        routes[M] = fused, split
    (jfused, jsplit), (tfused, tsplit) = routes[mx], routes[mt]
    # the port: forward + backward is one update, equal to JAX's fused
    np.testing.assert_allclose(tsplit[0][0], once, rtol=1e-5, atol=1e-6)
    for got, ref in zip(tsplit[0] + tfused[0], jfused[0] * 2):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    _close(tsplit[1], jfused[1], GRAD_TOL)
    # the JAX package's split route updates twice (its replay)
    np.testing.assert_allclose(jsplit[0][0], twice, rtol=1e-5, atol=1e-6)
    assert not np.allclose(jsplit[0][0], jfused[0][0], rtol=1e-3)


def test_dropout_deterministic_backward():
    """The backward differentiates the forward's own graph, so the mask
    it applies is the forward's (within the port: torch's draws)."""
    net = mt.sym.sum(mt.sym.Dropout(mt.sym.Variable("data"), p=0.5,
                                    name="do"))
    ga = mt.nd.zeros((64, 64), ctx=CPU)
    ex = net.bind(CPU, {"data": mt.nd.ones((64, 64), ctx=CPU)},
                  args_grad={"data": ga})
    mt.random.seed(11)
    out = ex.forward(is_train=True)
    ex.backward()
    g = ga.asnumpy()
    assert set(np.unique(g)) == {0.0, 2.0}
    np.testing.assert_allclose((g > 0).sum() * 2.0, out[0].asscalar(),
                               rtol=1e-5)
    # seeded: the same draw again; the next forward draws anew
    mt.random.seed(11)
    again = ex.forward(is_train=True)[0].asscalar()
    assert again == out[0].asscalar()
    assert ex.forward(is_train=True)[0].asscalar() != again
    assert ex.forward(is_train=False)[0].asscalar() == 64 * 64
    with pytest.raises(mt.MXNetError, match="is_train=True"):
        ex.backward()


def test_reshape_executor():
    xs = _rand(8, 6)

    def run(M, ctx, arr):
        net = M.sym.FullyConnected(M.sym.Variable("data"), num_hidden=4,
                                   name="fc")
        ex = net.simple_bind(ctx, data=(2, 6))
        ex.arg_dict["fc_weight"][:] = 0.5
        ex2 = ex.reshape(data=(8, 6))
        assert ex2.arg_dict["data"].shape == (8, 6)
        np.testing.assert_allclose(ex2.arg_dict["fc_weight"].asnumpy(),
                                   0.5 * np.ones((4, 6)))
        out = ex2.forward(data=arr(xs))
        return out[0].asnumpy()

    ref, got = _both(run)
    assert got.shape == (8, 4)
    _close(got, ref, FWD_TOL)


def test_copy_params_from():
    def run(M, ctx, arr):
        net = M.sym.FullyConnected(M.sym.Variable("data"), num_hidden=2,
                                   name="fc")
        ex = net.simple_bind(ctx, data=(1, 3))
        ex.copy_params_from({"fc_weight": arr(np.ones((2, 3), "float32")),
                             "fc_bias": arr(np.zeros(2, "float32"))})
        with pytest.raises(ValueError, match="unknown"):
            ex.copy_params_from({"nope": arr(np.ones(1, "float32"))})
        ex.copy_params_from({"nope": arr(np.ones(1, "float32"))},
                            allow_extra_params=True)
        ex.arg_dict["data"][:] = 1.0
        return ex.forward()[0].asnumpy()

    ref, got = _both(run)
    np.testing.assert_allclose(got, [[3.0, 3.0]])
    np.testing.assert_array_equal(got, ref)


def test_partial_last_batch():
    """A batch of 3 rows on an executor bound at 5: padded, run, sliced
    back when every output is batch-rowed; a batch-reducing output runs
    at the input's own shape instead (JAX: recompiles at it)."""
    x, w = _rand(3, 4), _rand(2, 4, seed=7)

    def run(M, ctx, arr):
        d = M.sym.Variable("data")
        rowed = M.sym.FullyConnected(d, num_hidden=2, name="fc")
        reduced = M.sym.sum(rowed)
        outs = []
        for net in (rowed, reduced):
            ex = net.simple_bind(ctx, data=(5, 4))
            ex.arg_dict["fc_weight"][:] = arr(w)
            outs.append(ex.forward(data=arr(x))[0].asnumpy())
        return outs

    ref, got = _both(run)
    assert got[0].shape == (3, 2) and got[1].shape == ()
    for g, r in zip(got, ref):
        _close(g, r, FWD_TOL)
    _close(got[0], x @ w.T, FWD_TOL)


def test_group2ctx_two_cpu_groups():
    """Nodes tagged by AttrScope(ctx_group=...) run on their group's
    device; here two CPU groups (the JAX package's are two of its
    virtual CPU devices)."""
    x, w1, w2 = _rand(4, 5), _rand(6, 5, seed=8), _rand(3, 6, seed=9)

    def run(M, ctx, arr):
        data = M.sym.Variable("data")
        with M.AttrScope(ctx_group="dev1"):
            h = M.sym.Activation(M.sym.FullyConnected(
                data, num_hidden=6, name="fc1"), act_type="tanh")
        with M.AttrScope(ctx_group="dev2"):
            out = M.sym.sum(M.sym.FullyConnected(h, num_hidden=3,
                                                 name="fc2") ** 2)
        g2c = {"dev1": mx.cpu(0), "dev2": mx.cpu(1)} if M is mx else \
            {"dev1": CPU, "dev2": CPU}
        ex = out.simple_bind(ctx, data=(4, 5), group2ctx=g2c)
        for k, v in (("data", x), ("fc1_weight", w1), ("fc2_weight", w2)):
            ex.arg_dict[k][:] = arr(v)
        ex.forward_backward()
        return ex.outputs[0].asnumpy(), {k: v.asnumpy()
                                         for k, v in ex.grad_dict.items()}

    ref, got = _both(run)
    _close(got[0], ref[0], FWD_TOL)
    for k in ref[1]:
        _close(got[1][k], ref[1][k], GRAD_TOL)


def test_monitor_taps_every_op():
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                name="fc")
    net = mt.sym.Activation(net, act_type="relu", name="act")
    ex = net.simple_bind(CPU, data=(2, 3))
    mon = mt.Monitor(interval=1, pattern="fc|act")
    mon.install(ex)
    mon.tic()
    ex.forward(data=mt.nd.array(-np.ones((2, 3), "float32"), ctx=CPU))
    rows = mon.toc()
    assert [r[1] for r in rows] == ["fc", "act"]
    mon.uninstall()
    mon.tic()
    ex.forward()
    assert mon.toc() == []
