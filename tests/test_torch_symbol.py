"""The port's symbolic frontend (incubator_mxnet_tpu_torch/symbol,
name.py, attribute.py) against the JAX package's, on the CPU.

Twins of the 15 tests of ``tests/test_symbol.py``, each run in both
packages; then:

- ``infer_shape`` and ``infer_type`` equal to the JAX package's, value
  for value, for an MLP, a conv net, a BatchNorm net and the narrow
  ResNet of ``tests/test_torch_vision.py`` traced with ``_to_symbol``
  (its names compared without each net's own prefix, which counts the
  nets a process has built);
- ``tojson()`` of a graph built the same way (auto-names, ``Prefix`` and
  ``AttrScope`` scopes, the traced ResNet) is the same string in both;
- a JSON file written by either package loads in the other and, bound
  to the same numpy arrays, gives the same outputs (fp32: rel 1e-5 of
  the largest value);
- an op that reads values fails shape inference with the reference's
  ValueError; ``optimize`` and ``gradient`` raise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres  # noqa: E402

CPU = mt.cpu()
PKGS = [pytest.param(mx, id="jax"), pytest.param(mt, id="port")]
RESNET = ([1, 1, 1, 1], [16, 32, 64, 128, 256])


def _ctx(M):
    return mx.cpu() if M is mx else CPU


def _arr(M, a):
    return M.nd.array(a) if M is mx else M.nd.array(a, ctx=CPU)


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()),
                                               1e-6))


def _mlp(S):
    data = S.Variable("data")
    fc1 = S.FullyConnected(data, num_hidden=16, name="fc1")
    act = S.Activation(fc1, act_type="relu", name="relu1")
    fc2 = S.FullyConnected(act, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(fc2, S.Variable("label"), name="softmax")


def _convnet(S):
    data = S.Variable("data")
    c = S.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                      name="conv1")
    b = S.BatchNorm(c, name="bn1")
    return S.Pooling(b, kernel=(2, 2), stride=(2, 2), pool_type="max")


def _bnnet(S):
    data = S.Variable("data")
    x = S.BatchNorm(data, name="bn0", fix_gamma=False)
    x = S.FullyConnected(x, num_hidden=6, name="fc")
    x = S.BatchNorm(x, name="bn1", momentum=0.5)
    return S.Activation(x, act_type="tanh", name="out")


# ------------------------------------------------ twins of test_symbol.py
@pytest.mark.parametrize("M", PKGS)
def test_compose_and_listing(M):
    net = _mlp(M.sym)
    assert net.list_arguments() == ["data", "fc1_weight", "fc1_bias",
                                    "fc2_weight", "fc2_bias", "label"]
    assert net.list_outputs() == ["softmax_output"]
    assert net.list_auxiliary_states() == []


@pytest.mark.parametrize("M", PKGS)
def test_auto_variable_creation_and_naming(M):
    M.sym.NameManager.reset()
    f = M.sym.FullyConnected(M.sym.Variable("x"), num_hidden=4)
    assert f.name == "fullyconnected0"
    assert f.list_arguments() == ["x", "fullyconnected0_weight",
                                  "fullyconnected0_bias"]


@pytest.mark.parametrize("build,shapes", [
    (_mlp, dict(data=(32, 100), label=(32,))),
    (_convnet, dict(data=(4, 3, 16, 16))),
    (_bnnet, dict(data=(5, 7)))], ids=["mlp", "conv", "batchnorm"])
def test_infer_shape_and_type_match_jax(build, shapes):
    ref, got = build(mx.sym), build(mt.sym)
    assert got.list_arguments() == ref.list_arguments()
    assert got.list_auxiliary_states() == ref.list_auxiliary_states()
    assert got.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert got.infer_type() == ref.infer_type()
    partial = {k: v for k, v in list(shapes.items())[:1]}
    assert got.infer_shape_partial(**partial) == \
        ref.infer_shape_partial(**partial)


def test_infer_shape_mlp():
    net = _mlp(mt.sym)
    arg_shapes, out_shapes, _ = net.infer_shape(data=(32, 100),
                                                label=(32,))
    d = dict(zip(net.list_arguments(), arg_shapes))
    assert d["fc1_weight"] == (16, 100) and d["fc1_bias"] == (16,)
    assert d["fc2_weight"] == (10, 16) and out_shapes == [(32, 10)]


def test_infer_shape_conv():
    p = _convnet(mt.sym)
    arg_shapes, out_shapes, aux_shapes = p.infer_shape(data=(4, 3, 16, 16))
    d = dict(zip(p.list_arguments(), arg_shapes))
    assert d["conv1_weight"] == (8, 3, 3, 3) and d["bn1_gamma"] == (8,)
    assert out_shapes == [(4, 8, 8, 8)]
    assert dict(zip(p.list_auxiliary_states(), aux_shapes)) == {
        "bn1_moving_mean": (8,), "bn1_moving_var": (8,)}


@pytest.mark.parametrize("M", PKGS)
def test_batchnorm_aux_listing(M):
    b = M.sym.BatchNorm(M.sym.Variable("data"), name="bn")
    assert b.list_arguments() == ["data", "bn_gamma", "bn_beta"]
    assert b.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]


def test_arithmetic_composition():
    outs = []
    for M in (mx, mt):
        a, b = M.sym.Variable("a"), M.sym.Variable("b")
        c = (a + b) * 2 - a / b
        assert set(c.list_arguments()) == {"a", "b"}
        ex = c.bind(_ctx(M), {"a": _arr(M, [2.0]), "b": _arr(M, [4.0])})
        outs.append(ex.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[1], [(2 + 4) * 2 - 2 / 4])
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("M", PKGS)
def test_group_and_internals(M):
    a = M.sym.Variable("a")
    x = M.sym.relu(a, name="r")
    g = M.sym.Group([x, M.sym.sigmoid(a, name="s")])
    assert g.list_outputs() == ["r_output", "s_output"]
    assert x.get_internals().list_outputs() == ["a", "r_output"]
    assert [s.name for s in x.get_children()] == ["a"]


@pytest.mark.parametrize("M", PKGS)
def test_multi_output_indexing(M):
    parts = M.sym.SliceChannel(M.sym.Variable("a"), num_outputs=3, axis=1,
                               name="split")
    assert len(parts) == 3
    assert parts.list_outputs() == ["split_output0", "split_output1",
                                    "split_output2"]
    assert parts[1].list_outputs() == ["split_output1"]
    assert parts["split_output2"].list_outputs() == ["split_output2"]


def test_json_roundtrip():
    net = _mlp(mt.sym)
    net2 = mt.sym.load_json(net.tojson())
    assert net2.list_arguments() == net.list_arguments()
    assert net2.list_outputs() == net.list_outputs()
    assert net2.infer_shape(data=(8, 20), label=(8,))[1] == [(8, 10)]
    assert net2.tojson() == net.tojson()


def test_save_load_file(tmp_path):
    fname = str(tmp_path / "net.json")
    _mlp(mt.sym).save(fname)
    assert mt.sym.load(fname).list_arguments() == \
        _mlp(mt.sym).list_arguments()


def test_method_style_ops():
    outs = []
    for M in (mx, mt):
        out = M.sym.Variable("a").reshape(shape=(2, 2)).sum()
        ex = out.bind(_ctx(M), {"a": _arr(M, [1.0, 2.0, 3.0, 4.0])})
        outs.append(ex.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[1], 10.0)
    np.testing.assert_array_equal(outs[1], outs[0])
    with pytest.raises(AttributeError):
        mt.sym.Variable("a").not_an_op


@pytest.mark.parametrize("M", PKGS)
def test_variable_attrs(M):
    v = M.sym.Variable("w", shape=(3, 4), lr_mult=2.0, dtype="float16")
    assert v.attr("__shape__") == "(3, 4)"
    assert v.attr("__lr_mult__") == "2.0"
    assert v.attr_dict() == {"w": {"__shape__": "(3, 4)",
                                   "__dtype__": "float16",
                                   "__lr_mult__": "2.0"}}
    assert v.infer_type()[0] == [np.dtype("float16")]


def test_variable_shape_attr_is_used():
    """Variable(shape=...) gives the shape unless the call gives one (as
    in MXNet; the JAX package ignores the attribute)."""
    w = mt.sym.Variable("w", shape=(4, 6))
    y = mt.sym.dot(mt.sym.Variable("x"), w)
    assert y.infer_shape(x=(2, 4)) == ([(2, 4), (4, 6)], [(2, 6)], [])
    assert y.infer_shape(x=(2, 3), w=(3, 5))[1] == [(2, 5)]


def test_keyword_input_after_gap():
    outs = []
    for M in (mx, mt):
        fc = M.sym.FullyConnected(M.sym.Variable("data"),
                                  bias=M.sym.Variable("my_bias"),
                                  num_hidden=4, name="fc")
        assert fc.list_arguments() == ["data", "fc_weight", "my_bias"]
        ex = fc.simple_bind(_ctx(M), data=(2, 3))
        ex.arg_dict["data"][:] = 0
        ex.arg_dict["my_bias"][:] = _arr(M, np.arange(4, dtype="float32"))
        outs.append(ex.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[1], np.tile(np.arange(4.0), (2, 1)))


@pytest.mark.parametrize("M", PKGS)
def test_unknown_symbol_kwarg_raises(M):
    data, stray = M.sym.Variable("data"), M.sym.Variable("stray")
    with pytest.raises(TypeError, match="bogus_input"):
        M.sym.FullyConnected(data, bogus_input=stray, num_hidden=4)
    with pytest.raises(TypeError, match="trailing"):
        M.sym.FullyConnected(data, None, stray, num_hidden=4)


def test_nd_missing_input_raises():
    x = mt.nd.array(np.zeros((2, 3), "float32"), ctx=CPU)
    b = mt.nd.array(np.zeros(4, "float32"), ctx=CPU)
    with pytest.raises(TypeError, match="bias"):
        mt.nd.FullyConnected(x, bias=b, num_hidden=4)


# ------------------------------------------------ JSON across packages
def _scoped(S, name_mod, attr_scope):
    """A graph with auto-names, a Prefix scope and an AttrScope."""
    S.NameManager.reset()
    x = S.Variable("x")
    with name_mod.Prefix("stage1_"):
        h = S.FullyConnected(x, num_hidden=8)
        with attr_scope(ctx_group="dev1", __lr_mult__="0.5"):
            h = S.Activation(h, act_type="relu")
            h = S.FullyConnected(h, num_hidden=3, no_bias=True)
    h = S.Convolution(S.Reshape(h, shape=(-1, 3, 1, 1)), kernel=(1, 1),
                      num_filter=2)
    return S.MakeLoss(S.sum(h * 0.5 + 1), name="loss")


def test_tojson_string_equal_across_packages():
    ref = _scoped(mx.sym, mx.name, mx.AttrScope)
    got = _scoped(mt.sym, mt.name, mt.AttrScope)
    assert got.tojson() == ref.tojson()
    for build in (_mlp, _convnet, _bnnet):
        assert build(mt.sym).tojson() == build(mx.sym).tojson()


def _resnet_arrays():
    """Shapes from one forward of the port's narrow ResNet, values from
    numpy."""
    probe = tres.ResNetV1(tres.BottleneckV1, *RESNET, classes=10,
                          thumbnail=True)
    probe.initialize(mt.init.Zero(), ctx=CPU)
    probe.infer_shape(torch.zeros(1, 3, 32, 32))
    rs = np.random.RandomState(0)
    return {k[len(probe.prefix):]: rs.rand(*p.shape).astype(np.float32)
            for k, p in probe.collect_params().items()}


def test_traced_resnet_matches_jax():
    arrays = _resnet_arrays()
    jnet = jres.ResNetV1(jres.BottleneckV1, *RESNET, classes=10,
                         thumbnail=True)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(arrays[k[len(jnet.prefix):]]))
    tnet = tres.ResNetV1(tres.BottleneckV1, *RESNET, classes=10,
                         thumbnail=True)
    ref = mx.sym.SoftmaxOutput(jnet._to_symbol(mx.sym.Variable("data")),
                               name="softmax")
    got = mt.sym.SoftmaxOutput(tnet(mt.sym.Variable("data")),
                               name="softmax")

    def strip(names, prefix):
        return [n[len(prefix):] if n.startswith(prefix) else n
                for n in names]

    for what in ("list_arguments", "list_auxiliary_states",
                 "list_outputs"):
        assert strip(getattr(got, what)(), tnet.prefix) == \
            strip(getattr(ref, what)(), jnet.prefix), what
    shapes = dict(data=(4, 3, 32, 32), softmax_label=(4,))
    assert got.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert got.infer_type() == ref.infer_type()
    assert got.tojson().replace(tnet.prefix, "net_") == \
        ref.tojson().replace(jnet.prefix, "net_")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_file_loads_in_other_package(tmp_path, writer):
    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    fname = str(tmp_path / "net.json")
    _bnnet(src.sym).save(fname)
    loaded = dst.sym.load(fname)
    assert loaded.tojson() == _bnnet(dst.sym).tojson()
    rs = np.random.RandomState(1)
    shapes = dict(zip(loaded.list_arguments() +
                      loaded.list_auxiliary_states(),
                      sum(loaded.infer_shape(data=(5, 7))[::2], [])))
    vals = {k: rs.rand(*s).astype(np.float32) + 0.5
            for k, s in shapes.items()}
    outs = []
    for M, s in ((src, src.sym.load(fname)), (dst, loaded)):
        args = {k: _arr(M, vals[k]) for k in s.list_arguments()}
        aux = {k: _arr(M, vals[k]) for k in s.list_auxiliary_states()}
        ex = s.bind(_ctx(M), args, aux_states=aux)
        outs.append([ex.forward(is_train=b)[0].asnumpy()
                     for b in (False, True)])
    for got, ref in zip(outs[1], outs[0]):
        _close(got, ref)


# ------------------------------------------------ what raises
def test_value_reading_op_fails_inference_and_optimize_raises():
    x = mt.sym.Variable("x")
    # a creation op runs on meta too (its ctx is the meta device)
    assert (mt.sym.arange(0, 3) + x).infer_shape(x=(3,))[1] == [(3,)]
    with pytest.raises(ValueError, match="shape inference failed at op"):
        mt.sym.Reshape(x, shape=(-1, 5)).infer_shape(x=(2, 3))
    # an op whose output length is a value of its input: meta has none
    mt.rtc.register("test_sym_head", lambda t: t[:int(t[0].item())],
                    arg_names=["data"])
    try:
        with pytest.raises(ValueError, match="test_sym_head"):
            mt.sym.test_sym_head(x).infer_shape(x=(4,))
    finally:
        mt.rtc.unregister("test_sym_head")
    assert not hasattr(mt.sym, "test_sym_head")
    with pytest.raises(ValueError, match="incomplete"):
        _mlp(mt.sym).infer_shape(data=(2, 3))
    # the pass pipeline is ported (tests/test_torch_graph.py)
    opt, report = x.optimize(level=1)
    assert report["level"] == 1 and opt.list_outputs() == x.list_outputs()
    with pytest.raises(NotImplementedError, match="Executor.backward"):
        x.gradient(["x"])
    with pytest.raises(ValueError, match="strings"):
        mt.AttrScope(ctx_group=1)


def test_get_symbol_retraces_recorded_history():
    """Twins of test_autograd.py's get_symbol tests: the recorded
    history re-traced into a Symbol reproduces the forward (in both
    packages, on the same arrays); an unrecorded array is a bare
    Variable; a custom Function's call and an inlined constant raise."""
    rs = np.random.RandomState(0)
    a, w = rs.rand(2, 3).astype("f4"), rs.rand(4, 3).astype("f4")
    b = np.zeros(4, "float32")
    outs = []
    for M in (mx, mt):
        arrs = [_arr(M, v) for v in (a, w, b)]
        with M.autograd.record():
            y = M.nd.FullyConnected(*arrs, num_hidden=4)
            z = M.nd.Activation(y, act_type="relu") * 2.0
        s = M.autograd.get_symbol(z)
        args = s.list_arguments()
        assert len(args) == 3
        ex = s.simple_bind(_ctx(M), **dict(zip(args, [(2, 3), (4, 3),
                                                      (4,)])))
        for name, arr in zip(args, arrs):
            ex.arg_dict[name][:] = arr
        outs.append((ex.forward()[0].asnumpy(), z.asnumpy()))
        assert M.autograd.get_symbol(_arr(M, b)).list_arguments() == \
            ["var0"]
    _close(outs[1][0], outs[1][1])
    _close(outs[1][0], outs[0][0])

    class Twice(mt.autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, g):
            return g * 2

    x = _arr(mt, a)
    x.attach_grad()
    with mt.autograd.record():
        y = Twice()(x)
        c = mt.nd.broadcast_add(x, np.ones((2, 3), "float32"))
    with pytest.raises(ValueError, match="opaque"):
        mt.autograd.get_symbol(y)
    with pytest.raises(ValueError, match="constant"):
        mt.autograd.get_symbol(c)
