"""The port's Gluon surface (incubator_mxnet_tpu_torch.gluon, ops/nn.py,
initializer, optimizer, lr_scheduler) against the JAX package's, on the
CPU with the same numpy inputs.

- The ``ops/nn.py`` ops the layers use, each against the JAX op's
  function and ``jax.vjp`` with the same cotangent: Convolution (stride,
  pad, dilate, groups), Pooling (max/avg/sum x valid/full at odd sizes,
  and global), BatchNorm (training and inference, fix_gamma on and off,
  the moving stats after two updates, and ``nd``'s aux write-back),
  FullyConnected (flatten), Activation (each act_type) and
  softmax_cross_entropy.  fp32: rtol 1e-5 and atol 1e-5 of the largest
  |value| (sums in another order).  The other ``ops/nn.py`` names run
  in ``test_torch_ndarray.py``'s op sweep.
- Parameter and ParameterDict naming, deferred initialization and
  grad_req 'write'/'add'; gluon.utils (split_data, split_and_load,
  clip_global_norm); the
  ``collect_params()`` names, shapes and grad_req of
  ``resnet18_v1(thumbnail=True)`` and ``resnet50_v1()`` (construction
  only); a ``.params`` file written by each package and read by the
  other.
- Every loss (weights, sample weights, batch_axis, from_logits,
  sparse_label) and every lr scheduler; each optimizer's update over 3
  steps, multi_precision SGD and the wd_mult default included (fp32:
  rtol 1e-5, atol 1e-6; bf16 weights: exactly the fp32 master rounded).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres  # noqa: E402
from incubator_mxnet_tpu.ops.registry import get_op as jget  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres  # noqa: E402
from incubator_mxnet_tpu_torch.ops.registry import get_op as tget  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).normal(0, 1, shape) \
        .astype(np.float32)


def _close(got, ref, rtol=1e-5):
    """rtol, and atol rtol x the largest |ref| (sums in another order)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max()) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(scale, 1e-6))


def _op_pair(name, inputs, params, diff, seed=9):
    """Forward and gradient (w.r.t. the inputs indexed by ``diff``, for
    one seeded cotangent) of op ``name`` in both packages: the outputs
    as numpy, and the gradients as lists."""
    jfn, tfn = jget(name).fn, tget(name).fn

    def jcall(*xs):
        return jfn(*xs, **params)

    jin = [None if a is None else jnp.asarray(a) for a in inputs]
    tin = [None if a is None else torch.from_numpy(a.copy())
           .requires_grad_(i in diff) for i, a in enumerate(inputs)]
    jout = jcall(*jin)
    tout = tfn(*tin, **params)
    jfirst = jout[0] if isinstance(jout, tuple) else jout
    tfirst = tout[0] if isinstance(tout, tuple) else tout
    if not diff:
        return jout, tout, [], []
    ct = _rand(*jfirst.shape, seed=seed)

    def head(*xs):
        full = list(jin)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jcall(*full)
        return out[0] if isinstance(out, tuple) else out

    _, vjp = jax.vjp(head, *[jin[i] for i in diff])
    jg = vjp(jnp.asarray(ct))
    tg = torch.autograd.grad(tfirst, [tin[i] for i in diff],
                             torch.from_numpy(ct), allow_unused=True)
    return jout, tout, [np.asarray(g) for g in jg], \
        [np.zeros(inputs[i].shape, np.float32) if g is None
         else g.detach().numpy() for i, g in zip(diff, tg)]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------------------------------ ops

CONV_CASES = [
    # (data shape, weight shape, params)
    ((2, 4, 9, 11), (6, 4, 3, 3), dict(stride=(2, 2), pad=(1, 1))),
    ((2, 4, 10, 9), (6, 4, 3, 3), dict(dilate=(2, 2), pad=(2, 1))),
    ((2, 4, 8, 8), (6, 2, 3, 3), dict(num_group=2, stride=(1, 2))),
    ((2, 3, 13), (5, 3, 4), dict(stride=(3,), pad=(1,))),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_convolution_matches_jax(case):
    dshape, wshape, params = CONV_CASES[case]
    inputs = [_rand(*dshape, seed=1), _rand(*wshape, seed=2),
              _rand(wshape[0], seed=3)]
    params = dict(params, kernel=wshape[2:], num_filter=wshape[0])
    jo, to, jg, tg = _op_pair("Convolution", inputs, params, (0, 1, 2))
    _close(_np(to), _np(jo))
    for g, r in zip(tg, jg):
        _close(g, r)


POOL_CASES = [(t, c) for t in ("max", "avg", "sum")
              for c in ("valid", "full")]


@pytest.mark.parametrize("pool_type,convention", POOL_CASES)
def test_pooling_matches_jax(pool_type, convention):
    # 8 x 10 with kernel 3, stride 2, pad 1: "full" adds a high-side row
    # and column (8 + 2 - 3 = 7, odd), which torch's ceil_mode would not
    x = _rand(2, 3, 8, 10, seed=4)
    params = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                  pool_type=pool_type, pooling_convention=convention)
    jo, to, jg, tg = _op_pair("Pooling", [x], params, (0,))
    assert _np(to).shape == _np(jo).shape
    _close(_np(to), _np(jo))
    _close(tg[0], jg[0])


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pooling_matches_jax(pool_type):
    x = _rand(2, 3, 7, 5, seed=5)
    params = dict(kernel=(2, 2), pool_type=pool_type, global_pool=True)
    jo, to, jg, tg = _op_pair("Pooling", [x], params, (0,))
    _close(_np(to), _np(jo))
    _close(tg[0], jg[0])


def test_pooling_1d_and_3d_match_jax():
    for shape, k in (((2, 3, 11), (3,)), ((1, 2, 5, 6, 7), (2, 3, 2))):
        x = _rand(*shape, seed=6)
        params = dict(kernel=k, stride=(2,) * len(k), pool_type="avg",
                      pooling_convention="full")
        jo, to, _, _ = _op_pair("Pooling", [x], params, ())
        _close(_np(to), _np(jo))


def _bn_inputs(seed):
    c = 5
    return [_rand(4, c, 3, 3, seed=seed) * 2 + 1, _rand(c, seed=seed + 1),
            _rand(c, seed=seed + 2), _rand(c, seed=seed + 3) * 0.1,
            np.abs(_rand(c, seed=seed + 4)) + 0.5]


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_training_and_moving_stats_match_jax(fix_gamma):
    params = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
                  _training=True)
    inputs = _bn_inputs(10)
    jo, to, jg, tg = _op_pair("BatchNorm", inputs, params, (0, 1, 2))
    for got, ref in zip(to, jo):
        _close(_np(got), _np(ref))
    for g, r in zip(tg, jg):
        _close(g, r)
    if fix_gamma:
        assert not np.any(tg[1])
    # a second update from the first one's moving stats, on new data
    second = _bn_inputs(20)[:3] + [_np(jo[1]), _np(jo[2])]
    jo2, to2, _, _ = _op_pair("BatchNorm", second, params, ())
    for got, ref in zip(to2[1:], jo2[1:]):
        _close(_np(got), _np(ref))


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batchnorm_inference_matches_jax(fix_gamma, use_global_stats):
    params = dict(eps=1e-3, fix_gamma=fix_gamma,
                  use_global_stats=use_global_stats,
                  _training=use_global_stats)
    jo, to, jg, tg = _op_pair("BatchNorm", _bn_inputs(30), params,
                              (0, 1, 2))
    jfirst = jo[0] if isinstance(jo, tuple) else jo
    tfirst = to[0] if isinstance(to, tuple) else to
    _close(_np(tfirst), _np(jfirst))
    for g, r in zip(tg, jg):
        _close(g, r)


def test_nd_batchnorm_writes_the_moving_stats_back():
    """nd's aux write-back: in training mode the op's trailing outputs
    land in its moving-stat inputs, in both packages alike."""
    data, gamma, beta, mm, mv = _bn_inputs(40)
    got = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        arrs = [pkg.nd.array(a, **kw) for a in (data, gamma, beta, mm, mv)]
        with pkg.autograd.train_mode():
            out = pkg.nd.BatchNorm(*arrs, fix_gamma=False)
        with pkg.autograd.predict_mode():
            pkg.nd.BatchNorm(*arrs, fix_gamma=False)    # no write-back
        got.append([out.asnumpy(), arrs[3].asnumpy(), arrs[4].asnumpy()])
    for t, j in zip(got[1], got[0]):
        _close(t, j)
    assert not np.allclose(got[1][1], mm)


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_matches_jax(flatten):
    x = _rand(3, 4, 5, seed=50)
    in_units = 20 if flatten else 5
    inputs = [x, _rand(6, in_units, seed=51), _rand(6, seed=52)]
    params = dict(num_hidden=6, flatten=flatten)
    jo, to, jg, tg = _op_pair("FullyConnected", inputs, params, (0, 1, 2))
    _close(_np(to), _np(jo))
    for g, r in zip(tg, jg):
        _close(g, r)


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh",
                                      "softrelu", "softsign"])
def test_activation_matches_jax(act_type):
    jo, to, jg, tg = _op_pair("Activation", [_rand(4, 7, seed=60)],
                              dict(act_type=act_type), (0,))
    _close(_np(to), _np(jo))
    _close(tg[0], jg[0])


def test_softmax_cross_entropy_matches_jax():
    label = np.array([0, 3, 2, 1], np.float32)
    jo, to, jg, tg = _op_pair("softmax_cross_entropy",
                              [_rand(4, 5, seed=70), label], {}, (0,))
    _close(_np(to), _np(jo))
    _close(tg[0], jg[0])


# ------------------------------------------------------ params, blocks

def test_parameter_naming_and_deferred_init():
    pd = mt.gluon.ParameterDict("net0_")
    w = pd.get("weight", shape=(4, 0), allow_deferred_init=True)
    assert w.name == "net0_weight" and pd.get("weight") is w
    assert list(pd.keys()) == ["net0_weight"]
    w.initialize(mt.init.One(), ctx=CPU)
    with pytest.raises(mt.gluon.DeferredInitializationError):
        w.data()
    w.shape = (4, 3)
    w._finish_deferred_init()
    assert w.data().shape == (4, 3) and (w.data().asnumpy() == 1).all()
    shared = mt.gluon.ParameterDict("net0_", shared=pd)
    assert shared.get("weight") is w

    net = tnn.HybridSequential()
    with net.name_scope():
        net.add(tnn.Dense(5), tnn.Dense(2, in_units=5))
    names = list(net.collect_params().keys())
    jnet = mx.gluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(mx.gluon.nn.Dense(5), mx.gluon.nn.Dense(2, in_units=5))
    strip = lambda n, p: [k[len(p):] for k in n]            # noqa: E731
    assert strip(names, net.prefix) == \
        strip(jnet.collect_params().keys(), jnet.prefix) == \
        ["dense0_weight", "dense0_bias", "dense1_weight", "dense1_bias"]
    assert list(net.collect_params(".*bias").keys()) == \
        [net.prefix + "dense0_bias", net.prefix + "dense1_bias"]
    net.initialize(mt.init.Xavier(), ctx=CPU)
    first = net.collect_params()[net.prefix + "dense0_weight"]
    with pytest.raises(mt.gluon.DeferredInitializationError):
        first.data()
    out = net(torch.ones(3, 7))
    assert out.shape == (3, 2) and first.shape == (5, 7)
    # the torch view of the same tree
    assert [n for n, _ in net.named_parameters()] == \
        ["0.weight", "0.bias", "1.weight", "1.bias"]


def test_grad_req_add_accumulates_and_zero_grad_clears():
    """'write' replaces the gradient at each backward, 'add' adds to it,
    in both packages alike; zero_grad clears it."""
    x, w = _rand(3, 4, seed=81), _rand(2, 4, seed=82)
    got = {}
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        for req in ("write", "add"):
            net = pkg.gluon.nn.Dense(2, in_units=4, use_bias=False)
            net.collect_params().setattr("grad_req", req)
            net.initialize(pkg.init.Zero(), **kw)
            param = net.collect_params()[net.prefix + "weight"]
            param.set_data(pkg.nd.array(w, **kw))
            for _ in range(2):
                with pkg.autograd.record():
                    out = net(pkg.nd.array(x, **kw))
                out.backward()
            got[pkg.__name__, req] = param.grad().asnumpy()
            if pkg is mt and req == "add":
                net.collect_params().zero_grad()
                assert not param.grad().asnumpy().any()
    for req in ("write", "add"):
        _close(got["incubator_mxnet_tpu_torch", req],
               got["incubator_mxnet_tpu", req])
    _close(got["incubator_mxnet_tpu_torch", "add"],
           2 * got["incubator_mxnet_tpu_torch", "write"])


def test_gluon_utils_match_jax():
    data = _rand(6, 5, seed=83)
    for even in (True, False):
        n = 3 if even else 4
        if not even:
            data = _rand(7, 5, seed=84)
        ref = mx.gluon.utils.split_data(mx.nd.array(data), n,
                                        even_split=even)
        got = mt.gluon.utils.split_data(mt.nd.array(data, ctx=CPU), n,
                                        even_split=even)
        assert [g.shape for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())
    with pytest.raises(ValueError):
        mt.gluon.utils.split_data(mt.nd.array(data, ctx=CPU), 4)
    (one,) = mt.gluon.utils.split_and_load(data, [CPU])
    np.testing.assert_array_equal(one.asnumpy(), data)
    grads = [_rand(3, 4, seed=85), _rand(5, seed=86)]
    jarr = [mx.nd.array(g) for g in grads]
    tarr = [mt.nd.array(g, ctx=CPU) for g in grads]
    jnorm = mx.gluon.utils.clip_global_norm(jarr, 1.5)
    tnorm = mt.gluon.utils.clip_global_norm(tarr, 1.5)
    assert tnorm == pytest.approx(jnorm, rel=1e-6)
    for t, j in zip(tarr, jarr):
        _close(t.asnumpy(), j.asnumpy())


def _strip_all(params, prefix):
    return {k[len(prefix):]: (p.shape, p.grad_req)
            for k, p in params.items()}


@pytest.mark.parametrize("factory,kw", [("resnet18_v1", {"thumbnail": True}),
                                        ("resnet50_v1", {}),
                                        ("resnet18_v2", {"classes": 10})])
def test_resnet_names_shapes_and_grad_req_match_jax(factory, kw):
    tnet = getattr(tres, factory)(**kw)
    jnet = getattr(jres, factory)(**kw)
    got = _strip_all(tnet.collect_params(), tnet.prefix)
    want = _strip_all(jnet.collect_params(), jnet.prefix)
    assert list(got) == list(want)
    assert got == want
    with pytest.raises(NotImplementedError, match="pretrained"):
        getattr(tres, factory)(pretrained=True)


def test_resnet50_parameter_count():
    net = tres.resnet50_v1()
    net.initialize(mt.init.Xavier(), ctx=CPU)
    net.infer_shape(torch.zeros(1, 3, 32, 32))
    params = net.collect_params()
    assert len(params) == 267 == \
        len(list(jres.resnet50_v1().collect_params().keys()))
    trainable = sum(int(np.prod(p.shape)) for p in params.values()
                    if p.grad_req != "null")
    assert trainable == 25557032     # ResNet-50 v1, 1000 classes


def test_params_file_crosses_between_packages(tmp_path):
    shape = (3, 4)
    tnet = tnn.Dense(3, in_units=4, device="cpu")
    mt.initializer.initialize(tnet, mt.init.Xavier(),
                              mt.random.generator(0))
    jnet = mx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize(mx.init.Zero())
    path = str(tmp_path / "dense.params")
    tnet.save_parameters(path)
    jnet.load_parameters(path)
    np.testing.assert_array_equal(jnet.weight.data().asnumpy(),
                                  tnet.weight.detach().numpy())
    jnet.weight.set_data(mx.nd.array(_rand(*shape, seed=80)))
    jnet.save_parameters(path)
    fresh = tnn.Dense(3, in_units=4)
    fresh.load_parameters(path, ctx=CPU)
    np.testing.assert_array_equal(fresh.weight.detach().numpy(),
                                  _rand(*shape, seed=80))
    assert fresh.weight.device.type == "cpu"
    with pytest.raises(IOError, match="missing"):
        tnn.Dense(3, in_units=4, use_bias=True).collect_params().load(
            path, ctx=CPU, restore_prefix="other_")


# --------------------------------------------------------------- losses

LOSSES = [
    ("L2Loss", {}, "dense"), ("L2Loss", {"weight": 2.0}, "dense"),
    ("L1Loss", {}, "dense"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("SoftmaxCrossEntropyLoss", {}, "sparse"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dist"),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True}, "sparse"),
    ("KLDivLoss", {}, "dist"), ("KLDivLoss", {"from_logits": False},
                                "dist"),
    ("HuberLoss", {"rho": 0.5}, "dense"), ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {}, "signed"), ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("L2Loss", {"batch_axis": 1}, "dense"),
]


def _loss_inputs(kind):
    pred = _rand(4, 5, seed=90)
    rs = np.random.RandomState(91)
    label = {
        "dense": _rand(4, 5, seed=92),
        "binary": rs.randint(0, 2, (4, 5)).astype(np.float32),
        "signed": rs.randint(0, 2, (4, 5)).astype(np.float32) * 2 - 1,
        "sparse": rs.randint(0, 5, (4,)).astype(np.float32),
        "dist": np.exp(_rand(4, 5, seed=93))
        / np.exp(_rand(4, 5, seed=93)).sum(1, keepdims=True),
    }.get(kind)
    if kind == "prob":
        pred = 1 / (1 + np.exp(-pred))
        label = rs.randint(0, 2, (4, 5)).astype(np.float32)
    return pred, label


@pytest.mark.parametrize("case", range(len(LOSSES)))
def test_loss_matches_jax(case):
    name, kw, kind = LOSSES[case]
    pred, label = _loss_inputs(kind)
    sw = np.abs(_rand(4, 1, seed=94)) if kw.get("batch_axis", 0) == 0 \
        else None
    jloss = getattr(mx.gluon.loss, name)(**kw)
    tloss = getattr(mt.gluon.loss, name)(**kw)
    args = [pred, label] + ([sw] if sw is not None else [])
    ref = jloss(*[mx.nd.array(a) for a in args]).asnumpy()
    got = tloss(*[torch.from_numpy(a) for a in args])
    _close(got.numpy(), ref)


def test_triplet_loss_and_ctc():
    a, p, n = (_rand(4, 6, seed=s) for s in (95, 96, 97))
    ref = mx.gluon.loss.TripletLoss(margin=0.5)(
        *[mx.nd.array(v) for v in (a, p, n)]).asnumpy()
    got = mt.gluon.loss.TripletLoss(margin=0.5)(
        *[torch.from_numpy(v) for v in (a, p, n)])
    _close(got.numpy(), ref)
    with pytest.raises(NotImplementedError, match="A8"):
        mt.gluon.loss.CTCLoss()


# ---------------------------------------------------------- schedulers

SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=0.02,
                             base_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[2, 5, 7], factor=0.3,
                                  base_lr=0.2)),
    ("PolyScheduler", dict(max_update=8, base_lr=0.1, pwr=2)),
    ("CosineScheduler", dict(max_update=8, base_lr=0.1, final_lr=0.01)),
]


@pytest.mark.parametrize("case", range(len(SCHEDULERS) + 1))
def test_lr_scheduler_matches_jax(case):
    def make(mod):
        if case == len(SCHEDULERS):
            return mod.WarmupScheduler(3, mod.FactorScheduler(2, 0.5,
                                                              base_lr=0.4))
        name, kw = SCHEDULERS[case]
        return getattr(mod, name)(**kw)
    j, t = make(mx.lr_scheduler), make(mt.lr_scheduler)
    for n in range(12):
        assert t(n) == pytest.approx(j(n), rel=1e-12)


# ---------------------------------------------------------- optimizers

OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.5, rescale_grad=0.5)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True,
                     clip_weights=2.0)),
    ("adadelta", dict(wd=0.01)),
    ("ftrl", dict(learning_rate=0.1, wd=0.01)),
    ("adamax", dict(learning_rate=0.01, wd=0.01)),
    ("nadam", dict(learning_rate=0.01, wd=0.01)),
    ("signum", dict(learning_rate=0.01, wd=0.01)),
    ("signum", dict(learning_rate=0.01, momentum=0.0)),
    ("test", dict(rescale_grad=0.5)),
]
NAMES = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma"}


def _run_optimizer(pkg, name, kw, kwctx, dtype="float32"):
    opt = pkg.optimizer.create(name, param_idx2name=NAMES, **kw)
    upd = pkg.optimizer.get_updater(opt)
    shapes = {0: (4, 3), 1: (4,), 2: (3,)}
    ws = {i: pkg.nd.array(_rand(*s, seed=100 + i), dtype=dtype, **kwctx)
          for i, s in shapes.items()}
    for step in range(3):
        for i, s in shapes.items():
            g = pkg.nd.array(_rand(*s, seed=200 + 10 * step + i),
                             dtype=dtype, **kwctx)
            upd(i, g, ws[i])
    return {i: w.asnumpy() for i, w in ws.items()}, upd


@pytest.mark.parametrize("case", range(len(OPTIMIZERS)))
def test_optimizer_three_steps_match_jax(case):
    name, kw = OPTIMIZERS[case]
    ref, _ = _run_optimizer(mx, name, kw, {})
    got, _ = _run_optimizer(mt, name, kw, {"ctx": CPU})
    for i in ref:
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-5, atol=1e-6)


def test_wd_mult_default_rule():
    """Only *_weight and *_gamma decay by default: with a zero
    gradient, the bias keeps its value and the others shrink."""
    opt = mt.optimizer.create("sgd", learning_rate=0.5, wd=0.1,
                              param_idx2name=NAMES)
    assert [opt._get_wd(i) for i in range(3)] == [0.1, 0.0, 0.1]
    opt.set_wd_mult({"fc_bias": 2.0})
    assert opt._get_wd(1) == pytest.approx(0.2)
    assert mt.parallel.optim.default_wd_mults(
        ["a_weight", "a_bias", "b_gamma", "b_beta"], {"b_beta": 3.0}) == \
        {"a_weight": 1.0, "a_bias": 0.0, "b_gamma": 1.0, "b_beta": 3.0}


def test_multi_precision_sgd_matches_jax():
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01,
              multi_precision=True)
    ref, jupd = _run_optimizer(mx, "sgd", kw, {}, jnp.bfloat16)
    got, tupd = _run_optimizer(mt, "sgd", kw, {"ctx": CPU}, torch.bfloat16)
    for i in ref:
        mom, w32 = tupd.states[i]
        jmom, jw32 = jupd.states[i]
        assert w32.dtype == np.float32
        np.testing.assert_allclose(w32.asnumpy(), jw32.asnumpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mom.asnumpy(), jmom.asnumpy(),
                                   rtol=1e-5, atol=1e-6)
        # the bf16 weight is the fp32 master rounded
        np.testing.assert_array_equal(
            got[i], torch.from_numpy(w32.asnumpy()).bfloat16().float()
            .numpy())


def test_sgld_noise_and_updater_states_roundtrip():
    opt = mt.optimizer.create("sgld", learning_rate=0.01)
    w = mt.nd.array(np.zeros((200, 100), np.float32), ctx=CPU)
    opt.update(0, w, mt.nd.array(np.ones((200, 100), np.float32),
                                 ctx=CPU), None)
    drift = -0.01 / 2
    noise = w.asnumpy() - drift
    assert abs(noise.std() - 0.1) < 0.01 and abs(noise.mean()) < 0.01
    _, upd = _run_optimizer(mt, "adam", dict(learning_rate=0.01),
                            {"ctx": CPU})
    blob = upd.get_states()
    fresh = mt.optimizer.get_updater(mt.optimizer.create("adam"))
    fresh.set_states(blob)
    w0 = mt.nd.array(np.ones((4, 3), np.float32), ctx=CPU)
    fresh(0, mt.nd.array(np.ones((4, 3), np.float32), ctx=CPU), w0)
    assert isinstance(fresh.states[0][0], mt.nd.NDArray)


def test_register_takes_bare_classes_and_aliases():
    """C2: optimizer.register and initializer.register are the
    registry's register(name=None, obj=None, aliases=()), as the JAX
    package's: a bare decorator registers a class under its own name."""
    for M in (mx, mt):
        @M.optimizer.register
        class PortTwinSGD(M.optimizer.SGD):
            pass

        assert type(M.optimizer.create("porttwinsgd",
                                       learning_rate=0.1)) is PortTwinSGD
        M.optimizer.register("porttwin_alias", PortTwinSGD,
                             aliases=("ptalias",))
        assert type(M.optimizer.create("PTALIAS")) is PortTwinSGD

        @M.initializer.register
        class PortTwinInit(M.initializer.Constant):
            def __init__(self):
                super().__init__(0.25)

        got = M.initializer.create("porttwininit")
        assert type(got) is PortTwinInit
        with pytest.raises(KeyError, match="unknown optimizer"):
            M.optimizer.create("no_such_optimizer")


# ------------------------------------------------ Trainer and kvstores
# (twins of tests/test_mesh_frontend.py's one-device Trainer cases)
@functools.lru_cache(maxsize=None)
def _gluon_weights():
    """test_mesh_frontend.py's net (Dense 32 relu, Dense 5) with the
    weights its JAX Trainer starts from (random.seed(0), Xavier)."""
    mx.random.seed(0)
    jnet = mx.gluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(mx.gluon.nn.Dense(32, activation="relu"),
                 mx.gluon.nn.Dense(5))
    jnet.initialize(mx.initializer.Xavier())
    jnet(mx.nd.array(np.zeros((2, 12), np.float32)))
    return tuple(p.data().asnumpy()
                 for _, p in sorted(jnet.collect_params().items(),
                                    key=lambda kv: kv[0][len(jnet.prefix):]))


def _train_gluon(M, force_eager=False, steps=15, kvstore="device",
                 weights=None):
    """(losses, params, trainer) of test_mesh_frontend.py's
    _train_gluon, from ``weights``."""
    rs = np.random.RandomState(0)
    X = rs.rand(64, 12).astype(np.float32)
    Y = rs.randint(0, 5, (64,)).astype(np.float32)
    kw = {} if M is mx else {"ctx": CPU}
    net = M.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(M.gluon.nn.Dense(32, activation="relu", in_units=12),
                M.gluon.nn.Dense(5, in_units=32))
    net.initialize(M.init.Zero(), **kw)
    params = sorted(net.collect_params().items(),
                    key=lambda kv: kv[0][len(net.prefix):])
    for (_, p), w in zip(params, weights):
        p.set_data(M.nd.array(w, **kw))
    tr = M.gluon.Trainer(net.collect_params(), "sgd",
                         dict(learning_rate=0.2, momentum=0.9, wd=1e-3),
                         kvstore=kvstore)
    if force_eager:
        if M is mx:
            tr._init_kvstore()
            tr._fused_update = False
        else:
            tr._fused = False
    loss_fn = M.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        xb, yb = M.nd.array(X, **kw), M.nd.array(Y, **kw)
        with M.autograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        tr.step(X.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return losses, [p.data().asnumpy() for _, p in params], tr


def test_trainer_fused_matches_eager_updater():
    w = _gluon_weights()
    l_e, p_e, _ = _train_gluon(mt, force_eager=True, weights=w)
    l_f, p_f, tr_f = _train_gluon(mt, weights=w)
    l_j, p_j, _ = _train_gluon(mx, weights=w)
    assert tr_f._fused is True and tr_f._fstate is not None
    assert l_f[-1] < l_f[0]
    np.testing.assert_allclose(l_e[-1], l_f[-1], rtol=1e-5)
    np.testing.assert_allclose(l_j[-1], l_f[-1], rtol=1e-5)
    for a, b, c in zip(p_e, p_f, p_j):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kvstore", ["tpu", "local", "store"])
def test_trainer_kvstores_match_device(kvstore):
    """Trainer(kvstore='tpu') takes the ambient mesh at construction;
    'local' (no store on one device) and a KVStore object (whose store
    runs the optimizer on the per-parameter route) give the 'device'
    result."""
    w = _gluon_weights()
    l_d, p_d, _ = _train_gluon(mt, weights=w, steps=4)
    mesh = mt.parallel.make_mesh(devices=["cpu"])
    spec = mt.kv.create("local") if kvstore == "store" else kvstore
    with mt.parallel.use_mesh(mesh):
        l_k, p_k, tr = _train_gluon(mt, weights=w, steps=4, kvstore=spec,
                                    force_eager=kvstore == "store")
    assert (tr._mesh is mesh) == (kvstore == "tpu")
    assert (tr._kvstore is spec) == (kvstore == "store")
    assert (tr._kvstore is None) == (kvstore != "store")
    np.testing.assert_allclose(l_k, l_d, rtol=1e-5)
    for a, b in zip(p_k, p_d):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_trainer_fused_lr_schedule_no_recompile():
    """The learning rate is a device tensor the whole-tree update reads:
    a new rate needs nothing rebuilt, and the step moves the params."""
    w = _gluon_weights()
    _, _, tr = _train_gluon(mt, steps=2, weights=w)
    fstate = tr._fstate
    tr.set_learning_rate(0.01)
    before = [p.data().asnumpy().copy() for p in tr._params]
    rs = np.random.RandomState(1)
    X = mt.nd.array(rs.rand(64, 12).astype(np.float32), ctx=CPU)
    Y = mt.nd.array(rs.randint(0, 5, (64,)).astype(np.float32), ctx=CPU)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    ps = tr._params
    with mt.autograd.record():
        h = mt.nd.relu(mt.nd.dot(X, ps[0].data().T) + ps[1].data())
        out = mt.nd.dot(h, ps[2].data().T) + ps[3].data()
        loss = loss_fn(out, Y)
    loss.backward()
    tr.step(64)
    after = [p.data().asnumpy() for p in tr._params]
    assert any(not np.allclose(a, b) for a, b in zip(before, after))
    assert tr._fstate is fstate and tr.learning_rate == 0.01
