"""The port's Module, metric, io, callback and model (checkpoint) layers
against the JAX package's, on the CPU with the same numpy inputs.

- Twins of the 8 tests of ``tests/test_module.py``, each also held
  against the JAX Module where both can compute the same thing.
- MLP lockstep: the MNIST MLP at narrow width (784-32-16-10, B=16,
  8 batches, 2 epochs, no shuffle, SGD lr 0.1 momentum 0.9) ``fit`` in
  both packages from the same weights: each epoch's accuracy equal, its
  cross-entropy and the final parameters within rel 1e-4.
- Narrow ResNet: ``ResNetV1(BottleneckV1, [1,1,1,1], [16, 32, 64, 128,
  256], classes=10, thumbnail=True)`` traced with ``_to_symbol`` under a
  ``SoftmaxOutput``, two Module SGD steps (lr 0.1, momentum 0.9, wd
  1e-4) at B=4 x 3x32x32 against the JAX Module's on the same graph
  (its JSON), within
  ``tests/test_torch_vision.py``'s tolerances (outputs, parameters and
  moving stats: 1e-4 of each tensor's largest value).  At 4 images the
  JAX package's fp32 BatchNorm gradient is close to float64 (that file's
  caveat is for 2-image micro-batches), so no float64 run is needed.
  The JAX Module runs its fused ``kvstore='tpu'`` step on a one-device
  mesh: the same update as its eager updater (checked there to 1e-6),
  compiled once instead of once per parameter shape.
- Checkpoints: a ``Module.save_checkpoint`` of each package loads in the
  other through ``Module.load`` with equal outputs; ``HybridBlock.
  export`` of each loads as the other's ``SymbolBlock`` with equal
  outputs; ``load_checkpoint`` falls back past a corrupt newest epoch
  in both.
- Metrics and iterators (twins of ``tests/test_metric_io.py``): each
  metric's value, and NDArrayIter (pad, discard, roll_over), ResizeIter,
  CSVIter, PrefetchingIter and MNISTIter batches: bitwise on the
  integer and shape logic, fp32 on values.
- ``Optimizer(sym=)`` reads ``lr_mult``/``wd_mult``; ``fixed_param_names``
  freezes a parameter; what is not ported raises.
"""
import functools
import gzip
import logging
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jpar  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
PKGS = [pytest.param(mx, id="jax"), pytest.param(mt, id="port")]
TOL = 1e-4
RESNET = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def _ctx(M):
    return mx.cpu() if M is mx else CPU


def _arr(M, a):
    return M.nd.array(a) if M is mx else M.nd.array(a, ctx=CPU)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-6))


def _mlp(S, hidden=(32,), classes=4):
    net = S.Variable("data")
    for i, h in enumerate(hidden):
        net = S.FullyConnected(net, num_hidden=h, name=f"fc{i + 1}")
        net = S.Activation(net, act_type="relu", name=f"relu{i + 1}")
    net = S.FullyConnected(net, num_hidden=classes,
                           name=f"fc{len(hidden) + 1}")
    return S.SoftmaxOutput(net, S.Variable("softmax_label"),
                           name="softmax")


def _toy(n=400, dim=20, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, dim).astype("float32") * 3
    labels = rs.randint(0, classes, n)
    data = centers[labels] + rs.randn(n, dim).astype("float32")
    return data.astype("float32"), labels.astype("float32")


def _weights(sym, shapes, seed=1, scale=0.1):
    """Seeded numpy values for every parameter of ``sym``."""
    rs = np.random.RandomState(seed)
    arg_shapes = dict(zip(sym.list_arguments(),
                          sym.infer_shape(**shapes)[0]))
    return {k: (rs.randn(*s) * scale).astype(np.float32)
            for k, s in arg_shapes.items() if k not in shapes}


def _module(M, sym, shapes, weights, **kw):
    mod = M.mod.Module(sym, context=_ctx(M), **kw)
    mod.bind(data_shapes=[("data", shapes["data"])],
             label_shapes=[("softmax_label", shapes["softmax_label"])])
    mod.init_params(arg_params={k: _arr(M, v) for k, v in weights.items()})
    return mod


# ------------------------------------------------ twins of test_module.py
def test_module_bind_shapes():
    for M in (mx, mt):
        mod = M.mod.Module(_mlp(M.sym), context=_ctx(M))
        mod.bind(data_shapes=[("data", (8, 20))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params()
        assert mod.binded and mod.params_initialized
        arg, aux = mod.get_params()
        assert arg["fc1_weight"].shape == (32, 20) and aux == {}
        assert mod.output_shapes == [("softmax_output", (8, 4))]


def test_module_fit_converges():
    data, labels = _toy()
    mod = mt.mod.Module(_mlp(mt.sym), context=CPU)
    mt.random.seed(0)
    mod.fit(mt.io.NDArrayIter(data, labels, batch_size=40, shuffle=True,
                              seed=0),
            eval_data=mt.io.NDArrayIter(data, labels, batch_size=40),
            optimizer="adam", kvstore="local",
            optimizer_params={"learning_rate": 0.01},
            initializer=mt.init.Xavier(), num_epoch=4)
    score = mod.score(mt.io.NDArrayIter(data, labels, batch_size=40), "acc")
    assert score[0][1] > 0.9, score


def test_mlp_fit_lockstep_with_jax():
    """The MNIST MLP at narrow width, fit in both packages from the same
    weights on the same batches."""
    rs = np.random.RandomState(2)
    x = rs.rand(128, 784).astype(np.float32)
    y = rs.randint(0, 10, 128).astype(np.float32)
    shapes = dict(data=(16, 784), softmax_label=(16,))
    weights = _weights(_mlp(mt.sym, (32, 16), 10), shapes, scale=0.05)
    res = {}
    for M in (mx, mt):
        epochs = []

        def at_epoch_end(param, epochs=epochs):
            if param.nbatch == 7:
                epochs.append(param.eval_metric.get_name_value())

        mod = M.mod.Module(_mlp(M.sym, (32, 16), 10), context=_ctx(M))
        mod.fit(M.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: _arr(M, v) for k, v in weights.items()},
                eval_metric=["acc", "ce"], batch_end_callback=at_epoch_end)
        arg, _ = mod.get_params()
        res[M] = epochs, {k: v.asnumpy() for k, v in arg.items()}
    (jep, jarg), (tep, targ) = res[mx], res[mt]
    assert len(tep) == len(jep) == 2
    for (tacc, tce), (jacc, jce) in zip(tep, jep):
        assert tacc == jacc
        assert tce[0] == jce[0]
        np.testing.assert_allclose(tce[1], jce[1], rtol=TOL)
    for k in jarg:
        _close(targ[k], jarg[k])


def test_module_predict_and_outputs():
    data, labels = _toy(n=60)
    shapes = dict(data=(20, 20), softmax_label=(20,))
    weights = _weights(_mlp(mt.sym), shapes)
    outs = []
    for M in (mx, mt):
        it = M.io.NDArrayIter(data[:50], labels[:50], batch_size=20)
        mod = _module(M, _mlp(M.sym), shapes, weights)
        out = mod.predict(it)
        assert out.shape == (50, 4)
        outs.append(out.asnumpy())
        per_batch = mod.predict(it, merge_batches=False)
        assert [b[0].shape[0] for b in per_batch] == [20, 20, 10]
    np.testing.assert_allclose(outs[1].sum(-1), np.ones(50), rtol=1e-5)
    _close(outs[1], outs[0], 1e-5)
    # the last Module (the port's): iter_predict and input gradients
    assert [n for _, n, _ in mod.iter_predict(it)] == [0, 1, 2]
    grads = M.mod.Module(_mlp(M.sym), context=CPU)
    grads.bind(data_shapes=[("data", (20, 20))],
               label_shapes=[("softmax_label", (20,))],
               inputs_need_grad=True)
    grads.init_params(arg_params={k: _arr(M, v) for k, v in
                                  weights.items()})
    it.reset()
    grads.forward_backward(it.next())
    (g,) = grads.get_input_grads()
    assert g.shape == (20, 20) and np.abs(g.asnumpy()).sum() > 0


def test_callbacks_checkpoint_and_log(tmp_path, caplog):
    data, labels = _toy(n=40)
    prefix = str(tmp_path / "cb")
    mod = mt.mod.Module(_mlp(mt.sym), context=CPU)
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(data, labels, batch_size=20),
                num_epoch=2, initializer=mt.init.Xavier(),
                epoch_end_callback=mt.callback.do_checkpoint(prefix, 2),
                batch_end_callback=[mt.callback.log_train_metric(1),
                                    mt.callback.ProgressBar(2)])
    assert sorted(os.listdir(tmp_path)) == [
        "cb-0002.params", "cb-0002.params.crc32", "cb-symbol.json"]
    assert "Train-accuracy" in caplog.text and "[=" in caplog.text
    mt.callback.module_checkpoint(mod, prefix, 1, True)(2)
    assert os.path.exists(prefix + "-0003.states")


def test_module_checkpoint_roundtrip(tmp_path):
    data, labels = _toy(n=80)
    it = mt.io.NDArrayIter(data, labels, batch_size=16)
    net = _mlp(mt.sym)
    mod = mt.mod.Module(net, context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mt.init.Xavier())
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 3)
    loaded_sym, arg, aux = mt.load_checkpoint(prefix, 3, ctx=CPU)
    assert loaded_sym.list_arguments() == net.list_arguments()
    orig, _ = mod.get_params()
    np.testing.assert_array_equal(arg["fc1_weight"].asnumpy(),
                                  orig["fc1_weight"].asnumpy())
    mod2 = mt.mod.Module(loaded_sym, context=CPU)
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.init_params(arg_params=arg, aux_params=aux, force_init=True)
    batch = it.next()
    mod.forward(batch, is_train=False)
    mod2.forward(batch, is_train=False)
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                  mod2.get_outputs()[0].asnumpy())


def test_module_score_and_speedometer(caplog):
    data, labels = _toy(n=100)
    shapes = dict(data=(25, 20), softmax_label=(25,))
    weights = _weights(_mlp(mt.sym), shapes)
    scores = []
    for M in (mx, mt):
        it = M.io.NDArrayIter(data, labels, batch_size=25)
        mod = M.mod.Module(_mlp(M.sym), context=_ctx(M))
        cb = M.callback.Speedometer(25, frequent=2)
        with caplog.at_level(logging.INFO):
            mod.fit(it, num_epoch=1, batch_end_callback=cb,
                    arg_params={k: _arr(M, v) for k, v in weights.items()})
        scores.append(mod.score(it, ["acc", "ce"]))
    assert "Speed:" in caplog.text
    assert [n for n, _ in scores[1]] == ["accuracy", "cross-entropy"]
    assert scores[1][0] == scores[0][0]
    np.testing.assert_allclose(scores[1][1][1], scores[0][1][1], rtol=TOL)


def test_fixed_params():
    data, labels = _toy(n=40)
    for M in (mx, mt):
        it = M.io.NDArrayIter(data, labels, batch_size=20)
        mod = M.mod.Module(_mlp(M.sym), context=_ctx(M),
                           fixed_param_names=["fc1_weight"])
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params(initializer=M.init.Xavier())
        w_before = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
        b_before = mod.get_params()[0]["fc1_bias"].asnumpy().copy()
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        mod.forward_backward(it.next())
        mod.update()
        params = mod.get_params()[0]
        np.testing.assert_array_equal(params["fc1_weight"].asnumpy(),
                                      w_before)
        assert not np.array_equal(params["fc1_bias"].asnumpy(), b_before)


def test_module_load_applies_params(tmp_path):
    data, labels = _toy(n=40)
    it = mt.io.NDArrayIter(data, labels, batch_size=20)
    mod = mt.mod.Module(_mlp(mt.sym), context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    batch = it.next()
    mod.forward_backward(batch)
    mod.update()
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    loaded = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                context=CPU)
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.forward(batch, is_train=False)
    loaded.forward(batch, is_train=False)
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                  loaded.get_outputs()[0].asnumpy())
    # the momentum comes back too: one more step gives the same weights
    loaded.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    for m in (mod, loaded):
        m.forward_backward(batch)
        m.update()
    np.testing.assert_array_equal(
        mod.get_params()[0]["fc1_weight"].asnumpy(),
        loaded.get_params()[0]["fc1_weight"].asnumpy())


# ------------------------------------------------ narrow ResNet
@pytest.fixture(scope="module")
def resnet():
    """The port's traced narrow ResNet, numpy weights (He-scaled, as
    test_torch_vision.py makes them), the batch, and the JAX Module's
    outputs of two SGD steps and its values after them.  The JAX Module
    binds the port's graph through its JSON (the two packages trace the
    same string, test_torch_symbol.py), so no JAX net is built."""
    rs = np.random.RandomState(0)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    tnet = tres.ResNetV1(tres.BottleneckV1, *RESNET, classes=10,
                         thumbnail=True)
    tnet.initialize(mt.init.Zero(), ctx=CPU)
    tnet.infer_shape(torch.from_numpy(x))
    sym = mt.sym.SoftmaxOutput(tnet(mt.sym.Variable("data")),
                               name="softmax")
    arrays = {}
    for k, p in tnet.collect_params().items():
        n = rs.normal(0, 1, p.shape).astype(np.float32)
        if k.endswith("_weight"):
            arrays[k] = n * np.float32(np.sqrt(2.0 / np.prod(p.shape[1:])))
        elif k.endswith("_gamma"):
            arrays[k] = 1 + 0.1 * n
        elif k.endswith("_running_var"):
            arrays[k] = (0.5 + rs.rand(*p.shape)).astype(np.float32)
        else:
            arrays[k] = 0.1 * n
    with jpar.use_mesh(jpar.make_mesh(devices=jax.devices("cpu")[:1])):
        ref = _resnet_steps(mx, mx.sym.load_json(sym.tojson()), arrays,
                            x, y)
    return sym, arrays, x, y, ref


def _resnet_steps(M, sym, arrays, x, y):
    """Two forward_backward + update steps: each step's outputs, then
    every parameter and moving stat."""
    args = set(sym.list_arguments())
    mod = M.mod.Module(sym, context=_ctx(M))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    vals = {k: _arr(M, v) for k, v in arrays.items()}
    arg = {k: v for k, v in vals.items() if k in args}
    aux = {k: v for k, v in vals.items() if k not in args}
    if M is mx:
        # the reference's own arrays set without one setitem program per
        # shape (init_params), as CPU compiles are the test's cost
        mod._exec.copy_params_from(arg, aux)
        mod.params_initialized = True
    else:
        mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(kvstore="tpu" if M is mx else "local",
                       optimizer="sgd", optimizer_params=RESNET_SGD)
    batch = M.io.DataBatch([_arr(M, x)], [_arr(M, y)])
    outs = []
    for _ in range(2):
        mod.forward_backward(batch)
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.update()
    if M is mx:
        mod._sync_mesh_params()     # the fused step's values, uncopied
    ex = mod._exec
    return outs, {k: v.asnumpy() for k, v in {**ex.arg_dict,
                                               **ex.aux_dict}.items()
                  if k in arrays}


def test_narrow_resnet_module_steps_match_jax(resnet):
    sym, arrays, x, y, (rout, rvals) = resnet
    gout, gvals = _resnet_steps(mt, sym, arrays, x, y)
    for g, r in zip(gout, rout):
        _close(g, r)
    assert sorted(gvals) == sorted(rvals) == sorted(arrays)
    for k in rvals:
        _close(gvals[k], rvals[k])
    # every parameter and moving stat moved
    moved = [k for k in arrays if not np.array_equal(gvals[k], arrays[k])]
    assert len(moved) == len(arrays)


# ------------------------------------------------ across packages
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_other_package(tmp_path, writer):
    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    data, labels = _toy(n=32)
    shapes = dict(data=(16, 20), softmax_label=(16,))
    net = src.sym.BatchNorm(_mlp(src.sym).get_internals()["fc2_output"],
                            name="bn", fix_gamma=False)
    net = src.sym.SoftmaxOutput(net, src.sym.Variable("softmax_label"),
                                name="softmax")
    mod = src.mod.Module(net, context=_ctx(src))
    mod.fit(src.io.NDArrayIter(data, labels, batch_size=16), num_epoch=1,
            arg_params={k: _arr(src, v)
                        for k, v in _weights(net, shapes).items()},
            aux_params={"bn_moving_mean": _arr(src, np.zeros(4, "f4")),
                        "bn_moving_var": _arr(src, np.ones(4, "f4"))},
            optimizer_params={"learning_rate": 0.1})
    prefix = str(tmp_path / "ck")
    mod.save_checkpoint(prefix, 2)
    assert os.path.exists(prefix + "-0002.params.crc32")
    kw = {"context": _ctx(dst)}
    loaded = dst.mod.Module.load(prefix, 2, **kw)
    loaded.bind(data_shapes=[("data", (16, 20))],
                label_shapes=[("softmax_label", (16,))],
                for_training=False)
    outs = []
    for M, m in ((src, mod), (dst, loaded)):
        m.forward(M.io.DataBatch([_arr(M, data[:16])],
                                 [_arr(M, labels[:16])]), is_train=False)
        outs.append(m.get_outputs()[0].asnumpy())
    _close(outs[1], outs[0], 1e-5)
    assert loaded.get_params()[1].keys() == {"bn_moving_mean",
                                             "bn_moving_var"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_loads_as_symbolblock_of_other(tmp_path, writer):
    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    rs = np.random.RandomState(4)
    x = rs.rand(2, 6).astype(np.float32)
    net = src.gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(src.gluon.nn.Dense(4, in_units=6),
                src.gluon.nn.BatchNorm(in_channels=4),
                src.gluon.nn.Activation("relu"),
                src.gluon.nn.Dense(5, in_units=4))
    if src is mx:
        net.initialize(mx.init.Xavier())
    else:
        net.initialize(mt.init.Xavier(), ctx=CPU)
    for k, p in net.collect_params().items():
        if k.endswith("running_mean"):
            p.set_data(_arr(src, rs.rand(4).astype(np.float32)))
    want = net(_arr(src, x)).asnumpy()
    prefix = str(tmp_path / "exp")
    out_sym = net.export(prefix, epoch=1)
    assert set(out_sym.list_auxiliary_states()) == {
        "net_batchnorm0_running_mean", "net_batchnorm0_running_var"}
    if dst is mx:
        loaded = mx.nd.load(prefix + "-0001.params")
        params = {k.split(":", 1)[1]: v for k, v in loaded.items()}
        block = mx.gluon.SymbolBlock(mx.sym.load(prefix + "-symbol.json"),
                                     mx.sym.var("data"), params=params)
    else:
        block = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                             ["data"],
                                             prefix + "-0001.params",
                                             ctx=CPU)
        assert block.collect_params()[
            "net_batchnorm0_running_mean"].grad_req == "null"
    got = block(_arr(dst, x)).asnumpy()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("M", PKGS)
def test_load_checkpoint_falls_back_past_corrupt_epoch(tmp_path, M):
    net = _mlp(M.sym)
    w = {"fc1_weight": _arr(M, np.ones((32, 20), "float32"))}
    prefix = str(tmp_path / "fb")
    for epoch in (1, 2):
        M.model.save_checkpoint(prefix, epoch, net, w, {})
    path = f"{prefix}-0002.params"
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\x00\x01\x02\x03")
    kw = {} if M is mx else {"ctx": CPU}
    with pytest.warns(RuntimeWarning, match="falling back"):
        _, arg, _, eff = M.model.load_checkpoint(prefix, 2,
                                                 return_epoch=True, **kw)
    assert eff == 1
    np.testing.assert_array_equal(arg["fc1_weight"].asnumpy(),
                                  np.ones((32, 20)))
    with pytest.raises(M.resilience.CheckpointCorruptError):
        M.model.load_checkpoint(prefix, 2, fallback=False, **kw)


# ------------------------------------------------ optimizer, what raises
def test_optimizer_reads_symbol_multipliers():
    for M in (mx, mt):
        data = M.sym.Variable("data")
        w = M.sym.Variable("fc_weight", lr_mult=0.5, wd_mult=2.0)
        with M.AttrScope(__lr_mult__="0.25"):
            net = M.sym.FullyConnected(data, w, num_hidden=3, name="fc")
        opt = M.optimizer.create("sgd", sym=net, learning_rate=0.2, wd=0.1,
                                 param_idx2name={0: "fc_weight",
                                                 1: "fc_bias"})
        assert opt.lr_mult == {"fc_weight": 0.5, "fc_bias": 0.25,
                               "fc": 0.25}
        assert opt.wd_mult == {"fc_weight": 2.0}
        assert opt._get_lr(0) == 0.2 * 0.5 and opt._get_lr(1) == 0.2 * 0.25
        assert opt._get_wd(0) == pytest.approx(0.1 * 2.0)


def test_not_ported_paths_raise(monkeypatch):
    mod = mt.mod.Module(_mlp(mt.sym), context=CPU)
    mod.bind(data_shapes=[("data", (4, 20))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    for kv in (None, "local", "device", "tpu", "dist_sync"):
        mod.init_optimizer(kvstore=kv, force_init=True)
    with monkeypatch.context() as mp:     # a store over two processes
        mp.setenv("MXTPU_NUM_WORKERS", "2")
        with pytest.raises(NotImplementedError, match="A9"):
            mod.init_optimizer(kvstore="dist_sync", force_init=True)
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    with pytest.raises(NotImplementedError, match="A11"):
        mod.init_optimizer(force_init=True)
    with pytest.raises(NotImplementedError, match="A11"):
        mod.fit(mt.io.NDArrayIter(np.zeros((4, 20), "f4"),
                                  np.zeros(4, "f4"), batch_size=4),
                num_epoch=1, checkpoint_prefix="x")
    with pytest.raises(NotImplementedError, match="A9"):
        mt.mod.Module(_mlp(mt.sym), context=[CPU, CPU])
    for make, item in ((mt.io.LibSVMIter, "A8"),
                       (mt.io.ImageRecordIter, "A10"),
                       (mt.io.DevicePrefetchIter, "A10")):
        with pytest.raises(NotImplementedError, match=item):
            make()


def test_feedforward_fit_predict_score(tmp_path):
    data, labels = _toy(n=200)
    mt.random.seed(3)
    model = mt.model.FeedForward(_mlp(mt.sym), ctx=CPU, num_epoch=3,
                                 optimizer="sgd", learning_rate=0.1,
                                 momentum=0.9, numpy_batch_size=40,
                                 initializer=mt.init.Xavier())
    model.fit(data, labels)
    assert model.score(data, labels) > 0.9
    assert model.predict(data[:50]).shape == (50, 4)
    model.save(str(tmp_path / "ff"))
    again = mt.model.FeedForward.load(str(tmp_path / "ff"), 3, ctx=CPU)
    np.testing.assert_array_equal(again.predict(data[:50]),
                                  model.predict(data[:50]))


# ------------------------------------------------ metrics
_PRED = np.array([[0.9, 0.05, 0.05], [0.2, 0.7, 0.1], [0.6, 0.3, 0.1],
                  [0.1, 0.2, 0.7]], "float32")
_LABEL = np.array([0, 1, 1, 2], "float32")


@pytest.mark.parametrize("name,kwargs,label,pred", [
    ("acc", {}, _LABEL, _PRED),
    ("top_k_accuracy", {"top_k": 2}, _LABEL, _PRED),
    ("f1", {}, np.array([0, 1, 1, 0], "f4"), _PRED[:, :2]),
    ("perplexity", {}, _LABEL, _PRED),
    ("perplexity", {"ignore_label": 1}, _LABEL, _PRED),
    ("mae", {}, _PRED[:, :1] + 0.3, _PRED[:, :1]),
    ("mse", {}, _PRED[:, :1] + 0.3, _PRED[:, :1]),
    ("rmse", {}, _PRED[:, :1] + 0.3, _PRED[:, :1]),
    ("ce", {}, _LABEL, _PRED),
    ("nll_loss", {}, _LABEL, _PRED),
    ("pearsonr", {}, _PRED[:, 0] * 2 + 0.1, _PRED[:, 0]),
    ("loss", {}, _LABEL, _PRED)])
def test_metric_matches_jax(name, kwargs, label, pred):
    got = []
    for M in (mx, mt):
        m = M.metric.create(name, **kwargs)
        for _ in range(2):
            m.update([_arr(M, label)], [_arr(M, pred)])
        got.append(m.get())
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-6)


def test_composite_and_custom_metric():
    out = []
    for M in (mx, mt):
        comp = M.metric.CompositeEvalMetric()
        comp.add("acc")
        comp.add(M.metric.np_metric(
            lambda lb, p: float(np.abs(lb - p.argmax(1)).mean()), "err"))
        comp.update([_arr(M, _LABEL)], [_arr(M, _PRED)])
        m = M.metric.create(["acc", "ce"])
        m.update([_arr(M, _LABEL)], [_arr(M, _PRED)])
        out.append((comp.get(), m.get_name_value()))
    assert out[1][0] == out[0][0]
    assert out[1][1][0] == out[0][1][0]
    np.testing.assert_allclose(out[1][1][1][1], out[0][1][1][1], rtol=1e-6)
    # a torch tensor counts as an array
    m = mt.metric.create("acc")
    m.update([torch.tensor(_LABEL)], [torch.tensor(_PRED)])
    assert m.get() == ("accuracy", 0.75)


# ------------------------------------------------ iterators
def _batches(it):
    return [([d.asnumpy() for d in b.data], [lb.asnumpy() for lb in b.label],
             b.pad) for b in it]


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for (gd, gl, gp), (rd, rl, rp) in zip(got, ref):
        assert gp == rp
        for g, r in zip(gd + gl, rd + rl):
            assert g.shape == r.shape and g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("handle,batch", [("pad", 3), ("discard", 4),
                                          ("roll_over", 4)])
def test_ndarray_iter_matches_jax(handle, batch):
    data = np.arange(40, dtype="float32").reshape(10, 4)
    labels = np.arange(10, dtype="float32")
    runs = []
    for M in (mx, mt):
        it = M.io.NDArrayIter(data, labels, batch_size=batch,
                              last_batch_handle=handle)
        first = _batches(it)
        it.reset()
        runs.append((first, _batches(it), it.provide_data,
                     it.provide_label))
    for g, r in zip(runs[1][:2], runs[0][:2]):
        _same_batches(g, r)
    for g, r in zip(runs[1][2] + runs[1][3], runs[0][2] + runs[0][3]):
        assert (g.name, g.shape) == (r.name, r.shape)
    port = mt.io.NDArrayIter(data, labels, batch_size=batch)
    assert all(b.data[0].context == CPU for b in port)


def test_ndarray_iter_seeded_shuffle_and_resume(tmp_path):
    """A seeded shuffle repeats; the position saved beside a checkpoint
    (model.save_data_state) resumes the stream at the next batch and
    every later epoch's shuffle."""
    data = np.arange(44, dtype="float32").reshape(22, 2)
    a = mt.io.NDArrayIter(data, None, batch_size=4, shuffle=True, seed=5)
    b = mt.io.NDArrayIter(data, None, batch_size=4, shuffle=True, seed=5)
    first = _batches(a)
    _same_batches(_batches(b), first)
    seen = np.concatenate([bt[0][0] for bt in first])[:22]
    assert not np.array_equal(seen, data)          # shuffled
    np.testing.assert_array_equal(np.sort(seen[:, 0]), data[:, 0])
    a.reset()
    a.next()
    prefix = str(tmp_path / "it")
    assert mt.model.save_data_state(prefix, 3, a) == prefix + "-0003.data"
    rest = _batches(a)
    a.reset()
    later = _batches(a)
    c = mt.io.NDArrayIter(data, None, batch_size=4, shuffle=True, seed=9)
    assert mt.model.load_data_state(prefix, 3, c, strict=True)
    c.reset()                    # the restored position survives it
    _same_batches(_batches(c), rest)
    c.reset()
    _same_batches(_batches(c), later)
    with pytest.warns(RuntimeWarning, match="epoch start"):
        assert not mt.model.load_data_state(prefix, 4, c)


def test_resize_csv_prefetching_iters_match_jax(tmp_path):
    f, lf = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(f, np.arange(15).reshape(5, 3), delimiter=",")
    np.savetxt(lf, np.arange(5), delimiter=",")
    data = np.random.RandomState(0).rand(10, 2).astype("float32")
    runs = []
    for M in (mx, mt):
        csv = M.io.CSVIter(data_csv=str(f), data_shape=(3,),
                           label_csv=str(lf), batch_size=2)
        resize = M.io.ResizeIter(M.io.NDArrayIter(data, None, batch_size=4),
                                 size=7)
        pf = M.io.PrefetchingIter(M.io.NDArrayIter(data, data[:, 0],
                                                   batch_size=5))
        got = [_batches(csv), _batches(resize), _batches(pf)]
        with pytest.raises(StopIteration):
            pf.next()                  # exhausted: must not hang
        pf.reset()
        got.append(_batches(pf))
        runs.append(got)
    for g, r in zip(runs[1], runs[0]):
        _same_batches(g, r)
    assert len(runs[1][1]) == 7 and runs[1][0][-1][2] == 1


def test_mnist_iter_reads_idx_files(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (10, 28, 28)).astype(np.uint8)
    lbls = rs.randint(0, 10, 10).astype(np.uint8)
    ipath, lpath = str(tmp_path / "img.gz"), str(tmp_path / "lbl")
    with gzip.open(ipath, "wb") as fh:
        fh.write(struct.pack(">IIII", 2051, 10, 28, 28) + imgs.tobytes())
    with open(lpath, "wb") as fh:
        fh.write(struct.pack(">II", 2049, 10) + lbls.tobytes())
    runs = []
    for M in (mx, mt):
        for flat in (False, True):
            it = M.io.MNISTIter(image=ipath, label=lpath, batch_size=5,
                                shuffle=False, flat=flat)
            runs.append(_batches(it))
    for g, r in zip(runs[2:], runs[:2]):
        _same_batches(g, r)
    np.testing.assert_array_equal(runs[2][0][0][0][0, 0],
                                  imgs[0].astype(np.float32) / 255)
    with pytest.raises(ValueError, match="magic"):
        mt.io.MNISTIter(image=lpath, label=lpath)


# ------------------------------------------------ kvstore='tpu' (twins of
# tests/test_mesh_frontend.py's one-device cases)
def _mesh_data(n=512, d=20, k=10, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, d).astype(np.float32)
    w = rs.rand(d, k).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.float32)


def _mesh_mlp(S):
    net = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=64)
    net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, name="fc2", num_hidden=10)
    return S.SoftmaxOutput(net, name="softmax")


@functools.lru_cache(maxsize=None)
def _mesh_weights(dim):
    """The initial weights of test_mesh_frontend.py's JAX Module
    (random.seed(0), Xavier uniform, avg, magnitude 3), as numpy."""
    mx.random.seed(0)
    mod = mx.mod.Module(_mesh_mlp(mx.sym), context=mx.cpu())
    mod.bind(data_shapes=[("data", (64, dim))],
             label_shapes=[("softmax_label", (64,))])
    mod.init_params(mx.initializer.Xavier(rnd_type="uniform",
                                          factor_type="avg", magnitude=3))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _mesh_fit(M, kvstore, x, y, optimizer="sgd", optimizer_params=None,
              num_epoch=3):
    """test_mesh_frontend.py's _fit, both packages from the weights its
    JAX Module draws (the packages' initializers draw differently):
    (accuracy, params, module).  The JAX Module's 'tpu' step runs on a
    one-device mesh."""
    it = M.io.NDArrayIter(x, y, batch_size=64, shuffle=False,
                          label_name="softmax_label")
    sym = _mesh_mlp(M.sym)
    weights = _mesh_weights(x.shape[1])
    mod = M.mod.Module(sym, context=_ctx(M))
    fit = dict(num_epoch=num_epoch, kvstore=kvstore, optimizer=optimizer,
               optimizer_params=optimizer_params
               or dict(learning_rate=0.5, momentum=0.9, wd=1e-4),
               arg_params={k: _arr(M, v) for k, v in weights.items()})
    if M is mx:
        with jpar.use_mesh(jpar.make_mesh(devices=jax.devices("cpu")[:1])):
            mod.fit(it, **fit)
    else:
        mod.fit(it, **fit)
    acc = dict(mod.score(it, "acc"))["accuracy"]
    arg, _ = mod.get_params()
    return acc, {n: v.asnumpy() for n, v in arg.items()}, mod


def test_module_fit_tpu_kvstore_matches_local():
    x, y = _mesh_data()
    acc_l, p_l, _ = _mesh_fit(mt, "local", x, y)
    acc_t, p_t, mod = _mesh_fit(mt, "tpu", x, y)
    acc_j, p_j, jmod = _mesh_fit(mx, "tpu", x, y)
    assert mod._mesh_step is not None and jmod._mesh_step is not None
    assert acc_t > 0.8
    assert abs(acc_l - acc_t) < 1e-6 and abs(acc_j - acc_t) < 1e-6
    for n in p_l:
        np.testing.assert_allclose(p_t[n], p_l[n], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(p_t[n], p_j[n], rtol=2e-4, atol=2e-5)
    # on the CPU the step runs op by op: nothing is captured
    assert mod._mesh_step.trace_counts == {}


def test_module_tpu_kvstore_adam_and_checkpoint(tmp_path):
    x, y = _mesh_data()
    opt = dict(optimizer="adam", optimizer_params=dict(learning_rate=0.01))
    acc, _, mod = _mesh_fit(mt, "tpu", x, y, **opt)
    assert acc > 0.8
    mod.save_checkpoint(str(tmp_path / "m"), 0, save_optimizer_states=True)
    it = mt.io.NDArrayIter(x, y, batch_size=64, label_name="softmax_label")
    mod2 = mt.mod.Module.load(str(tmp_path / "m"), 0, context=CPU)
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    acc2 = dict(mod2.score(it, "acc"))["accuracy"]
    assert abs(acc - acc2) < 1e-6
    # the JAX Module's fused-step checkpoint (params and Adam state)
    # resumes in the port's fused step: one more step agrees
    _, _, jmod = _mesh_fit(mx, "tpu", x, y, **opt)
    jmod.save_checkpoint(str(tmp_path / "j"), 0, save_optimizer_states=True)
    batch = (x[:64], y[:64])
    after = {}
    for M, prefix in ((mx, "j"), (mt, "j")):
        m = M.mod.Module.load(str(tmp_path / prefix), 0,
                              load_optimizer_states=True, context=_ctx(M))
        m.bind(data_shapes=[("data", (64, 20))],
               label_shapes=[("softmax_label", (64,))])
        if M is mx:
            with jpar.use_mesh(jpar.make_mesh(
                    devices=jax.devices("cpu")[:1])):
                m.init_optimizer(kvstore="tpu", **opt)
        else:
            m.init_optimizer(kvstore="tpu", **opt)
        m.forward_backward(M.io.DataBatch([_arr(M, batch[0])],
                                          [_arr(M, batch[1])]))
        m.update()
        after[M] = {n: v.asnumpy() for n, v in m.get_params()[0].items()}
    for n in after[mx]:
        _close(after[mt][n], after[mx][n], 1e-5)


def test_module_tpu_kvstore_rejects_exotic_optimizer():
    x, y = _mesh_data(n=64)
    for M in (mx, mt):
        with pytest.raises(ValueError, match="sgd/nag/adam"):
            _mesh_fit(M, "tpu", x, y, optimizer="rmsprop",
                      optimizer_params=dict(learning_rate=0.01))


def test_module_manual_loop_tpu_kvstore_updates_params():
    """forward/backward/update by hand under kvstore='tpu' updates
    (through the eager updater), and the fused step takes the values up
    afterwards."""
    x, y = _mesh_data(n=64)
    it = mt.io.NDArrayIter(x, y, batch_size=64, label_name="softmax_label")
    mod = mt.mod.Module(_mesh_mlp(mt.sym), context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params=dict(learning_rate=0.5))
    before = {n: v.asnumpy().copy() for n, v in mod.get_params()[0].items()}
    batch = next(iter(it))
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    after = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    assert any(not np.allclose(before[n], after[n]) for n in before)
    mod.forward_backward(batch)
    mod.update()
    after2 = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    assert any(not np.allclose(after[n], after2[n]) for n in after)
    # the fused step started from the manual update's values
    step = mod._mesh_step
    assert not mod._mesh_stale and mod._mesh_pending is False
    np.testing.assert_array_equal(step.params["fc1_weight"].numpy(),
                                  after2["fc1_weight"])


def test_narrow_resnet_module_tpu_kvstore_matches_jax(resnet):
    """The port's kvstore='tpu' step (SymbolTrainStep) on the narrow
    ResNet against the JAX Module's kvstore='tpu' step, at
    test_narrow_resnet_module_steps_match_jax's tolerances."""
    sym, arrays, x, y, (rout, rvals) = resnet
    args = set(sym.list_arguments())
    mod = mt.mod.Module(sym, context=CPU)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(
        arg_params={k: _arr(mt, v) for k, v in arrays.items() if k in args},
        aux_params={k: _arr(mt, v) for k, v in arrays.items()
                    if k not in args})
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params=RESNET_SGD)
    batch = mt.io.DataBatch([_arr(mt, x)], [_arr(mt, y)])
    for r in rout:
        mod.forward_backward(batch)
        _close(mod.get_outputs()[0].asnumpy(), r)
        mod.update()
    arg, aux = mod.get_params()
    got = {k: v.asnumpy() for k, v in {**arg, **aux}.items()}
    for k in rvals:
        _close(got[k], rvals[k])


# ------------------------------------------------ Queue C: C5
def test_iterator_skip_matches_jax():
    """C5: NDArrayIter.skip moves the cursor without building batches
    and disarms the resume shield; DataIter.skip pulls and drops."""
    data = np.arange(40, dtype="float32").reshape(20, 2)
    got = {}
    for M in (mx, mt):
        it = M.io.NDArrayIter(data, np.arange(20, dtype="float32"),
                              batch_size=4)
        it.skip(2)
        first = it.next()
        state = it.state_dict()
        it.next()
        it.load_state_dict(state)
        it.skip(1)                    # disarms the resume shield
        it.reset()                    # so this reset rewinds
        rewound = it.next()
        resized = M.io.ResizeIter(M.io.NDArrayIter(data, batch_size=4), 3)
        resized.skip(2)
        last = resized.next()
        got[M] = [first.data[0].asnumpy(), first.label[0].asnumpy(),
                  rewound.data[0].asnumpy(), last.data[0].asnumpy()]
        with pytest.raises(StopIteration):
            resized.skip(1)
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[mt][0][0], [16, 17])
