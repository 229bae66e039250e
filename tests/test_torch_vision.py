"""The port's ResNet training path against the JAX package's, on the CPU:
a narrow ResNet-v1 with bottleneck blocks,
``ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
classes=10, thumbnail=True)``, at B=4 x 3x32x32.

Weights are made from a numpy seed, set into the JAX net, and carried
into the port's by ``convert.load_gluon_params`` from the JAX net's
``collect_params()`` (names stripped of each net's own prefix).  Then:

- the forward in training mode (outputs and BatchNorm's new moving
  stats) and in eval mode;
- 3 ``ShardedTrainStep`` SGD steps (lr 0.1, momentum 0.9, wd 1e-4):
  the losses, and the parameters and moving stats after
  ``write_back()``;
- 3 steps of the ``autograd.record`` / ``backward`` / ``Trainer.step``
  loop with the same optimizer: the same things;
- ``grad_accum=2``: the same step, two micro-batches of 2, states
  threaded through them in order, against the JAX step run in float64
  (``jax.enable_x64``).  On its first micro-batch of 2 images the JAX
  package's fp32 BatchNorm gradient (its one-pass shifted variance) is
  up to 17% away from float64 while the port's is within 3e-6, so only
  the float64 run is a yardstick there;
- one bf16 ``compute_dtype`` step, against the fp32 step (within 1e-5
  of float64 at 4 images) and the JAX bf16 step (see the test).

The other vision families (AlexNet, VGG, SqueezeNet, DenseNet,
MobileNet, Inception3) and ResNet-18 through ``pretrained=True``: each
at B=1, ``classes=10``, in eval mode.  The port initializes the net and
saves a ``.params`` file, the JAX package installs it in a local store
(``model_store.import_model_file``, the sha1-tagged name) and loads it
with ``pretrained=True``, and so does the port from the same store;
parameter names and shapes are equal and the outputs within rel 1e-4.
Each family runs at its smallest published variant and input, except
DenseNet: ``densenet121``'s 58 layers of distinct widths cost the JAX
package ~25 s of per-shape compiles on the CPU, so the family's class
runs at two blocks of two layers, and densenet121 is held to the JAX
net by names alone.  ``get_model`` lists the reference's names, and the
store's layout, digest check, ``list_models`` and ``purge`` match.

fp32 tolerances: rel 1e-4 on losses; 1e-4 of each tensor's largest
|value| on outputs, parameters and moving stats (3 steps of sums in
another order).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jpar  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.convert import load_gluon_params  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
SHAPE = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
B, CLASSES, STEPS = 4, 10, 3
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
LOSS_TOL = 1e-4
TOL = 1e-4


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()),
                                              1e-6))


def _port_net():
    return tres.ResNetV1(tres.BottleneckV1, *SHAPE, classes=CLASSES,
                         thumbnail=True)


def _strip(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items()}


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    x = rs.rand(B, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, CLASSES, (B,)).astype(np.int32)
    # the shapes from one forward of the port's net, the values from
    # numpy: He-scaled weights, gamma near 1, small beta and stats
    probe = _port_net()
    probe.initialize(mt.init.Zero(), ctx=CPU)
    probe.infer_shape(torch.from_numpy(x))
    arrays = {}
    for k, p in _strip(probe.collect_params(), probe.prefix).items():
        n = rs.normal(0, 1, p.shape).astype(np.float32)
        if k.endswith("_weight"):
            arrays[k] = n * np.float32(np.sqrt(2.0 / np.prod(p.shape[1:])))
        elif k.endswith("_gamma"):
            arrays[k] = 1 + 0.1 * n
        elif k.endswith("_running_var"):
            arrays[k] = (0.5 + rs.rand(*p.shape)).astype(np.float32)
        else:
            arrays[k] = 0.1 * n
    return x, y, arrays


def _jax_net(arrays, hybridize=False):
    net = jres.ResNetV1(jres.BottleneckV1, *SHAPE, classes=CLASSES,
                        thumbnail=True)
    for k, p in _strip(net.collect_params(), net.prefix).items():
        p.set_data(mx.nd.array(arrays[k]))
    if hybridize:
        net.hybridize()
    return net


def _values(net):
    return _strip({k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}, net.prefix)


def _port_from(jnet):
    """The port's net, carried over from the JAX net's parameters."""
    net = _port_net()
    load_gluon_params(net, {k: p.data().asnumpy()
                            for k, p in jnet.collect_params().items()},
                      ctx=CPU)
    return net


def _jax_steps(arrays, x, y, steps=STEPS, x64=False, **kw):
    """The JAX ShardedTrainStep's losses and, after each step's
    write_back, the values (a list, one dict a step).  ``x64`` runs it
    in float64 (``jax.enable_x64``): the exact step the fp32 ones
    approximate."""
    dt = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        jnet = _jax_net({k: v.astype(dt) for k, v in arrays.items()})
        step = jpar.ShardedTrainStep(
            jpar.PureBlock(jnet), "sgd", SGD,
            mesh=jpar.make_mesh(devices=jax.devices("cpu")[:1]), **kw)
        losses, values = [], []
        for _ in range(steps):
            losses.append(float(step(jnp.asarray(x, dt), jnp.asarray(y))))
            step.write_back()
            values.append(_values(jnet))
    return losses, values


@pytest.fixture(scope="module")
def jax_ref(data):
    """Every JAX result the tests compare with, computed once."""
    x, y, arrays = data
    out = {}
    mx.random.seed(0)       # the JAX package's root key, made eagerly
    jnet = _jax_net(arrays)
    pure = jpar.PureBlock(jnet)
    apply = jax.jit(lambda p, s, xb, rng, training: pure.apply(
        p, s, [xb], rng, training), static_argnums=4)
    for training in (True, False):
        outs, states = apply(pure.params(), pure.states(), jnp.asarray(x),
                             jax.random.PRNGKey(0), training)
        out[training] = (np.asarray(outs[0]),
                         {k[len(jnet.prefix):]: np.asarray(v)
                          for k, v in states.items()})
    out["step"] = _jax_steps(arrays, x, y)
    out["accum"] = _jax_steps(arrays, x, y, x64=True, grad_accum=2)
    out["bf16"] = _jax_steps(arrays, x, y, steps=1,
                             compute_dtype=jnp.bfloat16)
    # the imperative loop, on the hybridized net (one compile)
    jnet = _jax_net(arrays, hybridize=True)
    trainer = mx.gluon.Trainer(jnet.collect_params(), "sgd", SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with mx.autograd.record():
            loss = loss_fn(jnet(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.mean().asscalar()))
    out["trainer"] = (losses, _values(jnet))
    return out


def _check_values(got, want):
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k])


def test_load_gluon_params_carries_every_parameter(data):
    x, _, arrays = data
    jnet = _jax_net(arrays)
    net = _port_from(jnet)
    _check_values(_values(net), arrays)
    assert all(p.device.type == "cpu" for p in net.parameters())
    short = {k: v for k, v in arrays.items() if "running_var" not in k}
    with pytest.raises(ValueError, match="lack"):
        load_gluon_params(_port_net(), short, ctx=CPU)
    bad = dict(arrays)
    key = next(k for k in bad if k.endswith("_weight"))
    bad[key] = bad[key][:1]
    with pytest.raises(ValueError, match="shape"):
        load_gluon_params(_port_from(jnet), bad, ctx=CPU)


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(data, jax_ref, training):
    x, _, arrays = data
    net = _port_from(_jax_net(arrays))
    want_out, want_states = jax_ref[training]
    if training:
        net.train()                     # torch tensors: torch's modes
        out = net(torch.from_numpy(x)).detach().numpy()
        states = {k: v for k, v in _values(net).items()
                  if "running" in k}
        assert list(states) == list(want_states)
        for k in want_states:
            _close(states[k], want_states[k])
    else:                               # NDArrays: autograd's modes
        out = net(mt.nd.array(x, ctx=CPU)).asnumpy()
        _check_values({k: v for k, v in _values(net).items()
                       if "running" in k},
                      {k: v for k, v in arrays.items() if "running" in k})
    _close(out, want_out)


def _port_steps(arrays, x, y, steps=STEPS, **kw):
    net = _port_from(_jax_net(arrays))
    step = mt.parallel.ShardedTrainStep(net, "sgd", SGD, **kw)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(steps)]
    before = _values(net)
    step.write_back()
    return losses, _values(net), before


@pytest.mark.parametrize("mode", ["step", "accum"])
def test_sharded_train_step_matches_jax(data, jax_ref, mode):
    x, y, arrays = data
    kw = {"grad_accum": 2} if mode == "accum" else {}
    losses, values, before = _port_steps(arrays, x, y, **kw)
    want_losses, want = jax_ref[mode]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL)
    assert losses[-1] < losses[0]
    _check_values(values, want[-1])
    # the step threads its own states: the live ones move at write_back
    for k in values:
        if "running" in k:
            np.testing.assert_array_equal(before[k], arrays[k])


def _update_err(values, exact, arrays, keys):
    """|update - exact update| over |exact update|, over ``keys``."""
    def flat(v):
        return np.concatenate([(v[k] - arrays[k]).ravel() for k in keys])
    d = flat(exact)
    return np.linalg.norm(flat(values) - d) / np.linalg.norm(d)


def test_bf16_step_matches_jax(data, jax_ref):
    """bf16 rounds each activation at 2^-8, and one step from fresh
    weights moves some parameters by sums that cancel, so neither
    package's bf16 update is near the exact (fp32) one parameter by
    parameter.  The port's must be no worse an approximation of it than
    the JAX step's: within 1.25x its distance over all parameters and
    2x parameter by parameter; the loss within 1e-2 rel of the exact
    one; the moving stats within 2e-2."""
    x, y, arrays = data
    losses, values, _ = _port_steps(arrays, x, y, steps=1,
                                    compute_dtype=torch.bfloat16)
    exact_losses, exact = jax_ref["step"][0][:1], jax_ref["step"][1][0]
    jax_losses, (jvals,) = jax_ref["bf16"]
    np.testing.assert_allclose(losses, exact_losses, rtol=1e-2)
    assert all(v.dtype == np.float32 for v in values.values())
    trainable = [k for k in exact if "running" not in k]
    assert _update_err(values, exact, arrays, trainable) <= \
        1.25 * _update_err(jvals, exact, arrays, trainable)
    for k in trainable:
        assert _update_err(values, exact, arrays, [k]) <= \
            2 * _update_err(jvals, exact, arrays, [k]), k
    for k in exact:
        if "running" in k:
            _close(values[k], exact[k], 2e-2)


def test_trainer_loop_matches_jax(data, jax_ref):
    x, y, arrays = data
    net = _port_from(_jax_net(arrays))
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", SGD)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mt.nd.array(x, ctx=CPU)
    ys = mt.nd.array(y, ctx=CPU)
    losses = []
    for _ in range(STEPS):
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.mean().asscalar()))
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert np.any(p.grad().asnumpy()), p.name
    want_losses, want = jax_ref["trainer"]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL)
    _check_values(_values(net), want)


def test_trainer_updater_route_and_states(data, tmp_path, monkeypatch):
    """multi_precision SGD takes the per-parameter Updater route; a
    stale parameter raises unless ignored; states round-trip."""
    x, y, arrays = data
    net = _port_from(_jax_net(arrays))
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(SGD, multi_precision=True))
    with mt.autograd.record():
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mt.nd.array(x, ctx=CPU)), mt.nd.array(y, ctx=CPU))
    loss.backward()
    trainer.step(B)
    assert trainer._fused is False and len(trainer._updater.states) > 0
    path = str(tmp_path / "trainer.states")
    trainer.save_states(path)
    trainer.load_states(path)
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")   # two processes
    monkeypatch.delenv("MXTPU_COORD_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="no MXTPU_COORD_ADDR"):
        mt.gluon.Trainer(net.collect_params(), "sgd",
                         kvstore="dist_sync").step(B)
    monkeypatch.delenv("MXTPU_NUM_WORKERS")
    # dynamic loss scaling is ported: it turns the guard to skip
    monkeypatch.setenv("MXTPU_LOSS_SCALE_DYNAMIC", "1")
    scaled = mt.gluon.Trainer(net.collect_params(), "sgd")
    assert scaled.guard.policy == "skip" and scaled.loss_scale == 1.0


# ------------------------------------------------------------ the families
FAMILIES = {          # variant -> (input side, constructor kwargs)
    "alexnet": (64, {}),
    "vgg11": (32, {}),
    "squeezenet1_1": (48, {}),
    "densenet": (32, dict(num_init_features=16, growth_rate=8,
                          block_config=[2, 2])),
    "mobilenet0_25": (32, {}),
    "inception_v3": (75, {}),
    "resnet18_v1": (16, dict(thumbnail=True)),
}


STORE_NAMES = {"squeezenet1_1": "squeezenet1.1"}   # the reference's


def _family(P, name, pretrained=False, root=None):
    V = P.gluon.model_zoo.vision
    kw = dict(FAMILIES[name][1], classes=10)
    if name == "densenet":
        net = V.DenseNet(**kw)
        if pretrained:
            V.others._pretrained(net, True, "densenet", root=root,
                                 **({} if P is mx else {"ctx": CPU}))
        return net
    extra = {"pretrained": True, "root": root} if pretrained else {}
    if pretrained and P is mt:
        extra["ctx"] = CPU
    return V.get_model(name, **kw, **extra)


@pytest.fixture
def quick_jax_compiles():
    """XLA's optimizations off while the test runs: the JAX side's
    per-shape compiles of a one-off forward are most of these tests'
    time on the CPU (about a third less without them)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_vision_family_through_the_store_matches_jax(name, tmp_path,
                                                     quick_jax_compiles):
    side = FAMILIES[name][0]
    x = np.random.RandomState(3).rand(1, 3, side, side).astype(np.float32)
    made = _family(mt, name)
    made.initialize(mt.init.Xavier(), ctx=CPU)
    made(mt.nd.array(x, ctx=CPU))                # settle deferred shapes
    src = str(tmp_path / "net.params")
    made.save_parameters(src)
    root = str(tmp_path / "models")
    stored = STORE_NAMES.get(name, name)
    path = mx.gluon.model_zoo.model_store.import_model_file(src, stored,
                                                            root=root)
    assert mt.gluon.model_zoo.model_store.get_model_file(
        stored, root=root) == path
    jnet = _family(mx, name, pretrained=True, root=root)
    pnet = _family(mt, name, pretrained=True, root=root)
    got = _strip_all_shapes(pnet)
    assert got == _strip_all_shapes(jnet)
    want = jnet(mx.nd.array(x)).asnumpy()
    out = pnet(mt.nd.array(x, ctx=CPU)).asnumpy()
    assert out.shape == (1, 10)
    _close(out, want)


def _strip_all_shapes(net):
    return [(k[len(net.prefix):], tuple(p.shape))
            for k, p in net.collect_params().items()]


def test_get_model_names_and_the_store_match_jax(tmp_path):
    tv = mt.gluon.model_zoo.vision
    jv = mx.gluon.model_zoo.vision
    assert sorted(tv._models) == sorted(jv._models)
    assert len(tv._models) == 32
    with pytest.raises(ValueError, match="unknown model"):
        tv.get_model("resnet19_v1")
    # the reference's names of a family it holds by names only here
    t121, j121 = tv.densenet121(), jv.densenet121()
    assert [k[len(t121.prefix):] for k in t121.collect_params()] == \
        [k[len(j121.prefix):] for k in j121.collect_params()]
    stores = (mt.gluon.model_zoo.model_store,
              mx.gluon.model_zoo.model_store)
    src = tmp_path / "w.params"
    src.write_bytes(b"weights")
    root = str(tmp_path / "store")
    for ms in stores:
        with pytest.raises(FileNotFoundError):
            ms.get_model_file("alexnet", root=root)
    tagged = stores[0].import_model_file(str(src), "alexnet", root=root)
    assert os.path.basename(tagged) == os.path.basename(
        stores[1].import_model_file(str(src), "alexnet", root=root))
    (tmp_path / "store" / "vgg11.params").write_bytes(b"plain")
    for ms in stores:
        assert ms.list_models(root=root) == ["alexnet", "vgg11"]
        assert ms.get_model_file("alexnet", root=root) == tagged
    with open(tagged, "ab") as f:                  # the digest breaks
        f.write(b"!")
    for ms in stores:
        with pytest.raises(OSError, match="checksum"):
            ms.get_model_file("alexnet", root=root)
    stores[0].purge(root=root)
    for ms in stores:
        assert ms.list_models(root=root) == []
    monkey_home = str(tmp_path / "home")
    os.environ["MXTPU_HOME"] = monkey_home
    try:
        assert stores[0]._default_root() == stores[1]._default_root() == \
            os.path.join(monkey_home, "models")
    finally:
        del os.environ["MXTPU_HOME"]
