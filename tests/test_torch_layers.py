"""The port's Gluon layers and model classes (incubator_mxnet_tpu_torch)
against the JAX package's: constructor signatures and behaviour.

Signatures: each ported class takes the reference class's parameters as
an ordered prefix, with the same names and defaults, and after them only
keyword-only extras (``device``).  Behaviour, on the CPU with the same
numpy inputs and weights in both packages: ``Dense`` with an activation
given positionally, ``flatten=True`` on a 3-D input, deferred
``in_units=0`` and ``in_channels=0`` (the initializer recorded before the
first forward, and the JAX layer's output on the same weights),
``LayerNorm`` over another axis, ``Dropout(axes=)`` sharing its mask,
and per-parameter initializers.  Tolerance: fp32, 1e-5 abs and rel (one
matrix product or one normalization in another order).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu.gluon import nn as jnn  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtr  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo import transformer as ttr  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PAIRS = {
    "Dense": (tnn.Dense, jnn.Dense),
    "LayerNorm": (tnn.LayerNorm, jnn.LayerNorm),
    "Dropout": (tnn.Dropout, jnn.Dropout),
    "Embedding": (tnn.Embedding, jnn.Embedding),
    "CausalSelfAttention": (ttr.CausalSelfAttention,
                            jtr.CausalSelfAttention),
    "TransformerBlock": (ttr.TransformerBlock, jtr.TransformerBlock),
    "TransformerLM": (ttr.TransformerLM, jtr.TransformerLM),
}


def _params(cls):
    return [p for p in inspect.signature(cls.__init__).parameters.values()
            if p.name != "self"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_has_the_reference_parameters_in_order(name):
    port, ref = PAIRS[name]
    want = [p for p in _params(ref)
            if p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)]
    got = _params(port)
    assert [(p.name, p.default) for p in got[:len(want)]] == \
        [(p.name, p.default) for p in want]
    assert all(p.kind is p.POSITIONAL_OR_KEYWORD for p in got[:len(want)])
    extras = got[len(want):]
    assert all(p.kind is p.KEYWORD_ONLY for p in extras), extras
    assert {p.name for p in extras} <= {"device"}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).normal(0, 1, shape) \
        .astype(np.float32)


def _jax_dense(units, x, **kw):
    """The JAX layer initialized (Xavier) and run on x: (out, weight,
    bias) as numpy."""
    net = jnn.Dense(units, **kw)
    net.initialize(mx.init.Xavier())
    out = net(mx.nd.array(x)).asnumpy()
    return out, net.weight.data().asnumpy(), net.bias.data().asnumpy()


def _load(layer, **arrays):
    with torch.no_grad():
        for name, a in arrays.items():
            getattr(layer, name).copy_(torch.from_numpy(np.array(a)))
    return layer


def test_dense_binds_a_positional_activation():
    x = _x(4, 8)
    ref, w, b = _jax_dense(64, x, activation="relu", in_units=8)
    layer = _load(tnn.Dense(64, "relu", in_units=8, device="cpu"),
                  weight=w, bias=b)
    got = layer(torch.from_numpy(x)).detach().numpy()
    assert got.min() >= 0.0 and (got > 0).any()
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match="activation"):
        tnn.Dense(64, "gelu", device="cpu")


@pytest.mark.parametrize("act", ["sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_dense_activations_match_jax(act):
    x = _x(3, 5, seed=1)
    ref, w, b = _jax_dense(7, x, activation=act, in_units=5)
    layer = _load(tnn.Dense(7, act, in_units=5, device="cpu"),
                  weight=w, bias=b)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("flatten", [True, False])
def test_dense_flatten_on_a_3d_input(flatten):
    x = _x(2, 3, 4, seed=2)
    in_units = 12 if flatten else 4
    ref, w, b = _jax_dense(5, x, flatten=flatten, in_units=in_units)
    layer = _load(tnn.Dense(5, flatten=flatten, in_units=in_units,
                            device="cpu"), weight=w, bias=b)
    got = layer(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ((2, 5) if flatten else (2, 3, 5)) == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_dense_deferred_in_units_matches_jax():
    x = _x(2, 3, 4, seed=3)
    ref, w, b = _jax_dense(6, x)          # in_units=0: deferred in JAX too
    layer = tnn.Dense(6, device="cpu")
    assert isinstance(layer.weight, torch.nn.parameter.UninitializedParameter)
    # the initializer is recorded, and applied at the first forward
    mt.initializer.initialize(layer, mt.initializer.One())
    first = layer(torch.from_numpy(x))
    assert tuple(layer.weight.shape) == w.shape == (6, 12)
    assert bool((layer.weight == 1).all()) and bool((layer.bias == 0).all())
    np.testing.assert_allclose(first.detach().numpy(),
                               np.repeat(x.reshape(2, 12).sum(1,
                                         keepdims=True), 6, 1), **TOL)
    _load(layer, weight=w, bias=b)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               ref, **TOL)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layernorm_axis_and_deferred_channels_match_jax(axis):
    x = _x(2, 5, 6, seed=4)
    ref_net = jnn.LayerNorm(axis=axis)
    ref_net.initialize()
    c = x.shape[axis]
    gamma, beta = _x(c, seed=5), _x(c, seed=6)
    ref_net(mx.nd.array(x))                   # finishes the deferred init
    ref_net.gamma.set_data(mx.nd.array(gamma))
    ref_net.beta.set_data(mx.nd.array(beta))
    ref = ref_net(mx.nd.array(x)).asnumpy()
    layer = tnn.LayerNorm(axis=axis, device="cpu")    # in_channels=0
    mt.initializer.initialize(layer, mt.initializer.Xavier())
    layer(torch.from_numpy(x))
    assert bool((layer.gamma == 1).all()) and bool((layer.beta == 0).all())
    _load(layer, gamma=gamma, beta=beta)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               ref, **TOL)


def test_layernorm_center_and_scale_set_what_is_learned():
    layer = tnn.LayerNorm(center=False, scale=False, in_channels=4,
                          device="cpu")
    assert not layer.gamma.requires_grad and not layer.beta.requires_grad
    layer = tnn.LayerNorm(in_channels=4, device="cpu")
    assert layer.gamma.requires_grad and layer.beta.requires_grad


def test_dropout_axes_share_the_mask():
    drop = tnn.Dropout(0.5, axes=(1,))
    drop.train()
    mt.random.seed(0)
    out = drop(torch.ones(4, 6, 8)).numpy()
    assert set(np.unique(out)) <= {0.0, 2.0} and 0.0 in out and 2.0 in out
    # one draw per (batch, feature), repeated along axis 1
    np.testing.assert_array_equal(out, np.repeat(out[:, :1], 6, 1))
    drop.eval()
    assert bool((drop(torch.ones(4, 6, 8)) == 1).all())


def test_own_initializers_win_over_the_one_given():
    emb = tnn.Embedding(10, 4, weight_initializer="zeros", device="cpu")
    dense = tnn.Dense(3, in_units=4, bias_initializer="ones",
                      weight_initializer=mt.initializer.One(), device="cpu")
    for layer in (emb, dense):
        mt.initializer.initialize(layer, mt.initializer.Xavier())
    assert bool((emb.weight == 0).all())
    assert bool((dense.weight == 1).all())
    # a bias goes by its name's rule whatever the initializer, as in
    # the reference's Initializer.__call__
    assert bool((dense.bias == 0).all())
    jd = jnn.Dense(3, in_units=4, bias_initializer="ones",
                   weight_initializer=mx.init.One())
    jd.initialize(mx.init.Xavier())
    np.testing.assert_array_equal(jd.weight.data().asnumpy(),
                                  dense.weight.detach().numpy())
    np.testing.assert_array_equal(jd.bias.data().asnumpy(),
                                  dense.bias.detach().numpy())
    assert isinstance(mt.initializer.create("orthogonal"),
                      mt.initializer.Orthogonal)
    with pytest.raises(ValueError, match="initializer"):
        mt.initializer.create("no_such_initializer")


def test_embedding_dtype():
    emb = tnn.Embedding(10, 4, "float16", device="cpu")
    assert emb.weight.dtype == torch.float16
    assert tnn.Embedding(10, 4, device="cpu").weight.dtype == torch.float32


def test_moe_capacity_factor_is_accepted():
    cfg = dict(d_model=32, n_layers=1, n_heads=4, max_len=16)
    net = ttr.TransformerLM(37, **cfg, moe_capacity_factor=1.25,
                            device="cpu")
    assert len(net.blocks) == 1
    ttr.TransformerBlock(32, 4, moe_capacity_factor=2.0, device="cpu")
    moe = ttr.TransformerLM(37, **cfg, moe_experts=2,
                            moe_capacity_factor=1.5, device="cpu")
    assert moe.blocks[0].moe._cf == 1.5
