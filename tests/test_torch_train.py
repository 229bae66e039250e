"""The port's training path (incubator_mxnet_tpu_torch.parallel) against
the JAX package's (incubator_mxnet_tpu.parallel), on the CPU.

- The functional optimizers and lr schedules give the JAX package's
  numbers on the same numpy inputs.
- ``ShardedTrainStep`` on a tiny TransformerLM, with the JAX model's
  weights carried over (``convert.load_reference_weights``), takes the
  same steps as the JAX ``ShardedTrainStep``, whose attention runs its
  Pallas forward and backward kernels in interpret mode
  (MXTPU_FLASH=1); the port runs its plain versions (device="cpu").
- Its own options (grad_accum, compute_dtype, remat, lr_schedule) and
  training-mode ``Dropout``.  Dropout draws from torch's Philox and not
  from JAX's threefry, so it is held to its own properties, not to JAX.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jparallel  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtr  # noqa: E402
from incubator_mxnet_tpu.parallel import optim as joptim  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.convert import load_reference_weights  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
    TransformerLM  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.nn import Dropout  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import ShardedTrainStep  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import optim as toptim  # noqa: E402

VOCAB = 37
CFG = dict(d_model=32, n_layers=2, n_heads=4, max_len=32)
B, L = 4, 24
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------- optimizers

def _tree(seed, n=3):
    rs = np.random.RandomState(seed)
    shapes = {"a_weight": (5, 4), "b_bias": (4,), "c_gamma": (3, 2)}
    return [{k: rs.normal(0, 1, s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


_OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.5)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5)),
]


@pytest.mark.parametrize("name,kw", _OPTIMIZERS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(_OPTIMIZERS)])
@pytest.mark.parametrize("extra", [{}, dict(
    scale=0.5, lr=0.05, lr_mults={"a_weight": 2.0},
    wd_mults={"b_bias": 0.0})], ids=["plain", "scaled"])
def test_optimizer_matches_jax(name, kw, extra):
    params = _tree(0, 1)[0]
    grads = _tree(1)
    jopt = joptim.create(name, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    topt = toptim.create(name, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    jextra = dict(extra)
    for k in ("lr_mults", "wd_mults"):
        if k in jextra:   # JAX wants a full pytree of multipliers
            jextra[k] = {n: jextra[k].get(n, 1.0) for n in params}
    for g in grads:
        jp, jstate = jopt.update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            **jextra)
        out, _ = topt.update(tp, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, tstate, **extra)
        assert out is tp          # updated in place
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("sched", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_jax(sched):
    jf = getattr(joptim, sched)(0.1, 5, 20, end_lr=0.01)
    tf = getattr(toptim, sched)(0.1, 5, 20, end_lr=0.01)
    for t in range(21):
        np.testing.assert_allclose(tf(t), float(jf(t)), rtol=1e-6,
                                   err_msg=str(t))


def test_create_rejects_unknown_optimizer():
    with pytest.raises(ValueError, match="no functional optimizer"):
        toptim.create("lamb")
    assert toptim.create(toptim.adam, learning_rate=0.5).hyper["lr"] \
        == 0.5


# ------------------------------------------------------ train step: JAX

def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, (B, L)).astype(np.int32),
            rs.randint(0, VOCAB, (B, L)).astype(np.int32))


def _jax_loss(outputs, labels):
    # bench.py's LM loss: logsumexp minus the picked logit, in fp32
    logits = outputs[0].astype(jnp.float32)
    lse = jax.nn.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
    return jnp.mean(lse - picked)


def _port_loss(outputs, labels):
    logits = outputs[0].float()
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def _jax_run(optimizer, params, steps=3):
    """(losses, weights after) of the JAX ShardedTrainStep, its flash
    kernels in interpret mode, and the port model with the JAX model's
    initial weights."""
    toks, labels = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_FLASH", "1")
        mx.random.seed(0)
        net = jtr.TransformerLM(VOCAB, **CFG)
        net.initialize(mx.initializer.Xavier())
        net(mx.nd.array(toks))                 # settles shapes
        wts = jax.tree_util.tree_map(np.asarray, net._decode_weights())
        port = load_reference_weights(
            TransformerLM(VOCAB, **CFG, device="cpu"), wts)
        step = jparallel.ShardedTrainStep(
            net, optimizer=optimizer, optimizer_params=params,
            loss_fn=_jax_loss,
            example_args=[mx.nd.array(np.zeros((2, L), "int32"))],
            mesh=jparallel.make_mesh(devices=jax.devices("cpu")[:1]))
        losses = [float(step(jnp.asarray(toks), jnp.asarray(labels)))
                  for _ in range(steps)]
        step.write_back()
        after = jax.tree_util.tree_map(np.asarray, net._decode_weights())
    return losses, after, port


def _port_run(port, optimizer, params, steps=3, **kw):
    toks, labels = _batch()
    step = ShardedTrainStep(port, optimizer=optimizer,
                            optimizer_params=params, loss_fn=_port_loss,
                            **kw)
    return [float(step(toks, labels)) for _ in range(steps)], step


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), tree)


def test_sgd_steps_match_jax():
    params = dict(learning_rate=0.1, momentum=0.9)
    jlosses, jafter, port = _jax_run("sgd", params)
    losses, step = _port_run(port, "sgd", params)
    step.write_back()                          # a no-op in the port
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    assert losses[-1] < losses[0]
    got = _numpy_tree(port._decode_params())
    flat_got = jax.tree_util.tree_leaves(got)
    flat_ref = jax.tree_util.tree_leaves(jafter)
    assert len(flat_got) == len(flat_ref)
    for a, b in zip(flat_got, flat_ref):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def test_adam_losses_match_jax():
    # Adam's first steps turn sign noise in near-zero gradients into
    # full-size updates, so its weights are held by the optimizer test
    params = dict(learning_rate=1e-2)
    jlosses, _, port = _jax_run("adam", params)
    losses, _ = _port_run(port, "adam", params)
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)


# ------------------------------------------------- train step: options

def _port_model(**kw):
    net = TransformerLM(VOCAB, **dict(CFG, **kw), device="cpu")
    return mt.initializer.initialize(net, mt.initializer.Xavier(),
                                     mt.random.generator(0))


def _state(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


def test_grad_accum_equals_one_big_batch():
    a = _port_model()
    b = copy.deepcopy(a)
    la, _ = _port_run(a, "sgd", dict(learning_rate=0.1, momentum=0.9), 2)
    lb, _ = _port_run(b, "sgd", dict(learning_rate=0.1, momentum=0.9), 2,
                      grad_accum=2)
    np.testing.assert_allclose(lb, la, rtol=1e-5, atol=1e-6)
    for k, v in _state(a).items():
        np.testing.assert_allclose(b.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        _port_run(_port_model(), "sgd", {}, 1, grad_accum=3)


def test_bf16_compute_keeps_fp32_masters():
    a = _port_model()
    b = copy.deepcopy(a)
    (l32,), _ = _port_run(a, "sgd", dict(learning_rate=0.1), 1)
    (l16,), step = _port_run(b, "sgd", dict(learning_rate=0.1), 1,
                             compute_dtype=torch.bfloat16)
    assert np.isfinite(l16)
    assert abs(l16 - l32) <= 2e-2 * abs(l32), (l16, l32)
    assert all(p.dtype == torch.float32 for p in b.parameters())
    assert all(p.dtype == torch.float32 for p in step.params.values())
    assert not torch.equal(b.head.weight, _port_model().head.weight)


def test_lr_schedule_is_used():
    net = _port_model()
    before = _state(net)
    seen = []

    def sched(t):
        seen.append(t)
        return 0.0

    _port_run(net, "sgd", dict(learning_rate=0.1), 2, lr_schedule=sched)
    assert seen == [0, 1]
    for k, v in before.items():      # lr 0: nothing moves
        assert torch.equal(net.state_dict()[k], v), k


def test_remat_redraws_the_same_dropout_masks():
    a = _port_model(dropout=0.2)
    b = copy.deepcopy(a)
    toks, labels = _batch()
    for net, remat in ((a, False), (b, True)):
        step = ShardedTrainStep(net, "sgd", dict(learning_rate=0.1),
                                loss_fn=_port_loss, remat=remat)
        step(toks, labels, generator=mt.random.generator(3))
    for k, v in _state(a).items():
        np.testing.assert_allclose(b.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_evaluate_runs_without_dropout_and_keeps_the_mode():
    net = _port_model(dropout=0.5)
    step = ShardedTrainStep(net, "sgd", loss_fn=_port_loss)
    toks, _ = _batch()
    a = step.evaluate(toks)
    b = step.evaluate(toks)
    assert isinstance(a, list) and a[0].shape == (B, L, VOCAB)
    assert torch.equal(a[0], b[0])
    assert net.training
    with torch.no_grad():
        assert not torch.equal(net(torch.from_numpy(toks)), a[0])


def test_train_flops_per_token_matches_jax():
    for kw in ({}, dict(n_kv_heads=2, attn_window=8)):
        net = jtr.TransformerLM(VOCAB, **CFG, **kw)
        net.initialize(mx.initializer.Xavier())
        net(mx.nd.array(_batch()[0]))
        port = TransformerLM(VOCAB, **CFG, **kw, device="cpu")
        assert port.train_flops_per_token(L) == \
            net.train_flops_per_token(L)


# ------------------------------------------------------------- dropout

def _drop(x, rate, seed):
    drop = Dropout(rate)
    with mt.random.key_provider(mt.random.generator(seed)):
        return drop(x)


def test_dropout_same_seed_same_mask():
    x = torch.ones(1000)
    assert torch.equal(_drop(x, 0.3, 1), _drop(x, 0.3, 1))
    assert not torch.equal(_drop(x, 0.3, 1), _drop(x, 0.3, 2))


def test_dropout_keeps_one_minus_rate_scaled():
    rate, n = 0.3, 100_000
    out = _drop(torch.ones(n), rate, 0)
    kept = out != 0
    share = float(kept.float().mean())
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(share - (1 - rate)) <= 4 * sigma, share
    np.testing.assert_allclose(out[kept].numpy(), 1 / (1 - rate),
                               rtol=1e-6)


def test_dropout_eval_is_identity_and_global_rng_untouched():
    x = torch.randn(64)
    drop = Dropout(0.5)
    assert drop.eval()(x) is x
    drop.train()
    state = torch.get_rng_state()
    mt.random.seed(7)
    a = drop(x)
    mt.random.seed(7)
    assert torch.equal(drop(x), a)    # the package's default generator
    assert torch.equal(torch.get_rng_state(), state)
    with pytest.raises(ValueError, match="rate"):
        Dropout(1.0)
