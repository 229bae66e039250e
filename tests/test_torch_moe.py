"""The port's Mixture-of-Experts (incubator_mxnet_tpu_torch.ops.moe, the
MoE branch of TransformerLM) against the JAX package's, on the CPU, on
the same numpy inputs.

- ``top2_gating``: the same routing (dispatch bit for bit); combine
  within 3e-7 relative, since torch's and XLA's fp32 softmax differ in
  the last bit; aux within 1e-6.
- ``moe_ffn_fn`` within rtol 1e-5 with equal routing, capacity overflow
  dropping tokens, and ``_moe_ffn`` on the tape with gradients within
  1e-4 of ``jax.grad``.
- A tiny ``TransformerLM(moe_experts=4)`` with the JAX model's weights
  (``convert.load_reference_weights``): logits and aux, ``generate``'s
  greedy tokens, two one-card train steps against the JAX
  ``ShardedTrainStep``'s, the bf16 compute dtype, and paged serving
  refused with the JAX package's error.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jparallel  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtr  # noqa: E402
from incubator_mxnet_tpu.ops import moe as jmoe  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.convert import load_reference_weights  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
    TransformerLM  # noqa: E402
from incubator_mxnet_tpu_torch.ops import moe as tmoe  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import ShardedTrainStep  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

VOCAB = 37
CFG = dict(d_model=32, n_layers=2, n_heads=4, max_len=32, moe_experts=4)
B, L = 2, 16
CPU = mt.cpu()
# the JAX functions compiled once (op-by-op dispatch is the slow part)
_jgating = jax.jit(jmoe.top2_gating, static_argnums=(1,))
_jffn = jax.jit(jmoe.moe_ffn_fn, static_argnames=("capacity_factor",))


def _stacked(rs, e, h, d):
    return [(rs.randn(e, h, d) * 0.3).astype(np.float32),
            (rs.randn(e, h) * 0.1).astype(np.float32),
            (rs.randn(e, d, h) * 0.3).astype(np.float32),
            (rs.randn(e, d) * 0.1).astype(np.float32)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("t,e,c", [(64, 4, 128), (64, 4, 20), (33, 8, 5)])
def test_top2_gating_matches_jax(t, e, c):
    logits = np.random.RandomState(t + e + c).randn(t, e).astype("f")
    jc, jd, ja = _jgating(jnp.asarray(logits), c)
    tc, td, ta = tmoe.top2_gating(torch.from_numpy(logits), c)
    assert tc.shape == td.shape == (t, e, c)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=3e-7,
                               atol=0)
    assert abs(float(ta) - float(ja)) <= 1e-6
    # each slot holds at most one token, each token at most two slots
    assert float(td.sum(0).max()) <= 1.0
    assert (td.sum((1, 2)) <= 2).all()


def test_top2_gating_ties_take_the_first_index():
    logits = np.zeros((6, 4), np.float32)      # every expert ties
    jc, jd, _ = _jgating(jnp.asarray(logits), 8)
    tc, td, _ = tmoe.top2_gating(torch.from_numpy(logits), 8)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert td[:, 0].sum() == 6 and td[:, 1].sum() == 6


@pytest.mark.parametrize("cf", [1.25, 0.01, 8.0])
def test_moe_ffn_fn_matches_jax(cf):
    rs = np.random.RandomState(2)
    t, d, e, h = 32, 8, 4, 8
    x = rs.randn(t, d).astype("f")
    router = rs.randn(e, d).astype("f")
    w = _stacked(rs, e, h, d)
    jout, jaux = _jffn(jnp.asarray(x), jnp.asarray(router), *_j(w),
                       capacity_factor=cf)
    tout, taux = tmoe.moe_ffn_fn(torch.from_numpy(x),
                                 torch.from_numpy(router), *_t(w),
                                 capacity_factor=cf)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    dropped = int((tout == 0).all(-1).sum())
    assert (dropped > 0) == (cf < 1)          # overflow really drops
    assert dropped == int(np.all(np.asarray(jout) == 0, axis=-1).sum())


def test_gating_runs_fp32_whatever_the_dtype():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(16, 8).astype("f"))
    router = torch.from_numpy(rs.randn(4, 8).astype("f"))
    w = _t(_stacked(rs, 4, 8, 8))
    out32, aux32 = tmoe.moe_ffn_fn(x, router, *w)
    out16, aux16 = tmoe.moe_ffn_fn(x.bfloat16(), router.bfloat16(),
                                   *[a.bfloat16() for a in w])
    assert out16.dtype == torch.bfloat16 and aux16.dtype == torch.float32
    assert out32.dtype == torch.float32
    assert torch.isfinite(out16.float()).all()


def test_identical_experts_match_dense_ffn():
    rs = np.random.RandomState(1)
    t, d, e, h = 48, 8, 4, 16
    x = rs.randn(t, d).astype("f")
    up, ub = rs.randn(h, d).astype("f") * 0.3, rs.randn(h).astype("f")
    dn, db = rs.randn(d, h).astype("f") * 0.3, rs.randn(d).astype("f")
    out, _ = tmoe.moe_ffn_fn(
        torch.from_numpy(x), torch.from_numpy(rs.randn(e, d).astype("f")),
        *_t([np.stack([a] * e) for a in (up, ub, dn, db)]),
        capacity_factor=4.0)
    want = np.maximum(x @ up.T + ub, 0) @ dn.T + db
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)


def test_moe_op_on_tape_matches_jax_grad():
    rs = np.random.RandomState(3)
    t, d, e, h = 16, 4, 2, 8
    vals = [rs.randn(t, d).astype("f"), rs.randn(e, d).astype("f"),
            (rs.randn(e, h, d) * 0.3).astype("f"), np.zeros((e, h), "f"),
            (rs.randn(e, d, h) * 0.3).astype("f"), np.zeros((e, d), "f")]
    arrs = [mt.nd.array(v, ctx=CPU) for v in vals]
    for a in arrs[1:]:
        a.attach_grad()
    with mt.autograd.record():
        y, aux = mt.nd._internal._moe_ffn(*arrs)
        loss = (y * y).sum() + 0.01 * aux
    loss.backward()

    @jax.jit
    def jloss(*ws):
        out, a = jmoe.moe_ffn_fn(jnp.asarray(vals[0]), *ws)
        return jnp.sum(out * out) + 0.01 * a

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*_j(vals[1:]))
    np.testing.assert_allclose(float(loss.asnumpy()),
                               float(jloss(*_j(vals[1:]))), rtol=1e-5)
    for a, g in zip(arrs[1:], jg):
        np.testing.assert_allclose(a.grad.asnumpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4)
    # sym reaches the op: two outputs
    s = mt.sym._internal._moe_ffn(mt.sym.Variable("x"), name="m")
    assert len(s) == 2


# ------------------------------------------------------- the tiny LM
@pytest.fixture(scope="module")
def ref():
    """The JAX MoE LM (seeded Xavier weights), its forward, generate
    and two ShardedTrainStep losses on one batch; and the port model
    with its weights."""
    rs = np.random.RandomState(0)
    toks = rs.randint(0, VOCAB, (B, L)).astype(np.int32)
    labels = rs.randint(0, VOCAB, (B, L)).astype(np.int32)
    mx.random.seed(0)
    net = jtr.TransformerLM(VOCAB, **CFG)
    net.initialize(mx.initializer.Xavier())
    logits, aux = net(mx.nd.array(toks))
    wts = jax.tree_util.tree_map(np.asarray, net._decode_weights())
    gen = net.generate(mx.nd.array(toks[:, :8]), max_new_tokens=6)

    def lm_loss(outputs, y):
        lg, a = outputs
        lse = jax.nn.logsumexp(lg.astype(jnp.float32), -1)
        picked = jnp.take_along_axis(lg, y[..., None], axis=-1)[..., 0]
        return jnp.mean(lse - picked.astype(jnp.float32)) + 0.01 * a

    step = jparallel.ShardedTrainStep(
        net, optimizer="adam", optimizer_params=dict(learning_rate=1e-3),
        loss_fn=lm_loss, example_args=[mx.nd.array(np.zeros((2, L),
                                                             np.int32))],
        mesh=jparallel.make_mesh(devices=jax.devices("cpu")[:1]))
    losses = [float(step(jnp.asarray(toks), jnp.asarray(labels)))
              for _ in range(2)]
    return dict(toks=toks, labels=labels, wts=wts,
                logits=logits.asnumpy(), aux=float(aux.asnumpy()),
                generate=gen.asnumpy(), losses=losses,
                flops=net.train_flops_per_token(L))


def _port(ref, **kw):
    return load_reference_weights(
        TransformerLM(VOCAB, **dict(CFG, **kw), device="cpu"), ref["wts"])


def _port_loss(outputs, y):
    logits, aux = outputs
    logits = logits.float()
    picked = logits.gather(-1, y.long()[..., None])[..., 0]
    return (logits.logsumexp(-1) - picked).mean() + 0.01 * aux


def test_lm_forward_and_generate_match_jax(ref):
    net = _port(ref)
    with torch.no_grad():
        logits, aux = net(ref["toks"])
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - ref["aux"]) <= 1e-5
    out = net.generate(ref["toks"][:, :8], max_new_tokens=6)
    assert np.array_equal(out.numpy(), ref["generate"])
    assert net.train_flops_per_token(L) == ref["flops"]
    names = [n for n, _ in net.named_parameters() if ".moe." in n]
    assert sorted({n.rsplit(".", 1)[1] for n in names}) == sorted(
        ["router_weight", "expert_up_weight", "expert_up_bias",
         "expert_down_weight", "expert_down_bias"])


def test_lm_train_steps_match_jax(ref):
    step = ShardedTrainStep(_port(ref), "adam",
                            dict(learning_rate=1e-3), loss_fn=_port_loss)
    losses = [float(step(ref["toks"], ref["labels"])) for _ in range(2)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4, atol=1e-4)


def test_lm_bf16_compute_dtype(ref):
    net = _port(ref)
    step = ShardedTrainStep(net, "adam", dict(learning_rate=1e-3),
                            loss_fn=_port_loss,
                            compute_dtype=torch.bfloat16)
    losses = [float(step(ref["toks"], ref["labels"])) for _ in range(6)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in net.parameters())
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=2e-2)


def test_paged_serving_refused_and_quantize_keeps_experts(ref):
    net = _port(ref)
    with pytest.raises(NotImplementedError, match="paged serving of MoE"):
        mt.serving.ServingEngine(net, max_batch=2, num_blocks=8)
    jnet = jtr.TransformerLM(VOCAB, **CFG)
    with pytest.raises(NotImplementedError, match="paged serving of MoE"):
        jnet._check_paged()
    q = mt.serving.quantize.quantize_weights(net._decode_params())
    for lw, qw in zip(net._decode_params()["layers"], q["layers"]):
        assert "up" not in qw
        assert all(a is b for a, b in zip(qw["moe"], lw["moe"]))
        assert isinstance(qw["qkv"][0], dict)
