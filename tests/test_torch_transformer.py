"""The port's TransformerLM (incubator_mxnet_tpu_torch) against the JAX
package's, on the CPU: the same weights (carried with
``convert.load_reference_weights``) give the same logits and the same
greedy tokens.  The JAX model runs its Pallas flash kernel in interpret
mode (MXTPU_FLASH=1); the port runs its plain path (device="cpu").

Also the port's own rules: it imports neither JAX nor the JAX package,
and ``device=None`` never falls back to the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtr  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.convert import load_reference_weights  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import (  # noqa: E402
    TransformerLM, transformer_lm)

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCAB = 37
CFG = dict(d_model=32, n_layers=2, n_heads=4, max_len=128)


CONFIGS = {"learned": {}, "rope": dict(pos="rope"),
           "gqa": dict(n_kv_heads=2), "window": dict(attn_window=8),
           "rope-gqa-window": dict(pos="rope", n_kv_heads=2,
                                   attn_window=8)}
_PAIRS = {}


def _tokens(b, l, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, l)) \
        .astype(np.int32)


TOKS = _tokens(3, 24)


def _pair(name):
    """(JAX logits on TOKS, JAX model, port model with its weights),
    built once per config: the JAX forward (with its Pallas kernel in
    interpret mode) is the slow part of these tests."""
    if name not in _PAIRS:
        kw = CONFIGS[name]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MXTPU_FLASH", "1")
            mx.random.seed(0)
            net = jtr.TransformerLM(VOCAB, **CFG, **kw)
            net.initialize(mx.initializer.Xavier())
            logits = net(mx.nd.array(TOKS)).asnumpy()   # settles shapes
        wts = jax.tree_util.tree_map(np.asarray, net._decode_weights())
        port = TransformerLM(VOCAB, **CFG, **kw, device="cpu")
        _PAIRS[name] = (logits, net, load_reference_weights(port, wts))
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(name):
    ref, _, port = _pair(name)
    with torch.inference_mode():
        got = port(torch.from_numpy(TOKS)).numpy()
    assert got.shape == (3, 24, VOCAB)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["learned", "rope-gqa-window"])
def test_greedy_generate_matches_jax(name):
    _, net, port = _pair(name)
    prompts = _tokens(3, 24, seed=1)
    ref = net.generate(prompts, max_new_tokens=10).asnumpy()
    got = port.generate(prompts, max_new_tokens=10).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 34)
    np.testing.assert_array_equal(got, ref)


def _port_only(**kw):
    net = TransformerLM(VOCAB, **CFG, **kw, device="cpu")
    return mt.initializer.initialize(net, mt.initializer.Xavier(),
                                     mt.random.generator(0))


def test_sampled_generate_seeded_and_within_top_k():
    # torch's Philox and JAX's threefry differ: sampling is held to
    # seeded reproducibility and to the top-k support, not to JAX
    port = _port_only()
    prompts = _tokens(2, 6, seed=2)

    def run(seed):
        return port.generate(prompts, 12, temperature=0.9, top_k=4,
                             top_p=0.95,
                             generator=mt.random.generator(seed)).numpy()

    a = run(7)
    np.testing.assert_array_equal(a, run(7))
    with torch.inference_mode():
        logits = port(torch.from_numpy(a)).numpy()
    for pos in range(5, a.shape[1] - 1):
        top = np.argsort(logits[:, pos], axis=-1)[:, -4:]
        assert all(a[i, pos + 1] in top[i] for i in range(2)), pos


def test_seed_makes_weights_reproducible():
    def init():
        net = TransformerLM(VOCAB, **CFG, device="cpu")
        mt.random.seed(3)
        mt.initializer.initialize(net, mt.initializer.Xavier())
        return net.state_dict()

    a, b = init(), init()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["ln_f.gamma"].min()) == 1.0
    assert float(a["blocks.0.up.bias"].abs().max()) == 0.0


def test_weight_carry_checks_shapes():
    wts = jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), _port_only()._decode_params())
    wider = TransformerLM(VOCAB, **dict(CFG, d_model=64), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_reference_weights(wider, wts)
    del wts["ln_f"]
    with pytest.raises(ValueError, match="missing"):
        load_reference_weights(TransformerLM(VOCAB, **CFG, device="cpu"),
                               wts)


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        TransformerLM(VOCAB, **CFG)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        transformer_lm(VOCAB, **CFG)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.default_device()


def test_features_outside_the_slice_raise():
    # MoE is in the port now (tests/test_torch_moe.py): it builds
    assert TransformerLM(VOCAB, **CFG, moe_experts=2,
                         device="cpu").blocks[0].moe.num_experts == 2
    with pytest.raises(NotImplementedError, match="seq_parallel"):
        TransformerLM(VOCAB, **CFG, seq_parallel=True, device="cpu")
    # training-mode dropout is in the slice now: it runs, and generate's
    # prefill leaves it out
    net = _port_only(dropout=0.1)
    toks = torch.from_numpy(_tokens(1, 4))
    with torch.inference_mode():
        assert net(toks).shape == (1, 4, VOCAB)
        ref = net.eval()(toks)
    net.train()
    np.testing.assert_array_equal(
        net.generate(toks, 1).numpy()[:, -1],
        ref[:, -1].argmax(-1).numpy())
    assert net.training


_FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def _forbidden(name):
    return name.split(".")[0] in _FORBIDDEN


# modules of each slice that the walk below must reach
_SLICE_MODULES = ("ops.flash", "gluon.model_zoo.transformer",
                  "parallel.data_parallel", "ops.registry", "ops.elemwise",
                  "ops.reduce", "ops.matrix", "ops.indexing", "ops.init_op",
                  "ops.optimizer_op", "engine", "autograd",
                  "ndarray.ndarray", "ndarray.register", "rtc",
                  "rtc_examples", "name", "attribute", "utils.registry",
                  "symbol.symbol", "symbol.register", "executor",
                  "metric", "io.io", "callback", "model",
                  "module.base_module", "module.module", "monitor",
                  "kvstore", "context", "parallel._graph", "parallel.mesh",
                  "parallel.symbol_step", "parallel.optim", "ops.moe",
                  "graph.ir", "graph.passes", "graph.fuse",
                  "graph.cached_op")


def test_port_imports_no_jax():
    files = sorted((ROOT / "incubator_mxnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    rel = {str(p.relative_to(ROOT / "incubator_mxnet_tpu_torch"))[:-3]
           .replace("/", ".") for p in files[:-1]}
    assert set(_SLICE_MODULES) <= rel, set(_SLICE_MODULES) - rel
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    # and at run time: every module of the package, in a fresh process
    code = (
        "import pkgutil, sys, incubator_mxnet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {_SLICE_MODULES!r} if p.__name__ + '.' "
        "+ m not in sys.modules]\n"
        "assert not missing, missing\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
