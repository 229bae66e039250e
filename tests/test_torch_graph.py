"""The port's graph layer (incubator_mxnet_tpu_torch.graph: the pass
pipeline, the Executor's bind through it, CachedOp behind
``hybridize()``) against the JAX package's, on the CPU.

- The same graphs built in both packages (bench.py's three graph-bench
  graphs and tests/test_graph_passes.py's randomized ones) give the
  JAX package's pass reports at levels 1 and 2; the port's outputs are
  bit-equal across levels 0, 1 and 2 and within rtol 1e-5, atol 1e-6 of
  the JAX package's at each level.
- Each CachedOp case of tests/test_graph_passes.py runs in both packages
  on the same sequence of calls, and the port's ``stats()`` equal the
  JAX package's.
- Random nodes keep their streams under optimization (torch's draws,
  held to the unoptimized graph, not to JAX's threefry).
"""
import gc
import os
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.graph import (Graph, PASSES,  # noqa: E402
                                             PassManager)
from incubator_mxnet_tpu_torch.graph.fuse import FusedOp  # noqa: E402
from incubator_mxnet_tpu_torch.symbol.symbol import _topo  # noqa: E402

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = mt.cpu()


def _op_names(symbol):
    return [n.op.name for n in _topo(symbol._heads) if n.op is not None]


def _random_symbol(S, seed, n_ops=24):
    """tests/test_graph_passes.py's randomized DAG over ``S`` (either
    package's sym): elementwise and scalar ops, transpose pairs,
    constant subtrees, duplicated subexpressions, identities."""
    rs = np.random.RandomState(seed)
    pool = [S.Variable("a"), S.Variable("b")]
    unary = ["tanh", "sin", "relu", "abs", "negative"]
    for _ in range(n_ops):
        r = rs.rand()

        def pick():
            return pool[rs.randint(len(pool))]
        if r < 0.30:
            t = getattr(S, unary[rs.randint(len(unary))])(pick())
        elif r < 0.55:
            f = [S.broadcast_add, S.broadcast_mul, S.broadcast_sub,
                 S.broadcast_maximum][rs.randint(4)]
            t = f(pick(), pick())
        elif r < 0.65:
            t = pick() * float(round(rs.uniform(0.2, 2.2), 3))
        elif r < 0.73:
            t = S.transpose(S.transpose(pick(), axes=(1, 0)), axes=(1, 0))
        elif r < 0.81:
            t = pick() + S.ones((4, 8)) * \
                float(round(rs.uniform(0.5, 1.5), 3))
        elif r < 0.92:
            x = pick()
            t = S.tanh(x) + S.tanh(x)
        else:
            t = S._internal._copy(pick())
        pool.append(t)
    return S.Group(pool[-2:])


def _graphs(which):
    """(JAX symbol, port symbol, shapes) of a named graph."""
    if which.startswith("random"):
        seed = int(which[len("random"):])
        return (_random_symbol(mx.sym, seed), _random_symbol(mt.sym, seed),
                {"a": (4, 8), "b": (4, 8)})
    jax_build = {"mlp": lambda: bench._graph_mlp(mx.sym),
                 "resnet_block": lambda: bench._graph_resnet_block(mx.sym),
                 "transformer_lm_step":
                     lambda: bench._graph_transformer_step(mx.sym)}[which]
    port_build = {"mlp": lambda: cs.graph_mlp(mt.sym),
                  "resnet_block": lambda: cs.graph_resnet_block(mt),
                  "transformer_lm_step":
                      lambda: cs.graph_transformer_step(mt.sym)}[which]
    jsym, shapes = jax_build()
    psym, _ = port_build()
    return jsym, psym, shapes


GRAPHS = ["random0", "random1", "random2", "random3", "random4", "mlp",
          "resnet_block", "transformer_lm_step"]


def _jax_bind(symbol, shapes, level, monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_OPT", str(level))
    exe = symbol.simple_bind(mx.cpu(), grad_req="null", **shapes)
    vals = cs.graph_values({k: v.shape for k, v in exe.arg_dict.items()})
    exe.copy_params_from({k: mx.nd.array(v) for k, v in vals.items()})
    return [o.asnumpy() for o in exe.forward()], exe.graph_report


@pytest.mark.parametrize("which", GRAPHS)
def test_reports_and_outputs_match_jax(which, monkeypatch):
    jsym, psym, shapes = _graphs(which)
    for level in (1, 2):
        _, jrep = jsym.optimize(level=level)
        _, prep = psym.optimize(level=level)
        assert prep == jrep, f"{which} level {level}"
    outs = {}
    for level in (0, 1, 2):
        got, rep = cs.bind_at_level(mt, psym, shapes, level, CPU)
        outs[level] = [t.numpy() for t in got]
        ref, jrep = _jax_bind(jsym, shapes, level, monkeypatch)
        if level:
            assert rep == jrep
        for a, b in zip(outs[level], ref):
            # atol at the output's scale: the two packages' convolutions
            # sum in different orders, and a relu after a cancellation
            # near 0 keeps the absolute error of O(1) terms
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=TOL["rtol"],
                                       atol=TOL["atol"] * scale)
    for level in (1, 2):
        for a, b in zip(outs[0], outs[level]):
            assert np.array_equal(a, b), f"{which}: level {level} diverged"


def test_gradients_bitwise_across_levels_and_near_jax(monkeypatch):
    rs = np.random.RandomState(7)
    vals = {"a": rs.randn(4, 8).astype("float32"),
            "b": rs.randn(4, 8).astype("float32")}
    grads = {}
    for pkg, S, ctx in (("port", mt.sym, CPU), ("jax", mx.sym, mx.cpu())):
        s = _random_symbol(S, 7)
        nd = mt.nd if pkg == "port" else mx.nd
        for lv in (0, 2):
            monkeypatch.setenv("MXTPU_GRAPH_OPT", str(lv))
            ex = s.simple_bind(ctx, grad_req="write", a=(4, 8), b=(4, 8))
            ex.copy_params_from({k: nd.array(v, ctx=ctx)
                                 for k, v in vals.items()})
            ex.forward_backward()
            grads[pkg, lv] = {k: g.asnumpy()
                              for k, g in ex.grad_dict.items()}
    for k in grads["port", 0]:
        assert np.array_equal(grads["port", 0][k], grads["port", 2][k])
        np.testing.assert_allclose(grads["port", 2][k], grads["jax", 2][k],
                                   **TOL)


def test_rng_stream_invariant_under_optimization(monkeypatch):
    """Dropout draws the same mask at every level: the generator index
    is stamped before optimization (``__rng_index__``)."""
    S = mt.sym
    x = S.Variable("x")
    # CSE removes a tanh node ahead of the second dropout's index
    y = S.Dropout(S.tanh(x) + S.tanh(x), p=0.5) * 1.0 \
        + S.Dropout(S.sin(x), p=0.5)
    v = np.random.RandomState(3).randn(8, 8).astype("float32")
    outs = {}
    for lv in (0, 1, 2):
        monkeypatch.setenv("MXTPU_GRAPH_OPT", str(lv))
        ex = y.bind(CPU, {"x": mt.nd.array(v, ctx=CPU)})
        mt.random.seed(123)
        outs[lv] = ex.forward(is_train=True)[0].asnumpy()
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], outs[2])


# ------------------------------------------------------------ passes
def test_cse_dedups_and_never_merges_rng_ops():
    S = mt.sym
    x = S.Variable("x")
    opt, report = (S.tanh(x) + S.tanh(x)).optimize(level=1)
    assert _op_names(opt).count("tanh") == 1
    row = [p for p in report["passes"]
           if p["pass"] == "eliminate_common_subexpressions"][0]
    assert row["merged"] == 1
    opt, _ = (S.Dropout(x, p=0.5) + S.Dropout(x, p=0.5)).optimize(level=1)
    assert _op_names(opt).count("Dropout") == 2


def test_constant_folding_removes_const_subtree(monkeypatch):
    S = mt.sym
    x = S.Variable("x")
    y = x + (S.ones((4,)) * 2.0 + 1.0)
    opt, report = y.optimize(level=1)
    names = _op_names(opt)
    assert "_ones" not in names and "_graph_const" in names
    folded = [p for p in report["passes"]
              if p["pass"] == "fold_constants"][0]
    assert folded["folded"] >= 1
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "1")
    ex = y.bind(CPU, {"x": mt.nd.zeros((2, 4), ctx=CPU)})
    np.testing.assert_allclose(ex.forward()[0].asnumpy(),
                               np.full((2, 4), 3.0))


@pytest.mark.parametrize("case", ["identity", "relu_act", "tanh_act",
                                  "unknown_dtype", "add_zero",
                                  "transpose_pair", "transpose_merge"])
def test_structural_rewrites_match_jax(case):
    """Each unit graph of tests/test_graph_passes.py leaves the same op
    list in both packages."""
    def build(S):
        x = S.Variable("x")
        return {
            "identity": lambda: S._internal._copy(S.tanh(x) * 1.0) / 1.0,
            "relu_act": lambda: S.Activation(x, act_type="relu") * 1.0,
            "tanh_act": lambda: S.Activation(x, act_type="tanh") * 1.0,
            "unknown_dtype": lambda: x * 1.0,
            "add_zero": lambda: (x + 0.0) - 0.0,
            "transpose_pair": lambda: S.tanh(S.transpose(
                S.transpose(x, axes=(1, 0)), axes=(1, 0))),
            "transpose_merge": lambda: S.transpose(
                S.transpose(x, axes=(0, 1)), axes=(1, 0)),
        }[case]()
    want = {"identity": ["tanh"], "unknown_dtype": ["_mul_scalar"],
            "add_zero": ["_plus_scalar", "_minus_scalar"],
            "transpose_pair": ["tanh"], "transpose_merge": ["transpose"]}
    jopt, jrep = build(mx.sym).optimize(level=1)
    popt, prep = build(mt.sym).optimize(level=1)
    assert _op_names(popt) == _op_names(jopt)
    assert prep == jrep
    if case in want:
        assert _op_names(popt) == want[case]
    if case == "relu_act":
        assert "_mul_scalar" in _op_names(popt)
    if case == "tanh_act":
        assert "_mul_scalar" not in _op_names(popt)


def test_scalar_identity_kept_on_integer_inputs(monkeypatch):
    x = mt.sym.Variable("x")
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "1")
    ex = (x * 1.0).simple_bind(CPU, grad_req="null",
                               type_dict={"x": "int32"}, x=(2, 2))
    ex.copy_params_from({"x": mt.nd.array(np.ones((2, 2), "int32"),
                                          ctx=CPU)})
    assert ex.forward()[0].asnumpy().dtype == np.float32


def test_pruning_never_drops_reachable_outputs():
    for seed in range(3):
        s = _random_symbol(mt.sym, seed, n_ops=16)
        opt, report = s.optimize(level=2)
        assert len(opt._heads) == len(s._heads)
        live = {id(n) for n in _topo(opt._heads)}
        assert {id(n) for n in Graph(opt._heads).topo()} == live
        assert report["nodes_after"] <= report["nodes_before"]


def test_fuse_elemwise_chains_and_boundaries(monkeypatch):
    S = mt.sym
    x = S.Variable("x")
    y = S.relu(S.tanh(S.sin(x) * 0.5) + 2.0)
    opt, report = y.optimize(level=2)
    ops = [n.op for n in _topo(opt._heads) if n.op is not None]
    assert len(ops) == 1 and isinstance(ops[0], FusedOp)
    fused = [p for p in report["passes"] if p["pass"] == "fuse_elemwise"][0]
    assert fused["chains"] == 1 and fused["ops_fused"] == 5
    v = np.random.RandomState(0).randn(3, 3).astype("float32")
    outs = []
    for lv in (0, 2):
        monkeypatch.setenv("MXTPU_GRAPH_OPT", str(lv))
        outs.append(y.bind(CPU, {"x": mt.nd.array(v, ctx=CPU)})
                    .forward()[0].asnumpy())
    assert np.array_equal(*outs)
    t = S.tanh(x)
    opt, _ = (t * 2.0 + S.sin(t)).optimize(level=2)
    assert "tanh" in _op_names(opt)          # two consumers: not fused


def test_pass_manager_ordering_unknown_and_custom_pass():
    pm = PassManager(["prune_dead_nodes", "fold_constants",
                      "eliminate_identity"])
    order = pm.pass_names
    assert order.index("eliminate_identity") \
        < order.index("fold_constants") < order.index("prune_dead_nodes")
    with pytest.raises(KeyError):
        PassManager(["no_such_pass"])
    from incubator_mxnet_tpu_torch.graph import GraphPass, register_pass

    @register_pass
    class CountTanh(GraphPass):
        name = "count_tanh_port_test"
        after = ("eliminate_identity",)

        def run(self, graph):
            return {"tanh": sum(1 for n in graph.topo()
                                if n.op is not None and n.op.name == "tanh")}

    try:
        _, report = mt.sym.tanh(mt.sym.Variable("x")).optimize(
            level=1, pass_names=["count_tanh_port_test",
                                 "eliminate_identity"])
        assert [p["pass"] for p in report["passes"]] == \
            ["eliminate_identity", "count_tanh_port_test"]
        assert report["passes"][1]["tanh"] == 1
    finally:
        del PASSES["count_tanh_port_test"]


def test_level_zero_returns_input():
    y = mt.sym.tanh(mt.sym.Variable("x"))
    opt, report = y.optimize(level=0)
    assert opt is y and report["passes"] == []


def test_executor_module_and_symbol_step_expose_report(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "1")
    S = mt.sym
    y = S.FullyConnected(S.Variable("data"), num_hidden=3, name="fcrep")
    mod = mt.mod.Module(y, data_names=["data"], label_names=[],
                        context=CPU)
    mod.bind(data_shapes=[("data", (2, 4))], for_training=False)
    rep = mod.graph_opt_report
    assert rep is not None and rep["level"] == 1
    assert rep["nodes_after"] <= rep["nodes_before"]
    step = mt.parallel.SymbolTrainStep(
        y, {"fcrep_weight": torch.zeros(3, 4), "fcrep_bias":
            torch.zeros(3)}, {}, ["data"])
    assert step.graph_report == rep
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "0")
    ex = y.simple_bind(CPU, data=(2, 4))
    assert ex.graph_report["level"] == 0


# ----------------------------------------------------------- CachedOp
class _Pkg:
    """One package's surface for the CachedOp cases."""

    def __init__(self, name):
        self.name = name
        self.m = mx if name == "jax" else mt
        self.ctx = mx.cpu() if name == "jax" else CPU

    def array(self, a):
        return self.m.nd.array(np.asarray(a), ctx=self.ctx)

    def mlp(self, width=16):
        nn = self.m.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Dense(width, activation="relu"))
        net.add(nn.Dense(4))
        net.initialize(self.m.init.Xavier(), ctx=self.ctx)
        return net

    def param(self, net, suffix):
        return [p for n, p in net.collect_params().items()
                if n.endswith(suffix)][0]


def _both(case):
    """Run ``case(pkg)`` in both packages; returns {name: result}."""
    return {name: case(_Pkg(name)) for name in ("jax", "port")}


def test_cachedop_hit_miss_counts():
    def case(P):
        net = P.mlp()
        net.hybridize()
        x = P.array(np.random.RandomState(0).rand(3, 8).astype("f"))
        net(x)
        net(x)
        first = dict(net._cached_op.stats())
        net(P.array(np.random.RandomState(1).rand(5, 8).astype("f")))
        return first, net._cached_op.stats()
    got = _both(case)
    assert got["port"] == got["jax"]
    assert got["port"][0]["misses"] == 1 and got["port"][0]["hits"] == 1


def test_cachedop_train_eval_cache_separation():
    def case(P):
        nn = P.m.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.BatchNorm(in_channels=3))
        net.initialize(ctx=P.ctx)
        net.hybridize()
        x = P.array(np.random.RandomState(0).rand(4, 3).astype("f") + 2)
        y_eval = net(x).asnumpy()
        before = P.param(net, "running_mean").data().asnumpy().copy()
        with P.m.autograd.record():
            net(x)
        after = P.param(net, "running_mean").data().asnumpy()
        return (net._cached_op.stats(), y_eval, before, after,
                net(x).asnumpy())
    got = _both(case)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0]["entries"] == 2
    for a, b in zip(got["port"][1:], got["jax"][1:]):
        np.testing.assert_allclose(a, b, **TOL)
    assert not np.allclose(got["port"][2], got["port"][3])


def test_cachedop_stable_scalar_signatures():
    def case(P):
        class ScaledDense(P.m.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = P.m.gluon.nn.Dense(3, in_units=4)

            def hybrid_forward(self, F, x, scale):
                return self.fc(x) * scale

        net = ScaledDense()
        net.initialize(P.m.init.One(), ctx=P.ctx)
        net.hybridize()
        x = P.array(np.ones((2, 4), "float32"))
        base = net(x, 1.0).asnumpy()
        outs = [net(x, v).asnumpy() for v in
                (2.0, np.float32(2.0), np.float64(2.0), np.array(2.0))]
        mid = dict(net._cached_op.stats())
        net(x, 2)
        return mid, net._cached_op.stats(), base, outs
    got = _both(case)
    assert got["port"][:2] == got["jax"][:2]
    assert got["port"][0]["traces"] == 2 and got["port"][1]["traces"] == 3
    for o in got["port"][3]:
        np.testing.assert_allclose(o, got["port"][2] * 2.0, rtol=1e-6)


def test_cachedop_capacity_lru():
    def case(P):
        net = P.mlp()
        rs = np.random.RandomState(0)
        net(P.array(rs.rand(2, 8).astype("f")))       # settle shapes
        mod = mx.graph if P.name == "jax" else mt.graph
        co = mod.CachedOp(net, capacity=2)
        for b in (2, 3, 4, 5):
            co(P.array(rs.rand(b, 8).astype("f")))
        return len(co._entries), co.misses, co.stats()
    got = _both(case)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (2, 4)


def test_cachedop_capacity_flag(monkeypatch):
    monkeypatch.setenv("MXTPU_CACHEDOP_CAPACITY", "1")
    net = _Pkg("port").mlp()
    net.hybridize()
    for b in (2, 3, 2):
        net(mt.nd.ones((b, 8), ctx=CPU))
    assert net._cached_op.stats()["entries"] == 1
    assert net._cached_op.misses == 3


def test_cachedop_unhashable_arg_falls_back(caplog):
    def case(P):
        class Weird(P.m.gluon.HybridBlock):
            def hybrid_forward(self, F, x, cfg):
                return x * (cfg["k"] if isinstance(cfg, dict) else cfg)

        net = Weird()
        net.initialize(ctx=P.ctx)
        net.hybridize()
        x = P.array(np.ones((2, 2), "float32"))
        outs = [net(x, {"k": 3.0}).asnumpy()]
        fell_back = net._cache_fallback
        outs.append(net(x, 2.0).asnumpy())
        outs.append(net(x, {"k": 4.0}).asnumpy())
        return fell_back, net._cached_op.stats(), outs
    with caplog.at_level("WARNING"):
        got = _both(case)
    assert got["port"][:2] == got["jax"][:2]
    assert got["port"][0] and got["port"][1]["misses"] == 1
    for o, k in zip(got["port"][2], (3.0, 2.0, 4.0)):
        np.testing.assert_allclose(o, k * np.ones((2, 2)))
    warned = [r for r in caplog.records
              if "cannot key a replay cache" in r.getMessage()
              and r.name.startswith("incubator_mxnet_tpu_torch")]
    assert len(warned) == 1


def test_cachedop_graph_mode_engages_and_matches_eager(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "2")

    def case(P):
        net = P.mlp()
        x = P.array(np.random.RandomState(2).rand(3, 8).astype("f"))
        eager = net(x).asnumpy()
        net.hybridize()
        return net._cached_op is None, eager, net(x).asnumpy(), \
            net._cached_op.stats()["modes"]
    got = _both(case)
    assert got["port"][3] == got["jax"][3] == ["graph"]
    # each package draws its own Xavier weights: the port's replay is
    # held to its own eager call
    assert np.array_equal(got["port"][1], got["port"][2])


def test_cachedop_dropout_block_uses_jit_mode():
    def case(P):
        nn = P.m.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Dense(8, in_units=8))
        net.add(nn.Dropout(0.5))
        net.initialize(ctx=P.ctx)
        net.hybridize()
        with P.m.autograd.record():
            net(P.array(np.random.RandomState(0).rand(2, 8).astype("f")))
        return net._cached_op.stats()
    got = _both(case)
    assert got["port"] == got["jax"]
    assert got["port"]["modes"] == ["jit"]


def _same_weights(P, net, seed):
    """Give ``net``'s parameters (shapes settled) the same values in
    both packages: uniform draws in parameter order."""
    rs = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(P.array(rs.uniform(-0.5, 0.5, p.shape).astype("f")))


def _grads(net):
    return [p.grad().asnumpy().copy() for p in net.collect_params().values()]


def test_cachedop_gradients_through_replay():
    def case(P):
        net = P.mlp()
        x = P.array(np.random.RandomState(5).rand(4, 8).astype("f"))
        net(x)                                       # settle shapes
        _same_weights(P, net, 6)
        net.hybridize()
        with P.m.autograd.record():
            y = net(x).sum()
        y.backward()
        hybrid = _grads(net)
        net.hybridize(active=False)
        with P.m.autograd.record():
            y2 = net(x).sum()
        y2.backward()
        return hybrid, _grads(net)
    got = _both(case)
    (hyb, eager), (j_hyb, j_eager) = got["port"], got["jax"]
    assert len(hyb) == len(j_hyb) == 4
    for h, e, jh, je in zip(hyb, eager, j_hyb, j_eager):
        np.testing.assert_allclose(h, e, **TOL)
        np.testing.assert_allclose(h, jh, **TOL)
        np.testing.assert_allclose(e, je, **TOL)


def _cell(P):
    """A Dense(8, tanh) cell that maps its output space onto its input
    space, so calls chain (an unrolled cell)."""
    nn = P.m.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=8, activation="tanh"))
    net.initialize(ctx=P.ctx)
    _same_weights(P, net, 7)
    return net


def _chained_grads(P, net, x0, calls=3):
    """x and every parameter's gradient of sum(net(net(...net(x))))
    with ``calls`` calls under one record()."""
    x = P.array(x0)
    x.attach_grad()
    with P.m.autograd.record():
        h = x
        for _ in range(calls):
            h = net(h)
        y = h.sum()
    y.backward()
    return [x.grad.asnumpy().copy()] + _grads(net)


def test_cachedop_chained_calls_under_one_record():
    """One hybridized block applied three times in a chain under one
    record() gives the eager chain's gradients (bit for bit in the port,
    within TOL of the JAX package)."""
    x0 = np.random.RandomState(8).rand(4, 8).astype("f")

    def case(P):
        net = _cell(P)
        eager = _chained_grads(P, net, x0)
        net.hybridize()
        return eager, [_chained_grads(P, net, x0) for _ in range(2)]
    got = _both(case)
    eager, hybrid = got["port"]
    for run in hybrid:
        for h, e, j in zip(run, eager, got["jax"][1][0]):
            assert np.array_equal(h, e)
            np.testing.assert_allclose(h, j, **TOL)


class _FakeGraph:
    def __init__(self, run):
        self.replay = run


def _fake_capture_pair(self, entry, inputs, needs, tparams, training,
                       gens):
    """A stand-in for a captured pair that runs on the CPU with the
    pair's buffer semantics: each forward replay overwrites the one set
    of activations (``live``) that the backward replay reads, as the
    captured graphs' shared memory pool does."""
    from incubator_mxnet_tpu_torch.graph import cached_op
    pair = cached_op._Pair()
    pair.n_in, pair.owner = len(inputs), None
    pair.static_in = [x.detach().clone().requires_grad_(rg)
                      for x, rg in zip(inputs, needs)]
    subs = {p: p._var.detach().requires_grad_() for p in tparams}
    wrt = [s for s in pair.static_in if s.requires_grad] \
        + list(subs.values())
    live = {}

    def fwd():
        with cached_op.Inside(), mt.autograd._RecordingStateScope(
                True, training), torch.enable_grad():
            live["outs"] = entry.forward(pair.static_in, training, subs)
        for s, o in zip(pair.static_out, live["outs"]):
            s.copy_(o.detach())

    def bwd():
        with torch.enable_grad():
            grads = torch.autograd.grad(
                [live["outs"][i] for i in pair.grad_of], wrt,
                pair.out_grad, allow_unused=True, retain_graph=True)
        for s, g in zip(bufs, grads):
            s.copy_(g)

    with torch.enable_grad():
        outs = entry.forward(pair.static_in, training, subs)
    pair.static_out = [o.detach().clone() for o in outs]
    pair.grad_of = [i for i, o in enumerate(outs) if o.requires_grad]
    pair.out_grad = [torch.empty_like(outs[i]) for i in pair.grad_of]
    bufs = [torch.empty_like(w) for w in wrt]
    it = iter(bufs)
    pair.static_grads = [next(it) if rg else None for rg in needs] \
        + [next(it) for _ in tparams]
    pair.fwd, pair.bwd = _FakeGraph(fwd), _FakeGraph(bwd)
    return pair


@pytest.fixture
def fake_card(monkeypatch):
    """CachedOp's card route (pairs of captured forward and backward
    graphs replayed through ``_Replay``) on the CPU, with the captures
    stood in for by ``_fake_capture_pair``."""
    from incubator_mxnet_tpu_torch.graph.cached_op import CachedOp
    monkeypatch.setattr(CachedOp, "_on_card", lambda self, inputs: True)
    monkeypatch.setattr(CachedOp, "_capture_pair", _fake_capture_pair)


@pytest.mark.parametrize("level", ["0", "1"])
def test_cachedop_busy_pair_takes_another(fake_card, monkeypatch, level):
    """A recorded call whose key's pair waits for its backward replays a
    pair of its own: three chained calls hold three pairs, bit-equal to
    the eager chain, and the next iteration reuses them (jit mode at
    level 0, graph mode at 1)."""
    monkeypatch.setenv("MXTPU_GRAPH_OPT", level)
    P = _Pkg("port")
    x0 = np.random.RandomState(8).rand(4, 8).astype("f")
    net = _cell(P)
    eager = _chained_grads(P, net, x0)
    net.hybridize()
    for _ in range(2):
        for h, e in zip(_chained_grads(P, net, x0), eager):
            assert np.array_equal(h, e)
        assert net._cached_op.trace_count == 3
    assert net._cached_op.stats()["modes"] == [
        "jit" if level == "0" else "graph"]
    (entry,) = net._cached_op._entries.values()
    (pairs,) = entry.captures.values()
    assert len(pairs) == 3 and not any(p.busy() for p in pairs)
    # a recorded call whose graph is freed without a backward frees its
    # pair too
    with mt.autograd.record():
        net(P.array(x0)).sum()
    gc.collect()
    assert not any(p.busy() for p in pairs)


def test_cachedop_second_backward_through_a_replay_raises(fake_card):
    P = _Pkg("port")
    net = _cell(P)
    net.hybridize()
    with mt.autograd.record():
        y = net(P.array(np.ones((2, 8), "f"))).sum()
    y.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="once per forward"):
        y.backward()


def test_cachedop_entry_does_not_pin_input_arrays():
    P = _Pkg("port")
    net = P.mlp()
    net.hybridize()
    x = P.array(np.random.RandomState(0).rand(3, 8).astype("f"))
    net(x)
    ref = weakref.ref(x)
    del x
    gc.collect()
    assert ref() is None, "CachedOp entry retained the input NDArray"


def test_symbolblock_hybridized_graph_mode():
    def case(P):
        S = P.m.sym
        x = S.Variable("sbx")
        y = S.tanh(S.FullyConnected(x, num_hidden=3, name="sbfc"))
        blk = P.m.gluon.SymbolBlock(
            y, x, params={"sbfc_weight": P.array(np.ones((3, 4), "f")),
                          "sbfc_bias": P.array(np.zeros(3, "f"))})
        v = P.array(np.random.RandomState(1).rand(2, 4).astype("f"))
        eager = blk(v).asnumpy()
        blk.hybridize()
        outs = [blk(v).asnumpy(), blk(v).asnumpy()]
        return blk._cached_op.stats(), eager, outs
    got = _both(case)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0]["modes"] == ["graph"]
    for o in got["port"][2]:
        assert np.array_equal(o, got["port"][1])
        np.testing.assert_allclose(o, got["jax"][1], **TOL)


def test_cachedop_batchnorm_stats_equal_eager_after_training_calls():
    """N hybridized training calls move the moving stats as N eager
    calls do (and the outputs and gradients agree bit for bit)."""
    def run(hybrid):
        nn = mt.gluon.nn
        net = nn.HybridSequential()
        with mt.name.Prefix("bnstat_"):
            net.add(nn.Dense(6, in_units=5), nn.BatchNorm(in_channels=6),
                    nn.Activation("relu"), nn.Dense(3, in_units=6))
        mt.random.seed(0)
        net.initialize(mt.init.Xavier(), ctx=CPU)
        if hybrid:
            net.hybridize()
        rs = np.random.RandomState(0)
        outs = []
        for _ in range(3):
            x = mt.nd.array(rs.randn(8, 5).astype("f"), ctx=CPU)
            with mt.autograd.record():
                y = net(x)
            y.backward()
            outs.append(y.asnumpy())
        params = {k[k.index("_") + 1:]: p.data().asnumpy()
                  for k, p in net.collect_params().items()}
        grads = {k[k.index("_") + 1:]: p.grad().asnumpy()
                 for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        return outs, params, grads, net
    e_outs, e_params, e_grads, _ = run(False)
    h_outs, h_params, h_grads, net = run(True)
    assert net._cached_op.stats()["modes"] == ["graph"]
    assert net._cached_op.stats()["traces"] == 1
    for a, b in zip(e_outs, h_outs):
        assert np.array_equal(a, b)
    for k in e_params:
        assert np.array_equal(e_params[k], h_params[k]), k
    for k in e_grads:
        assert np.array_equal(e_grads[k], h_grads[k]), k


def test_hybridized_child_runs_directly_inside_outer_trace():
    nn = mt.gluon.nn
    outer = nn.HybridSequential()
    inner = nn.HybridSequential()
    inner.add(nn.Dense(4, in_units=4))
    outer.add(inner, nn.Activation("tanh"))
    outer.initialize(ctx=CPU)
    outer.hybridize()            # children too
    x = mt.nd.ones((2, 4), ctx=CPU)
    outer(x)
    outer(x)
    assert outer._cached_op.stats()["hits"] == 1
    assert inner._cached_op is None     # never called on its own
    # torch tensors (torch's rules) run the forward directly
    assert isinstance(outer(torch.ones(2, 4)), torch.Tensor)


def test_cast_and_hybridize_reset_the_cache():
    net = _Pkg("port").mlp()
    net.hybridize()
    net(mt.nd.ones((2, 8), ctx=CPU))
    assert net._cached_op is not None
    net.cast("float32")
    assert net._cached_op is None
    net(mt.nd.ones((2, 8), ctx=CPU))
    net.hybridize()
    assert net._cached_op is None


def test_graph_flags_default_and_parse(monkeypatch):
    from incubator_mxnet_tpu_torch.graph.passes import env_flag
    monkeypatch.delenv("MXTPU_GRAPH_OPT", raising=False)
    monkeypatch.delenv("MXTPU_CACHEDOP_CAPACITY", raising=False)
    assert env_flag("MXTPU_GRAPH_OPT") == 1
    assert env_flag("MXTPU_CACHEDOP_CAPACITY") == 64
    monkeypatch.setenv("MXTPU_GRAPH_OPT", "2")
    assert env_flag("MXTPU_GRAPH_OPT") == 2
    assert os.environ["MXTPU_GRAPH_OPT"] == "2"


def test_captures_drop_when_parameter_storage_moves():
    """A captured graph reads parameters by address: a cast (new
    storage) drops an entry's captures, a write in place keeps them."""
    from incubator_mxnet_tpu_torch.gluon.parameter import storage_epoch
    net = _Pkg("port").mlp()
    net.hybridize()
    net(mt.nd.ones((2, 8), ctx=CPU))
    co = net._cached_op
    (entry,) = co._entries.values()
    co._check_storage()
    entry.captures["infer"] = "captured"
    p = next(iter(net.collect_params().values()))
    p.set_data(np.zeros(p.shape, "float32"))       # in place
    co._check_storage()
    assert entry.captures == {"infer": "captured"}
    before = storage_epoch()
    p.cast("float64")
    assert storage_epoch() > before
    co._check_storage()
    assert entry.captures == {}
