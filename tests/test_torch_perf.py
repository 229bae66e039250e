"""The port's perf observatory against the JAX package's, on the CPU:
the analytic cost model, the device table, the MFU clock and the memory
planner (twins of ``tests/test_perf.py`` and ``tests/test_memory_planner
.py`` as far as they apply to one device).

- ``symbol_cost``: FLOPs, bytes, per-family totals and coverage equal to
  the JAX package's exactly on the MLP, a ResNet basic block and a
  2-layer d=64 transformer step Symbol (bench.py's three graphs, built
  from each package's ``sym``); FlopCounterMode's count of the products
  (``jit_cost`` / ``Module.perf_report``) within 10% of the analytic
  count of the same families; every one of the registry's 327 op names
  covered.
- The memory planner: ``symbol_liveness`` and ``plan_memory``'s
  categories equal to the JAX package's (at its elementwise constant);
  the preflight's remat, grad_accum and dry-ladder rungs with their
  counter, events and gauge; ``next_divisor``; the ShardedTrainStep and
  Module preflights; ``dispatch_liveness`` on a transformer step with flash
  attention as its outputs alone.
- The device table: the H100 row's datasheet peaks, the fp32/tf32 rule,
  an unknown card marked nominal, the CPU overrides and the roofline.
- The clock: on a (stand-in) card it publishes from event intervals and
  never synchronizes or reads a device value; Trainer.arm_perf and
  ShardedTrainStep.cost_analysis arm it.
"""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import perf as jperf  # noqa: E402
from incubator_mxnet_tpu import symbol as jsym  # noqa: E402
from incubator_mxnet_tpu.perf import memory_planner as jmp  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import perf  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as rz  # noqa: E402
from incubator_mxnet_tpu_torch import telemetry, tracing  # noqa: E402
from incubator_mxnet_tpu_torch.ops import registry  # noqa: E402
from incubator_mxnet_tpu_torch.perf import device_db  # noqa: E402
from incubator_mxnet_tpu_torch.perf import memory_planner as mp  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
GRAPH_INPUTS = {"mlp": {"data", "label"}, "resnet_block": {"data"},
                "transformer": {"tokens", "labels"}}


def _bench():
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("bench")
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXTPU_FAULT_SPEC", "MXTPU_MEM_POLICY", "MXTPU_HBM_BYTES",
                "MXTPU_MEM_GATE_MARGIN", "MXTPU_PERF_INTERVAL",
                "MXTPU_PERF_CPU_PEAK_GFLOPS", "MXTPU_PERF_CPU_GBPS"):
        monkeypatch.delenv(var, raising=False)
    telemetry.get_registry().reset()
    tracing.reset_for_tests()
    yield
    telemetry.get_registry().reset()
    tracing.reset_for_tests()


def _resnet_block(M, S, channels=64, hw=16, batch=2):
    """bench.py's ResNet block graph (BasicBlockV1 traced through the
    Gluon symbol frontend), in either package."""
    resnet = importlib.import_module(
        f"{M.__name__}.gluon.model_zoo.vision.resnet")
    kw = {} if M is mx else {"ctx": CPU}
    with M.name.Prefix("rb_"):
        blk = resnet.BasicBlockV1(channels, 1, in_channels=channels)
    blk.initialize(M.init.Xavier(), **kw)
    blk(M.nd.zeros((batch, channels, hw, hw), **kw))
    with M.name.Prefix("rb_"):
        out = blk._to_symbol(S.Variable("data"))
    return out, {"data": (batch, channels, hw, hw)}


def _graph(name, M):
    S = jsym if M is mx else mt.sym
    bench = _bench()
    if name == "mlp":
        return bench._graph_mlp(S)
    if name == "resnet_block":
        return _resnet_block(M, S)
    return bench._graph_transformer_step(S, D=64, n_layers=2)


GRAPHS = ["mlp", "resnet_block", "transformer"]


@pytest.fixture(scope="module")
def graphs():
    return {n: {M: _graph(n, M) for M in (mx, mt)} for n in GRAPHS}


# ------------------------------------------------------------ cost model
@pytest.mark.parametrize("name", GRAPHS)
def test_symbol_cost_equals_jax(graphs, name):
    (sj, shj), (st, sht) = graphs[name][mx], graphs[name][mt]
    rj, rt = jperf.symbol_cost(sj, shj), perf.symbol_cost(st, sht)
    assert rt.flops == rj.flops and rt.bytes == rj.bytes
    assert rt.per_family == rj.per_family
    assert rt.coverage == rj.coverage and rt.n_nodes == rj.n_nodes
    assert rt.coverage["unknown"] == 0 and rt.coverage["default"] == 0
    train = rt.scaled(3.0)
    assert train.flops == 3.0 * rt.flops
    caps = device_db.caps_for_kind("NVIDIA H100 80GB HBM3")
    rows = train.table(caps, "bfloat16")
    assert rows == rj.scaled(3.0).table(caps, "bfloat16")
    assert sum(r["flops_pct"] for r in rows) == pytest.approx(100, abs=0.5)


PRODUCTS = ("matmul", "conv", "attention")


@pytest.mark.parametrize("name", GRAPHS)
def test_flop_counter_within_10pct_of_analytic(graphs, name):
    """FlopCounterMode counts the products of the bound graph's forward
    on meta tensors; the analytic count of the same families is within
    10% (bias adds ride in the FullyConnected formula)."""
    from incubator_mxnet_tpu_torch.executor import build_graph_fn
    s, shapes = graphs[name][mt]
    rep = perf.symbol_cost(s, shapes)
    arg_shapes, _, aux_shapes = s.infer_shape_partial(**shapes)
    meta = {n: torch.empty(sh, device="meta") for n, sh in
            zip(s.list_arguments(), arg_shapes)}
    for n in GRAPH_INPUTS[name] & set(meta):
        if n in ("label", "tokens", "labels"):
            meta[n] = torch.zeros(shapes[n], dtype=torch.int32,
                                  device="meta")
    aux = {n: torch.empty(sh, device="meta") for n, sh in
           zip(s.list_auxiliary_states(), aux_shapes)}
    run = build_graph_fn(s, default_device=torch.device("meta"))
    cost = perf.jit_cost(lambda: run(meta, aux, lambda f, d: None, False))
    assert cost is not None and cost["flops"] > 0 and cost["bytes"] > 0
    analytic = sum(rep.per_family.get(f, {}).get("flops", 0.0)
                   for f in PRODUCTS)
    assert abs(analytic - cost["flops"]) / cost["flops"] <= 0.10, \
        (analytic, cost["flops"])


def test_cost_model_covers_every_registered_op():
    assert len(registry.OPS) == 327
    names = {op.name for op in registry.OPS.values()}
    assert perf.coverage_gaps(names) == []
    assert perf.coverage_gaps(registry.OPS) == [] or all(
        registry.OPS[k].name in perf.covered_ops() for k in registry.OPS)
    assert perf.covered_ops() == jperf.covered_ops()


def test_transformer_formulas_match_jax():
    kw = dict(d_model=64, n_layers=2, vocab=128, n_heads=4)
    for fn in ("transformer_train_flops_per_token",):
        assert getattr(perf, fn)(seq_len=32, **kw) == \
            getattr(jperf, fn)(seq_len=32, **kw)
    assert perf.transformer_decode_flops_per_token(context_len=12, **kw) \
        == jperf.transformer_decode_flops_per_token(context_len=12, **kw)
    a = perf.transformer_decode_cost(context_len=12, batch=4, **kw)
    b = jperf.transformer_decode_cost(context_len=12, batch=4, **kw)
    assert a.per_family == b.per_family and a.flops == b.flops
    from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
        TransformerLM
    net = TransformerLM(128, d_model=64, n_layers=2, n_heads=4,
                        max_len=32, device="cpu")
    assert net.train_flops_per_token(32) == \
        perf.transformer_train_flops_per_token(seq_len=32, **kw)


# ------------------------------------------------------------ device table
def test_h100_row_and_fp32_rule(monkeypatch):
    h = device_db.caps_for_kind("NVIDIA H100 80GB HBM3")
    assert not h.nominal and not h.nominal_hbm
    assert h.peak("bfloat16") == h.peak(torch.float16) == 989.4e12
    assert h.peak("int8") == 1979e12
    assert h.hbm_bytes_per_s == 3.35e12 and h.capacity() == 80e9
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert h.peak("float32") == h.peak(torch.float32) == 66.9e12
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert h.peak("float32") == 494.7e12 == h.peak("tf32")
    assert all("tpu" not in c.kind and "v5" not in c.kind
               for c in device_db.DEVICE_DB)
    monkeypatch.setenv("MXTPU_HBM_BYTES", "1000")
    assert h.capacity() == 1000.0


def test_unknown_card_is_nominal(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 PCIe")
    caps = device_db.caps_for(torch.device("cuda", 0))
    assert caps.nominal and caps.kind == "NVIDIA H100 PCIe"
    assert caps.peak("bfloat16") != 989.4e12
    assert device_db.peak_flops(torch.device("cuda", 0)) is None
    monkeypatch.setenv("MXTPU_PERF_CPU_PEAK_GFLOPS", "50")
    monkeypatch.setenv("MXTPU_PERF_CPU_GBPS", "10")
    cpu = device_db.caps_for(CPU)
    assert cpu.nominal and cpu.peak("float32") == 50e9
    assert cpu.hbm_bytes_per_s == 10e9
    caps = device_db.DeviceCaps("test", 100e9, 100.0)
    assert device_db.roofline(200e9, 1e9, caps)["bound"] == "compute"
    assert device_db.roofline(1e9, 200e9, caps)["bound"] == "memory"
    assert device_db.roofline(1e9, 1e9, caps)["bound"] == "balanced"
    assert device_db.roofline(0, 0, caps)["bound"] == "idle"


# ------------------------------------------------------------ the clock
class _FakeEvent:
    """A CUDA event stand-in on a device clock the test advances."""
    now = [0.0]
    device_at = [0.0]

    def record(self, stream=None):
        self.t = _FakeEvent.now[0]

    def query(self):
        return self.t <= _FakeEvent.device_at[0]

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_clock_publishes_device_time_without_host_reads(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("the clock synchronized")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.Tensor, "item", no_sync)
    monkeypatch.setenv("MXTPU_PERF_INTERVAL", "4")
    clock = perf.TrainPerfClock(flops_per_step=989.4e12 * 0.01,
                                tokens_per_step=1000, device=CPU,
                                dtype="bfloat16")
    clock._device = torch.device("cuda", 0)
    clock._caps = device_db.caps_for_kind("NVIDIA H100 80GB HBM3")
    clock._new_event = _FakeEvent
    _FakeEvent.now[0] = _FakeEvent.device_at[0] = 0.0
    for _ in range(9):        # the host runs ahead: device 0.02 s a step
        _FakeEvent.now[0] += 0.02
        clock.tick()
    assert clock.poll() == 2 and not clock.windows    # nothing resolved
    _FakeEvent.device_at[0] = 0.14                  # first window done
    assert clock.poll() == 1
    assert list(clock.windows) == [(3, pytest.approx(0.06))]
    g = telemetry.get_registry()
    assert g.gauge("train_mfu").value == pytest.approx(0.5)
    assert g.gauge("train_tokens_per_sec").value == pytest.approx(5e4)
    _FakeEvent.device_at[0] = 1.0
    assert clock.poll() == 0 and len(clock.windows) == 2


def test_trainer_arm_perf_adds_no_guard_reads(monkeypatch):
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_GUARD_INTERVAL", "4")
    monkeypatch.setenv("MXTPU_PERF_INTERVAL", "2")
    from incubator_mxnet_tpu_torch import optimizer as opt_mod
    reads = []
    orig = opt_mod.read_window_bad
    monkeypatch.setattr(opt_mod, "read_window_bad",
                        lambda g: reads.append(1) or orig(g))
    rs = np.random.RandomState(0)
    net = mt.gluon.nn.Dense(3, in_units=10)
    net.initialize(mt.init.Xavier(), ctx=CPU)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01})
    clock = tr.arm_perf(flops_per_step=1e9, bytes_per_step=1e8,
                        tokens_per_step=10)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(8):
        x = mt.nd.array(rs.randn(10, 10).astype("f4"), ctx=CPU)
        y = mt.nd.array(rs.randint(0, 3, 10).astype("f4"), ctx=CPU)
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(10)
    assert len(reads) == 2 and clock is tr._perf_clock
    gauges = telemetry.snapshot()["gauges"]
    assert gauges["train_mfu"] > 0 and gauges["train_mbu"] > 0
    assert gauges["train_tokens_per_sec"] > 0


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("name", GRAPHS)
def test_plan_categories_equal_jax(graphs, name):
    (sj, shj), (st, sht) = graphs[name][mx], graphs[name][mt]
    lj = jmp.symbol_liveness(sj, shj, input_names=GRAPH_INPUTS[name])
    lt = mp.symbol_liveness(st, sht, input_names=GRAPH_INPUTS[name])
    assert lt == lj
    for kw in (dict(), dict(donate=False), dict(grad_accum=2),
               dict(remat=True), dict(train=False),
               dict(optimizer_bytes=1e6)):
        a = mp.plan_memory(liveness=lt, **kw).as_dict()
        b = jmp.plan_memory(liveness=lj, **kw).as_dict()
        assert a == b, kw


def test_next_divisor_and_tree_bytes():
    assert [mp.next_divisor(32, c) for c in (1, 2)] == [2, 4]
    assert mp.next_divisor(12, 2) == 3 and mp.next_divisor(12, 6) == 12
    assert mp.next_divisor(12, 12) is None and mp.next_divisor(0, 1) is None
    tree = {"w": torch.empty(64, 32), "b": [torch.empty(32,
                                                        dtype=torch.bfloat16)],
            "i": np.zeros(7, np.int32)}
    assert mp.tree_bytes(tree) == 64 * 32 * 4 + 32 * 2 + 7 * 4
    assert mp.max_leaf_bytes(tree) == 64 * 32 * 4
    assert mp.sharded_tree_bytes(tree) == mp.tree_bytes(tree)
    mesh = mt.parallel.make_mesh(dp=2, devices=["cpu"] * 2)
    by_dp = {"w": mt.parallel.named_sharding(mesh, "dp")}
    assert mp.sharded_tree_bytes({"w": tree["w"]}, by_dp) == 32 * 32 * 4
    assert mp.max_leaf_bytes({"w": tree["w"]}, by_dp) == 32 * 32 * 4


def _counter(name):
    return telemetry.get_registry().counter(name).value


def test_preflight_rungs_counters_and_events(graphs, monkeypatch):
    s, shapes = graphs["mlp"][mt]
    live = mp.symbol_liveness(s, shapes, input_names=GRAPH_INPUTS["mlp"])

    def make(remat, accum):
        return mp.plan_memory(liveness=live, remat=remat,
                              grad_accum=accum)

    base, remat = make(False, 1).total(), make(True, 1).total()
    assert remat < base
    monkeypatch.setenv("MXTPU_MEM_GATE_MARGIN", "0")
    monkeypatch.setenv("MXTPU_HBM_BYTES", str(int((base + remat) / 2)))
    res = mp.preflight(make, site="t", can_remat=True, batch_size=32)
    assert res.rungs == ["remat"] and res.remat and res.grad_accum == 1
    assert _counter("memory_plan_degrades_total") == 1
    evs = tracing.events("mem_degrade", site="t")
    assert evs[0]["rung"] == "remat" and evs[0]["predicted_bytes"] == base
    assert telemetry.get_registry().gauge(
        "memory_plan_peak_bytes").value == remat
    published = tracing.memory_plan()
    assert published["predicted_bytes"] == remat
    assert published["categories"]["activations"] == make(True, 1).activations

    def shrink(remat, accum):
        return mp.MemoryPlan(params=100.0, activations=1000.0 / accum)

    monkeypatch.setenv("MXTPU_HBM_BYTES", "400")
    res = mp.preflight(shrink, site="t", can_remat=False, batch_size=8)
    assert res.rungs == ["grad_accum=2", "grad_accum=4"]
    assert res.grad_accum == 4 and res.plan.total() == 350.0
    monkeypatch.setenv("MXTPU_HBM_BYTES", "1000")
    with pytest.raises(rz.MemoryPlanError) as ei:
        mp.preflight(lambda r, a: mp.MemoryPlan(params=1e12), site="gate",
                     can_remat=True, batch_size=4)
    assert ei.value.rungs == ["remat", "grad_accum=2", "grad_accum=4"]
    assert "gate" in str(ei.value) and "params=" in str(ei.value)
    monkeypatch.setenv("MXTPU_MEM_POLICY", "off")
    assert mp.preflight(lambda r, a: mp.MemoryPlan(params=1e12),
                        site="t") is None


def _tiny_lm_step(batch=4, **kw):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
        TransformerLM
    net = TransformerLM(64, d_model=64, n_layers=2, n_heads=4, max_len=32,
                        device="cpu")
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(0))
    step = mt.parallel.ShardedTrainStep(net, "adam",
                                        dict(learning_rate=1e-3), **kw)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 64, (batch, 32), generator=g)
    return step, x, torch.randint(0, 64, (batch, 32), generator=g)


def test_sharded_step_preflight_cost_and_ladder(monkeypatch):
    """The transformer step plans its activations from the ops its
    forward dispatches on meta, flash attention as its outputs alone; cost_analysis counts a whole
    step on meta (within 10% of the 3x-forward formula) and arms the
    clock; a capacity under the plan takes remat, a smaller one
    grad_accum=2, none at all raises; no planning on the hot path."""
    step, x, y = _tiny_lm_step()
    cost = step.cost_analysis(x, y)
    want = step.block.train_flops_per_token(32) * x.numel()
    assert abs(cost["flops"] - want) / want <= 0.10
    assert step._perf_clock is not None
    plan = step.memory_analysis(x, y)
    assert plan.activations > 0 and plan.grads == mp.tree_bytes(step.params)
    float(step(x, y))
    assert step._mem_plan.total() == plan.total()
    monkeypatch.setattr(mp, "preflight", lambda *a, **k: 1 / 0)
    float(step(x, y))                   # planned once, never again

    monkeypatch.undo()
    monkeypatch.setenv("MXTPU_MEM_GATE_MARGIN", "0")
    # at 16 sequences the activations outweigh grad_accum's accumulator
    step, x, y = _tiny_lm_step(batch=16)
    full = step.memory_analysis(x, y).total()
    remat = step._memory_plan(True, 1).total()
    accum = step._memory_plan(True, 2).total()
    assert accum < remat < full
    for cap, knobs in ((remat, (True, 1)), (accum, (True, 2))):
        monkeypatch.setenv("MXTPU_HBM_BYTES", str(int(cap) + 1))
        s2, x2, y2 = _tiny_lm_step(batch=16)
        assert np.isfinite(float(s2(x2, y2)))
        assert (s2.remat, s2.grad_accum) == knobs
    monkeypatch.setenv("MXTPU_HBM_BYTES", "1000")
    s3, x3, y3 = _tiny_lm_step()
    with pytest.raises(rz.MemoryPlanError):
        s3(x3, y3)


def test_module_bind_preflight_and_perf_report(monkeypatch):
    data = mt.sym.Variable("data")
    fc1 = mt.sym.FullyConnected(data, num_hidden=512, name="fc1")
    act = mt.sym.Activation(fc1, act_type="relu")
    fc2 = mt.sym.FullyConnected(act, num_hidden=64, name="fc2")
    out = mt.sym.SoftmaxOutput(fc2, name="softmax")
    mod = mt.mod.Module(out, context=CPU)
    mod.bind(data_shapes=[("data", (64, 256))],
             label_shapes=[("softmax_label", (64,))])
    mod.init_params(initializer=mt.initializer.Xavier())
    rep = mod.perf_report()
    assert "matmul" in {r["family"] for r in rep["per_family"]}
    assert rep["total"]["gflops"] > 0 and rep["coverage"]["unknown"] == 0
    assert rep["roofline"]["bound"] in ("compute", "memory", "balanced")
    assert rep["device"]["nominal"] is True
    assert rep["flop_counter_check"]["rel_delta"] <= 0.10
    monkeypatch.setenv("MXTPU_HBM_BYTES", "1000")
    mod2 = mt.mod.Module(out, context=CPU)
    with pytest.raises(rz.MemoryPlanError, match="module_bind"):
        mod2.bind(data_shapes=[("data", (8, 20))],
                  label_shapes=[("softmax_label", (8,))])
    monkeypatch.setenv("MXTPU_MEM_POLICY", "warn")
    mod3 = mt.mod.Module(out, context=CPU)
    mod3.bind(data_shapes=[("data", (8, 20))],
              label_shapes=[("softmax_label", (8,))])
    assert mod3.binded
