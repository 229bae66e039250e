"""The port's reshardable checkpoints and its dp x tp ShardedTrainStep
(incubator_mxnet_tpu_torch.parallel.{sharding,checkpoint,
data_parallel}) against the JAX package's, on the CPU.

- The slice arithmetic (``spec_to_json``/``spec_from_json``,
  ``bounds_of``, ``shard_bounds``, ``intersect_bounds``) equals the JAX
  functions' bit for bit on every dp x tp factorization of 1/2/4/8
  devices.
- One-process generations: corrupt-shard fallback, pruning, the data
  companion, a loud structure mismatch, an uncommitted re-save.
- A generation the JAX ``ShardedTrainStep`` wrote on 4 virtual devices
  (dp=2 x tp=2) restores into the port's step bit for bit; a generation
  the port wrote over a world of ranks restores into the JAX step bit
  for bit; ``Module``'s sharded checkpoint crosses too.
- The elastic twin (``tests/torch_elastic_worker.py``, one spawned world
  of 4 gloo ranks): dp=2 x tp=2, shrunk to dp=1 x tp=2, grown back;
  every restore bitwise, the losses within rtol 1e-5 of the port's
  uninterrupted run and 1e-4 of the JAX trajectory from the same
  weights.  In the same world, Megatron tp on the port's TransformerLM
  against one process's step (rtol 1e-5 on losses, 1e-6 on
  parameters).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding as JSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jpar  # noqa: E402
from incubator_mxnet_tpu.parallel import sharding as jsh  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import parallel as tpar  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as rz  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import checkpoint as ck  # noqa
from incubator_mxnet_tpu_torch.parallel import sharding as tsh  # noqa
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401
import torch_elastic_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_DEADLINE_S = 180


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("MXTPU_FAULT_SPEC", raising=False)
    rz.reset_faults()
    yield
    rz.reset_faults()


def _mesh_configs():
    return [(n, n // tp, tp) for n in (1, 2, 4, 8) for tp in (1, 2, 4, 8)
            if n % tp == 0]


# ----------------------------------------------------------- slice math
def test_spec_json_matches_jax():
    for spec in ((), ("tp",), (None, "tp"), (("dp", "tp"), None),
                 ("dp", None, "tp")):
        j = jsh.spec_to_json(JP(*spec))
        assert tsh.spec_to_json(tpar.P(*spec)) == j
        assert tuple(tsh.spec_from_json(j)) == tuple(jsh.spec_from_json(j))


@pytest.mark.parametrize("n,dp,tp", _mesh_configs())
def test_shard_bounds_match_jax(n, dp, tp):
    jmesh = jpar.make_mesh(dp=dp, tp=tp, devices=jax.devices("cpu")[:n])
    tmesh = tpar.make_mesh(dp=dp, tp=tp, devices=["cpu"] * n)
    for shape in ((16, 8), (8, 16), (16,), (8, 8, 3), (7, 5), ()):
        specs = [()]
        if shape:
            specs += [(a,) for a in ("tp", "dp", ("dp", "tp"))
                      if shape[0] % (n if a == ("dp", "tp")
                                     else {"tp": tp, "dp": dp}[a]) == 0]
        if len(shape) > 1:
            specs += [(None, "tp"), ("dp", "tp")]
            specs = [s for s in specs if len(s) < 2 or (
                (s[0] is None or shape[0] % dp == 0)
                and shape[1] % tp == 0)]
        for spec in specs:
            jb = jsh.shard_bounds(JSharding(jmesh, JP(*spec)), shape)
            tb = tsh.shard_bounds(tpar.named_sharding(tmesh, *spec), shape)
            assert tb == {b: [d.id for d in devs]
                          for b, devs in jb.items()}, (spec, shape)
            jm = JSharding(jmesh, JP(*spec)).devices_indices_map(shape)
            tm = tpar.named_sharding(tmesh, *spec).devices_indices_map(
                shape)
            assert {d.id: jsh.bounds_of(i, shape) for d, i in jm.items()} \
                == {d: tsh.bounds_of(i, shape) for d, i in tm.items()}


def test_intersect_bounds_matches_jax():
    rs = np.random.RandomState(0)
    for _ in range(200):
        nd = rs.randint(0, 3)
        a, b = [tuple(tuple(sorted(rs.randint(0, 9, 2)))
                      for _ in range(nd)) for _ in range(2)]
        assert tsh.intersect_bounds(a, b) == jsh.intersect_bounds(a, b)


# ------------------------------------------------- one-process generations
def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(rs.rand(4, 3).astype("f4")),
                       "b": torch.from_numpy(rs.rand(3).astype("f4"))},
            "opt_state": {"mean": [torch.from_numpy(
                rs.rand(2, 2).astype("f4"))],
                "t": torch.tensor(int(rs.randint(9)), dtype=torch.int32)}}


def _bitwise(got, want):
    g, w = dict(ck._flatten(got)), dict(ck._flatten(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert torch.equal(torch.as_tensor(g[k]), torch.as_tensor(w[k])), k


def test_generations_fallback_prune_and_companion(tmp_path, monkeypatch):
    mesh = tpar.make_mesh(devices=["cpu"])
    d = str(tmp_path / "ck")
    trees = [_tree(s) for s in range(4)]
    for step, t in enumerate(trees):
        ck.save_sharded(d, t, mesh, step=step, data_state={"cursor": step},
                        keep=3)
    assert ck.generations(d) == [3, 2, 1]          # the oldest pruned
    rz.damage_file(os.path.join(d, "gen-00000003", "shard-00000.pkl"),
                   "corrupt")
    with pytest.warns(RuntimeWarning, match="falling back"):
        got, manifest, gen_dir = ck.load_latest(d, _tree(9), mesh)
    _bitwise(got, trees[2])
    assert manifest["format"] == ck.FORMAT == "mxtpu-sharded-v1"
    assert ck.load_data_companion(gen_dir) == {"cursor": 2}
    with pytest.raises(ValueError, match="structure"):
        ck.load_latest(d, {"params": _tree()["params"]}, mesh)
    # an injected shard fault leaves the generation uncommitted
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "checkpoint:shard:1:error")
    rz.reset_faults()
    with pytest.raises(rz.TransientError):
        ck.save_sharded(d, trees[0], mesh, step=2)
    assert ck.generations(d) == [3, 1]             # step 2 uncommitted


# ------------------------------------------------- the JAX step, same weights
def _inputs():
    rs = np.random.RandomState(0)
    return dict(dense0_weight=(rs.randn(32, 16) * 0.3).astype("f4"),
                dense0_bias=(rs.randn(32) * 0.1).astype("f4"),
                dense1_weight=(rs.randn(4, 32) * 0.3).astype("f4"),
                dense1_bias=(rs.randn(4) * 0.1).astype("f4"),
                xs=rs.rand(8, 8, 16).astype("f4"),
                ys=rs.randint(0, 4, (8, 8)).astype("i4"))


def _jax_step(mesh, inp):
    net = mx.gluon.nn.HybridSequential(prefix="elck_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(32, activation="relu"),
                mx.gluon.nn.Dense(4))
    net.initialize(mx.initializer.Xavier())
    net(mx.nd.array(np.zeros((2, 16), "f4")))
    for name in ("dense0_weight", "dense0_bias", "dense1_weight",
                 "dense1_bias"):
        net.collect_params()["elck_" + name].set_data(
            mx.nd.array(inp[name]))
    rules = jpar.ShardingRules([
        (r"dense0_weight$", JP("tp", None)),
        (r"dense0_bias$", JP("tp")),
        (r"dense1_weight$", JP(None, "tp")),
    ])
    return jpar.ShardedTrainStep(
        net, optimizer="adam", optimizer_params=dict(learning_rate=1e-3),
        mesh=mesh, rules=rules,
        example_args=[jnp.zeros((2, 16), jnp.float32)])


def _jax_tree(step):
    leaves = jax.tree_util.tree_flatten_with_path(step._ckpt_tree())[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trajectory on dp=2 x tp=2 (4 virtual devices), 8 steps
    from the inputs' weights, and its generation after them."""
    inp = _inputs()
    step = _jax_step(jpar.make_mesh(dp=2, tp=2,
                                    devices=jax.devices("cpu")[:4]), inp)
    key = jax.random.PRNGKey(7)
    losses = [float(step(inp["xs"][i], inp["ys"][i], rng=key))
              for i in range(len(inp["xs"]))]
    d = str(tmp_path_factory.mktemp("jax_ck"))
    step.save_checkpoint(d)
    return {"losses": losses, "dir": d, "tree": _jax_tree(step),
            "numpy_tree": jax.tree_util.tree_map(np.asarray,
                                                 step._ckpt_tree())}


def test_jax_generation_restores_into_the_port(jax_run):
    """Both bridges: the JAX generation through the files, and the JAX
    step's numpy tree through ``convert.load_train_step_state``."""
    inp = _inputs()
    want = jax_run["tree"]
    for bridge in ("checkpoint", "convert"):
        step = worker.build(mt, tpar.make_mesh(devices=["cpu"]), inp)
        if bridge == "checkpoint":
            step.load_checkpoint(jax_run["dir"])
        else:
            mt.convert.load_train_step_state(step, jax_run["numpy_tree"])
        got = {k: v.numpy() for k, v in ck._flatten(step._ckpt_tree())}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                np.array_equal(got[k], want[k]), (bridge, k)
        assert step.step_count == 8 and float(step.opt_state["t"]) == 8.0
    with pytest.raises(ValueError, match="structure"):
        mt.convert.load_train_step_state(
            step, {"params": jax_run["numpy_tree"]["params"]})


# ---------------------------------------------------------------- Module
def test_module_sharded_checkpoint_crosses(tmp_path):
    """Module(kvstore='tpu').save_sharded_checkpoint in the port, read
    back by the port (bitwise) and by the JAX Module (bitwise)."""
    rs = np.random.RandomState(0)
    x = rs.rand(32, 10).astype("f4")
    y = rs.randint(0, 5, 32).astype("f4")
    mods = {}
    for M in (mt, mx):
        data = M.sym.Variable("data")
        sym = M.sym.SoftmaxOutput(M.sym.FullyConnected(
            data, name="fc", num_hidden=5), name="softmax")
        ctx = mt.cpu() if M is mt else mx.cpu()
        kw = dict(label_name="softmax_label")
        it = M.io.NDArrayIter(x, y, batch_size=8, **kw)
        mod = M.mod.Module(sym, context=ctx)
        if M is mx:
            with jpar.use_mesh(jpar.make_mesh(
                    devices=jax.devices("cpu")[:1])):
                mod.fit(it, num_epoch=1, kvstore="tpu", optimizer="sgd",
                        optimizer_params=dict(learning_rate=0.1,
                                              momentum=0.9),
                        initializer=M.initializer.Xavier())
        else:
            mod.fit(it, num_epoch=1, kvstore="tpu", optimizer="sgd",
                    optimizer_params=dict(learning_rate=0.1, momentum=0.9),
                    initializer=M.initializer.Xavier())
        mods[M] = mod
    d = str(tmp_path / "mod_ck")
    it = mt.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    next(iter(it))
    mods[mt].save_sharded_checkpoint(d, step=4, data_iter=it)
    want = {k: v.asnumpy() for k, v in mods[mt].get_params()[0].items()}
    mom = {k: v.numpy().copy()
           for k, v in mods[mt]._mesh_step.opt_state["mom"].items()}
    for M in (mt, mx):
        state = mods[M].load_sharded_checkpoint(d)
        assert state["cursor"] == it.state_dict()["cursor"]
        got = {k: v.asnumpy() for k, v in mods[M].get_params()[0].items()}
        for k in want:
            assert np.array_equal(got[k], want[k]), (M.__name__, k)
    jmom = mods[mx]._mesh_step.opt_state["mom"]
    for k in mom:
        assert np.array_equal(np.asarray(jmom[k]), mom[k]), k


# ---------------------------------------------------------------- exports
A9B = {"pipeline_apply", "stack_stage_params", "ring_attention",
       "ring_attention_local", "ulysses_attention",
       "ulysses_attention_local"}


def test_parallel_exports_match_jax_but_a9b():
    """``parallel`` exports the JAX package's names but the six of
    sequence and pipeline parallelism (A9b), each from its module."""
    assert set(tpar.__all__) <= set(jpar.__all__)
    assert set(jpar.__all__) - set(tpar.__all__) == A9B
    for name in ("ShardingRules", "tp_rules_for_dense_stacks",
                 "constrain"):
        assert getattr(tpar, name) is getattr(tsh, name), name
    for name in ("save_sharded", "load_sharded", "load_latest",
                 "load_data_companion"):
        assert getattr(tpar, name) is getattr(ck, name), name


# ---------------------------------------------------- the elastic world
@pytest.fixture(scope="module", autouse=True)
def elastic_world(tmp_path_factory):
    """One spawned world of 4 ranks running torch_elastic_worker.py,
    started with the module so that it runs while the in-process tests
    do; every rank still running at the module's end is killed."""
    work = str(tmp_path_factory.mktemp("elastic"))
    np.savez(os.path.join(work, "inputs.npz"), **_inputs())
    env = dict(os.environ, MXTPU_FORCE_CPU="1",
               MXTPU_COLLECTIVE_TIMEOUT="60", MXTPU_RETRY_MAX="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    try:
        for r in range(4):
            logs.append(open(os.path.join(work, f"rank{r}.log"), "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "torch_elastic_worker.py"),
                 str(r), work], env=env, cwd=ROOT,
                stdout=logs[r], stderr=subprocess.STDOUT))
        yield work, procs, logs, time.time() + WORLD_DEADLINE_S
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


@pytest.fixture(scope="module")
def elastic(elastic_world):
    """The world's result, once every rank has exited 0; a failed rank's
    log reaches the assertion."""
    work, procs, logs, deadline = elastic_world
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            r = bad[0] if bad else 0
            logs[r].flush()
            with open(logs[r].name, "rb") as f:
                tail = f.read()[-4000:].decode(errors="replace")
            pytest.fail(f"elastic rank {r} "
                        f"{'failed' if bad else 'timed out'}:\n{tail}")
        time.sleep(0.05)
    assert all(p.returncode == 0 for p in procs)
    with open(os.path.join(work, "result.json")) as f:
        result = json.load(f)
    return work, result


def test_elastic_twin_bitwise_and_uninterrupted(elastic):
    """The restores were checked bit for bit inside the ranks (shrink
    and grow); the interrupted trajectory tracks the uninterrupted one
    and two generations were committed."""
    _, res = elastic
    np.testing.assert_allclose(res["losses"], res["ref_losses"],
                               rtol=1e-5)
    assert res["gens"] == ["gen-00000004", "gen-00000006"]


def test_megatron_transformer_lm_matches_one_process(elastic):
    """dp=2 x tp=2 on the port's TransformerLM (attention through the
    DTensor route, heads split over tp): losses within rtol 1e-5 and
    every parameter within 1e-6 of one process's SGD step on the whole
    batch; 14 parameters sharded; one DTensor attention call a layer a
    step."""
    _, res = elastic
    np.testing.assert_allclose(res["lm_losses"], res["lm_ref_losses"],
                               rtol=1e-5)
    assert res["lm_param_err"] <= 1e-6, res["lm_param_err"]
    assert res["lm_sharded"] == 14
    assert res["lm_dtensor_attention_calls"] == 2 * 3


def test_apply_rules_and_constrain_on_a_world(elastic):
    """The default rules split an up projection's rows over tp=2 and
    leave a norm's scale whole; constrain() gathers it back."""
    _, res = elastic
    assert res["rules"] == {"up_local_shape": [4, 4],
                            "constrained_local_shape": [8, 4]}


def test_elastic_twin_tracks_jax(elastic, jax_run):
    _, res = elastic
    np.testing.assert_allclose(res["ref_losses"], jax_run["losses"],
                               rtol=1e-4)


def test_port_generation_restores_into_jax(elastic):
    """The port's dp=1 x tp=2 generation (two ranks' shard files) into
    the JAX step on dp=2 x tp=2: bit for bit."""
    work, _ = elastic
    step = _jax_step(jpar.make_mesh(dp=2, tp=2,
                                    devices=jax.devices("cpu")[:4]),
                     _inputs())
    step.load_checkpoint(os.path.join(work, "ck"))
    got = _jax_tree(step)
    want = dict(np.load(os.path.join(work, "tree_b.npz")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    files = sorted(os.listdir(os.path.join(work, "ck", "gen-00000006")))
    assert "shard-00001.pkl" in files      # rank 1 wrote its tp slices
