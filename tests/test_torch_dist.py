"""The port's processes (incubator_mxnet_tpu_torch.dist on
torch.distributed), its kvstore over workers, meshes over a world, and
two repairs, against the JAX package on the CPU.

- C10: ``FeedForward.fit(checkpoint_prefix=)`` arms the divergence
  rollback: three ``grad:nonfinite`` bad steps restore the newest
  checkpoint and raise, in both packages.
- C11: ``io``'s sharding helpers, ``utils``'s registry/env/log names and
  ``initializer.init`` are exported as in the JAX package.
- ``dist`` in one process: the env contract, the backend rule, the
  no-op single-process join, the reentrant ``shutdown``, identity
  collectives, the elastic probe.
- A 2-rank ``dist_sync`` world through the unchanged ``tools/launch.py``
  (``incubator_mxnet_tpu_torch/tools/dist_worker_check.py``): broadcast
  init, allreduced push, ``Module.fit``, a Gluon ``Trainer``, the guard's
  allreduce-max and a dp=2 ``ShardedTrainStep`` against one process's
  step (rtol 1e-5).
- ``Module(context=[...])`` gives the JAX Module's numbers (fp32, rtol
  1e-6); ``make_mesh``'s A9b axes raise; the memory planner's per-device
  bytes over shardings equal the JAX planner's.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding as JSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jpar  # noqa: E402
from incubator_mxnet_tpu import resilience as jrz  # noqa: E402
from incubator_mxnet_tpu.perf import memory_planner as jmp  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import parallel as tpar  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as rz  # noqa: E402
from incubator_mxnet_tpu_torch import telemetry  # noqa: E402
from incubator_mxnet_tpu_torch.perf import memory_planner as tmp_  # noqa
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("MXTPU_FAULT_SPEC", raising=False)
    rz.reset_faults()
    jrz.reset_faults()
    yield
    rz.reset_faults()
    jrz.reset_faults()


# ------------------------------------------------------------------ C10
def _ff_problem(M):
    rs = np.random.RandomState(0)
    x = rs.rand(64, 10).astype(np.float32)
    y = (x @ rs.rand(10, 5)).argmax(1).astype(np.float32)
    data = M.sym.Variable("data")
    net = M.sym.FullyConnected(data, name="fc", num_hidden=5)
    sym = M.sym.SoftmaxOutput(net, name="softmax")
    ctx = CPU if M is mt else mx.cpu()
    w = {"fc_weight": (rs.randn(5, 10) * 0.1).astype(np.float32),
         "fc_bias": np.zeros(5, np.float32)}
    args = {k: M.nd.array(v, ctx=ctx) if M is mt else M.nd.array(v)
            for k, v in w.items()}
    return x, y, sym, ctx, args


def _ff_rollback(M, prefix, monkeypatch):
    """Train one epoch, save epoch 0, then fit again under three
    poisoned steps with ``checkpoint_prefix``: (restored, saved,
    consecutive bad, rollbacks)."""
    r = rz if M is mt else jrz
    x, y, sym, ctx, args = _ff_problem(M)
    ff = M.model.FeedForward(sym, ctx=ctx, num_epoch=1,
                             numpy_batch_size=16, arg_params=args,
                             learning_rate=0.5)
    ff.fit(x, y)
    ff.save(prefix, 0)
    saved = {k: v.asnumpy().copy() for k, v in ff.arg_params.items()}
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_MAX_BAD_STEPS", "3")
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:*:nan")
    r.reset_faults()
    reg = (telemetry if M is mt else __import__(
        "incubator_mxnet_tpu.telemetry", fromlist=["x"])).get_registry()
    before = reg.counter("rollbacks_total").value
    ff2 = M.model.FeedForward(sym, ctx=ctx, num_epoch=1,
                              numpy_batch_size=16, arg_params=args,
                              learning_rate=0.5)
    with pytest.raises(r.DivergedError):
        ff2.fit(x, y, checkpoint_prefix=prefix)
    mod = ff2._module
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    monkeypatch.delenv("MXTPU_FAULT_SPEC")
    r.reset_faults()
    return (got, saved, mod._guard.consecutive_bad,
            reg.counter("rollbacks_total").value - before)


def test_feedforward_fit_checkpoint_prefix_rolls_back(tmp_path,
                                                      monkeypatch):
    out = {M: _ff_rollback(M, str(tmp_path / M.__name__), monkeypatch)
           for M in (mx, mt)}
    for M, (got, saved, bad, rollbacks) in out.items():
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
        assert bad == 3 and rollbacks == 1, (M.__name__, bad, rollbacks)


# ------------------------------------------------------------------ C11
@pytest.mark.parametrize("mod", ["io", "utils"])
def test_package_exports_match_jax(mod):
    import importlib
    j = importlib.import_module(f"incubator_mxnet_tpu.{mod}")
    t = importlib.import_module(f"incubator_mxnet_tpu_torch.{mod}")
    assert t.__all__ == j.__all__
    for name in t.__all__:
        obj = getattr(t, name)
        home = importlib.import_module(obj.__module__)
        assert getattr(home, name) is obj, name


def test_initializer_init_alias():
    init = mt.initializer.init
    assert type(init).__name__ == "_InitModule"
    names = {n for n in vars(type(init)) if not n.startswith("__")}
    assert names == {n for n in vars(type(mx.initializer.init))
                     if not n.startswith("__")}
    for name in names:
        assert getattr(init, name) is getattr(mt.initializer, name), name


# ------------------------------------------------------- dist, 1 process
def test_dist_single_process_contract(monkeypatch):
    d = mt.dist
    for k in ("MXTPU_NUM_WORKERS", "MXTPU_WORKER_RANK", "MXTPU_COORD_ADDR",
              "MXTPU_RANK_FROM_MPI"):
        monkeypatch.delenv(k, raising=False)
    assert sorted(set(mx.dist.__all__) - set(d.__all__)) == []
    assert d.init() == 0 and not d.is_initialized()
    assert d.rank() == 0 and d.num_workers() == 1
    assert d.backend() == d.backend(4) == "gloo"       # no card here
    assert d.group_backend() is None and d.rank_device().type == "cpu"
    v = torch.arange(3.0)
    assert d.allreduce_sum(v) is v and d.allreduce_max(v) is v
    assert d.broadcast(v) is v
    d.barrier()
    d.shutdown()
    d.shutdown()
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    with pytest.raises(RuntimeError, match="MXTPU_COORD_ADDR"):
        d.init()
    monkeypatch.setenv("MXTPU_RANK_FROM_MPI", "1")
    monkeypatch.setenv("PMI_RANK", "1")
    assert d._env_rank() == mx.dist._env_rank() == 1
    monkeypatch.delenv("PMI_RANK")
    for M in (d, mx.dist):
        with pytest.raises(RuntimeError, match="mpirun"):
            M._env_rank()
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "elastic:rank0:2:error")
    rz.reset_faults()
    monkeypatch.setenv("MXTPU_WORKER_RANK", "0")
    d.elastic_probe()
    with pytest.raises(rz.TransientError):
        d.elastic_probe()


def test_kvstore_and_mesh_over_workers_need_a_world(monkeypatch):
    """A 'dist' store joins the world; without a coordinator it raises
    the JAX package's error.  A mesh's sp/pp/ep above 1 is A9b."""
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.delenv("MXTPU_COORD_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="MXTPU_COORD_ADDR"):
        mt.kvstore.create("dist_sync")
    monkeypatch.delenv("MXTPU_NUM_WORKERS")
    assert mt.kvstore.create("dist_sync").num_workers == 1
    for kw in (dict(sp=2), dict(pp=2), dict(ep=2)):
        with pytest.raises(NotImplementedError, match="A9b"):
            tpar.make_mesh(1, devices=["cpu"] * 2, **kw)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tpar.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert mesh.active_axes() == ("dp", "tp")
    cases = [((), [Replicate(), Replicate()]),
             (("tp", None), [Replicate(), Shard(0)]),
             ((None, "tp"), [Replicate(), Shard(1)]),
             (("dp", "tp"), [Shard(0), Shard(1)]),
             ((("dp", "tp"),), [Shard(0), Shard(0)])]
    for spec, want in cases:
        assert tpar.named_sharding(mesh, *spec).placements() == want
    with pytest.raises(ValueError, match="order"):
        tpar.named_sharding(mesh, ("tp", "dp")).placements()
    with pytest.raises(NotImplementedError, match="one process"):
        mesh.device


def test_sharded_bytes_match_jax_planner():
    jmesh = jpar.make_mesh(dp=2, tp=2, devices=jax.devices("cpu")[:4])
    tmesh = tpar.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    specs = {"w": ("tp", None), "v": (None, "tp"), "b": ("dp",),
             "r": ()}
    shapes = {"w": (8, 6), "v": (6, 8), "b": (10,), "r": (3, 3)}
    jtree = {n: jax.ShapeDtypeStruct(s, np.float32)
             for n, s in shapes.items()}
    ttree = {n: torch.empty(s) for n, s in shapes.items()}
    jsh = {n: JSharding(jmesh, JP(*sp)) for n, sp in specs.items()}
    tsh = {n: tpar.named_sharding(tmesh, *sp) for n, sp in specs.items()}
    assert tmp_.sharded_tree_bytes(ttree, tsh) == \
        jmp.sharded_tree_bytes(jtree, jsh) == (24 + 24 + 5 + 9) * 4
    assert tmp_.max_leaf_bytes(ttree, tsh) == \
        jmp.max_leaf_bytes(jtree, jsh) == 24 * 4
    assert tmp_.sharded_tree_bytes(ttree) == tmp_.tree_bytes(ttree)


def test_module_context_list_gives_jax_numbers():
    """The JAX Module binds one executor over the whole batch for a
    context list: one update equals a single context's, in both."""
    rs = np.random.RandomState(0)
    x = rs.rand(8, 5).astype("f4")
    y = rs.randint(0, 3, 8).astype("f4")
    got = {}
    for M, ctxs in ((mx, [mx.cpu(0), mx.cpu(1)]), (mt, [CPU, mt.cpu(1)]),
                    (mt, CPU)):
        data = M.sym.Variable("data")
        net = M.sym.SoftmaxOutput(M.sym.FullyConnected(
            data, name="fc", num_hidden=3), name="softmax")
        mod = M.mod.Module(net, context=ctxs)
        mod.bind(data_shapes=[("data", (8, 5))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(M.initializer.Constant(0.1))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(learning_rate=0.5))
        ctx = None if M is mx else CPU
        arr = (lambda a: M.nd.array(a)) if M is mx else \
            (lambda a: M.nd.array(a, ctx=ctx))
        mod.forward(M.io.DataBatch([arr(x)], [arr(y)]), is_train=True)
        mod.backward()
        mod.update()
        got[(M.__name__, isinstance(ctxs, list))] = {
            k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    ref = got[("incubator_mxnet_tpu", True)]
    for key, vals in got.items():
        for k in ref:
            np.testing.assert_allclose(vals[k], ref[k], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} {k}")


# ---------------------------------------------- a 2-rank world (launcher)
@pytest.fixture(scope="module", autouse=True)
def launched_world(tmp_path_factory):
    """The unchanged launcher's two port workers (gloo on the CPU),
    started with the module so that they run while the in-process tests
    do; the launcher's process group is killed at the module's end if it
    is still running."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env.pop("MXTPU_FAULT_SPEC", None)
    env.update(MXTPU_FORCE_CPU="1", MXTPU_COLLECTIVE_TIMEOUT="60",
               MXTPU_RETRY_MAX="1")
    log = open(tmp_path_factory.mktemp("launch") / "launch.log", "w+b")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
         "-n", "2", "--", sys.executable,
         os.path.join(ROOT, "incubator_mxnet_tpu_torch", "tools",
                      "dist_worker_check.py")],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
        start_new_session=True)
    try:
        yield proc, log
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()


def test_launch_two_process_dist_sync(launched_world):
    """The kvstore, Module.fit, Trainer, guard and dp=2 step checks of
    dist_worker_check.py pass on both ranks.  The launcher tears the job
    down when a worker fails, and its output carries the traceback."""
    proc, log = launched_world
    try:
        proc.wait(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    log.flush()
    log.seek(0)
    out = log.read().decode(errors="replace")
    assert proc.returncode == 0, out[-4000:]
    assert "DIST_OK rank 0" in out and "DIST_OK rank 1" in out, out[-4000:]
