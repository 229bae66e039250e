"""The port's training-step sentinel, loss scaling, divergence rollback,
OOM typing and platform pinning against the JAX package's
(``tests/test_sentinel.py`` and ``tests/test_memory_planner.py``'s
runtime half, as far as they apply to one device), on the CPU.

- NumericGuard: policies, the interval cadence, ``check_loss`` (spike
  and injection), each step's verdicts equal to the JAX guard's on the
  same sequence.
- LossScaler: backoff, growth, cap, floor and ``state_dict``, the scale
  sequence equal to the JAX scaler's.
- ``all_finite``, the window counter, ``GuardedUpdater`` (skip and
  raise) and the one-read-per-interval transfer budget.
- The Trainer's whole-tree (sgd, adam) and per-parameter (adagrad)
  routes: an injected bad step leaves every parameter and optimizer
  state tensor bit for bit as the run that never saw that batch; warn
  applies it; the interval observes a bad step between reads; dynamic
  and static loss scales.
- ``Module.fit`` on 'local' and 'tpu': bad steps skipped, the interval
  budget, and the rollback to the newest valid checkpoint (parameters,
  optimizer states, the iterator's position) on ``DivergedError``.
- Exit codes 13 and 15 in a subprocess; ``is_oom`` on torch's
  exhaustion and on the synthetic ``mem:oom``; the injected ``mem:oom``
  taking one rung in ``ShardedTrainStep``; ``maybe_force_cpu`` and
  ``enable_compile_cache``.
"""
import contextlib
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu.optimizer as jopt  # noqa: E402
import incubator_mxnet_tpu.resilience as jrz  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import optimizer as opt_mod  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as rz  # noqa: E402
from incubator_mxnet_tpu_torch import telemetry, tracing  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _clean_sentinel_env(monkeypatch):
    for var in ("MXTPU_FAULT_SPEC", "MXTPU_NONFINITE_POLICY",
                "MXTPU_GUARD_INTERVAL", "MXTPU_MAX_BAD_STEPS",
                "MXTPU_LOSS_SCALE", "MXTPU_LOSS_SCALE_DYNAMIC",
                "MXTPU_LOSS_SCALE_WINDOW", "MXTPU_LOSS_SPIKE_FACTOR",
                "MXTPU_MEM_POLICY", "MXTPU_HBM_BYTES", "MXTPU_FORCE_CPU"):
        monkeypatch.delenv(var, raising=False)
    for r in (rz, jrz):
        r.reset_faults()
    telemetry.get_registry().reset()
    tracing.reset_for_tests()
    yield
    for r in (rz, jrz):
        r.reset_faults()
    telemetry.get_registry().reset()
    tracing.reset_for_tests()


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


# ---------------------------------------------------------------- guard
@pytest.mark.parametrize("R", [jrz, rz], ids=["jax", "port"])
def test_guard_policies_and_divergence(R):
    g = R.NumericGuard(policy="skip", interval=1, max_bad_steps=3)
    assert g.enabled
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        verdicts = [g.record(f) for f in (True, False, True, False,
                                          False)]
        with pytest.raises(R.DivergedError):
            g.record(False)
    assert verdicts == ["ok", "skip", "ok", "skip", "skip"]
    assert g.bad_steps == 4 and g.skipped_steps == 3
    with pytest.raises(R.BadStepError):
        R.NumericGuard(policy="raise", max_bad_steps=0).record(False)
    g = R.NumericGuard(policy="warn", max_bad_steps=0)
    with pytest.warns(RuntimeWarning):
        assert g.record(False) == "ok"
    assert not R.NumericGuard(policy="off").enabled
    with pytest.raises(ValueError):
        R.NumericGuard(policy="bogus")
    assert R.DivergedError.EXIT_CODE == 13
    assert R.OomError.EXIT_CODE == R.MemoryPlanError.EXIT_CODE == 15


def test_guard_interval_due_cadence():
    g = rz.NumericGuard(policy="skip", interval=3, max_bad_steps=0)
    assert [g.begin_step() for _ in range(7)] == \
        [True, False, False, True, False, False, True]
    g2 = rz.NumericGuard(policy="off", interval=1)
    assert [g2.begin_step() for _ in range(3)] == [False] * 3


def test_check_loss_matches_jax(monkeypatch):
    """The same loss sequence (with a NaN, a spike and an injected
    spike) gives each package's guard the same verdicts and EMA."""
    losses = [1.0, float("nan"), 1.1, 500.0, 1.2, 1.0, 1.0]
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "loss:spike:6:spike")
    out = {}
    for R in (jrz, rz):
        R.reset_faults()
        g = R.NumericGuard(policy="skip", interval=1, max_bad_steps=0,
                           spike_factor=10.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out[R] = ([g.check_loss(v) for v in losses], g._loss_ema,
                      g.bad_steps)
    assert out[rz] == out[jrz]
    assert out[rz][0] == ["ok", "skip", "ok", "skip", "ok", "skip", "ok"]
    assert rz.NumericGuard(policy="off").check_loss(float("nan")) == "ok"


# ---------------------------------------------------------------- scaler
def test_loss_scaler_matches_jax():
    kw = dict(init_scale=8.0, dynamic=True, growth=2.0, backoff=0.5,
              window=2, max_scale=16.0)
    flags = [True, False, False, False, False, True, True, True, True,
             False, False]
    seqs = []
    for O in (jopt, opt_mod):
        s = O.LossScaler(**kw)
        seqs.append([s.update(f) for f in flags]
                    + [s.num_backoffs, s.num_growths])
    assert seqs[0] == seqs[1]
    assert seqs[1][:5] == [4.0, 4.0, 8.0, 8.0, 16.0]
    s2 = opt_mod.LossScaler(init_scale=1.0, dynamic=True, backoff=0.5,
                            window=100)
    assert s2.update(overflow=True) == 1.0          # floor
    assert not opt_mod.LossScaler().active
    s = opt_mod.LossScaler(init_scale=4.0, dynamic=True, window=5)
    s.update(False)
    s3 = opt_mod.LossScaler(init_scale=1.0, dynamic=True, window=5)
    s3.load_state_dict(s.state_dict())
    assert s3.scale == 4.0 and s3._good_steps == 1


# ---------------------------------------------------------------- flag
def test_all_finite_and_window_accumulation():
    ok = mt.nd.array(np.ones((3, 2), np.float32), ctx=CPU)
    bad = mt.nd.array(np.array([1.0, np.inf], np.float32), ctx=CPU)
    nan = torch.tensor([np.nan, 1.0])
    ints = torch.arange(4, dtype=torch.int32)
    assert bool(opt_mod.all_finite([ok])) is True
    assert bool(opt_mod.all_finite([ok, bad])) is False
    assert bool(opt_mod.all_finite([nan.bfloat16(), ok])) is False
    assert opt_mod.all_finite([ints]) is True
    assert opt_mod.all_finite([]) is True
    g = rz.NumericGuard(policy="skip", interval=4, max_bad_steps=0)
    for arrays in ([ok], [ok, bad], [nan], [ok]):
        opt_mod.accumulate_window(g, opt_mod.all_finite(arrays))
    assert opt_mod.read_window_bad(g) == 2
    assert opt_mod.read_window_bad(g) == 0


def test_guarded_updater_skip_raise_and_budget(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:2:nan")
    rz.reset_faults()
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9)
    up = opt_mod.GuardedUpdater(
        opt, guard=rz.NumericGuard(policy="skip", interval=1,
                                   max_bad_steps=0))
    w = mt.nd.array(np.ones((4,), np.float32), ctx=CPU)
    with _quiet():
        g1 = mt.nd.array(np.full((4,), 0.5, np.float32), ctx=CPU)
        assert up.begin_step([g1])
        up(0, g1, w)
        after_good = w.asnumpy().copy()
        mom = up.states[0].asnumpy().copy()
        g2 = mt.nd.array(np.full((4,), 0.5, np.float32), ctx=CPU)
        assert not up.begin_step([g2])      # poisoned -> skip
        up(0, g2, w)                        # no-op
    assert np.array_equal(w.asnumpy(), after_good)
    assert np.array_equal(up.states[0].asnumpy(), mom)
    assert opt.num_update == 1 and up.guard.skipped_steps == 1

    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:1:inf")
    rz.reset_faults()
    up = opt_mod.GuardedUpdater(
        opt_mod.create("sgd"),
        guard=rz.NumericGuard(policy="raise", interval=1,
                              max_bad_steps=0))
    with pytest.raises(rz.BadStepError):
        up.begin_step([mt.nd.array(np.ones((2,), np.float32), ctx=CPU)])

    monkeypatch.delenv("MXTPU_FAULT_SPEC")
    reads = []
    orig = opt_mod.read_window_bad
    monkeypatch.setattr(opt_mod, "read_window_bad",
                        lambda g: reads.append(1) or orig(g))
    guard = rz.NumericGuard(policy="skip", interval=4, max_bad_steps=0)
    up = opt_mod.GuardedUpdater(opt_mod.create("sgd"), guard=guard)
    for _ in range(8):
        g = mt.nd.array(np.full((4,), 0.1, np.float32), ctx=CPU)
        assert up.begin_step([g])
        up(0, g, w)
    assert len(reads) == 2 and guard.checks == 2 and guard.steps == 8


# ---------------------------------------------------------------- gluon
def _toy_data(n=100, dim=10, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, dim).astype("float32"),
            rs.randint(0, classes, n).astype("float32"))


def _weights(seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(16, 10).astype("f4") * 0.3, np.zeros(16, "f4"),
            rs.randn(3, 16).astype("f4") * 0.3, np.zeros(3, "f4")]


def _train_gluon(optimizer, steps, batch=10, skip_batches=(), opt_kw=None):
    """Train the toy MLP from fixed weights on batches 0..steps-1 (less
    ``skip_batches``); returns (net, trainer, losses)."""
    data, labels = _toy_data()
    net = mt.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(16, activation="relu", in_units=10),
                mt.gluon.nn.Dense(3, in_units=16))
    net.initialize(mt.init.Zero(), ctx=CPU)
    for p, w in zip(net.collect_params().values(), _weights()):
        p.set_data(mt.nd.array(w, ctx=CPU))
    trainer = mt.gluon.Trainer(net.collect_params(), optimizer,
                               dict(learning_rate=0.1, **(opt_kw or {})))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    with _quiet():
        for step in range(steps):
            if step in skip_batches:
                continue
            lo = (step * batch) % len(data)
            x = mt.nd.array(data[lo:lo + batch], ctx=CPU)
            y = mt.nd.array(labels[lo:lo + batch], ctx=CPU)
            with mt.autograd.record():
                loss = loss_fn(net(x), y) * trainer.loss_scale
            loss.backward()
            trainer.step(batch)
            losses.append(float(loss.asnumpy().mean()))
    return net, trainer, losses


def _state(net, trainer):
    vals = [p.data().asnumpy() for p in net.collect_params().values()]
    if trainer._fused:
        vals += [v.numpy() for v in _tensors(trainer._fstate)]
    else:
        vals += [s.asnumpy() for _, s in sorted(
            trainer._updater.states.items()) if s is not None]
    return vals


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree.detach().clone()] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("optimizer,kw", [
    ("sgd", dict(momentum=0.9)), ("adam", {}), ("adagrad", {})],
    ids=["fused_sgd", "fused_adam", "eager_adagrad"])
def test_trainer_skip_is_bit_equal_to_no_step(optimizer, kw, monkeypatch):
    """An injected non-finite gradient at step 3 under policy skip:
    every parameter and optimizer-state tensor (Adam's step count too)
    and the schedule count end bit for bit as in the run that never saw
    batch 3."""
    ref_net, ref_tr, ref_losses = _train_gluon(optimizer, 6,
                                               skip_batches=(2,),
                                               opt_kw=kw)
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:3:nan")
    rz.reset_faults()
    net, tr, losses = _train_gluon(optimizer, 6, opt_kw=kw)
    assert tr._fused is (optimizer != "adagrad")
    assert tr.guard.skipped_steps == 1 and tr.guard.steps == 6
    assert tr._optimizer.num_update == ref_tr._optimizer.num_update == 5
    assert losses[:2] + losses[3:] == ref_losses
    got, ref = _state(net, tr), _state(ref_net, ref_tr)
    assert len(got) == len(ref)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_trainer_warn_policy_applies_bad_updates(optimizer, monkeypatch):
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "warn")
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:2:nan")
    rz.reset_faults()
    net, tr, _ = _train_gluon(optimizer, 4)
    assert tr.guard.bad_steps >= 1 and tr.guard.skipped_steps == 0
    flat = np.concatenate([p.data().asnumpy().ravel()
                           for p in net.collect_params().values()])
    assert not np.all(np.isfinite(flat))


def test_trainer_interval_observes_offread_bad_steps(monkeypatch):
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_GUARD_INTERVAL", "4")
    monkeypatch.setenv("MXTPU_FAULT_SPEC",
                       "grad:nonfinite:2:nan,grad:nonfinite:3:inf")
    rz.reset_faults()
    net, tr, _ = _train_gluon("sgd", 8)
    for p in net.collect_params().values():
        assert np.all(np.isfinite(p.data().asnumpy()))
    assert tr.guard.checks == 2
    assert tr.guard.skipped_steps == 2
    assert tr.guard.bad_steps == 1
    assert tr._optimizer.num_update == 6
    ref_net, ref_tr, _ = _train_gluon("sgd", 8, skip_batches=(1, 2))
    assert all(np.array_equal(a, b) for a, b in
               zip(_state(net, tr), _state(ref_net, ref_tr)))


def test_trainer_dynamic_loss_scale_backoff_and_regrowth(monkeypatch):
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "8")
    monkeypatch.setenv("MXTPU_LOSS_SCALE_DYNAMIC", "1")
    monkeypatch.setenv("MXTPU_LOSS_SCALE_WINDOW", "2")
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:2:nan")
    rz.reset_faults()
    net, tr, _ = _train_gluon("sgd", 7)
    assert tr.guard.policy == "skip"
    assert tr._scaler.num_backoffs == 1
    assert tr._scaler.num_growths == 2
    assert tr.loss_scale == 16.0
    assert telemetry.get_registry().gauge("loss_scale").value == 16.0
    for p in net.collect_params().values():
        assert np.all(np.isfinite(p.data().asnumpy()))


def test_trainer_static_loss_scale_matches_unscaled(monkeypatch):
    net_a, _, _ = _train_gluon("sgd", 3)
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "8")
    net_b, tr, _ = _train_gluon("sgd", 3)
    assert tr.loss_scale == 8.0
    for pa, pb in zip(net_a.collect_params().values(),
                      net_b.collect_params().values()):
        np.testing.assert_allclose(pa.data().asnumpy(),
                                   pb.data().asnumpy(), rtol=2e-5,
                                   atol=2e-6)


# ---------------------------------------------------------------- module
def _toy_module_problem(n=64, dim=10, classes=5, batch=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, dim).astype(np.float32)
    w = rs.rand(dim, classes).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=batch,
                           label_name="softmax_label")
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, name="fc", num_hidden=classes)
    return it, mt.sym.SoftmaxOutput(net, name="softmax")


def _fit(mod, it, kvstore, **kw):
    mt.random.seed(0)
    with _quiet():
        mod.fit(it, num_epoch=kw.pop("num_epoch", 2), kvstore=kvstore,
                optimizer="sgd",
                optimizer_params=dict(learning_rate=0.5),
                initializer=mt.initializer.Xavier(), **kw)


@pytest.mark.parametrize("kvstore", ["local", "tpu"])
def test_module_fit_skips_injected_bad_steps(kvstore, monkeypatch):
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:2:nan")
    rz.reset_faults()
    it, sym = _toy_module_problem()
    mod = mt.mod.Module(sym, context=CPU)
    _fit(mod, it, kvstore)
    for k, v in mod.get_params()[0].items():
        assert np.all(np.isfinite(v.asnumpy())), k
    assert mod._guard.skipped_steps == 1
    assert mod._guard.steps == 8
    assert mod._optimizer.num_update == 7


def test_module_fit_guard_interval_transfer_budget(monkeypatch):
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_GUARD_INTERVAL", "4")
    it, sym = _toy_module_problem()
    mod = mt.mod.Module(sym, context=CPU)
    _fit(mod, it, "local")
    assert mod._guard.steps == 8 and mod._guard.checks == 2


@pytest.mark.parametrize("kvstore", ["local", "tpu"])
def test_module_fit_rollback_on_divergence(kvstore, monkeypatch,
                                           tmp_path):
    """MXTPU_MAX_BAD_STEPS consecutive bad steps: fit restores the
    newest valid checkpoint (parameters, optimizer states, the
    iterator's position), counts one rollback and re-raises; a newer
    checkpoint that fails its CRC is passed over."""
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_MAX_BAD_STEPS", "3")
    it, sym = _toy_module_problem()
    prefix = str(tmp_path / "ckpt")
    mod = mt.mod.Module(sym, context=CPU)
    _fit(mod, it, kvstore, num_epoch=1)
    it.reset()
    next(it)
    next(it)
    mod.save_checkpoint(prefix, 0, save_optimizer_states=True,
                        data_iter=it)
    saved_cursor = it.state_dict()["cursor"]
    saved = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    # a newer checkpoint whose bytes no longer match their sidecar
    mod.save_checkpoint(prefix, 1)
    rz.damage_file(f"{prefix}-0001.params", "corrupt")

    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:*:nan")
    rz.reset_faults()
    it2, _ = _toy_module_problem()
    mod2 = mt.mod.Module(sym, context=CPU)
    with pytest.raises(rz.DivergedError):
        _fit(mod2, it2, kvstore, checkpoint_prefix=prefix)
    for k, v in mod2.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), saved[k], err_msg=k)
    assert mod2._guard.consecutive_bad == 3
    assert it2.state_dict()["cursor"] == saved_cursor
    assert telemetry.get_registry().counter("rollbacks_total").value == 1


def test_module_fit_rollback_without_checkpoint_still_raises(
        monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_NONFINITE_POLICY", "skip")
    monkeypatch.setenv("MXTPU_MAX_BAD_STEPS", "2")
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:*:inf")
    rz.reset_faults()
    it, sym = _toy_module_problem()
    mod = mt.mod.Module(sym, context=CPU)
    with pytest.raises(rz.DivergedError):
        _fit(mod, it, "local", num_epoch=1,
             checkpoint_prefix=str(tmp_path / "none"))
    assert telemetry.get_registry().counter("rollbacks_total").value == 0


def test_symbol_step_guard_select_keeps_state(monkeypatch):
    """The fused step's on-device select: a poisoned step leaves the
    parameters, aux states and momentum bit for bit; ``warn``
    (guard_select=False) lets it through."""
    it, sym = _toy_module_problem()
    batch = next(iter(it))
    inputs = {"data": batch.data[0], "softmax_label": batch.label[0]}
    rs = np.random.RandomState(3)
    pvals = {"fc_weight": torch.from_numpy(rs.randn(5, 10).astype("f4")),
             "fc_bias": torch.zeros(5)}
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "grad:nonfinite:2:nan")
    for select in (True, False):
        rz.reset_faults()
        step = mt.parallel.SymbolTrainStep(
            sym, pvals, {}, ["data", "softmax_label"], optimizer="sgd",
            optimizer_params=dict(learning_rate=0.1, momentum=0.9),
            numeric_guard=True, guard_select=select)
        step(inputs, lr=0.1)
        assert bool(step.last_finite) is True
        before = [t.clone() for t in step._mutable()]
        step(inputs, lr=0.1)
        assert bool(step.last_finite) is False
        same = [torch.equal(a, b) for a, b in zip(before, step._mutable())]
        assert all(same) if select else not any(same)


# ---------------------------------------------------------------- exits
@pytest.mark.parametrize("err,code", [
    ("DivergedError('test divergence')", 13),
    ("OomError('t')", 15)])
def test_exithook_distinct_exit_codes(err, code):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c",
         "import incubator_mxnet_tpu_torch.resilience as rz\n"
         f"rz.install_diverged_exithook()\nraise rz.{err}\n"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == code, (r.returncode, r.stderr[-500:])
    assert err.split("(")[0] in r.stderr


def test_is_oom_on_torch_and_synthetic(monkeypatch):
    assert rz.is_oom(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert rz.is_oom(RuntimeError(
        "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"))
    assert rz.is_oom(RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"))
    assert not rz.is_oom(RuntimeError("CUDA error: an illegal memory "
                                      "access was encountered"))
    assert not rz.is_oom(rz.MemoryPlanError("t"))
    assert rz.as_oom_error(ValueError("shape mismatch"), "t") is None
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "mem:oom:2:error")
    rz.reset_faults()
    rz.check_oom("site")
    with pytest.raises(RuntimeError) as ei:
        rz.check_oom("site")
    oom = rz.as_oom_error(ei.value, "site_x")
    assert isinstance(oom, rz.OomError) and "site_x" in str(oom)
    assert jrz.is_oom(ei.value)         # the JAX classifier agrees


def _tiny_step(**kw):
    mt.random.seed(0)
    net = mt.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(16, activation="relu", in_units=12),
                mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(mt.initializer.Xavier(), ctx=CPU)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 12).astype("f4"))
    y = torch.from_numpy(rs.randint(0, 4, (8,)).astype("i4"))
    return mt.parallel.ShardedTrainStep(
        net, "sgd", dict(learning_rate=0.1), **kw), x, y


def test_injected_oom_takes_one_rung_and_retries(monkeypatch):
    ref, x, y = _tiny_step()
    want = [float(ref(x, y)) for _ in range(4)]
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "mem:oom:2:error")
    rz.reset_faults()
    step, x, y = _tiny_step()
    assert step.remat is False
    got = [float(step(x, y)) for _ in range(4)]
    # the remat rung changes the schedule, not the math
    assert step.remat is True and got == want
    assert telemetry.get_registry().counter("oom_retries_total").value == 1
    evs = tracing.events("mem_degrade", cause="runtime_oom")
    assert evs and evs[0]["rung"] == "remat"
    assert evs[0]["site"] == "sharded_train_step"
    # a second injected OOM on the retry is typed and raised
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "mem:oom:*:error")
    rz.reset_faults()
    with pytest.raises(rz.OomError):
        step(x, y)


# ---------------------------------------------------------------- platform
def test_maybe_force_cpu_and_compile_cache(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch import context
    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.utils import host_build, platform
    assert platform.maybe_force_cpu() is False
    assert context._PINNED["ctx"] is None
    monkeypatch.setenv("MXTPU_FORCE_CPU", "1")
    try:
        assert platform.maybe_force_cpu() is (not torch.cuda.is_initialized())
        assert context.default_device() == torch.device("cpu")
        assert context.current_context() == mt.cpu()
    finally:
        context.pin_default(None)
    for mod, attr in ((_build, "BUILD_DIR"), (_build, "RTC_DIR"),
                      (host_build, "BUILD_DIR")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))
    assert platform.enable_compile_cache(str(tmp_path / "cache"))
    assert _build.BUILD_DIR == (tmp_path / "cache" / "cuda").resolve()
    assert _build.RTC_DIR.parent == _build.BUILD_DIR
    assert host_build.BUILD_DIR == (tmp_path / "cache" / "host").resolve()
    with pytest.raises(ValueError, match="gitignore"):
        platform.enable_compile_cache(os.path.join(REPO, "not_ignored"))
    assert not os.path.exists(os.path.join(REPO, "not_ignored"))
    inside = os.path.join(REPO, "build", "test_compile_cache")
    try:
        assert platform.enable_compile_cache(inside)
    finally:
        shutil.rmtree(inside, ignore_errors=True)
