"""The port's last small frontends against the JAX package's, on the CPU:
``profiler``, ``predictor``, ``visualization``, ``test_utils`` and
``contrib.{autograd,tensorboard}``.

- The profiler's framework trace: one 'X' event per dispatched ``nd``
  op, named as the JAX package names them, with the same schema (and
  'M' metadata); ``mode='sync'``; the device trace
  (``start_xla_trace``/``stop_xla_trace`` over ``torch.profiler``)
  writes Chrome trace JSON that loads.
- ``Predictor`` over one checkpoint (symbol JSON and params written by
  the JAX package): outputs within rel 1e-5 of the JAX ``Predictor``'s,
  through ``forward``/``get_output``, ``predict`` and ``reshape``; the
  bind takes the params' saved dtypes.
- ``print_summary``'s text and total equal to the JAX package's;
  ``plot_network`` gives the same nodes and edges without graphviz.
- ``test_utils``: ``check_consistency`` (``cpu()`` against ``cpu()``
  here; the card's run is chip_smoke's) with the JAX package's inputs
  and results, ``check_numeric_gradient``,
  ``check_symbolic_forward``/``backward``, ``rand_ndarray`` of each
  storage type.
- ``LogMetricsCallback``'s JSONL equal to the JAX package's (but for
  the wall-clock stamp); ``contrib.autograd`` as the JAX package's.
"""
import contextlib
import importlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

PKGS = {"jax": mx, "port": mt}
CPU = {"jax": mx.cpu(), "port": mt.cpu()}


def _arr(n, a):
    return PKGS[n].nd.array(a, ctx=CPU[n])


def _small_net(S, head="softmax_output"):
    data = S.Variable("data")
    x = S.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                      name="conv0")
    x = S.BatchNorm(x, name="bn0")
    x = S.Activation(x, act_type="relu", name="relu0")
    x = S.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool0")
    x = S.Flatten(x, name="flat0")
    x = S.FullyConnected(x, num_hidden=5, name="fc0")
    if head == "softmax":
        return S.softmax(x, name="prob")
    return S.SoftmaxOutput(x, name="softmax")


# ------------------------------------------------------------- profiler
def _profiled_ops(n, path):
    M = PKGS[n]
    M.profiler.set_config(filename=path, mode="sync")
    M.profiler.set_state("run")
    a = _arr(n, np.arange(6, dtype=np.float32).reshape(2, 3))
    b = M.nd.relu(a - 2.0)
    c = M.nd.dot(b, M.nd.transpose(a))
    M.nd.softmax(c).asnumpy()
    M.profiler.set_state("stop")
    M.profiler.dump_profile()
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profiler_trace_schema_matches(tmp_path):
    traces = {n: _profiled_ops(n, str(tmp_path / f"{n}.json"))
              for n in PKGS}
    ops = {n: [e for e in t if e["ph"] == "X"] for n, t in traces.items()}
    assert [e["name"] for e in ops["port"]] == \
        [e["name"] for e in ops["jax"]]
    assert len(ops["port"]) >= 5
    for e in ops["port"]:
        assert set(e) == set(ops["jax"][0])
        assert e["cat"] == "operator" and e["dur"] >= 0
    meta = [e for e in traces["port"] if e["ph"] == "M"]
    assert meta[0]["name"] == "process_name" and \
        {e["name"] for e in meta} == {e["name"] for e in traces["jax"]
                                      if e["ph"] == "M"}
    # stopped: nothing more is recorded
    mt.nd.relu(_arr("port", np.ones(3, np.float32)))
    assert mt.profiler._profiler._events == []
    with pytest.raises(ValueError):
        mt.profiler.set_state("paused")


def test_device_trace_writes_chrome_json(tmp_path):
    logdir = str(tmp_path / "trace")
    assert mt.profiler.start_xla_trace(logdir) == logdir
    with pytest.raises(RuntimeError, match="running already"):
        mt.profiler.start_xla_trace(logdir)
    x = torch.ones(64, 64)
    (x @ x).sum().item()
    path = mt.profiler.stop_xla_trace()
    assert os.path.dirname(path) == logdir
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError, match="no device trace"):
        mt.profiler.stop_xla_trace()


# ------------------------------------------------------------ predictor
@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX Module checkpoint of the small net after one SGD step."""
    prefix = str(tmp_path_factory.mktemp("pred") / "small")
    rs = np.random.RandomState(0)
    x = rs.rand(8, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 5, 8).astype(np.float32)
    mx.random.seed(0)
    mod = mx.mod.Module(_small_net(mx.sym), context=mx.cpu())
    mod.bind(data_shapes=[("data", (8, 3, 8, 8))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=dict(learning_rate=0.1))
    mod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                         [mx.nd.array(y)]))
    mod.update()
    arg, aux = mod.get_params()
    mx.model.save_checkpoint(prefix, 1, _small_net(mx.sym, "softmax"),
                             arg, aux)
    return prefix, x


def test_predictor_matches_jax(checkpoint):
    prefix, x = checkpoint
    shapes = {"data": (8, 3, 8, 8)}
    sym, params = prefix + "-symbol.json", prefix + "-0001.params"
    ref = mx.Predictor(sym, params, shapes, ctx=mx.cpu())
    got = mt.Predictor(sym, params, shapes, ctx=mt.cpu())
    want = ref.predict(x)
    out = got.predict(x)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-7)
    got.forward(data=x)
    np.testing.assert_array_equal(got.get_output(0).asnumpy(), out)
    small = got.reshape({"data": (2, 3, 8, 8)})
    np.testing.assert_allclose(small.predict(x[:2]), want[:2], rtol=1e-5,
                               atol=1e-7)
    assert set(got._exec.arg_dict) >= {"conv0_weight", "fc0_bias"}
    with pytest.raises(KeyError):
        got.set_input("nope", x)
    with pytest.raises(ValueError, match="expected 1 inputs"):
        got.predict(x, x)
    # the bind takes the dtypes the params were saved at
    arg, aux = mt.predictor.load_params(params)
    half = {f"arg:{k}": mt.nd.array(v.asnumpy().astype(np.float16),
                                    ctx=mt.cpu())
            for k, v in arg.items()}
    half.update({f"aux:{k}": v for k, v in aux.items()})
    mt.nd.save(prefix + "-half.params", half)
    p16 = mt.Predictor(sym, prefix + "-half.params", shapes, ctx=mt.cpu(),
                       type_dict={"data": np.float16})
    assert p16._exec.arg_dict["conv0_weight"].dtype == np.float16


def test_predictor_default_context_is_the_card(checkpoint, monkeypatch):
    prefix, _ = checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.Predictor(prefix + "-symbol.json", prefix + "-0001.params",
                     {"data": (8, 3, 8, 8)})


# -------------------------------------------------------- visualization
def test_print_summary_and_plot_network_match():
    texts, totals = {}, {}
    for n, M in PKGS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            totals[n] = M.visualization.print_summary(
                _small_net(M.sym), shape={"data": (2, 3, 8, 8)})
        texts[n] = buf.getvalue()
    assert texts["port"] == texts["jax"] and totals["port"] == totals["jax"]
    assert "conv0 (Convolution)" in texts["port"]
    sources = {}
    for graphviz in ("installed", "missing"):
        with pytest.MonkeyPatch.context() as m:
            if graphviz == "missing":
                m.setitem(sys.modules, "graphviz", None)
            dot = mt.visualization.plot_network(_small_net(mt.sym),
                                                title="small")
        assert type(dot).__name__ == ("Dot" if graphviz == "missing"
                                      else "Digraph")
        sources[graphviz] = sorted(
            ln.replace('"', "").strip() for ln in dot.source.splitlines()
            if "->" in ln)
    if importlib.util.find_spec("graphviz") is None:
        sources.pop("installed")
    assert "conv0 -> bn0" in sources["missing"]
    assert len(set(map(tuple, sources.values()))) == 1


# ----------------------------------------------------------- test_utils
def _consistency(n, monkeypatch, sym_of, shapes):
    M = PKGS[n]
    monkeypatch.setattr(M.test_utils, "_RNG", np.random.RandomState(1))
    sym = sym_of(M.sym)
    ctx_list = [dict(ctx=CPU[n], shapes=shapes),
                dict(ctx=CPU[n], shapes=shapes)]
    return M.test_utils.check_consistency(sym, ctx_list)


SYMBOLS = {
    "conv": (lambda S: S.Convolution(S.Variable("data"), num_filter=3,
                                     kernel=(3, 3), name="c"),
             {"data": (2, 2, 6, 6), "c_weight": (3, 2, 3, 3),
              "c_bias": (3,)}),
    "fc": (lambda S: S.FullyConnected(S.Variable("data"), num_hidden=4,
                                      name="f"),
           {"data": (3, 5), "f_weight": (4, 5), "f_bias": (4,)}),
    "pool": (lambda S: S.Pooling(S.Variable("data"), kernel=(2, 2),
                                 stride=(2, 2), pool_type="avg"),
             {"data": (2, 3, 6, 6)}),
    "softmax": (lambda S: S.softmax(S.Variable("data")),
                {"data": (4, 7)}),
}


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_check_consistency_matches(monkeypatch, name):
    sym_of, shapes = SYMBOLS[name]
    res = {n: _consistency(n, monkeypatch, sym_of, shapes) for n in PKGS}
    (po, pg, _), (jo, jg, _) = res["port"][0], res["jax"][0]
    for a, b in zip(po, jo):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert set(pg) == set(jg)
    for k in pg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-4, atol=1e-5)


def test_check_consistency_binds_batchnorm(monkeypatch):
    """The JAX package's check_consistency cannot bind a BatchNorm (its
    moving stats are not given); the port's starts them as the op
    does, and its training output is the batch's normalization."""
    shapes = {"data": (4, 3, 5, 5), "bn_gamma": (3,), "bn_beta": (3,)}
    sym = mt.sym.BatchNorm(mt.sym.Variable("data"), name="bn")
    monkeypatch.setattr(mt.test_utils, "_RNG", np.random.RandomState(7))
    (outs, grads, _), _ = mt.test_utils.check_consistency(
        sym, [dict(ctx=mt.cpu(), shapes=shapes)] * 2)
    rs = np.random.RandomState(7)
    x, _, beta = (rs.standard_normal(shapes[n]).astype(np.float32)
                  for n in ("data", "bn_gamma", "bn_beta"))
    mean = x.mean(axis=(0, 2, 3), keepdims=True)
    var = x.var(axis=(0, 2, 3), keepdims=True)
    # fix_gamma defaults to True: gamma is read as 1
    want = (x - mean) / np.sqrt(var + 1e-3) + beta.reshape(1, 3, 1, 1)
    np.testing.assert_allclose(outs[0], want, rtol=1e-4, atol=1e-5)
    assert set(grads) == {"data", "bn_gamma", "bn_beta"}


def test_numeric_and_symbolic_checks():
    tu = mt.test_utils
    S = mt.sym
    rs = np.random.RandomState(3)
    x, w, b = (rs.rand(3, 4).astype(np.float32),
               rs.rand(2, 4).astype(np.float32),
               rs.rand(2).astype(np.float32))
    fc = S.FullyConnected(S.Variable("x"), num_hidden=2, name="f")
    loc = {"x": x, "f_weight": w, "f_bias": b}
    tu.check_numeric_gradient(fc, loc, numeric_eps=1e-2, rtol=2e-2,
                              atol=2e-3, ctx=mt.cpu())
    tu.check_symbolic_forward(fc, loc, [x @ w.T + b], ctx=mt.cpu())
    og = rs.rand(3, 2).astype(np.float32)
    tu.check_symbolic_backward(fc, loc, [og], {"x": og @ w,
                                               "f_weight": og.T @ x,
                                               "f_bias": og.sum(0)},
                               ctx=mt.cpu())
    with pytest.raises(AssertionError):
        tu.check_symbolic_forward(fc, loc, [x @ w.T], ctx=mt.cpu())
    for stype, cls in (("default", mt.nd.NDArray),
                       ("csr", mt.nd.sparse.CSRNDArray),
                       ("row_sparse", mt.nd.sparse.RowSparseNDArray)):
        arr = tu.rand_ndarray((5, 6), stype, density=0.4, ctx=mt.cpu())
        assert isinstance(arr, cls) and arr.shape == (5, 6)
    tu.assert_almost_equal(mt.nd.array([1.0, 2.0], ctx=mt.cpu()),
                           np.array([1.0, 2.0]))
    assert tu.same(np.ones(2), np.ones(2))


# --------------------------------------------------------------- contrib
class _Param:
    def __init__(self, metric):
        self.epoch, self.nbatch, self.eval_metric = 0, 0, metric


def test_log_metrics_callback_jsonl_matches(tmp_path):
    lines = {}
    for n, M in PKGS.items():
        tb = importlib.import_module(M.__name__ + ".contrib.tensorboard")
        metric = M.metric.create(["acc", "ce"])
        cb = tb.LogMetricsCallback(
            str(tmp_path / n), prefix="train",
            summary_writer=tb._JsonlWriter(str(tmp_path / n)))
        for step in range(3):
            labels = [_arr(n, np.array([0, 1, 2, 1], np.float32))]
            preds = [_arr(n, np.eye(3, dtype=np.float32)[[0, 1, step, 2]]
                          * 0.8 + 0.1)]
            metric.update(labels, preds)
            cb(_Param(metric))
        cb.writer.close()
        (path,) = list((tmp_path / n).iterdir())
        lines[n] = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                    for ln in path.read_text().splitlines()]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 6
    snap = {"counters": {"train_steps_total": 3, "retries": 1},
            "gauges": {"epoch": 2.0}}
    logged = {}
    for n, M in PKGS.items():
        tb = importlib.import_module(M.__name__ + ".contrib.tensorboard")
        w = tb._JsonlWriter(str(tmp_path / ("tel_" + n)))
        assert tb.log_telemetry(w, snapshot=snap) == 3
        w.close()
        (path,) = list((tmp_path / ("tel_" + n)).iterdir())
        logged[n] = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                     for ln in path.read_text().splitlines()]
    assert logged["port"] == logged["jax"]
    assert logged["port"][0] == {"tag": "telemetry/epoch", "value": 2.0,
                                 "step": 3}
    with mt.contrib.tensorboard.LogMetricsCallback(
            str(tmp_path / "own"),
            summary_writer=mt.contrib.tensorboard._JsonlWriter(
                str(tmp_path / "own"))) as cb:
        pass
    with pytest.raises(ValueError, match="closed"):
        cb(_Param(None))


def test_contrib_autograd_matches():
    out = {}
    for n, M in PKGS.items():
        ag = importlib.import_module(M.__name__ + ".contrib.autograd")
        x = _arr(n, np.array([1.0, -2.0, 3.0], np.float32))
        grads, loss = ag.grad_and_loss(lambda a: a * a + a)(x)
        y = _arr(n, np.array([0.5, 2.0], np.float32))
        y.attach_grad()
        with ag.train_section():
            z = y * y * y
        ag.compute_gradient([z])
        out[n] = (grads[0].asnumpy(), loss.asnumpy(), y.grad.asnumpy())
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
