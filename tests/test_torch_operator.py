"""The port's ``Custom`` ops (``operator.py``) against the JAX package's,
on the CPU with the same numpy inputs.

Two ops are registered in both packages: ``scale2`` (tests/test_aux.py's,
x * factor) and ``powsplit``, two outputs (x * a, x * x) whose prop
declares only its output gradients and inputs as backward dependencies,
so the port hands its ``backward`` None for the outputs.  They run:

- through ``nd`` under ``autograd.record()``: outputs and input
  gradients equal the JAX package's (rel 1e-6);
- as a bound Symbol (``sym.Custom`` between two FullyConnected layers
  and a SoftmaxOutput) through ``Module``'s forward and backward, and
  through its ``kvstore='tpu'`` fused step: outputs, input gradients and
  the parameters after one SGD step, rel 1e-5;
- in a hybridized block: the outputs and gradients equal the eager
  block's, and on the card route (CachedOp's captures, driven here with
  CUDA's stream calls stubbed) the warm-up sees the Custom op, so no
  capture is taken and ``stats()["capture_skipped"] == "Custom"``; a
  ``StepGraph`` step records the same.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import parallel as jpar  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch.graph.cached_op import CachedOp  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import _graph  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
PKGS = (mx, mt)


def _register(P):
    """scale2 and powsplit on package P."""

    @P.operator.register("scale2")
    class Scale2Prop(P.operator.CustomOpProp):
        def __init__(self, factor=2.0):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            factor = self.factor

            class Scale2(P.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * factor)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * factor)
            return Scale2()

    @P.operator.register("powsplit")
    class PowSplitProp(P.operator.CustomOpProp):
        def __init__(self, a=1.0):
            super().__init__(need_top_grad=True)
            self.a = float(a)

        def list_outputs(self):
            return ["scaled", "squared"]

        def declare_backward_dependency(self, out_grad, in_data,
                                        out_data):
            return list(out_grad) + list(in_data)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            a = self.a

            class PowSplit(P.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    self.assign(out_data[0], req[0], x * a)
                    self.assign(out_data[1], req[1], x * x)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    if P is mt:       # undeclared: not kept
                        assert out_data == [None, None]
                    x = in_data[0]
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * a + out_grad[1] * 2 * x)
            return PowSplit()


for _P in PKGS:
    _register(_P)


def _kw(P):
    return {} if P is mx else {"ctx": CPU}


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("op", ["scale2", "powsplit"])
def test_custom_op_through_nd_and_autograd_matches_jax(op):
    x0 = _x()
    params = {"factor": 3.0} if op == "scale2" else {"a": 1.5}
    got = {}
    for P in PKGS:
        x = P.nd.array(x0, **_kw(P))
        x.attach_grad()
        with P.autograd.record():
            outs = P.nd.Custom(x, op_type=op, **params)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            loss = sum((o * (i + 1.0)).sum() for i, o in enumerate(outs))
        loss.backward()
        got[P] = [o.asnumpy() for o in outs] + [x.grad.asnumpy()]
    assert len(got[mt]) == (2 if op == "scale2" else 3)
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert mt.operator.get_all_registered().keys() >= {"scale2",
                                                       "powsplit"}
    with pytest.raises(ValueError, match="not registered"):
        mt.nd.Custom(mt.nd.array(x0, ctx=CPU), op_type="no_such_op")


def _net(S):
    data = S.Variable("data")
    h = S.FullyConnected(data, num_hidden=6, name="fc1")
    h = S.Custom(h, op_type="scale2", factor=0.5, name="half")
    h = S.FullyConnected(h, num_hidden=3, name="fc2")
    return S.SoftmaxOutput(h, name="softmax")


@pytest.mark.parametrize("kvstore", ["local", "tpu"])
def test_custom_op_in_a_bound_symbol_through_module_matches_jax(kvstore):
    rs = np.random.RandomState(1)
    x, y = _x(2, (4, 5)), rs.randint(0, 3, 4).astype(np.float32)
    arg = {"fc1_weight": rs.randn(6, 5).astype(np.float32) * 0.3,
           "fc1_bias": rs.randn(6).astype(np.float32) * 0.1,
           "fc2_weight": rs.randn(3, 6).astype(np.float32) * 0.3,
           "fc2_bias": rs.randn(3).astype(np.float32) * 0.1}
    got = {}
    for P in PKGS:
        with jpar.use_mesh(jpar.make_mesh(devices=jax.devices("cpu")[:1])) \
                if P is mx else contextlib.nullcontext():
            got[P] = _module_step(P, kvstore, x, y, arg)
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[mt][-1], arg["fc2_weight"])


def _module_step(P, kvstore, x, y, arg):
    """One forward_backward and update of the Module over ``_net``:
    the outputs, the input gradient ('local') and the parameters."""
    ctx = {} if P is mx else {"context": CPU}
    mod = P.mod.Module(_net(P.sym), **ctx)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))],
             inputs_need_grad=kvstore == "local")
    mod.init_params(arg_params={k: P.nd.array(v, **_kw(P))
                                for k, v in arg.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    batch = P.io.DataBatch([P.nd.array(x, **_kw(P))],
                           [P.nd.array(y, **_kw(P))])
    mod.forward_backward(batch)
    outs = [mod.get_outputs()[0].asnumpy()]
    if kvstore == "local":
        outs.append(mod.get_input_grads()[0].asnumpy())
    mod.update()
    params = mod.get_params()[0]
    return outs + [params[k].asnumpy() for k in sorted(arg)]


class _Block:
    """A HybridBlock whose forward holds a Custom op, on package P."""

    @staticmethod
    def make(P):
        class Net(P.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = P.gluon.nn.Dense(4, in_units=3)

            def hybrid_forward(self, F, x):
                s, q = F.Custom(self.fc(x), op_type="powsplit", a=2.0)
                return F.Custom(s + q, op_type="scale2", factor=0.5)

        net = Net()
        net.initialize(P.init.Xavier(), **_kw(P))
        return net


def _grads(net, x):
    with mt.autograd.record():
        y = net(x)
        (y * y).sum().backward()
    return [y.asnumpy(), net.fc._param("weight").grad().asnumpy().copy()]


@pytest.fixture
def cuda_streams_stubbed(monkeypatch):
    """The card route of CachedOp and StepGraph up to their captures, on
    the CPU: CUDA's device and stream calls stand in as no-ops."""
    class _Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(CachedOp, "_on_card", lambda self, inputs: True)

    def no_graph(*a, **k):
        raise AssertionError("a Custom op's step was captured")
    monkeypatch.setattr(_graph, "new_graph", no_graph)


def test_hybridized_block_with_custom_equals_eager_and_jax():
    x0 = _x(3, (5, 3))
    j = _Block.make(mx)
    p = _Block.make(mt)
    p.fc.weight.data.copy_(torch.tensor(j.fc.weight.data().asnumpy()))
    p.fc.bias.data.copy_(torch.tensor(j.fc.bias.data().asnumpy()))
    jx = mx.nd.array(x0)
    jx.attach_grad()
    with mx.autograd.record():
        jy = j(jx)
        (jy * jy).sum().backward()
    x = mt.nd.array(x0, ctx=CPU)
    eager = _grads(p, x)
    np.testing.assert_allclose(eager[0], jy.asnumpy(), rtol=1e-5)
    np.testing.assert_allclose(eager[1], j.fc.weight.grad().asnumpy(),
                               rtol=1e-5, atol=1e-6)
    p.hybridize()
    for a, b in zip(_grads(p, x), eager):
        np.testing.assert_array_equal(a, b)
    assert "capture_skipped" not in p._cached_op.stats()   # the CPU


@pytest.mark.parametrize("recording", [True, False])
def test_hybridized_custom_block_on_the_card_route_is_not_captured(
        cuda_streams_stubbed, recording):
    x = mt.nd.array(_x(4, (5, 3)), ctx=CPU)
    net = _Block.make(mt)
    eager = net(x).asnumpy()
    want = _grads(net, x)
    net.hybridize()
    for _ in range(2):
        if recording:
            for a, b in zip(_grads(net, x), want):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(net(x).asnumpy(), eager)
    stats = net._cached_op.stats()
    assert stats["capture_skipped"] == "Custom"
    assert stats["traces"] == 1 and stats["hits"] == 1


def test_step_graph_with_custom_runs_eagerly(cuda_streams_stubbed):
    w = torch.ones(3)

    def step(x):
        out = mt.nd.Custom(mt.nd.NDArray(x), op_type="scale2",
                           factor=2.0)._data
        w.add_(out.sum())
        return out

    g = _graph.StepGraph(step, lambda: [w], "custom_step")
    x = torch.arange(3.0)
    for i in range(2):
        (out,) = g([x])
        assert torch.equal(out, 2 * x)
        assert w[0].item() == 1 + 6 * (i + 1)   # warm-ups undone
    assert g.capture_skipped == "Custom" and "custom_step" not in g.counts
