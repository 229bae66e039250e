"""The port's CTC loss (``ops/ctc.py``, ``gluon.loss.CTCLoss``) against
the JAX package's, on the CPU with the same numpy inputs.

- ``ctc_loss`` under both blank modes (``'first'``: blank 0, padding 0;
  ``'last'``: blank C-1, padding -1), with and without data and label
  lengths, and with padding inside a row (a label's length counts every
  entry that is not padding): costs within rel 1e-5, gradients within
  1e-5.  Its aliases are one op.
- An impossible alignment (more labels than frames) costs 1e30, as in
  the JAX op, and its gradient stays finite.
- ``gluon.loss.CTCLoss`` in both layouts on
  ``tests/test_ctc.py:127``'s case (padded data and label lengths):
  costs within rel 1e-5, gradients finite and within 1e-5.
- The slice as a whole: 3 steps of ``examples/speech_ctc.py``'s loop
  (its utterances; its BiLSTM + Dense model, at hidden 12;
  ``CTCLoss`` with lengths, ``clip_global_norm``, Adam) from the same
  weights: losses within rel 1e-4.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402
from incubator_mxnet_tpu_torch.ops.registry import OPS as TOPS  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import speech_ctc  # noqa: E402

CPU = mt.cpu()
T, B, C, L = 12, 4, 6, 4


def _labels(blank_label, rs):
    pad = 0 if blank_label == "first" else -1
    lo, hi = (1, C) if blank_label == "first" else (0, C - 1)
    lab = rs.randint(lo, hi, (B, L)).astype(np.float32)
    lab[0, 3] = pad                    # lengths 3, 4, 2 (padding inside), 0
    lab[1, 1] = lab[1, 2]              # a repeat: the skip is barred
    lab[2, 1] = pad
    lab[2, 3] = pad
    lab[3, :] = pad
    return lab


def _both(inputs, params, tol=1e-5):
    """Costs and the gradient of a weighted sum with respect to data, in
    both packages."""
    jfn = JOPS["ctc_loss"].fn

    @jax.jit
    def jax_cost_grad(ct, data, *rest):
        cost, vjp = jax.vjp(lambda d: jfn(d, *rest, **params), data)
        return cost, vjp(ct)[0]

    ct = np.linspace(0.5, 1.5, inputs[0].shape[1]).astype(np.float32)
    jcost, jgrad = jax_cost_grad(*(jnp.asarray(a) for a in [ct] + inputs))
    jgrad = np.asarray(jgrad)
    xs = [mt.nd.array(a, ctx=CPU) for a in inputs]
    xs[0].attach_grad()
    with mt.autograd.record():
        cost = mt.nd.ctc_loss(*xs, **params)
    cost.backward(mt.nd.array(ct, ctx=CPU))
    np.testing.assert_allclose(cost.asnumpy(), np.asarray(jcost), rtol=tol)
    grad = xs[0].grad.asnumpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, jgrad, rtol=0, atol=tol)
    return cost.asnumpy(), grad


@pytest.mark.parametrize("blank_label", ["first", "last"])
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_matches_jax(blank_label, lengths):
    rs = np.random.RandomState(0)
    data = rs.randn(T, B, C).astype(np.float32)
    inputs = [data, _labels(blank_label, rs)]
    params = dict(blank_label=blank_label)
    if lengths:
        inputs += [np.array([12, 9, 7, 5], np.float32),
                   np.array([3, 2, 2, 0], np.float32)]
        params.update(use_data_lengths=True, use_label_lengths=True)
    cost, grad = _both(inputs, params)
    assert (cost > 0).all() and (cost < 1e3).all()
    if lengths:                       # frames past a length get no gradient
        assert (grad[9:, 1] == 0).all() and (grad[5:, 3] == 0).all()


def test_ctc_aliases_and_impossible_alignment():
    assert TOPS["CTCLoss"] is TOPS["ctc_loss"] is TOPS["_contrib_CTCLoss"] \
        is TOPS["_contrib_ctc_loss"]
    assert mt.nd.contrib.ctc_loss is not None
    rs = np.random.RandomState(1)
    data = rs.randn(3, 2, 5).astype(np.float32)
    # 4 labels cannot fit 3 frames; "1 1" needs a blank between: 3 frames
    label = np.array([[1, 2, 3, 4], [1, 1, 0, 0]], np.float32)
    cost, _ = _both([data, label], dict(blank_label="first"))
    assert cost[0] == np.float32(1e30)
    assert cost[1] < 1e3


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_gluon_ctc_loss_padded_lengths(layout):
    # tests/test_ctc.py:127's case: the extended states past a label's
    # length keep NEG on both logaddexp inputs; the gradient stays finite
    rs = np.random.RandomState(7)
    T2, B2, C2, L2 = 26, 8, 9, 6
    pred = rs.randn(B2, T2, C2).astype(np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    label = np.full((B2, L2), -1, np.float32)
    lab_len = rs.randint(3, L2 + 1, B2)
    for i in range(B2):
        label[i, :lab_len[i]] = rs.randint(0, C2 - 1, lab_len[i])
    dat_len = rs.randint(2 * L2, T2 + 1, B2).astype(np.float32)
    arrays = [pred, label, dat_len, lab_len.astype(np.float32)]
    out = {}
    for pkg in (mx, mt):
        kw = {"ctx": CPU} if pkg is mt else {}
        loss_fn = pkg.gluon.loss.CTCLoss(layout=layout, label_layout="NT")
        xs = [pkg.nd.array(a, **kw) for a in arrays]
        xs[0].attach_grad()
        with pkg.autograd.record():
            loss = loss_fn(*xs)
            total = loss.mean()
        total.backward()
        out[pkg] = (loss.asnumpy(), xs[0].grad.asnumpy())
    np.testing.assert_allclose(out[mt][0], out[mx][0], rtol=1e-5)
    assert np.isfinite(out[mt][1]).all() and np.abs(out[mt][1]).sum() > 0
    np.testing.assert_allclose(out[mt][1], out[mx][1], rtol=0, atol=1e-5)


# ---------------------------------------- examples/speech_ctc.py's loop

FRAME_DIM, N_PHONES = speech_ctc.FRAME_DIM, speech_ctc.N_PHONES


def _acoustic_model(pkg, hidden):
    class AcousticModel(pkg.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.lstm = pkg.gluon.rnn.LSTM(
                    hidden, num_layers=1, bidirectional=True, layout="NTC",
                    input_size=FRAME_DIM)
                self.proj = pkg.gluon.nn.Dense(N_PHONES + 1, flatten=False,
                                               in_units=2 * hidden)

        def forward(self, x):
            state = self.lstm.begin_state(x.shape[0], **(
                {"ctx": x.context} if pkg is mt else {}))
            h, _ = self.lstm(x, state)
            return self.proj(h)

    return AcousticModel()


def test_speech_ctc_loop_matches_jax():
    rs = np.random.RandomState(0)
    templates = rs.randn(N_PHONES, FRAME_DIM).astype(np.float32) * 2
    batches = [speech_ctc.make_utterances(rs, 8, templates)
               for _ in range(3)]
    losses, weights = {}, None
    for pkg in (mt, mx):          # the port's Xavier weights go to JAX
        kw = {"ctx": CPU} if pkg is mt else {}
        mt.random.seed(0)
        net = _acoustic_model(pkg, 12)
        net.initialize(pkg.initializer.Xavier() if pkg is mt
                       else pkg.initializer.Zero(), **kw)
        params = list(net.collect_params().values())
        if weights is None:
            weights = [p.data().asnumpy() for p in params]
        else:
            for p, w in zip(params, weights):
                p.set_data(pkg.nd.array(w))
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-2})
        ctc = pkg.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
        losses[pkg] = []
        for X, Y, xl, yl in batches:
            xs = [pkg.nd.array(a, **kw) for a in (X, Y, xl, yl)]
            with pkg.autograd.record():
                loss = ctc(net(xs[0]), *xs[1:]).mean()
            loss.backward()
            pkg.gluon.utils.clip_global_norm(
                [p.grad() for p in params if p.grad_req != "null"], 1.0)
            trainer.step(8)
            losses[pkg].append(float(loss.asnumpy().reshape(-1)[0]))
    assert np.isfinite(losses[mt]).all()
    np.testing.assert_allclose(losses[mt], losses[mx], rtol=1e-4)
