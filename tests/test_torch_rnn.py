"""The port's recurrent stack against the JAX package's, on the CPU with
the same numpy inputs and weights.

- The fused ``RNN`` op for every mode x bidirectional x state_outputs
  (2 layers of LSTM, 1 of the other modes), and the LSTM
  with ``lstm_state_clip_{min,max}``: outputs, final states and the
  gradients of a weighted sum of the outputs with respect to data,
  parameters and states within 1e-5 (outputs) and 1e-4 (gradients) of
  the JAX op's.  Inter-layer dropout draws from the op's generator: a
  seeded generator repeats the masks, another does not, and torch's
  global generator is left alone.
- Each Gluon cell and ``unroll`` (``valid_length``) against the JAX
  cells on the same weights, and the other layout with per-step
  outputs against the port's first; the modifier cells, the
  bidirectional cell and the conv cells; the fused LSTM against JAX's,
  and each fused layer against its ``_unfuse()`` stack.
- ``BucketSentenceIter``: with the same Python and numpy seeds its
  batches equal the JAX iterator's bit for bit, across a reset.
- ``BucketingModule``: the bucketed LSTM LM of examples/lstm_bucketing.py
  at narrow width, two buckets, 3 Adam steps from the JAX module's
  weights: the losses within rel 1e-5 and every parameter within 1e-5
  after them.  The graph passes at levels 0 to 2 leave the RNN node's
  outputs bit-equal.
- Weights across: a Gluon ``.params`` file of ``rnn.LSTM`` / ``GRU`` /
  ``RNN`` and a ``BucketingModule`` checkpoint (``rnn_parameters``)
  written by the JAX package give the port the JAX outputs.
- ``mt.rnn``'s legacy names; the op on a tensor taken for a CUDA one
  raises rather than running anywhere but cuDNN.
"""
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu.ops.rnn import rnn_param_size as j_param_size  # noqa: E402
from incubator_mxnet_tpu_torch.ops import rnn as trnn  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

CPU = mt.cpu()
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
T, N, C, H, L = 5, 3, 4, 6, 2
# the other modes share the packing and the multi-layer walk with the
# LSTM, so one layer of them is enough (and compiles faster)
LAYERS = {"lstm": 2, "gru": 1, "rnn_tanh": 1, "rnn_relu": 1}


def _arr(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is mt else pkg.nd.array(a)


def _op_inputs(mode, bidir, seed=0):
    rs = np.random.RandomState(seed)
    D = 2 if bidir else 1
    L = LAYERS[mode]
    n = j_param_size(mode, L, C, H, bidir)
    assert n == trnn.rnn_param_size(mode, L, C, H, bidir)
    ins = [rs.rand(T, N, C).astype("f"),
           ((rs.rand(n) - 0.5) * 0.8).astype("f"),
           rs.rand(L * D, N, H).astype("f")]
    if mode == "lstm":
        ins.append(rs.rand(L * D, N, H).astype("f"))
    return ins


def _weights(shapes, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.rand(*s).astype("f") for s in shapes]


def _run_op(pkg, ins, ws, **kw):
    xs = [_arr(pkg, a) for a in ins]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.RNN(*xs, **kw)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = sum((o * _arr(pkg, w)).sum() for o, w in zip(outs, ws))
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


@functools.lru_cache(maxsize=None)
def _jax_ref(mode, bidir, clip):
    """The JAX op's outputs (state_outputs=True) and the gradients of
    the weighted sum of all outputs and of the first alone."""
    ins = _op_inputs(mode, bidir)
    L = LAYERS[mode]
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bidir,
              state_outputs=True)
    if clip:
        kw.update(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.25)
    D = 2 if bidir else 1
    ws = _weights([(T, N, D * H)] + [(L * D, N, H)] * (len(ins) - 2))
    outs, g_all = _run_op(mx, ins, ws, **kw)
    _, g_first = _run_op(mx, ins, ws[:1], **kw)
    return ins, kw, ws, outs, g_all, g_first


@pytest.mark.parametrize("state_outputs", [True, False])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, bidir, state_outputs):
    ins, kw, ws, outs, g_all, g_first = _jax_ref(mode, bidir, False)
    kw = dict(kw, state_outputs=state_outputs)
    p_outs, p_grads = _run_op(mt, ins, ws if state_outputs else ws[:1],
                              **kw)
    ref_outs = outs if state_outputs else outs[:1]
    ref_grads = g_all if state_outputs else g_first
    assert len(p_outs) == len(ref_outs)
    for a, b in zip(p_outs, ref_outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(p_grads, ref_grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bidir", [False, True])
def test_rnn_op_lstm_state_clip_matches_jax(bidir):
    ins, kw, ws, outs, g_all, _ = _jax_ref("lstm", bidir, True)
    p_outs, p_grads = _run_op(mt, ins, ws, **kw)
    for a, b in zip(p_outs, outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(p_grads, g_all):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    # the clip is applied: the cell state stays within the bounds
    assert outs[2].min() >= -0.2 - 1e-7 and outs[2].max() <= 0.25 + 1e-7


def test_rnn_op_dropout_draws_from_its_generator():
    big = torch.rand(50, 40, C, generator=torch.Generator().manual_seed(0))
    kw = dict(state_size=H, num_layers=3, mode="lstm", p=0.5,
              _training=True)
    flat = torch.rand(trnn.rnn_param_size("lstm", 3, C, H)) - 0.5
    h0 = torch.zeros(3, 40, H)
    runs = [trnn.rnn(big, flat, h0, h0, _rng=mt.random.generator(5), **kw)
            for _ in range(2)]
    other = trnn.rnn(big, flat, h0, h0, _rng=mt.random.generator(6), **kw)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], other)
    # no dropout outside training, none after the last layer
    ev = trnn.rnn(big, flat, h0, h0, _rng=mt.random.generator(5),
                  **dict(kw, _training=False))
    ref = trnn.rnn(big, flat, h0, h0, _rng=None,
                   **dict(kw, p=0.0, _training=False))
    assert torch.equal(ev, ref)
    state = torch.random.get_rng_state()
    trnn.rnn(big, flat, h0, h0, _rng=mt.random.generator(1), **kw)
    assert torch.equal(state, torch.random.get_rng_state())


def test_rnn_op_on_a_card_tensor_raises_rather_than_running_elsewhere(
        monkeypatch):
    """The op runs a CUDA tensor through cuDNN or raises: a tensor taken
    for a card tensor that cuDNN does not accept (here a CPU one) is
    refused, never run on ATen's path."""
    monkeypatch.setattr(trnn, "_on_card", lambda t: True)
    ins = [mt.nd.array(a, ctx=CPU) for a in _op_inputs("gru", False)]
    with pytest.raises(RuntimeError, match="cuDNN"):
        mt.nd.RNN(*ins, state_size=H, num_layers=LAYERS["gru"],
                  mode="gru")


def test_rnn_op_shape_inference_on_meta():
    data = mt.sym.Variable("data")
    out = mt.sym.RNN(data, mt.sym.Variable("p"), mt.sym.Variable("h"),
                     mt.sym.Variable("c"), state_size=H, num_layers=L,
                     mode="lstm", bidirectional=True, state_outputs=True)
    n = trnn.rnn_param_size("lstm", L, C, H, True)
    _, shapes, _ = out.infer_shape(data=(T, N, C), p=(n,),
                                   h=(2 * L, N, H), c=(2 * L, N, H))
    assert shapes == [(T, N, 2 * H), (2 * L, N, H), (2 * L, N, H)]


# ------------------------------------------------------------------ cells
def _pair_cells(make, seed=2):
    """The same cell built in both packages, the port's given the JAX
    one's weights."""
    mx.random.seed(seed)
    j = make(mx)
    j.initialize(mx.init.Uniform(0.4))
    p = make(mt)
    p.initialize(mt.init.Uniform(0.4), ctx=CPU)
    return j, p


def _copy_weights(j, p):
    src = {k[len(j.prefix):]: v.data().asnumpy()
           for k, v in j.collect_params().items()}
    for k, v in p.collect_params().items():
        v.set_data(torch.as_tensor(src[k[len(p.prefix):]]))


def _unroll_both(j, p, x, layout, valid, merge=None):
    """Both cells unrolled outside training (dropout the identity,
    zoneout its expectation): [(outputs, states)] of JAX, the port."""
    vl = np.array(valid, "f") if valid is not None else None
    res = []
    for pkg, cell in ((mx, j), (mt, p)):
        kw = dict(layout=layout, merge_outputs=merge)
        if vl is not None:
            kw["valid_length"] = _arr(pkg, vl)
        out, states = cell.unroll(x.shape[layout.find("T")], _arr(pkg, x),
                                  **kw)
        outs = out if isinstance(out, list) else [out]
        res.append(([o.asnumpy() for o in outs],
                    [s.asnumpy() for s in states]))
    return res


def _assert_pair(res, tol=1e-5):
    (jo, js), (po, ps) = res
    assert len(jo) == len(po) and len(js) == len(ps)
    for a, b in zip(jo + js, po + ps):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


CELLS = {
    "lstm": lambda P: P.gluon.rnn.LSTMCell(H, input_size=C),
    "gru": lambda P: P.gluon.rnn.GRUCell(H, input_size=C),
    "rnn_relu": lambda P: P.gluon.rnn.RNNCell(H, activation="relu",
                                              input_size=C),
    "rnn_tanh": lambda P: P.gluon.rnn.RNNCell(H, input_size=C),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name):
    x = np.random.RandomState(3).rand(N, T, C).astype("f")
    j, p = _pair_cells(CELLS[name])
    _copy_weights(j, p)
    if name != "lstm":
        _assert_pair(_unroll_both(j, p, x, "NTC", None))
        return
    vl = [2, 5, 3]
    _assert_pair(_unroll_both(j, p, x, "NTC", vl))
    # the other layout, per-step outputs: the port against itself
    ntc, ntc_states = p.unroll(T, mt.nd.array(x, ctx=CPU), layout="NTC",
                               valid_length=mt.nd.array(vl, ctx=CPU))
    steps, tnc_states = p.unroll(
        T, mt.nd.array(np.swapaxes(x, 0, 1), ctx=CPU), layout="TNC",
        merge_outputs=False, valid_length=mt.nd.array(vl, ctx=CPU))
    assert len(steps) == T
    np.testing.assert_array_equal(
        np.stack([o.asnumpy() for o in steps], 1), ntc.asnumpy())
    for a, b in zip(tnc_states, ntc_states):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_stacked_modifier_and_bidirectional_cells_match_jax():
    def stack(P):
        s = P.gluon.rnn.SequentialRNNCell()
        with s.name_scope():
            s.add(P.gluon.rnn.LSTMCell(H, input_size=C))
            s.add(P.gluon.rnn.ResidualCell(P.gluon.rnn.GRUCell(
                H, input_size=H)))
            s.add(P.gluon.rnn.DropoutCell(0.5))
            s.add(P.gluon.rnn.ZoneoutCell(P.gluon.rnn.RNNCell(
                H, input_size=H), zoneout_outputs=0.3,
                zoneout_states=0.2))
        return s

    x = np.random.RandomState(4).rand(N, T, C).astype("f")
    j, p = _pair_cells(stack)
    assert list(p.collect_params()) == list(j.collect_params())
    _copy_weights(j, p)
    _assert_pair(_unroll_both(j, p, x, "NTC", None))

    def bi(P):
        return P.gluon.rnn.BidirectionalCell(
            P.gluon.rnn.LSTMCell(H, input_size=C, prefix="l_"),
            P.gluon.rnn.GRUCell(H, input_size=C, prefix="r_"))

    j, p = _pair_cells(bi)
    assert list(p.collect_params()) == list(j.collect_params())
    _copy_weights(j, p)
    _assert_pair(_unroll_both(j, p, x, "NTC", [4, 1, 5]))
    with pytest.raises(NotImplementedError):
        p(mt.nd.array(x[:, 0], ctx=CPU), p.begin_state(batch_size=N,
                                                       ctx=CPU))


def test_deferred_cell_and_variational_dropout():
    cell = mt.gluon.rnn.LSTMCell(H)
    cell.initialize(ctx=CPU)
    x = mt.nd.array(np.random.RandomState(5).rand(N, T, C), ctx=CPU)
    out, _ = cell.unroll(T, x)
    assert out.shape == (N, T, H)
    assert cell.collect_params()[cell.prefix + "i2h_weight"].shape == \
        (4 * H, C)
    vd = mt.gluon.contrib.rnn.VariationalDropoutCell(
        mt.gluon.rnn.RNNCell(H, activation="relu", input_size=C),
        drop_inputs=0.5)
    vd.initialize(ctx=CPU)
    ones = mt.nd.ones((N, C), ctx=CPU)
    state = vd.begin_state(batch_size=N, ctx=CPU)
    with mt.autograd.record():
        vd(ones, state)
        m1 = vd._masks["in"].asnumpy()
        vd(ones, state)
        assert vd._masks["in"].asnumpy() is not None
        assert np.array_equal(vd._masks["in"].asnumpy(), m1)
        vd.reset()
        with mt.random.key_provider(mt.random.generator(9)):
            vd(ones, state)
        m2 = vd._masks["in"].asnumpy()
    assert set(np.unique(m1)) <= {0.0, 2.0} and not np.array_equal(m1, m2)


def test_conv_lstm_cell_matches_jax():
    """Two steps, the second fed the first's output."""
    shape = (3, 5, 6)

    def make(P):
        return P.gluon.contrib.rnn.Conv2DLSTMCell(
            shape, 3, i2h_kernel=(3, 3), h2h_kernel=(3, 3), i2h_pad=(1, 1))

    x = np.random.RandomState(6).rand(N, *shape).astype("f")
    j, p = _pair_cells(make)
    _copy_weights(j, p)
    outs = []
    for pkg, cell in ((mx, j), (mt, p)):
        states = cell.begin_state(batch_size=N, **(
            dict(ctx=CPU) if pkg is mt else {}))
        out, new = cell(_arr(pkg, x), states)
        out, new = cell(out, new)
        outs.append([out.asnumpy()] + [a.asnumpy() for a in new])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["Conv1DGRUCell", "Conv3DRNNCell"])
def test_conv_cells_one_step_equals_their_equations(kind):
    """The 1-D GRU and 3-D RNN cells' step against their equations on
    torch's functional convolutions (the shared code is held against
    the JAX cells by the 2-D LSTM cell; XLA's CPU convolutions compile
    slowly)."""
    import torch.nn.functional as tf
    shape = {"Conv1DGRUCell": (2, 7), "Conv3DRNNCell": (2, 3, 3, 4)}[kind]
    nsp = len(shape) - 1
    cell = getattr(mt.gluon.contrib.rnn, kind)(
        shape, 3, i2h_kernel=(3,) * nsp, h2h_kernel=(3,) * nsp,
        i2h_pad=(1,) * nsp, i2h_dilate=(1,) * nsp, h2h_dilate=(2,) * nsp)
    cell.initialize(mt.init.Uniform(0.4), ctx=CPU)
    x = torch.as_tensor(np.random.RandomState(6).rand(N, *shape)
                        .astype("f"))
    h = torch.as_tensor(np.random.RandomState(7).rand(
        N, 3, *shape[1:]).astype("f"))
    out, (new,) = cell(mt.nd.array(x, ctx=CPU), [mt.nd.array(h, ctx=CPU)])
    conv = {1: tf.conv1d, 3: tf.conv3d}[nsp]
    i2h = conv(x, cell.i2h_weight, cell.i2h_bias, padding=1)
    h2h = conv(h, cell.h2h_weight, cell.h2h_bias, padding=2, dilation=2)
    if kind == "Conv1DGRUCell":
        xr, xz, xn = i2h.chunk(3, 1)
        hr, hz, hn = h2h.chunk(3, 1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        ref = (1 - z) * torch.tanh(xn + r * hn) + z * h
    else:
        ref = torch.tanh(i2h + h2h)
    np.testing.assert_allclose(out.asnumpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert np.array_equal(new.asnumpy(), out.asnumpy())


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "RNN"])
def test_fused_layer_matches_jax_and_its_unfused_stack(cls):
    x = np.random.RandomState(7).rand(N, T, C).astype("f")

    def make(P, bidir):
        return getattr(P.gluon.rnn, cls)(H, num_layers=L, layout="NTC",
                                        bidirectional=bidir)

    # against JAX: the LSTM both ways (the op itself is held against JAX
    # for every mode), then every class against its unfused stack
    for bidir in (True, False) if cls == "LSTM" else ():
        j = make(mx, bidir)
        j.initialize(mx.init.Uniform(0.4))
        jy = j(mx.nd.array(x))
        p = make(mt, bidir)
        p.initialize(mt.init.Uniform(0.4), ctx=CPU)
        assert [k[len(p.prefix):] for k in p.collect_params()] == \
            [k[len(j.prefix):] for k in j.collect_params()]
        _copy_weights(j, p)
        state = p.begin_state(N, ctx=CPU)
        py, pstates = p(mt.nd.array(x, ctx=CPU), state)
        np.testing.assert_allclose(py.asnumpy(), jy.asnumpy(), rtol=1e-5,
                                   atol=1e-5)
        assert len(pstates) == len(state)
    if cls != "LSTM":
        p = make(mt, False)
        p.initialize(mt.init.Uniform(0.4), ctx=CPU)
        py = p(mt.nd.array(x, ctx=CPU))
    stack = p._unfuse()
    yc, _ = stack.unroll(T, mt.nd.array(x, ctx=CPU), layout="NTC",
                         merge_outputs=True)
    np.testing.assert_allclose(yc.asnumpy(), py.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    # torch tensors in (states too), torch tensors out; the deferred
    # input width
    q = make(mt, False)
    q.initialize(ctx=CPU)
    y = q(torch.as_tensor(x))
    assert isinstance(y, torch.Tensor) and y.shape == (N, T, H)
    h0 = torch.zeros(L, N, H, requires_grad=True)
    states = [h0, torch.zeros(L, N, H)] if cls == "LSTM" else [h0]
    y, out_states = q(torch.as_tensor(x), states)
    assert all(isinstance(s, torch.Tensor) for s in [y] + out_states)
    y.sum().backward()
    assert h0.grad is not None and h0.grad.abs().sum() > 0


def test_hybridized_block_with_lstm_equals_eager():
    class Model(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.rnn = mt.gluon.rnn.LSTM(8, input_size=C, layout="NTC")
                self.out = mt.gluon.nn.Dense(3, flatten=False, in_units=8)

        def hybrid_forward(self, F, x):
            return self.out(self.rnn(x))

    net = Model()
    net.initialize(mt.init.Xavier(), ctx=CPU)
    x = mt.nd.array(np.random.RandomState(8).rand(N, T, C), ctx=CPU)

    def step():
        with mt.autograd.record():
            y = net(x)
            (y * y).sum().backward()
        return y.asnumpy(), net.rnn._param("l0_h2h_weight").grad() \
            .asnumpy().copy()

    eager = step()
    net.hybridize()
    for a, b in zip(step(), eager):
        np.testing.assert_array_equal(a, b)
    assert net._cached_op.stats()["modes"] == ["jit"]


# ------------------------------------------------------------------ io
def _sentences(rs, n=120, vocab=20):
    return [[int(t) for t in rs.randint(1, vocab + 1, rs.randint(3, 17))]
            for _ in range(n)]


def _iter_batches(it):
    return [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             b.provide_data[0].shape) for b in it]


def test_bucket_sentence_iter_batches_equal_jax():
    sents = _sentences(np.random.RandomState(0))
    runs = []
    for pkg in (mx, mt):
        random.seed(11)
        np.random.seed(11)
        it = pkg.rnn.BucketSentenceIter(sents, 8, buckets=[6, 10, 16, 30],
                                        invalid_label=0)
        first = _iter_batches(it)
        random.seed(12)
        np.random.seed(12)
        it.reset()
        runs.append((first, _iter_batches(it), it.default_bucket_key,
                     [d.shape for d in it.provide_data]))
    (j1, j2, jk, jp), (p1, p2, pk, pp) = runs
    assert jk == pk == 30 and jp == pp and len(p1) == len(j1) > 3
    for (jb, jd, jl, js), (pb, pd, pl, ps) in zip(j1 + j2, p1 + p2):
        assert jb == pb and js == ps
        assert pd.dtype == jd.dtype
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pl, jl)
    coded, vocab = mt.rnn.encode_sentences([["a", "b"], ["b", "c"]])
    assert (coded, vocab) == mx.rnn.encode_sentences([["a", "b"],
                                                      ["b", "c"]])


def test_legacy_rnn_names():
    assert sorted(mt.rnn.__all__) == sorted(mx.rnn.__all__)
    assert mt.rnn.LSTMCell is mt.gluon.rnn.LSTMCell
    assert sorted(mt.gluon.rnn.__all__) == sorted(mx.gluon.rnn.__all__)
    assert sorted(mt.gluon.contrib.rnn.__all__) == \
        sorted(mx.gluon.contrib.rnn.__all__)
    assert mt.mod.BucketingModule is mt.module.BucketingModule


# ------------------------------------------------------------------ module
VOCAB, NH, NE, BATCH = 12, 8, 6, 4


def _sym_gen(P, num_layers=1):
    """examples/lstm_bucketing.py's sym_gen, narrow."""
    def sym_gen(seq_len):
        data = P.sym.Variable("data")
        label = P.sym.Variable("softmax_label")
        embed = P.sym.Embedding(data, input_dim=VOCAB, output_dim=NE,
                                name="embed")
        tnc = P.sym.swapaxes(embed, dim1=0, dim2=1)
        params = P.sym.Variable("rnn_parameters")
        init_h = P.sym.zeros((num_layers, BATCH, NH))
        init_c = P.sym.zeros((num_layers, BATCH, NH))
        out = P.sym.RNN(tnc, params, init_h, init_c, state_size=NH,
                        num_layers=num_layers, mode="lstm", name="rnn")
        ntc = P.sym.swapaxes(out, dim1=0, dim2=1)
        pred = P.sym.Reshape(ntc, shape=(-1, NH))
        pred = P.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        lab = P.sym.Reshape(label, shape=(-1,))
        pred = P.sym.SoftmaxOutput(pred, lab, name="softmax",
                                   use_ignore=True, ignore_label=0,
                                   normalization="valid")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _shapes(P, key, num_layers=1):
    psize = j_param_size("lstm", num_layers, NE, NH)
    return ([P.io.DataDesc("data", (BATCH, key)),
             P.io.DataDesc("rnn_parameters", (psize,))],
            [P.io.DataDesc("softmax_label", (BATCH, key))])


def _bucketing(P, default_key=8):
    kw = dict(context=CPU) if P is mt else {}
    mod = P.mod.BucketingModule(_sym_gen(P), default_bucket_key=default_key,
                                **kw)
    dsh, lsh = _shapes(P, default_key)
    mod.bind(data_shapes=dsh, label_shapes=lsh)
    mod.init_params(P.initializer.Mixed(
        [".*rnn_parameters", ".*"],
        [P.initializer.Uniform(0.1), P.initializer.Xavier()]))
    return mod


def _batch(P, key, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, VOCAB, (BATCH, key)).astype("f")
    y = np.concatenate([x[:, 1:], np.zeros((BATCH, 1), "f")], 1)
    dsh, lsh = _shapes(P, key)
    kw = dict(ctx=CPU) if P is mt else {}
    return P.io.DataBatch([P.nd.array(x, **kw)], [P.nd.array(y, **kw)],
                          bucket_key=key, provide_data=dsh,
                          provide_label=lsh), y


def _ce(prob, y):
    y = y.reshape(-1).astype(int)
    keep = y != 0
    return float(-np.log(prob[np.arange(len(y)), y][keep]).mean())


STEPS = ((6, 0), (8, 1), (6, 2))       # (bucket, batch seed) per step


@pytest.fixture(scope="module")
def jax_bucketing():
    """The JAX BucketingModule's start weights, then its 3 Adam steps
    over two buckets: (module, start weights, outputs of each step)."""
    jm = _bucketing(mx)
    start = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}
    jm.init_optimizer(kvstore=None, optimizer="adam",
                      optimizer_params=(("learning_rate", 0.01),))
    outs = []
    for key, seed in STEPS:
        b, _ = _batch(mx, key, seed)
        jm.forward(b, is_train=True)
        jm.backward()
        jm.update()
        outs.append(jm.get_outputs()[0].asnumpy())
    return jm, start, outs


def test_bucketing_module_two_buckets_match_jax(jax_bucketing):
    jm, start, j_outs = jax_bucketing
    pm = _bucketing(mt)
    pm.set_params({k: mt.nd.array(v, ctx=CPU) for k, v in start.items()},
                  {})
    pm.init_optimizer(kvstore=None, optimizer="adam",
                      optimizer_params=(("learning_rate", 0.01),))
    for (key, seed), j_out in zip(STEPS, j_outs):
        b, y = _batch(mt, key, seed)
        pm.forward(b, is_train=True)
        pm.backward()
        pm.update()
        out = pm.get_outputs()[0].asnumpy()
        assert out.shape == (BATCH * key, VOCAB)
        np.testing.assert_allclose(_ce(out, y), _ce(j_out, y), rtol=1e-5)
    assert sorted(pm._buckets) == [6, 8]
    (ja, _), (pa, _) = jm.get_params(), pm.get_params()
    assert sorted(ja) == sorted(pa)
    for k in ja:
        np.testing.assert_allclose(pa[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_graph_passes_leave_the_rnn_node_intact(monkeypatch, level):
    """The passes meet a variadic, multi-output, random op: it keeps its
    inputs, its generator index and its outputs at every level."""
    from incubator_mxnet_tpu_torch.graph.passes import optimize_symbol
    from incubator_mxnet_tpu_torch.symbol.symbol import _topo
    sym, _, _ = _sym_gen(mt, num_layers=2)(7)
    opt, _ = optimize_symbol(sym, level=level, device=torch.device("cpu"))
    (node,) = [n for n in _topo(opt._heads)
               if n.op is not None and n.op.name == "RNN"]
    assert len(node.inputs) == 4
    assert level == 0 or node.attrs["__rng_index__"] == "0"
    dsh, lsh = _shapes(mt, 7, num_layers=2)
    shapes = {d.name: d.shape for d in dsh + lsh}
    rs = np.random.RandomState(3)
    outs = []
    for lv in (str(level), "0"):
        monkeypatch.setenv("MXTPU_GRAPH_OPT", lv)
        ex = sym.simple_bind(CPU, grad_req="null", **shapes)
        if not outs:
            vals = {k: rs.rand(*v.shape).astype("f") * 0.2
                    for k, v in ex.arg_dict.items()}
            vals["data"] = rs.randint(0, VOCAB, (BATCH, 7)).astype("f")
        outs.append(ex.forward(**vals)[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "RNN"])
def test_gluon_params_file_of_a_jax_layer_loads(cls, tmp_path):
    x = np.random.RandomState(9).rand(T, N, C).astype("f")
    j = getattr(mx.gluon.rnn, cls)(H, bidirectional=True)
    j.initialize(mx.init.Uniform(0.4))
    jy = j(mx.nd.array(x)).asnumpy()
    f = str(tmp_path / "layer.params")
    j.save_parameters(f)
    p = getattr(mt.gluon.rnn, cls)(H, bidirectional=True)
    p.load_parameters(f, ctx=CPU)
    np.testing.assert_allclose(p(mt.nd.array(x, ctx=CPU)).asnumpy(), jy,
                               rtol=1e-5, atol=1e-6)


def test_bucketing_checkpoint_of_the_jax_package_loads(jax_bucketing,
                                                        tmp_path):
    jm = jax_bucketing[0]
    prefix = str(tmp_path / "lm")
    arg, aux = jm.get_params()
    mx.model.save_checkpoint(prefix, 1, jm.symbol, arg, aux)
    pm = mt.mod.BucketingModule(_sym_gen(mt), default_bucket_key=8,
                                context=CPU)
    dsh, lsh = _shapes(mt, 8)
    pm.bind(data_shapes=dsh, label_shapes=lsh)
    mt.convert.load_module_checkpoint(pm, prefix, 1)
    outs = []
    for P, m in ((mx, jm), (mt, pm)):
        b, _ = _batch(P, 8, 5)
        m.forward(b, is_train=True)      # no update follows
        outs.append(m.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    # the fused vector fills a Gluon LSTM with the same outputs
    flat = arg["rnn_parameters"].asnumpy()
    layer = mt.gluon.rnn.LSTM(NH)
    mt.convert.load_rnn_parameters(layer, flat, ctx=CPU)
    x = np.random.RandomState(6).rand(5, BATCH, NE).astype("f")
    h0 = np.zeros((1, BATCH, NH), "f")
    ref = mx.nd.RNN(mx.nd.array(x), arg["rnn_parameters"], mx.nd.array(h0),
                    mx.nd.array(h0), state_size=NH, num_layers=1,
                    mode="lstm").asnumpy()
    np.testing.assert_allclose(layer(mt.nd.array(x, ctx=CPU)).asnumpy(),
                               ref, rtol=1e-5, atol=1e-6)
    # a vector of the wrong length is refused before anything loads
    bad = {"rnn_parameters": np.zeros(7, "f")}
    with pytest.raises(ValueError, match="rnn_parameters"):
        mt.convert._check_rnn_nodes(pm.symbol, bad,
                                    {d.name: d.shape for d in dsh + lsh})
