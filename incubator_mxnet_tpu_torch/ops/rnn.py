"""Fused RNN op: multi-layer (bi)directional RNN/LSTM/GRU (twin of
``incubator_mxnet_tpu/ops/rnn.py``; ref: src/operator/rnn-inl.h,
registered rnn.cc, cuDNN's ``cudnn_rnn-inl.h``).

API parity with the reference op:
  RNN(data, parameters, state[, state_cell], state_size=, num_layers=,
      mode='rnn_relu'|'rnn_tanh'|'lstm'|'gru', bidirectional=False,
      p=0.0, state_outputs=False, lstm_state_clip_min=None,
      lstm_state_clip_max=None)
  data (T, N, C) time-major; ``parameters`` is the flat vector packed
  the MXNet way (all weights layer-major, then all biases: what
  gluon's rnn_layer produces); state (L*D, N, H).
Gate orders are LSTM i,f,g,o and GRU r,z,n, torch's own.

Each layer is one call of torch's fused RNN entry point
(``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``, both
directions in the call) on weight views cut from the flat vector:
cuDNN on the card, ATen's implementation on the CPU and on ``meta``
tensors (bind-time shape inference).  On a CUDA tensor the op checks
that cuDNN takes the input and raises if it does not: it never runs
elsewhere.  The views are not cuDNN's flat weight layout, so torch
copies them into one buffer on every call.

Inter-layer dropout (``p > 0`` in training, after every layer but the
last) is drawn here from the op's generator, between the per-layer
calls; the entry points' own ``dropout`` argument would draw from
torch's global generator.  ``lstm_state_clip_{min,max}`` has no cuDNN
route, so where it is set the LSTM runs a per-timestep loop of torch
ops (input projections hoisted into one product), on the card too.
"""
import torch

from .registry import defop

__all__ = ["rnn", "rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _unpack_params(flat, mode, num_layers, input_size, H, bidir):
    """Walk the flat packed vector into per-(layer, dir) W and b views."""
    G = _GATES[mode]
    D = 2 if bidir else 1
    weights, biases = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        for _ in range(D):
            w_ih = flat[off:off + G * H * in_sz].reshape(G * H, in_sz)
            off += G * H * in_sz
            w_hh = flat[off:off + G * H * H].reshape(G * H, H)
            off += G * H * H
            weights.append((w_ih, w_hh))
    for layer in range(num_layers):
        for _ in range(D):
            b_ih = flat[off:off + G * H]
            off += G * H
            b_hh = flat[off:off + G * H]
            off += G * H
            biases.append((b_ih, b_hh))
    return weights, biases


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False):
    """Length of the flat parameter vector (helper for frontends)."""
    G = _GATES[mode]
    D = 2 if bidirectional else 1
    H = state_size
    n = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        n += D * (G * H * in_sz + G * H * H + 2 * G * H)
    return n


def _on_card(t):
    return t.device.type == "cuda"


def _check_cudnn(x):
    if not torch.backends.cudnn.is_acceptable(x):
        raise RuntimeError(
            f"RNN: cuDNN does not take this input ({x.dtype} on "
            f"{x.device}, cudnn enabled: {torch.backends.cudnn.enabled}); "
            "the op runs on the card only through cuDNN")


def _fused_layer(x, mode, params, h0, c0, bidir, train):
    """One layer, both directions, through torch's fused entry point."""
    fn = getattr(torch._VF, mode)
    hx = (h0, c0) if mode == "lstm" else h0
    out = fn(x, hx, params, True, 1, 0.0, train, bidir, False)
    y, h = out[0], out[1]
    return y, h, (out[2] if mode == "lstm" else None)


def _clipped_lstm_dir(x, w_ih, w_hh, b_ih, b_hh, h, c, clip, reverse):
    """One direction of an LSTM layer with the cell state clipped at
    every step, before the output gate (cuDNN's rule, ref: rnn-inl.h
    lstm_state_clip_{min,max})."""
    T = x.shape[0]
    xg = torch.matmul(x, w_ih.t()) + b_ih            # hoisted product
    ys = [None] * T
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        g = xg[t] + torch.matmul(h, w_hh.t()) + b_hh
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        c = torch.clamp(c, clip[0], clip[1])
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys, 0), h, c


def _rnn_num_outputs(params):
    return 3 if params.get("state_outputs", False) and \
        params.get("mode", "lstm") == "lstm" else \
        (2 if params.get("state_outputs", False) else 1)


@defop("RNN", variadic=True, needs_rng=True, needs_mode=True,
       num_outputs=_rnn_num_outputs)
def rnn(*args, state_size=0, num_layers=1, mode="lstm",
        bidirectional=False, p=0.0, state_outputs=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        _rng=None, _training=False):
    """Fused multi-layer RNN (ref: src/operator/rnn-inl.h RNNParam)."""
    data, flat = args[0], args[1]
    state = args[2]
    if mode == "lstm" and len(args) < 4:
        raise ValueError(
            "RNN(mode='lstm') requires a state_cell input "
            "(data, parameters, state, state_cell)")
    state_cell = args[3] if mode == "lstm" else None
    T, N, C = data.shape
    H = int(state_size)
    L = int(num_layers)
    D = 2 if bidirectional else 1
    weights, biases = _unpack_params(flat, mode, L, C, H, bidirectional)
    clip = (lstm_state_clip_min, lstm_state_clip_max) \
        if mode == "lstm" and lstm_state_clip_min is not None else None
    if _on_card(data) and clip is None:
        _check_cudnn(data)
    # cuDNN keeps its reserve for the backward only in training mode
    train = bool(_training) or (torch.is_grad_enabled() and any(
        t.requires_grad for t in args))
    x = data
    h_finals, c_finals = [], []
    for layer in range(L):
        sl = slice(layer * D, (layer + 1) * D)
        h0 = state[sl]
        c0 = state_cell[sl] if state_cell is not None else None
        if clip is None:
            params = []
            for d in range(D):
                params += [*weights[layer * D + d], *biases[layer * D + d]]
            x, h, c = _fused_layer(x, mode, params, h0.contiguous(),
                                   None if c0 is None else c0.contiguous(),
                                   bidirectional, train)
            h_finals.append(h)
            if c is not None:
                c_finals.append(c)
        else:
            outs = []
            for d in range(D):
                idx = layer * D + d
                ys, h, c = _clipped_lstm_dir(
                    x, *weights[idx], *biases[idx], h0[d], c0[d], clip,
                    reverse=d == 1)
                outs.append(ys)
                h_finals.append(h[None])
                c_finals.append(c[None])
            x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and _training and layer < L - 1 and _rng is not None:
            keep = torch.rand(x.shape, generator=_rng,
                              device=x.device) >= p
            x = torch.where(keep, x / (1.0 - p),
                            torch.zeros((), dtype=x.dtype, device=x.device))

    if not state_outputs:
        return x
    h_out = torch.cat(h_finals, dim=0)
    if mode == "lstm":
        return x, h_out, torch.cat(c_finals, dim=0)
    return x, h_out
