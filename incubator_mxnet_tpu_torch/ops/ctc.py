"""CTC loss (twin of ``incubator_mxnet_tpu/ops/ctc.py``; ref:
src/operator/contrib/ctc_loss.cc, which wraps warp-ctc).

The log-semiring alpha recursion runs as a loop over the static time
axis in torch ops, every sequence of the batch at once, masked by the
data and label lengths, which stay device tensors: no length is read on
the host, so the op runs inside a CUDA-graph capture and on ``meta``
tensors.  The gradient (softmax minus the alignment posterior) is
torch autograd's through the loop.  ``torch.nn.functional.ctc_loss``
is not used: it reads the lengths on the host, returns ``inf`` for an
impossible alignment and its CUDA backward is not deterministic.

Conventions (ref docstring ctc_loss.cc:72-105):

- data (T, B, C), unnormalised; the softmax is taken here;
- label (B, L); with ``blank_label='first'`` the blank is channel 0 and
  the padding 0, with ``'last'`` the blank is channel C-1 and the
  padding -1; a label's length is its count of entries that are not
  padding, anywhere in the row, unless ``label_lengths`` is given;
- optional data_lengths (B,) and label_lengths (B,) inputs, gated by
  ``use_data_lengths`` / ``use_label_lengths``;
- out (B,): -log p(label | data).  ``NEG`` = -1e30 stands for -inf, so
  an impossible alignment costs 1e30.
"""
import torch

from .registry import defop

NEG = -1e30  # -inf substitute that keeps logaddexp gradients finite


def _logaddexp(a, b):
    # Both branches of the where must be NaN-free in their gradient too:
    # with a = b = NEG the dead branch's backward is 0/0, and the
    # where's zero times NaN is NaN.  Clamp the dead branch's inputs,
    # not only the max.
    ok = torch.maximum(a, b) > NEG / 2
    a_safe = torch.where(ok, a, 0.0)
    b_safe = torch.where(ok, b, 0.0)
    m = torch.maximum(a_safe, b_safe)
    out = m + torch.log(torch.exp(a_safe - m) + torch.exp(b_safe - m))
    return torch.where(ok, out, NEG)


def _shift(alpha, n):
    """alpha moved n states to the right, NEG filled in."""
    return torch.cat([torch.full_like(alpha[:, :n], NEG), alpha[:, :-n]],
                     dim=1)


def _ctc_costs(log_probs, lab, dat_len, lab_len, blank):
    """log_probs (T, B, C), lab (B, L) int64 data channels, lengths
    (B,) int64 -> costs (B,)."""
    T, B, C = log_probs.shape
    L = lab.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    s_idx = torch.arange(S, device=dev)
    z = torch.where(s_idx % 2 == 0, blank,
                    lab[:, ((s_idx - 1) // 2).clamp(0, L - 1)])   # (B, S)
    s_valid = s_idx[None, :] < 2 * lab_len[:, None] + 1
    # a skip from two states back: a label that differs from the one
    # two states before it
    z_m2 = torch.where(s_idx >= 2, z[:, (s_idx - 2).clamp(0, S - 1)], -1)
    allow_skip = (z != blank) & (z != z_m2)
    lp_z = torch.gather(log_probs, 2,
                        z.clamp(0, C - 1)[None].expand(T, B, S))

    alpha = torch.full((B, S), NEG, dtype=log_probs.dtype, device=dev)
    alpha = torch.cat(
        [lp_z[0, :, :1],
         torch.where(lab_len[:, None] > 0, lp_z[0, :, 1:2], NEG),
         alpha[:, 2:]], dim=1)
    for t in range(1, T):
        acc = _logaddexp(alpha, _shift(alpha, 1))
        acc = torch.where(allow_skip, _logaddexp(acc, _shift(alpha, 2)),
                          acc)
        new = torch.where(s_valid, acc + lp_z[t], NEG)
        # frozen past the sequence's own length
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    end = 2 * lab_len                                # the last blank
    a_last = alpha.gather(1, end.clamp(0, S - 1)[:, None])[:, 0]
    a_prev = torch.where(
        lab_len > 0, alpha.gather(1, (end - 1).clamp(0, S - 1)[:, None])[:, 0],
        NEG)
    return -_logaddexp(a_last, a_prev)


@defop("ctc_loss", aliases=("_contrib_CTCLoss", "CTCLoss",
                            "_contrib_ctc_loss"), variadic=True)
def ctc_loss(*inputs, use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss (ref: src/operator/contrib/ctc_loss.cc).
    inputs: data (T, B, C), label (B, L)
    [, data_lengths (B,)][, label_lengths (B,)] -> costs (B,)."""
    data, label = inputs[0], inputs[1]
    k = 2
    data_lengths = label_lengths = None
    if use_data_lengths:
        data_lengths = inputs[k]
        k += 1
    if use_label_lengths:
        label_lengths = inputs[k]

    T, B, C = data.shape
    lab = label.to(torch.int64)
    first = blank_label == "first"
    blank = 0 if first else C - 1
    pad = 0 if first else -1
    if label_lengths is None:
        lab_len = (lab != pad).sum(dim=1)
    else:
        lab_len = label_lengths.to(torch.int64)
    if data_lengths is None:
        dat_len = torch.full((B,), T, dtype=torch.int64,
                             device=data.device)
    else:
        dat_len = data_lengths.to(torch.int64)
    log_probs = torch.log_softmax(data.float(), dim=2)
    return _ctc_costs(log_probs, lab, dat_len, lab_len, blank) \
        .to(data.dtype)
