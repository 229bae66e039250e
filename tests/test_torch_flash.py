"""The port's flash attention (incubator_mxnet_tpu_torch/ops/flash.py)
against the JAX package's (incubator_mxnet_tpu/ops/flash.py), forward
and backward.

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode, or its reference path where
the 128-tiling does not cover the shape.  Forward tolerance 2e-5, as the
JAX package's own flash tests use; gradients 1e-4, since they sum
products over every key and query in another order.  The kernels' loop
bounds (which key tiles each query tile visits, ``_k_tile_range``, and
which query tiles each key tile visits, ``_q_tile_range``) are held
against the JAX kernels' band helpers and against the mask itself.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_mxnet_tpu.ops import flash as jflash  # noqa: E402
from incubator_mxnet_tpu_torch.ops import flash as tflash  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(bh, lq, d, lk=None, seed=0):
    rs = np.random.RandomState(seed)
    lk = lq if lk is None else lk
    return [rs.normal(0, 1, (bh, n, d)).astype(np.float32)
            for n in (lq, lk, lk)]


def _port(arrs, **kw):
    o, lse = tflash.flash_attention_fwd(
        *(torch.from_numpy(a) for a in arrs), **kw)
    return o.numpy(), lse.numpy()


def _jax(arrs, **kw):
    return np.asarray(jflash.flash_attention(
        *(jnp.asarray(a) for a in arrs), interpret=True, **kw))


@pytest.mark.parametrize("l", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_kernel(causal, l):
    arrs = _inputs(2, l, 64)
    got, lse = _port(arrs, causal=causal)
    jarrs = [jnp.asarray(a) for a in arrs]
    # the Pallas kernel's forward (interpret mode) with its lse, lane 0
    jo, jlse = jflash._flash_fwd(*jarrs, causal, 1.0 / 8.0, True)
    np.testing.assert_allclose(got, np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse, np.asarray(jlse)[..., 0], **TOL)
    ref = jflash._reference_attention(*jarrs, causal, 1.0 / 8.0)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_window_matches_jax_kernel():
    arrs = _inputs(2, 256, 32, seed=1)
    got, _ = _port(arrs, causal=True, window=64)
    np.testing.assert_allclose(
        got, _jax(arrs, causal=True, window=64), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lq_ne_lk_matches_jax_kernel(causal):
    arrs = _inputs(2, 128, 32, lk=256, seed=2)
    got, _ = _port(arrs, causal=causal)
    np.testing.assert_allclose(got, _jax(arrs, causal=causal), **TOL)


def test_ragged_length_matches_jax_reference_path():
    # L=200 is not 128-divisible: the JAX op takes its reference path
    arrs = _inputs(2, 200, 64, seed=3)
    assert not jflash._supported(*(jnp.asarray(a) for a in arrs[:2]))
    got, _ = _port(arrs, causal=True, scale=0.3)
    np.testing.assert_allclose(
        got, _jax(arrs, causal=True, scale=0.3), **TOL)


def test_argument_errors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 32))
    with pytest.raises(ValueError, match="window must be >= 0"):
        tflash.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="requires causal"):
        tflash.flash_attention(q, k, v, causal=False, window=4)
    k2 = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="lq == lk"):
        tflash.flash_attention(q, k2, k2, window=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        tflash.flash_attention(q, k, torch.zeros(1, 16, 16))
    with pytest.raises(ValueError, match=r"\(BH, L, D\)"):
        tflash.flash_attention(q[0], k[0], v[0])
    # gradients flow (through _FlashAttention and its plain backward)
    qg = q.clone().requires_grad_()
    (dq,) = torch.autograd.grad(tflash.flash_attention(qg, k, v).sum(),
                                (qg,))
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    assert float(dq.abs().max()) > 0
    # meta tensors (shape inference, counted cost, the memory planner's
    # trace) take the plain version, or give the shapes alone
    qm, km, vm = (t.to("meta") for t in (q, k, v))
    o, lse = tflash.flash_attention_fwd(qm, km, vm)
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    assert o.device.type == lse.device.type == "meta"
    with tflash.meta_shapes_only():
        o2, lse2 = tflash.flash_attention_fwd(qm, km, vm)
    assert o2.shape == o.shape and lse2.dtype == torch.float32


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    # checked before the library is loaded, so no card is needed
    x = torch.zeros(2, 64, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash._launch(x.half(), x.half(), x.half(), True, 0.1, 0)
    y = torch.zeros(2, 64, 48)
    with pytest.raises(ValueError, match="head dim"):
        tflash._launch(y, y, y, True, 0.1, 0)
    nc = torch.zeros(2, 64, 64).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tflash._launch(nc, nc, nc, True, 0.1, 0)
    with pytest.raises(ValueError, match="share device and dtype"):
        tflash._launch(x, x.bfloat16(), x, True, 0.1, 0)


def test_band_helpers_match_jax():
    # the kernel's loop bounds, at the JAX kernel's 128-tiles: the tiles
    # its banded grid visits (_band_nj/_band_k_index) and the ones it
    # keeps live (_block_live)
    for l in (128, 256, 512, 1024):
        nk = l // 128
        for window in (0, 1, 64, 127, 128, 129, 300):
            nj = jflash._band_nj(window, 128, 128, nk) if window else nk
            for iq in range(nk):
                first, stop = tflash._k_tile_range(iq, l, l, True, window,
                                                   128, 128)
                live = {jk for jk in range(nk) if bool(jflash._block_live(
                    iq, jk, 128, 128, True, window))}
                if window:
                    visited = set()
                    for j in range(nj):
                        jk, valid = jflash._band_k_index(
                            iq, j, 128, 128, nk, window)
                        if valid:
                            visited.add(int(jk))
                    assert visited == live, (l, window, iq)
                assert set(range(first, stop)) == live, (l, window, iq)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 1), (True, 16),
                                           (True, 64), (True, 100)])
def test_kernel_tile_range_covers_exactly_the_kept_pairs(causal, window):
    # at the CUDA kernel's 64-tiles, ragged lengths and lq != lk
    bq, bk = tflash.BQ, tflash.BK
    shapes = [(1, 1), (63, 63), (64, 64), (65, 65), (200, 200),
              (257, 257)]
    if not window:
        shapes += [(64, 200), (200, 64), (130, 257)]
    for lq, lk in shapes:
        qp = np.arange(lq)[:, None]
        kp = np.arange(lk)[None, :]
        keep = np.ones((lq, lk), bool)
        if causal:
            keep = qp >= kp
            if window:
                keep &= qp - kp < window
        for iq in range(math.ceil(lq / bq)):
            rows = keep[iq * bq:(iq + 1) * bq]
            live = {jk for jk in range(math.ceil(lk / bk))
                    if rows[:, jk * bk:(jk + 1) * bk].any()}
            first, stop = tflash._k_tile_range(iq, lq, lk, causal, window)
            assert set(range(first, stop)) == live, (lq, lk, iq)


def test_bwd_kernel_wrapper_refuses_what_the_kernels_do_not_take():
    # checked before the library is loaded, so no card is needed
    x = torch.zeros(2, 64, 64)
    lse = torch.zeros(2, 64)

    def bwd(q, k, v, g, lse=lse):
        return tflash._launch_bwd(q, k, v, q, lse, g, True, 0.1, 0)

    h = x.half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd(h, h, h, h)
    y = torch.zeros(2, 64, 48)
    with pytest.raises(ValueError, match="head dim"):
        bwd(y, y, y, y)
    nc = torch.zeros(64, 2, 64).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(x, x, x, nc)
    with pytest.raises(ValueError, match="share device and dtype"):
        bwd(x, x, x, x.bfloat16())
    with pytest.raises(ValueError, match="lse must be"):
        bwd(x, x, x, x, lse.double())
    with pytest.raises(ValueError, match="delta must be"):
        tflash._launch_dkv(x, x, x, x, lse, lse[:, :8], True, 0.1, 0)


def test_inference_saves_nothing_training_saves_the_residuals():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(1, 16, 32))
    with torch.no_grad():
        assert tflash.flash_attention(q, k, v).grad_fn is None
    out = tflash.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


# ------------------------------------------------------------ backward

def _grads_port(arrs, g, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = tflash.flash_attention(q, k, v, **kw)
    return [t.numpy() for t in torch.autograd.grad(
        o, (q, k, v), torch.from_numpy(g))]


def _grads_autograd_reference(arrs, g, causal, scale, window=0):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o, _ = tflash._reference_fwd(q, k, v, causal, scale, window)
    return [t.numpy() for t in torch.autograd.grad(
        o, (q, k, v), torch.from_numpy(g))]


def _grads_jax_kernel(arrs, g, causal, scale, window=0):
    """The Pallas forward and backward kernels, interpret mode."""
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    o, lse = jflash._flash_fwd(jq, jk, jv, causal, scale, True, window)
    return [np.asarray(t) for t in jflash._flash_bwd(
        jq, jk, jv, o, lse, jnp.asarray(g), causal, scale, True, window)]


def _check_grads(arrs, causal, window=0, seed=10):
    g = np.random.RandomState(seed).normal(
        0, 1, arrs[0].shape).astype(np.float32)
    scale = 1.0 / math.sqrt(arrs[0].shape[-1])
    got = _grads_port(arrs, g, causal=causal, window=window)
    for ref in (_grads_jax_kernel(arrs, g, causal, scale, window),
                _grads_autograd_reference(arrs, g, causal, scale,
                                          window)):
        for name, a, b in zip("dq dk dv".split(), got, ref):
            np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("l", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_matches_jax_kernel(causal, l):
    _check_grads(_inputs(2, l, 64, seed=4), causal)


def test_bwd_window_matches_jax_kernel():
    _check_grads(_inputs(2, 256, 32, seed=5), True, window=64)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_lq_ne_lk_matches_jax_kernel(causal):
    _check_grads(_inputs(2, 128, 32, lk=256, seed=6), causal)


def test_bwd_ragged_length_matches_jax_reference_path():
    # L=200 is not 128-divisible: the JAX op takes its reference path,
    # and jax.vjp differentiates that
    arrs = _inputs(2, 200, 64, seed=7)
    g = np.random.RandomState(8).normal(0, 1, arrs[0].shape) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jflash.flash_attention(
        q, k, v, causal=True, scale=0.3, interpret=True),
        *(jnp.asarray(a) for a in arrs))
    ref = vjp(jnp.asarray(g))
    got = _grads_port(arrs, g, causal=True, scale=0.3)
    for name, a, b in zip("dq dk dv".split(), got, ref):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


def test_bwd_causal_keys_past_the_last_query_get_zero_gradient():
    # causal, Lk > Lq: keys past the last query are seen by no query
    arrs = _inputs(2, 64, 32, lk=200, seed=9)
    g = np.ones(arrs[0].shape, np.float32)
    _, dk, dv = _grads_port(arrs, g, causal=True)
    assert not dk[:, 64:].any() and not dv[:, 64:].any()
    assert dk[:, :64].any() and dv[:, :64].any()


def test_q_band_helpers_match_jax():
    # flash_dkv's loop bounds, at the JAX kernel's 128-tiles: the query
    # tiles its banded grid visits (_band_nj/_band_q_index) and the ones
    # it keeps live (_block_live)
    for l in (128, 256, 512, 1024):
        nq = l // 128
        for window in (0, 1, 64, 127, 128, 129, 300):
            nj = jflash._band_nj(window, 128, 128, nq) if window else nq
            for jk in range(nq):
                first, stop = tflash._q_tile_range(jk, l, l, True, window,
                                                   128, 128)
                live = {iq for iq in range(nq) if bool(jflash._block_live(
                    iq, jk, 128, 128, True, window))}
                if window:
                    visited = set()
                    for j in range(nj):
                        iq, valid = jflash._band_q_index(
                            jk, j, 128, 128, nq, window)
                        if valid:
                            visited.add(int(iq))
                    assert visited == live, (l, window, jk)
                assert set(range(first, stop)) == live, (l, window, jk)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 1), (True, 16),
                                           (True, 64), (True, 100)])
def test_kernel_q_tile_range_covers_exactly_the_kept_pairs(causal, window):
    # at the CUDA kernel's 64-tiles, ragged lengths and lq != lk
    bq, bk = tflash.BQ, tflash.BK
    shapes = [(1, 1), (63, 63), (64, 64), (65, 65), (200, 200),
              (257, 257)]
    if not window:
        shapes += [(64, 200), (200, 64), (130, 257), (1, 130)]
    for lq, lk in shapes:
        qp = np.arange(lq)[:, None]
        kp = np.arange(lk)[None, :]
        keep = np.ones((lq, lk), bool)
        if causal:
            keep = qp >= kp
            if window:
                keep &= qp - kp < window
        for jk in range(math.ceil(lk / bk)):
            cols = keep[:, jk * bk:(jk + 1) * bk]
            live = {iq for iq in range(math.ceil(lq / bq))
                    if cols[iq * bq:(iq + 1) * bq].any()}
            first, stop = tflash._q_tile_range(jk, lq, lk, causal, window)
            assert set(range(first, stop)) == live, (lq, lk, jk)


# ---------------------------------------------------------------- bf16

def _bf16_inputs(bh, l, d, seed, lk=None):
    """q, k, v and the output gradient g as numpy fp32 values that bf16
    holds exactly, so both packages get the same bf16 tensors."""
    arrs = _inputs(bh, l, d, lk=lk, seed=seed)
    arrs.append(np.random.RandomState(seed + 1).normal(
        0, 1, arrs[0].shape).astype(np.float32))
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_bf16_matches_jax_kernel(causal):
    # the port's bf16 backward on the CPU (its plain version) against the
    # Pallas kernels in interpret mode on the same bf16 inputs, within
    # the bf16 tolerance of chip_smoke.py's kernels_bwd (2e-2 abs + rel)
    arrs = _bf16_inputs(2, 128, 64, seed=12)
    scale = 1.0 / 8.0
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    o, lse = jflash._flash_fwd(jq, jk, jv, causal, scale, True)
    ref = jflash._flash_bwd(jq, jk, jv, o, lse, jg, causal, scale, True)
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_()
               for a in arrs[:3])
    out = tflash.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v),
                              torch.from_numpy(arrs[3]).bfloat16())
    for name, a, b in zip("dq dk dv".split(), got, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b.astype(jnp.float32)),
            rtol=2e-2, atol=2e-2, err_msg=name)


def _tensor_core_recipe_bwd(q, k, v, o, lse, g, causal, scale):
    """The arithmetic of the bf16 kernels in csrc/flash_bwd.cu: products
    of bf16 operands summed in fp32, P and dS rounded to bf16 before the
    gradient products (they feed wgmma from registers), dq/dk/dv rounded
    to bf16 once at the end."""
    delta = tflash._delta(g, o)
    p, ds = tflash._reference_p_ds(q, k, v, g, lse, delta, causal, scale,
                                   0)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = ds @ k.float()
    dk = ds.transpose(1, 2) @ q.float()
    dv = p.transpose(1, 2) @ g.float()
    return [t.bfloat16() for t in (dq, dk, dv)]


def test_bf16_recipe_rounding_stays_inside_the_card_tolerance():
    # The rounding of P and dS that the tensor-core kernels add, against
    # the plain backward the card holds them to, at chip_smoke.py's bf16
    # BWD_TOL.  Worst |error| / (tol * (1 + |ref|)) seen here: 0.365
    # (dv; dq 0.192, dk 0.205), where the two sums land one bf16 step
    # apart after the outputs' own rounding.
    from chip_smoke import BWD_TOL
    tol = BWD_TOL["bfloat16"]
    q, k, v, g = (torch.from_numpy(a).bfloat16()
                  for a in _bf16_inputs(2, 512, 64, seed=13))
    scale = 1.0 / 8.0
    o, lse = tflash._reference_fwd(q, k, v, True, scale)
    got = _tensor_core_recipe_bwd(q, k, v, o, lse, g, True, scale)
    ref = tflash._reference_bwd(q, k, v, o, lse, g, True, scale)
    worst = {}
    for name, a, b in zip("dq dk dv".split(), got, ref):
        a, b = a.float(), b.float()
        worst[name] = ((a - b).abs() / (tol * (1 + b.abs()))).max().item()
    assert max(worst.values()) <= 1.0, worst


def test_kernel_wrappers_refuse_unaligned_tensors():
    # TMA reads the tensor-core kernels' operands (the forward's in fp32
    # and bf16, the bf16 backward's): a contiguous view 4 or 2 bytes past
    # an aligned base is refused before the library is loaded
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, 64, 64, dtype=dtype)
        mis = torch.zeros(2 * 64 * 64 + 1, dtype=dtype)[1:].view(2, 64, 64)
        assert mis.is_contiguous() and mis.data_ptr() % 16
        for args in ((mis, x, x), (x, mis, x), (x, x, mis)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                tflash._launch(*args, True, 0.1, 0)
    x = torch.zeros(2, 64, 64)
    lse = torch.zeros(2, 64)
    mis = torch.zeros(2 * 64 * 64 + 1)[1:].view(2, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash._launch_bwd(x, x, x, x, lse, mis, True, 0.1, 0)
    lse_mis = torch.zeros(2 * 64 + 1)[1:].view(2, 64)
    for launch in (tflash._launch_dq, tflash._launch_dkv):
        with pytest.raises(ValueError, match="lse must be"):
            launch(x, x, x, x, lse_mis, lse, True, 0.1, 0)
        with pytest.raises(ValueError, match="delta must be"):
            launch(x, x, x, x, lse, lse_mis, True, 0.1, 0)


# ------------------------------------------------- bf16 forward recipe

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _tensor_core_recipe_fwd(q, k, v, causal, scale, window=0):
    """The arithmetic of flash_fwd_tc_kernel (csrc/flash_fwd.cu): bf16
    q.k^T products summed in fp32, the scale (times log2 e, in fp32)
    applied to the accumulator, an online softmax over the 64-key tiles
    of the band (``_k_tile_range``) with l summed from the fp32 p, P
    rounded to bf16 before P.v, o rounded to bf16 once at the end.
    Returns (o bf16, lse (BH, Lq) fp32)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    keep = tflash._mask(lq, lk, causal, window, q.device)
    o = torch.zeros(bh, lq, d)
    lse = torch.zeros(bh, lq)
    for iq in range(math.ceil(lq / tflash.BQ)):
        rows = slice(iq * tflash.BQ, (iq + 1) * tflash.BQ)
        qt = q[:, rows].float()
        n = qt.shape[1]
        m = torch.full((bh, n), -math.inf)
        l = torch.zeros(bh, n)
        acc = torch.zeros(bh, n, d)
        for jk in range(*tflash._k_tile_range(iq, lq, lk, causal, window)):
            cols = slice(jk * tflash.BK, (jk + 1) * tflash.BK)
            t = (qt @ k[:, cols].float().transpose(1, 2)) * sl2
            if keep is not None:
                t = t.masked_fill(~keep[rows, cols], -math.inf)
            m_new = torch.maximum(m, t.amax(-1))
            mu = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(t - mu[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] \
                + p.bfloat16().float() @ v[:, cols].float()
            m = m_new
        live = l > 0
        o[:, rows] = torch.where(live[..., None], acc / l[..., None], 0.0)
        lse[:, rows] = torch.where(live, (m + torch.log2(l)) * LN2,
                                   -math.inf)
    return o.bfloat16(), lse


def _bf16_qkv(bh, lq, d, seed, lk=None):
    return [torch.from_numpy(a).bfloat16()
            for a in _bf16_inputs(bh, lq, d, seed, lk)[:3]]


@pytest.mark.parametrize("causal,window,l", [(True, 0, 512),
                                             (False, 0, 512),
                                             (True, 100, 200)])
def test_bf16_fwd_recipe_stays_inside_the_card_tolerance(causal, window,
                                                         l):
    # The rounding of P that the tensor-core forward adds, against the
    # plain version the card holds it to, at chip_smoke.py's bf16 TOL.
    # Worst |error| / (tol * (1 + |ref|)) of o seen here: 0.192 (causal,
    # L=512), 0.078 (not causal), 0.259 (window 100, L=200), where the
    # two sums land one bf16 step apart after o's own rounding; of lse
    # under 1e-5, since l sums the fp32 p.
    from chip_smoke import TOL
    tol = TOL["bfloat16"]
    q, k, v = _bf16_qkv(4, l, 64, seed=14)
    o, lse = _tensor_core_recipe_fwd(q, k, v, causal, 0.125, window)
    ro, rlse = tflash._reference_fwd(q, k, v, causal, 0.125, window)
    assert o.dtype == ro.dtype == torch.bfloat16
    worst = {}
    for name, a, b in (("o", o, ro), ("lse", lse, rlse)):
        a, b = a.float(), b.float()
        worst[name] = ((a - b).abs() / (tol * (1 + b.abs()))).max().item()
    assert max(worst.values()) <= 1.0, worst


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_fwd_recipe_matches_jax_kernel(causal):
    # the recipe's o and lse against the Pallas forward in interpret mode
    # on the same bf16 inputs, within 2e-2 (abs + rel)
    q, k, v = _bf16_qkv(2, 256, 64, seed=15)
    o, lse = _tensor_core_recipe_fwd(q, k, v, causal, 0.125)
    jo, jlse = jflash._flash_fwd(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal, 0.125, True)
    assert jo.dtype == jnp.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal,window,lq,lk", [(True, 0, 256, 256),
                                                 (False, 0, 130, 200),
                                                 (True, 64, 200, 200)])
def test_bf16_fwd_recipe_lse_rebuilds_rows_that_sum_to_one(causal, window,
                                                           lq, lk):
    # The backward rebuilds P as exp(s * scale - lse) (its plain version,
    # _reference_p_ds): from the recipe's lse every kept row sums to 1
    # within 1e-2.
    q, k, v = _bf16_qkv(2, lq, 64, seed=16, lk=lk)
    _, lse = _tensor_core_recipe_fwd(q, k, v, causal, 0.125, window)
    zeros = torch.zeros(2, lq)
    p, _ = tflash._reference_p_ds(q, k, v, q, lse, zeros, causal, 0.125,
                                  window)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-2)


# ---------------------------------------------- fp32 split-TF32 recipe

def _tf32(x):
    """x as the tensor core reads a tf32 operand: its top 19 bits (sign,
    exponent, 10 mantissa bits), the low 13 cleared by bit mask."""
    return (x.contiguous().view(torch.int32) & -(1 << 13)).view(
        torch.float32)


def _tf32_matmul(a, b, products):
    """a @ b from tf32 products summed in fp32.  products=3 is the
    split-TF32 recipe of flash_fwd_tf32_kernel: a = hi + lo with hi =
    _tf32(a) and lo = a - hi (which the tensor core reads as _tf32(lo)),
    and a @ b = lo_a @ hi_b + hi_a @ lo_b + hi_a @ hi_b (lo @ lo
    dropped); products=1 is one tf32 product, hi_a @ hi_b."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    return (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + ah @ bh


def _pv_order(bk):
    """The key at each position of v^T's tile in flash_fwd_tf32_kernel:
    position 8j + t + 4e holds key 8j + 2t + e (the score accumulator's
    column order, so P's registers are the A fragment as they stand)."""
    return torch.tensor([8 * (p // 8) + 2 * (p % 4) + (p % 8) // 4
                         for p in range(bk)])


def _split_tf32_recipe_fwd(q, k, v, causal, scale, window=0, products=3):
    """The arithmetic of flash_fwd_tf32_kernel (csrc/flash_fwd.cu), fp32
    in and out: s = q.k^T and o += P.v each as ``_tf32_matmul``, the
    scale (times log2 e) applied to the fp32 accumulator, an online
    softmax over the key tiles of the band (``_k_tile_range`` at the
    kernel's keys per tile, ``TF32_BK``), l summed from the fp32 p, the
    keys of P.v in the kernel's order.  Returns (o, lse (BH, Lq))."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    bk = tflash.TF32_BK[d]
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    keep = tflash._mask(lq, lk, causal, window, q.device)
    o = torch.zeros(bh, lq, d)
    lse = torch.zeros(bh, lq)
    for iq in range(math.ceil(lq / tflash.BQ)):
        rows = slice(iq * tflash.BQ, (iq + 1) * tflash.BQ)
        qt = q[:, rows]
        n = qt.shape[1]
        m = torch.full((bh, n), -math.inf)
        l = torch.zeros(bh, n)
        acc = torch.zeros(bh, n, d)
        first, stop = tflash._k_tile_range(iq, lq, lk, causal, window,
                                           tflash.BQ, bk)
        for jk in range(first, stop):
            cols = slice(jk * bk, (jk + 1) * bk)
            kt, vt = k[:, cols], v[:, cols]
            t = _tf32_matmul(qt, kt.transpose(1, 2), products) * sl2
            if keep is not None:
                t = t.masked_fill(~keep[rows, cols], -math.inf)
            m_new = torch.maximum(m, t.amax(-1))
            mu = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(t - mu[..., None])
            l = l * alpha + p.sum(-1)
            # a ragged last tile is zero-padded to bk keys, as TMA loads it
            order = _pv_order(bk)[_pv_order(bk) < kt.shape[1]]
            acc = acc * alpha[..., None] + _tf32_matmul(
                p[..., order], vt[:, order], products)
            m = m_new
        live = l > 0
        o[:, rows] = torch.where(live[..., None], acc / l[..., None], 0.0)
        lse[:, rows] = torch.where(live, (m + torch.log2(l)) * LN2,
                                   -math.inf)
    return o, lse


def _float64_fwd(q, k, v, causal, scale, window=0):
    """Attention and lse in float64, the exact yardstick."""
    s = (q.double() @ k.double().transpose(1, 2)) * scale
    keep = tflash._mask(q.shape[1], k.shape[1], causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep[None], -math.inf)
    return torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1)


def _worst_over_tol(got, ref, tol):
    """max |got - ref| / (tol * (1 + |ref|)) over o and lse, as
    chip_smoke.py holds the card's results."""
    return max(((a.double() - b.double()).abs()
                / (tol * (1 + b.double().abs()))).max().item()
               for a, b in zip(got, ref))


SPLIT_CASES = [  # (causal, window, L, D)
    (True, 0, 512, 64), (False, 0, 512, 64), (True, 256, 512, 64),
    (True, 0, 200, 64), (True, 0, 256, 32), (True, 0, 256, 128)]


@pytest.mark.parametrize("causal,window,l,d", SPLIT_CASES)
def test_split_tf32_recipe_stays_inside_the_card_tolerance(causal, window,
                                                           l, d):
    # The recipe's o and lse against float64 and against the plain
    # version (the card's yardstick), at chip_smoke.py's fp32 TOL (5e-5
    # abs + rel).  Worst |error| / (tol * (1 + |ref|)) seen here: 0.009
    # to 0.016 against float64, 0.011 to 0.019 against the plain version
    # (chip_smoke.py's kernels phase on an H100: 0.031 to 0.097 at its
    # larger shapes).
    from chip_smoke import TOL
    tol = TOL["float32"]
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, l, d, seed=20))
    scale = 1.0 / math.sqrt(d)
    got = _split_tf32_recipe_fwd(q, k, v, causal, scale, window)
    assert _worst_over_tol(got, _float64_fwd(q, k, v, causal, scale,
                                             window), tol) <= 1.0
    assert _worst_over_tol(got, tflash._reference_fwd(
        q, k, v, causal, scale, window), tol) <= 1.0


def test_one_tf32_product_fails_the_card_tolerance():
    # Why the kernel splits: the same recipe with one tf32 product per
    # product lands far outside 5e-5 (worst ratio 22 here), three
    # products far inside (0.013)
    from chip_smoke import TOL
    tol = TOL["float32"]
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 512, 64, seed=21))
    ref = _float64_fwd(q, k, v, True, 0.125)
    one = _split_tf32_recipe_fwd(q, k, v, True, 0.125, products=1)
    three = _split_tf32_recipe_fwd(q, k, v, True, 0.125, products=3)
    assert _worst_over_tol(one, ref, tol) > 2.0
    assert _worst_over_tol(three, ref, tol) < 0.1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_split_tf32_recipe_matches_jax_kernel(causal, d):
    # the recipe's o and lse against the Pallas forward in interpret
    # mode on the same fp32 inputs, at the parity tests' TOL
    arrs = _inputs(2, 256, d, seed=22)
    scale = 1.0 / math.sqrt(d)
    o, lse = _split_tf32_recipe_fwd(*(torch.from_numpy(a) for a in arrs),
                                    causal, scale)
    jo, jlse = jflash._flash_fwd(*(jnp.asarray(a) for a in arrs), causal,
                                 scale, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("d", sorted(tflash.TF32_BK))
def test_tf32_key_tiles_cover_exactly_the_kept_pairs(d):
    # flash_fwd_tf32_kernel's key loop at its keys per tile (64 at D=32,
    # 32 at D=64 and 128), ragged lengths and windows included
    bq, bk = tflash.BQ, tflash.TF32_BK[d]
    for causal, window in ((False, 0), (True, 0), (True, 1), (True, 40),
                           (True, 100)):
        for l in (1, 31, 32, 33, 64, 65, 200, 257):
            qp = np.arange(l)[:, None]
            kp = np.arange(l)[None, :]
            keep = np.ones((l, l), bool)
            if causal:
                keep = qp >= kp
                if window:
                    keep &= qp - kp < window
            for iq in range(math.ceil(l / bq)):
                rows = keep[iq * bq:(iq + 1) * bq]
                live = {jk for jk in range(math.ceil(l / bk))
                        if rows[:, jk * bk:(jk + 1) * bk].any()}
                first, stop = tflash._k_tile_range(iq, l, l, causal,
                                                   window, bq, bk)
                assert set(range(first, stop)) == live, (l, window, iq)


def test_pv_order_is_a_permutation_within_groups_of_8():
    order = _pv_order(64).tolist()
    assert sorted(order) == list(range(64))
    assert all(k // 8 == p // 8 for p, k in enumerate(order))
    # the score accumulator's columns 2t, 2t + 1 land on A's t, t + 4
    assert order[:8] == [0, 2, 4, 6, 1, 3, 5, 7]


# ------------------------------------- fp32 split-TF32 backward recipe

def _split_tf32_recipe_bwd(q, k, v, o, lse, g, causal, scale, window=0,
                           products=3):
    """The arithmetic of flash_dq_tf32_kernel and flash_dkv_tf32_kernel
    (csrc/flash_bwd.cu), fp32 in and out.  Tile by tile over the
    streamed side at the kernels' rows a tile (``TF32_BWD_BN``): flash_dq
    walks the key tiles of each 64-row query tile (``_k_tile_range``),
    flash_dkv the query tiles of each 64-row key tile
    (``_q_tile_range``).  Every product is ``_tf32_matmul``; p = exp(s *
    scale - lse), zero where masked; ds = p (dp - delta) scale; the
    gradient products sum over the streamed rows in the kernels' order
    (``_pv_order``: a ragged last tile is zero-padded, as TMA loads it);
    the sums stay fp32.  Returns (dq, dk, dv)."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    bn = tflash.TF32_BWD_BN[d]
    bq, bk = tflash.BQ, tflash.BK
    delta = tflash._delta(g, o)
    keep = tflash._mask(lq, lk, causal, window, q.device)
    if keep is None:
        keep = torch.ones(lq, lk, dtype=torch.bool)

    def mm(a, b):
        return _tf32_matmul(a, b, products)

    dq = torch.zeros(bh, lq, d)
    for iq in range(math.ceil(lq / bq)):
        rows = slice(iq * bq, (iq + 1) * bq)
        qt, gt = q[:, rows], g[:, rows]
        acc = torch.zeros(bh, qt.shape[1], d)
        first, stop = tflash._k_tile_range(iq, lq, lk, causal, window, bq,
                                           bn)
        for jk in range(first, stop):
            cols = slice(jk * bn, (jk + 1) * bn)
            kt, vt = k[:, cols], v[:, cols]
            p = torch.exp(mm(qt, kt.transpose(1, 2)) * scale
                          - lse[:, rows, None])
            p = p.masked_fill(~keep[rows, cols], 0.0)
            ds = p * (mm(gt, vt.transpose(1, 2)) - delta[:, rows, None]) \
                * scale
            order = _pv_order(bn)[_pv_order(bn) < kt.shape[1]]
            acc = acc + mm(ds[..., order], kt[:, order])
        dq[:, rows] = acc
    dk, dv = torch.zeros(bh, lk, d), torch.zeros(bh, lk, d)
    for jk in range(math.ceil(lk / bk)):
        cols = slice(jk * bk, (jk + 1) * bk)
        kt, vt = k[:, cols], v[:, cols]
        acc_k = torch.zeros(bh, kt.shape[1], d)
        acc_v = torch.zeros(bh, kt.shape[1], d)
        first, stop = tflash._q_tile_range(jk, lq, lk, causal, window, bn,
                                           bk)
        for iq in range(first, stop):
            rows = slice(iq * bn, (iq + 1) * bn)
            qt, gt = q[:, rows], g[:, rows]
            pt = torch.exp(mm(kt, qt.transpose(1, 2)) * scale
                           - lse[:, None, rows])
            pt = pt.masked_fill(~keep[rows, cols].T, 0.0)
            dst = pt * (mm(vt, gt.transpose(1, 2))
                        - delta[:, None, rows]) * scale
            order = _pv_order(bn)[_pv_order(bn) < qt.shape[1]]
            acc_v = acc_v + mm(pt[..., order], gt[:, order])
            acc_k = acc_k + mm(dst[..., order], qt[:, order])
        dk[:, cols], dv[:, cols] = acc_k, acc_v
    return dq, dk, dv


def _float64_bwd(q, k, v, g, causal, scale, window=0):
    """dq, dk, dv of attention in float64, the exact yardstick."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    s = (q @ k.transpose(1, 2)) * scale
    keep = tflash._mask(q.shape[1], k.shape[1], causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep[None], -math.inf)
    p = torch.softmax(s, -1)
    dp = g @ v.transpose(1, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    return ds @ k, ds.transpose(1, 2) @ q, p.transpose(1, 2) @ g


def _bwd_case(causal, window, lq, lk, d, seed):
    """numpy fp32 q, k, v, g (BH=2) and, as torch tensors, the same with
    the plain forward's o and lse, which the kernels take as they take
    the card's forward's: (arrays, (q, k, v, o, lse, g), scale)."""
    arrs = _inputs(2, lq, d, lk=lk, seed=seed)
    arrs.append(np.random.RandomState(seed + 1).normal(
        0, 1, arrs[0].shape).astype(np.float32))
    q, k, v, g = (torch.from_numpy(a) for a in arrs)
    scale = 1.0 / math.sqrt(d)
    o, lse = tflash._reference_fwd(q, k, v, causal, scale, window)
    return arrs, (q, k, v, o, lse, g), scale


SPLIT_BWD_CASES = [  # (causal, window, Lq, Lk, D)
    (True, 0, 256, 256, 64), (False, 0, 256, 256, 64),
    (True, 64, 256, 256, 32), (True, 0, 200, 200, 64),
    (False, 0, 128, 256, 32), (True, 0, 128, 256, 32),
    (True, 0, 256, 256, 32)]


@pytest.mark.parametrize("causal,window,lq,lk,d", SPLIT_BWD_CASES)
def test_split_tf32_recipe_bwd_stays_inside_the_card_tolerance(
        causal, window, lq, lk, d):
    # The recipe's dq, dk, dv against float64 and against the plain
    # backward (the card's yardstick), at chip_smoke.py's fp32 BWD_TOL
    # (1e-4 abs + rel).  Worst |error| / (tol * (1 + |ref|)) seen here:
    # 0.008 to 0.019 against float64, 0.009 to 0.017 against the plain
    # backward.
    from chip_smoke import BWD_TOL
    tol = BWD_TOL["float32"]
    _, (q, k, v, o, lse, g), scale = _bwd_case(causal, window, lq, lk, d,
                                               seed=30)
    got = _split_tf32_recipe_bwd(q, k, v, o, lse, g, causal, scale, window)
    assert _worst_over_tol(got, _float64_bwd(q, k, v, g, causal, scale,
                                             window), tol) <= 1.0
    assert _worst_over_tol(got, tflash._reference_bwd(
        q, k, v, o, lse, g, causal, scale, window), tol) <= 1.0


@pytest.mark.parametrize("causal,window,lq,lk,d", SPLIT_BWD_CASES)
def test_split_tf32_recipe_bwd_matches_jax_kernel(causal, window, lq, lk,
                                                  d):
    # the recipe's gradients against the Pallas backward in interpret mode
    # on the same fp32 inputs (its reference path under jax.vjp where the
    # 128-tiling does not cover the shape), at the parity tests' GRAD_TOL
    arrs, (q, k, v, o, lse, g), scale = _bwd_case(causal, window, lq, lk,
                                                  d, seed=31)
    got = _split_tf32_recipe_bwd(q, k, v, o, lse, g, causal, scale, window)
    jarrs = [jnp.asarray(a) for a in arrs[:3]]
    if jflash._supported(*jarrs[:2]):
        ref = _grads_jax_kernel(arrs[:3], arrs[3], causal, scale, window)
    else:
        _, vjp = jax.vjp(lambda q, k, v: jflash.flash_attention(
            q, k, v, causal=causal, scale=scale, window=window,
            interpret=True), *jarrs)
        ref = vjp(jnp.asarray(arrs[3]))
    for name, a, b in zip("dq dk dv".split(), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


def test_one_tf32_product_fails_the_card_bwd_tolerance():
    # Why the backward kernels split: the same recipe with one tf32
    # product per product lands far outside 1e-4 (worst ratio 29 here),
    # three products far inside (0.020)
    from chip_smoke import BWD_TOL
    tol = BWD_TOL["float32"]
    _, (q, k, v, o, lse, g), scale = _bwd_case(True, 0, 512, 512, 64,
                                               seed=32)
    ref = _float64_bwd(q, k, v, g, True, scale)
    one = _split_tf32_recipe_bwd(q, k, v, o, lse, g, True, scale,
                                 products=1)
    three = _split_tf32_recipe_bwd(q, k, v, o, lse, g, True, scale)
    assert _worst_over_tol(one, ref, tol) > 2.0
    assert _worst_over_tol(three, ref, tol) < 0.2


@pytest.mark.parametrize("d", sorted(tflash.TF32_BWD_BN))
def test_tf32_bwd_tiles_cover_exactly_the_kept_pairs(d):
    # the fp32 backward's loops at its streamed rows a tile: flash_dq's
    # key tiles of each 64-row query tile and flash_dkv's query tiles of
    # each 64-row key tile, ragged lengths, windows and Lq != Lk included
    bq, bk, bn = tflash.BQ, tflash.BK, tflash.TF32_BWD_BN[d]
    assert bn % 8 == 0 and sorted(_pv_order(bn).tolist()) == list(range(bn))
    shapes = [(1, 1), (15, 15), (16, 16), (17, 17), (64, 64), (65, 65),
              (200, 200), (257, 257)]
    for causal, window in ((False, 0), (True, 0), (True, 1), (True, 40),
                           (True, 100)):
        for lq, lk in shapes + ([(64, 200), (200, 64), (1, 130)]
                                if not window else []):
            qp = np.arange(lq)[:, None]
            kp = np.arange(lk)[None, :]
            keep = np.ones((lq, lk), bool)
            if causal:
                keep = qp >= kp
                if window:
                    keep &= qp - kp < window
            for iq in range(math.ceil(lq / bq)):
                rows = keep[iq * bq:(iq + 1) * bq]
                live = {jk for jk in range(math.ceil(lk / bn))
                        if rows[:, jk * bn:(jk + 1) * bn].any()}
                first, stop = tflash._k_tile_range(iq, lq, lk, causal,
                                                   window, bq, bn)
                assert set(range(first, stop)) == live, (lq, lk, iq)
            for jk in range(math.ceil(lk / bk)):
                cols = keep[:, jk * bk:(jk + 1) * bk]
                live = {iq for iq in range(math.ceil(lq / bn))
                        if cols[iq * bn:(iq + 1) * bn].any()}
                first, stop = tflash._q_tile_range(jk, lq, lk, causal,
                                                   window, bn, bk)
                assert set(range(first, stop)) == live, (lq, lk, jk)
