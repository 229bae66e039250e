"""The port's flash attention (incubator_mxnet_tpu_torch/ops/flash.py)
against the JAX package's (incubator_mxnet_tpu/ops/flash.py).

On the CPU the port's wrapper runs its plain version; the JAX side runs
its Pallas kernel in interpret mode, or its reference path where the
128-tiling does not cover the shape.  Tolerance 2e-5, as the JAX
package's own flash tests use.  The kernel's loop bounds (which key
tiles each query tile visits, ``_k_tile_range``) are held against the
JAX kernel's band helpers and against the mask itself.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from incubator_mxnet_tpu.ops import flash as jflash  # noqa: E402
from incubator_mxnet_tpu_torch.ops import flash as tflash  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


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
    with pytest.raises(NotImplementedError, match="no backward"):
        tflash.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(*(t.to("meta") for t in (k, k, v)))


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
