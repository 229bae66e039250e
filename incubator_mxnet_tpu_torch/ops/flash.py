"""Flash attention forward on a hand-written Hopper kernel.

Port of ``incubator_mxnet_tpu/ops/flash.py``: the Pallas TPU kernel
``_fwd_kernel`` becomes the CUDA kernel ``csrc/flash_fwd.cu`` (one
block per (bh, 64-row query tile), an online-softmax loop over the key
tiles of the band, fp32 accumulation; see the source's header).

For a CUDA tensor, ``flash_attention`` launches the kernel or raises:
there is no fallback.  For a CPU tensor it computes the plain version,
``_reference_fwd``, which is also what the kernel is held against on
the card.  The backward kernels (``_dq_kernel``/``_dkv_kernel``)
belong to the training slice; until then a call that would need a
gradient raises.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd"]

_NEG = -1e30
# the kernel's tile sizes (csrc/flash_fwd.cu BQ/BK)
BQ = 64
BK = 64
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference_fwd(q, k, v, causal, scale, window=0):
    """Plain PyTorch attention and its log-sum-exp: the numeric oracle
    (twin of the JAX package's ``_reference_attention``, plus ``lse``).
    q (BH, Lq, D), k/v (BH, Lk, D).  Causal alignment is top-left
    (q_pos >= k_pos, both from 0); ``window > 0`` keeps keys
    (i - window, i].  Returns (o in q's dtype, lse (BH, Lq) fp32)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    lq, lk = q.shape[1], k.shape[1]
    qp = torch.arange(lq, device=q.device)[:, None]
    kp = torch.arange(lk, device=q.device)[None, :]
    if causal:
        mask = qp >= kp
        if window > 0:
            mask &= (qp - kp) < window
        s = torch.where(mask[None], s, torch.full_like(s, _NEG))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype), lse


# ---------------------------------------------------------------- bands
# The key-tile range the CUDA kernel walks (the tests hold it against the
# JAX kernel's band helpers and against the mask itself).

def _k_tile_range(iq, lq, lk, causal, window, bq=BQ, bk=BK):
    """[first, stop) of the key tiles that q-tile iq visits, exactly as
    csrc/flash_fwd.cu computes it: from the window's first tile to the
    causal diagonal, for any (ragged) Lq and Lk."""
    nk = -(-lk // bk)
    if not causal:
        return 0, nk
    stop = min(nk, (min((iq + 1) * bq, lq) - 1) // bk + 1)
    first = max(0, iq * bq - window + 1) // bk if window > 0 else 0
    return first, stop


# -------------------------------------------------------------- wrapper

def _check_args(q, k, v, causal, window):
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window > 0 requires causal=True")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, L, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(q.shape[1], k.shape[1]) < 1:
        raise ValueError("empty sequence")
    if window and q.shape[1] != k.shape[1]:
        raise ValueError(
            "window > 0 requires self-attention shapes (lq == lk); "
            f"got lq={q.shape[1]}, lk={k.shape[1]} — a query past "
            "the key horizon would have an empty key set")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet (the _dq/_dkv kernels "
            "come with the training slice); call it under "
            "torch.no_grad() or torch.inference_mode()")


_SIGNATURES = {
    "mxt_flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "mxt_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _launch(q, k, v, causal, scale, window):
    """Run csrc/flash_fwd.cu on CUDA tensors; raises on what the
    kernel does not take or on a failed launch."""
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share device and dtype")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    bh, lq, d = q.shape
    lk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {HEAD_DIMS}, "
                         f"got {d}")
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q, k, v")
    o = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mxt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, lq, lk, d, _DTYPE_CODES[q.dtype],
            int(causal), window, scale, stream)
    if rc != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.mxt_error_string(rc).decode())
    _build.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal=True, scale=None, window=0):
    """Tiled online-softmax attention.  q (BH, Lq, D), k/v (BH, Lk, D).

    Returns ``(o, lse)``: o in q's dtype, lse (BH, Lq) fp32, the
    residual the backward rebuilds P from.  ``window > 0`` (requires
    ``causal`` and Lq == Lk): query i sees keys (i - window, i].
    CUDA tensors run the kernel (float32 or bfloat16, D in 32/64/128,
    any L); CPU tensors run the plain version.
    """
    causal = bool(causal)
    window = int(window)
    _check_args(q, k, v, causal, window)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None \
        else float(scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, window)
    if q.device.type == "cpu":
        return _reference_fwd(q, k, v, causal, scale, window)
    raise ValueError(f"flash_attention runs on cuda or cpu, not "
                     f"{q.device}")


def flash_attention(q, k, v, causal=True, scale=None, window=0):
    """``flash_attention_fwd``'s output alone (the JAX op's surface)."""
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]
