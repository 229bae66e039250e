"""Flash attention on hand-written Hopper kernels, forward and backward.

Port of ``incubator_mxnet_tpu/ops/flash.py``: the Pallas TPU kernel
``_fwd_kernel`` becomes the CUDA kernel ``flash_fwd`` in
``csrc/flash_fwd.cu`` (one block per (bh, 64-row query tile), an
online-softmax loop over the key tiles of the band, fp32 sums), and
``_dq_kernel`` and ``_dkv_kernel`` become ``flash_dq`` and
``flash_dkv`` in ``csrc/flash_bwd.cu`` (one block per 64-row query
tile and per 64-row key tile, P rebuilt from the forward's ``lse``).
Each runs bf16 on the tensor cores, ``wgmma`` fed by TMA (the shared
pieces are ``csrc/hopper_tc.cuh``).  In fp32 all three run there too,
as split-TF32 (each operand split into a tf32 high part and the rest,
three tf32 products per fp32 product); see the sources' headers.
``_FlashAttention`` ties them together as the JAX op's ``custom_vjp``
does.

The op is registered as ``_flash_attention`` (``nd._internal``), the JAX
op's name, with its parameters less ``interpret``, which picks the
Pallas interpreter and has no counterpart here.

For a CUDA tensor, ``flash_attention`` and its backward launch the
kernels or raise: there is no fallback.  For a CPU tensor they compute
the plain versions, ``_reference_fwd`` and ``_reference_bwd``, which
are also what the kernels are held against on the card.  On ``meta``
tensors (shape inference, the perf package's counted cost) they run the
plain versions too, so a FLOP counter sees their products; inside
``meta_shapes_only()`` (the memory planner's trace) they give their
outputs' shapes alone, as the kernels keep no (L, L) tensor.
"""
import contextlib
import ctypes
import math
import sys

import torch

from . import _build
from .registry import defop

__all__ = ["flash_attention", "flash_attention_fwd", "meta_shapes_only"]

_NEG = -1e30
# the kernels' tile sizes (csrc/hopper_tc.cuh BQ/BK)
BQ = 64
BK = 64
# keys per tile of the fp32 forward, by head dim (Tf32Fwd<D>::BKT in
# csrc/flash_fwd.cu)
TF32_BK = {32: 64, 64: 32, 128: 32}
# streamed rows per tile of the fp32 backward (keys for flash_dq, queries
# for flash_dkv), by head dim (Tf32Dq<D>::BN, Tf32Dkv<D>::BN in
# csrc/flash_bwd.cu)
TF32_BWD_BN = {32: 32, 64: 16, 128: 16}
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


_SHAPES_ONLY = [False]


@contextlib.contextmanager
def meta_shapes_only():
    """Within the scope, the op on ``meta`` tensors makes its outputs
    (o, lse; dq, dk, dv) without the plain version's intermediates."""
    was = _SHAPES_ONLY[0]
    _SHAPES_ONLY[0] = True
    try:
        yield
    finally:
        _SHAPES_ONLY[0] = was


def _meta_fwd(q):
    return torch.empty_like(q), q.new_empty(q.shape[:2],
                                            dtype=torch.float32)


def _reference_fwd(q, k, v, causal, scale, window=0):
    """Plain PyTorch attention and its log-sum-exp: the numeric oracle
    (twin of the JAX package's ``_reference_attention``, plus ``lse``).
    q (BH, Lq, D), k/v (BH, Lk, D).  Causal alignment is top-left
    (q_pos >= k_pos, both from 0); ``window > 0`` keeps keys
    (i - window, i].  Returns (o in q's dtype, lse (BH, Lq) fp32)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    keep = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    if keep is not None:
        s = torch.where(keep[None], s, torch.full_like(s, _NEG))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _mask(lq, lk, causal, window, device):
    """(Lq, Lk) bool of the pairs the mask keeps, or None (all)."""
    if not causal:
        return None
    qp = torch.arange(lq, device=device)[:, None]
    kp = torch.arange(lk, device=device)[None, :]
    keep = qp >= kp
    if window > 0:
        keep &= (qp - kp) < window
    return keep


def _delta(g, o):
    """rowsum(g * o) in fp32, (BH, Lq): computed outside the backward
    kernels, as the JAX package's ``_flash_bwd`` does."""
    return (g.float() * o.float()).sum(-1)


def _reference_p_ds(q, k, v, g, lse, delta, causal, scale, window):
    """The backward's P-rebuild recipe in fp32 (the JAX package's
    ``_dq_kernel`` / ``_dkv_kernel`` body): p = exp(s - lse), zero
    where masked; ds = p * (g v^T - delta) * scale."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    keep = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    if keep is not None:
        p = p.masked_fill(~keep[None], 0.0)
    dp = torch.matmul(g.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * scale


def _reference_dq(q, k, v, g, lse, delta, causal, scale, window=0):
    """Plain version of ``flash_dq``: dq = ds k, in q's dtype."""
    _, ds = _reference_p_ds(q, k, v, g, lse, delta, causal, scale, window)
    return torch.matmul(ds, k.float()).to(q.dtype)


def _reference_dkv(q, k, v, g, lse, delta, causal, scale, window=0):
    """Plain version of ``flash_dkv``: dk = ds^T q, dv = p^T g, in k's
    and v's dtypes."""
    p, ds = _reference_p_ds(q, k, v, g, lse, delta, causal, scale, window)
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _reference_bwd(q, k, v, o, lse, g, causal, scale, window=0):
    """Plain PyTorch attention backward in fp32, the kernels' oracle:
    (dq, dk, dv) from the forward's o and lse and the output gradient
    g, in q's, k's and v's dtypes."""
    delta = _delta(g, o)
    dq = _reference_dq(q, k, v, g, lse, delta, causal, scale, window)
    return (dq,) + _reference_dkv(q, k, v, g, lse, delta, causal, scale,
                                  window)


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


def _q_tile_range(jk, lq, lk, causal, window, bq=BQ, bk=BK):
    """[first, stop) of the query tiles that k-tile jk visits, exactly
    as ``flash_dkv`` in csrc/flash_bwd.cu computes it: from the causal
    diagonal to the end of the window band.  Empty (first == stop) for
    a key tile past the last query (causal, Lk > Lq)."""
    nq = -(-lq // bq)
    if not causal:
        return 0, nq
    first = min(nq, jk * bk // bq)
    stop = nq
    if window > 0:
        stop = min(nq, (min((jk + 1) * bk, lk) - 1 + window - 1) // bq
                   + 1)
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


_SIGNATURES = {
    "mxt_flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "mxt_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_BWD_SIGNATURES = {
    "mxt_flash_dq": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "mxt_flash_dkv": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "mxt_flash_bwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _check_kernel_args(q, *others):
    """What the kernels take: one device and dtype (float32 or
    bfloat16), head dim in HEAD_DIMS, contiguous tensors at 16-byte
    aligned addresses (the tensor-core kernels read them by TMA)."""
    for t in others:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v (and g) must share device and "
                             "dtype")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if not all(t.is_contiguous() for t in (q,) + others):
        raise ValueError("flash kernel takes contiguous q, k, v (and g)")
    if any(t.data_ptr() % 16 for t in (q,) + others):
        raise ValueError("flash kernel takes q, k, v (and g) at 16-byte "
                         "aligned addresses")


def _launch(q, k, v, causal, scale, window):
    """Run csrc/flash_fwd.cu on CUDA tensors; raises on what the
    kernel does not take or on a failed launch."""
    _check_kernel_args(q, k, v)
    bh, lq, d = q.shape
    lk = k.shape[1]
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


def _raise_bwd(lib, name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.mxt_flash_bwd_error_string(rc).decode())


def _check_bwd_args(q, k, v, g, lse, delta):
    """What the backward kernels take: ``_check_kernel_args`` for q, k,
    v and g, and lse and delta as contiguous, 16-byte aligned fp32
    (BH, Lq)."""
    _check_kernel_args(q, k, v, g)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != q.shape[:2] \
                or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte "
                             f"aligned fp32 {tuple(q.shape[:2])} on "
                             f"{q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _launch_dq(q, k, v, g, lse, delta, causal, scale, window):
    """Run ``flash_dq`` (csrc/flash_bwd.cu) on CUDA tensors; returns dq
    in q's dtype."""
    _check_bwd_args(q, k, v, g, lse, delta)
    bh, lq, d = q.shape
    dq = torch.empty_like(q)
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mxt_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, lq,
            k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal), window,
            scale, stream)
    _raise_bwd(lib, "flash_dq", rc)
    _build.LAUNCHES["flash_dq"] += 1
    return dq


def _launch_dkv(q, k, v, g, lse, delta, causal, scale, window):
    """Run ``flash_dkv`` (csrc/flash_bwd.cu) on CUDA tensors; returns
    (dk, dv) in k's and v's dtype."""
    _check_bwd_args(q, k, v, g, lse, delta)
    bh, lq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mxt_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, lq, k.shape[1], d, _DTYPE_CODES[q.dtype],
            int(causal), window, scale, stream)
    _raise_bwd(lib, "flash_dkv", rc)
    _build.LAUNCHES["flash_dkv"] += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, g, causal, scale, window):
    """The backward on CUDA tensors: delta with plain torch ops, then
    ``flash_dq`` and ``flash_dkv``, each of which raises on what it does
    not take before its library is loaded."""
    delta = _delta(g, o)
    dq = _launch_dq(q, k, v, g, lse, delta, causal, scale, window)
    return (dq,) + _launch_dkv(q, k, v, g, lse, delta, causal, scale,
                               window)


def _prepare(q, k, v, causal, scale, window):
    causal = bool(causal)
    window = int(window)
    _check_args(q, k, v, causal, window)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None \
        else float(scale)
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, "
                         f"not {q.device}")
    return causal, scale, window


def flash_attention_fwd(q, k, v, causal=True, scale=None, window=0):
    """Tiled online-softmax attention.  q (BH, Lq, D), k/v (BH, Lk, D).

    Returns ``(o, lse)``: o in q's dtype, lse (BH, Lq) fp32, the
    residual the backward rebuilds P from.  ``window > 0`` (requires
    ``causal`` and Lq == Lk): query i sees keys (i - window, i].
    CUDA tensors run the kernel (float32 as split-TF32 or bfloat16, D
    in 32/64/128, any L, 16-byte aligned) or raise; CPU tensors run the
    plain version.  No gradient flows through it: ``flash_attention``
    is the differentiable op.
    """
    causal, scale, window = _prepare(q, k, v, causal, scale, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, window)
    if q.device.type == "meta" and _SHAPES_ONLY[0]:
        return _meta_fwd(q)
    return _reference_fwd(q, k, v, causal, scale, window)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward saves (q, k,
    v, o, lse), and the backward rebuilds P from them: ``flash_dq`` and
    ``flash_dkv`` for CUDA tensors, ``_reference_bwd`` for CPU ones
    (the JAX op's ``custom_vjp``, ``_flash_vjp_fwd`` /
    ``_flash_vjp_bwd``).  Takes the arguments ``_prepare`` returns."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "meta" and _SHAPES_ONLY[0]:
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None, None, None)
        bwd = _launch_bwd if q.device.type == "cuda" else _reference_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, window=0):
    """Attention output (the JAX op's surface), differentiable in q, k
    and v.  Under autograd it saves what the backward kernels need;
    otherwise (inference) it runs the forward alone and saves
    nothing.  DTensor inputs (a tensor-parallel step) go through
    :func:`_flash_dtensor`."""
    if _is_dtensor(q):
        return _flash_dtensor(q, k, v, causal, scale, window)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        args = _prepare(q, k, v, causal, scale, window)
        return _FlashAttention.apply(q, k, v, *args)
    return flash_attention_fwd(q, k, v, causal, scale, window)[0]


def _is_dtensor(t):
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _flash_dtensor(q, k, v, causal, scale, window):
    """Attention of DTensors on the rows this rank owns: the heads are
    split over the mesh's 'tp' dim.  q, k and v come replicated (any
    placement is redistributed to that first); each rank runs the kernel
    on its 1/tp of the (batch x head) rows, and the outputs are
    all-gathered back to replicated, differentiably (the backward runs
    the kernels on the same rows and gathers dq, dk, dv).  With no 'tp'
    dim, or rows that do not split evenly, each rank runs all rows.
    Every other mesh dim stays replicated: the step's batch is declared
    replicated over 'dp', so no collective may run over it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    rep = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names or ()
    rows = list(rep)
    if "tp" in names and q.shape[0] % mesh.size(names.index("tp")) == 0:
        rows[names.index("tp")] = Shard(0)
    q, k, v = (t.redistribute(mesh, rep).redistribute(mesh, rows)
               for t in (q, k, v))
    o = flash_attention(q.to_local(), k.to_local(), v.to_local(),
                        causal=causal, scale=scale, window=window)
    return DTensor.from_local(o, mesh, rows, run_check=False).redistribute(
        mesh, rep)


@defop("_flash_attention")
def _flash_attention_op(q, k, v, causal=True, scale=None, window=0):
    """Registry surface of :func:`flash_attention` (q/k/v: (BH, L, D));
    on CUDA arrays it launches ``flash_fwd`` (and, under autograd, the
    backward kernels)."""
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           window=window)
