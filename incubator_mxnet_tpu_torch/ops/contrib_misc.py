"""The remaining contrib and legacy op families (twin of
``incubator_mxnet_tpu/ops/contrib_misc.py``), in plain torch ops:

  _contrib_fft / _contrib_ifft      (src/operator/contrib/fft.cc, ifft.cc)
  _contrib_count_sketch             (contrib/count_sketch.cc)
  _contrib_quantize / _dequantize   (contrib/quantize.cc, dequantize.cc)
  Correlation                       (src/operator/correlation.cc, the
                                     FlowNet layer)
  _contrib_DeformablePSROIPooling   (contrib/deformable_psroi_pooling.cc)
  IdentityAttachKLSparseReg         (identity_attach_KL_sparse_reg.cc)
  cast_storage / reshape_like / _sparse_retain / _square_sum and the
  scatter aliases                   (tensor/cast_storage.cc,
                                     elemwise_unary_op_basic.cc,
                                     sparse_retain.cc, square_sum.cc)
  _NDArray / _Native                (plugin hooks: they raise)

The FFTs run on ``torch.fft`` (cuFFT on the card) with MXNet's
interleaved real and imaginary layout; Correlation unrolls its static
grid of displacements into multiply-reduces over strided views.  The
JAX module also gives ``make_loss`` its loss-head gradient and the
alias ``MakeLoss``; the port's ``elemwise.make_loss`` has both already.
"""
import torch

from .contrib_det import _div, _rdiv
from .registry import defop

# ---------------------------------------------------------------------------
# FFT family
# ---------------------------------------------------------------------------


@defop("_contrib_fft")
def contrib_fft(data, compute_size=128):
    """FFT along the last axis; complex output interleaved as
    [r0, i0, r1, i1, ...] -> (..., 2d) (ref: contrib/fft-inl.h).
    ``compute_size`` (the reference's batching knob) is accepted and
    ignored."""
    f = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(data.dtype)


@defop("_contrib_ifft")
def contrib_ifft(data, compute_size=128):
    """Unnormalised inverse FFT of interleaved complex input:
    out = n * ifft(in) (cuFFT's inverse applies no 1/n, and the
    reference passes it through; ref: contrib/ifft-inl.h)."""
    d = data.shape[-1] // 2
    c = data.reshape(data.shape[:-1] + (d, 2)).float()
    z = torch.complex(c[..., 0], c[..., 1])
    out = torch.fft.ifft(z, dim=-1).real * d
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# count sketch
# ---------------------------------------------------------------------------


@defop("_contrib_count_sketch")
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count-sketch projection (ref: contrib/count_sketch-inl.h):
    out[n, h[j]] += s[j] * data[n, j]."""
    hh = h.reshape(-1).to(torch.int64)
    signed = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, signed)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@defop("_contrib_quantize", num_outputs=3, differentiable=False)
def quantize(data, min_range, max_range, out_type="uint8"):
    """Linear quantization to uint8 over [min_range, max_range] (ref:
    contrib/quantize-inl.h QuantizeCompute; the reference kernel takes
    uint8 only too).  Rounds half to even, as ``jnp.round``."""
    if out_type != "uint8":
        raise ValueError(
            f"_contrib_quantize supports out_type='uint8' only "
            f"(like the reference kernel); got {out_type!r}")
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = _rdiv(255.0, hi - lo)
    q = torch.clamp(torch.round((data - lo) * scale), 0, 255)
    return q.to(torch.uint8), min_range * 1.0, max_range * 1.0


@defop("_contrib_dequantize", differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    """(ref: contrib/dequantize-inl.h)"""
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = _div(hi - lo, 255.0)
    return data.to(torch.float32) * scale + lo


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------


@defop("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation layer (ref: src/operator/correlation-inl.h).
    For every output position and every displacement (dy, dx) on the
    stride2 grid within max_displacement, correlates a kernel_size^2
    patch of data1 with the displaced patch of data2, averaged over
    channels * K^2.  Output (B, D*D, out_h, out_w), dy slow, dx fast."""
    c, h, w = data1.shape[1:]
    K = int(kernel_size)
    pad = int(pad_size)
    md = int(max_displacement)
    s1, s2 = int(stride1), int(stride2)
    d2 = md // s2
    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    kr = K // 2
    border = kr + md
    ph, pw = h + 2 * pad, w + 2 * pad
    out_h = (ph - 2 * border + s1 - 1) // s1
    out_w = (pw - 2 * border + s1 - 1) // s1

    def view(p, y, x):
        """p at rows y + s1 * i, columns x + s1 * j of the output grid."""
        return p[:, :, y:y + s1 * (out_h - 1) + 1:s1,
                 x:x + s1 * (out_w - 1) + 1:s1]

    outs = []
    for dy in range(-d2 * s2, d2 * s2 + 1, s2):
        for dx in range(-d2 * s2, d2 * s2 + 1, s2):
            acc = 0
            for ky in range(-kr, K - kr):
                for kx in range(-kr, K - kr):
                    a = view(p1, border + ky, border + kx)
                    b = view(p2, border + ky + dy, border + kx + dx)
                    v = a * b if is_multiply else torch.abs(a - b)
                    acc = acc + v.sum(dim=1)
            outs.append(_div(acc, c * K * K))
    return torch.stack(outs, dim=1).to(data1.dtype)


# ---------------------------------------------------------------------------
# deformable PS-ROI pooling
# ---------------------------------------------------------------------------


@defop("_contrib_DeformablePSROIPooling", variadic=True, num_outputs=1)
def deformable_psroi_pooling(*inputs, spatial_scale=1.0, output_dim=1,
                             group_size=1, pooled_size=1, part_size=0,
                             sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive ROI pooling (ref: contrib/
    deformable_psroi_pooling-inl.h; R-FCN + Deformable ConvNets).

    inputs: data (B, output_dim*group_size^2, H, W), rois (R, 5)
    [batch_idx, x0, y0, x1, y1] in image coordinates, and unless
    ``no_trans`` a trans tensor (R, 2*cls, part, part) of normalised
    bin offsets.  Output (R, output_dim, pooled, pooled).  Every roi is
    computed at once: each sample point gathers (R, output_dim) values
    straight from ``data``."""
    data, rois = inputs[0], inputs[1]
    trans = None if (no_trans or len(inputs) < 3) else inputs[2]
    H, W = data.shape[2:]
    g = int(group_size)
    p = int(pooled_size)
    part = int(part_size) if part_size else p
    spp = int(sample_per_part)
    odim = int(output_dim)
    dev = data.device

    bidx = rois[:, 0].to(torch.int64)[:, None]          # (R, 1)
    x0 = (rois[:, 1] * spatial_scale - 0.5)[:, None]
    y0 = (rois[:, 2] * spatial_scale - 0.5)[:, None]
    x1 = (rois[:, 3] * spatial_scale + 0.5)[:, None]
    y1 = (rois[:, 4] * spatial_scale + 0.5)[:, None]
    rw = torch.clamp_min(x1 - x0, 0.1)
    rh = torch.clamp_min(y1 - y0, 0.1)
    bw, bh = _div(rw, p), _div(rh, p)
    sub = _div(bw, spp + 1.0)
    sbh = _div(bh, spp + 1.0)
    ods = torch.arange(odim, device=dev)
    # per-class offsets (ref: class_id = ctop / channels_each_class,
    # trans channels [2*cls, 2*cls+1])
    n_cls = 1 if trans is None else trans.shape[1] // 2
    cls_ids = ods // max(odim // max(n_cls, 1), 1)
    zero = torch.zeros((1, odim), dtype=torch.float32, device=dev)
    rows = []
    for py in range(p):
        cols = []
        for px in range(p):
            pt_y = min(py * part // p, part - 1)
            pt_x = min(px * part // p, part - 1)
            if trans is None:
                dx = dy = zero
            else:
                dx = trans[:, cls_ids * 2, pt_y, pt_x] * trans_std * rw
                dy = trans[:, cls_ids * 2 + 1, pt_y, pt_x] * trans_std * rh
            gy = min(py * g // p, g - 1)
            gx = min(px * g // p, g - 1)
            # ctop-major channel map, as PSROIPooling's
            chans = ((ods * g + gy) * g + gx)[None, :]
            acc = 0
            for iy in range(1, spp + 1):
                for ix in range(1, spp + 1):
                    sy = y0 + py * bh + iy * sbh + dy       # (R, odim)
                    sx = x0 + px * bw + ix * sub + dx
                    syc = torch.clamp(sy, 0.0, H - 1.0)
                    sxc = torch.clamp(sx, 0.0, W - 1.0)
                    yl = torch.floor(syc).to(torch.int64)
                    xl = torch.floor(sxc).to(torch.int64)
                    yh = torch.clamp_max(yl + 1, H - 1)
                    xh = torch.clamp_max(xl + 1, W - 1)
                    wy = syc - yl
                    wx = sxc - xl
                    v = ((1 - wy) * (1 - wx) * data[bidx, chans, yl, xl]
                         + (1 - wy) * wx * data[bidx, chans, yl, xh]
                         + wy * (1 - wx) * data[bidx, chans, yh, xl]
                         + wy * wx * data[bidx, chans, yh, xh])
                    inb = ((sy > -1) & (sy < H) & (sx > -1)
                           & (sx < W)).to(data.dtype)
                    acc = acc + v * inb
            cols.append(_div(acc, spp * spp))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2).to(data.dtype)


# ---------------------------------------------------------------------------
# loss attachments
# ---------------------------------------------------------------------------


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds the gradient of a KL
    sparseness penalty on the mean activation per hidden unit (ref:
    identity_attach_KL_sparse_reg-inl.h; as in the JAX package, the
    batch mean stands in for the momentum moving average)."""

    @staticmethod
    def forward(ctx, data, sparseness_target, penalty):
        ctx.save_for_backward(data)
        ctx.args = (sparseness_target, penalty)
        return data * 1.0

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        t, penalty = ctx.args
        rho = torch.clamp(data.mean(dim=0), 1e-6, 1 - 1e-6)
        kl = _div(_rdiv(-t, rho) + _rdiv(1 - t, 1 - rho), data.shape[0])
        return g + penalty * kl[None, :].to(g.dtype), None, None


@defop("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Identity that adds a KL sparseness-penalty gradient (ref:
    src/operator/identity_attach_KL_sparse_reg.cc)."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _KLSparseReg.apply(data, float(sparseness_target),
                                  float(penalty))
    return data * 1.0


# ---------------------------------------------------------------------------
# storage / shape utilities
# ---------------------------------------------------------------------------


@defop("cast_storage", aliases=["_sparse_cast_storage"])
def cast_storage_op(data, stype="default"):
    """Graph-level storage cast (ref: tensor/cast_storage.cc): every
    tensor of a graph is dense, so 'default' is the identity."""
    if stype != "default":
        raise ValueError(
            "cast_storage inside a graph supports only stype='default' "
            "(graph tensors are dense); cast an array to a sparse "
            "storage type with nd.cast_storage or NDArray.tostype")
    return data * 1.0


@defop("reshape_like")
def reshape_like(lhs, rhs):
    """(ref: tensor/elemwise_unary_op_basic.cc reshape_like)"""
    return lhs.reshape(rhs.shape)


@defop("_sparse_retain")
def sparse_retain_op(data, indices):
    """Dense semantics of sparse_retain (ref: tensor/sparse_retain.cc):
    rows whose index is absent become zero."""
    idx = indices.reshape(-1).to(torch.int64)
    keep = (torch.arange(data.shape[0], device=data.device)[:, None]
            == idx[None, :]).any(dim=1)
    return data * keep.reshape((-1,) + (1,) * (data.ndim - 1)) \
        .to(data.dtype)


@defop("_square_sum")
def square_sum(data, axis=None, keepdims=False):
    """sum(x^2) (ref: tensor/square_sum-inl.h, sparse-optimised there;
    dense here)."""
    sq = torch.square(data)
    if axis is None:
        out = sq.sum()
        return out.reshape((1,) * data.ndim) if keepdims else out
    return sq.sum(dim=int(axis), keepdim=bool(keepdims))


@defop("_scatter_elemwise_div")
def scatter_elemwise_div(lhs, rhs):
    """(ref: tensor/elemwise_binary_op_basic.cc: storage-aware division;
    the dense math is the same)"""
    return lhs / rhs


@defop("_scatter_plus_scalar")
def scatter_plus_scalar(data, scalar=0.0):
    return data + scalar


@defop("_scatter_minus_scalar")
def scatter_minus_scalar(data, scalar=0.0):
    return data - scalar


# legacy plugin hooks: the Custom op is the supported extension point
_PLUGIN = ("{} plugin ops are not supported; the extension point is a "
           "Custom op: subclass operator.CustomOp and CustomOpProp, "
           "register it with operator.register, and call the 'Custom' op")


@defop("_NDArray", differentiable=False)
def _ndarray_plugin(*args, **kwargs):
    """Legacy NDArray-function plugin hook (ref: plugin/)."""
    raise NotImplementedError(_PLUGIN.format("_NDArray"))


@defop("_Native", differentiable=False)
def _native_plugin(*args, **kwargs):
    """Legacy native-callback plugin hook (ref: plugin/)."""
    raise NotImplementedError(_PLUGIN.format("_Native"))
