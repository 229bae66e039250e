"""Neural-network layer ops (twin of ``incubator_mxnet_tpu/ops/nn.py``):
the same 34 names, aliases included.

The JAX package lowers these to XLA (``lax.conv_general_dilated``,
``reduce_window``, plain jnp code); here each is one torch call where
torch has one, so convolution, pooling and batch normalization run
through cuDNN and the products through cuBLAS.  No hand kernel is on
this path.  Layouts are the reference's: NC(D)HW data, OI(D)HW
convolution weights, (in, out/group, *k) deconvolution weights.

BatchNorm keeps the reference's arithmetic, not torch's: the running
variance is the biased one (over n), and the new moving value is
``momentum * old + (1 - momentum) * batch`` (torch's ``momentum`` is the
weight of the new value and its running variance the unbiased one), so
the moving stats are never handed to ``F.batch_norm``.  In training
mode the op returns them after its output, and ``nd`` writes them back
into its two trailing (aux) inputs.

The output heads (``SoftmaxOutput``, the regression outputs,
``SVMOutput``) are identity or softmax forward with the loss's gradient
backward, as ``torch.autograd.Function``s.
"""
import torch
import torch.nn.functional as F

from .registry import defop

# ---------------------------------------------------------------------------
# dense / conv / pool
# ---------------------------------------------------------------------------


@defop("FullyConnected", arg_names=["data", "weight", "bias"])
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """y = x W^T + b; ``flatten`` first reshapes x to (N, -1)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, None if no_bias else bias)


def _tup(v, n, default):
    if v is None or v == ():
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t + (default,) * (n - len(t))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@defop("Convolution", aliases=["Convolution_v1"],
       arg_names=["data", "weight", "bias"])
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False,
                layout=None):
    """N-D convolution, NC(D)HW data and OI(D)HW weight."""
    nsp = data.ndim - 2
    return _CONV[nsp](data, weight, None if no_bias else bias,
                      _tup(stride, nsp, 1), _tup(pad, nsp, 0),
                      _tup(dilate, nsp, 1), int(num_group))


@defop("Deconvolution", arg_names=["data", "weight", "bias"])
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0,
                  num_group=1, workspace=1024, no_bias=True,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution; weight (in, out/group, *k), ``adj`` the
    extra rows on the high side (torch's output_padding)."""
    nsp = data.ndim - 2
    return _DECONV[nsp](data, weight, None if no_bias else bias,
                        _tup(stride, nsp, 1), _tup(pad, nsp, 0),
                        _tup(adj, nsp, 0), int(num_group),
                        _tup(dilate, nsp, 1))


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_padding(shape, kernel, stride, pad, convention):
    """(lo, hi) per spatial dim: ``pad`` on both sides, and under the
    "full" convention ``stride - rem`` more on the high side, so the
    last partial window is kept (which torch's ceil_mode drops when it
    starts in the padding)."""
    out = []
    for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
        hi = p
        if convention == "full":
            rem = (shape[2 + i] + 2 * p - k) % s
            if rem:
                hi += s - rem
        out.append((p, hi))
    return out


@defop("Pooling", aliases=["Pooling_v1"])
def pooling(data, kernel=(), pool_type="max", global_pool=False,
            stride=(), pad=(), pooling_convention="valid",
            cudnn_off=False):
    """Max, avg or sum pooling.  Max pads with -inf; avg divides by the
    whole kernel, padding included (torch's count_include_pad)."""
    nsp = data.ndim - 2
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(f"unknown pool_type {pool_type}")
    if global_pool:
        dims = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dims, keepdim=True)
        if pool_type == "sum":
            return data.sum(dims, keepdim=True)
        return data.mean(dims, keepdim=True)
    kernel = _tup(kernel, nsp, 1)
    stride = _tup(stride, nsp, 1)
    pad = _tup(pad, nsp, 0)
    padding = _pool_padding(data.shape, kernel, stride, pad,
                            pooling_convention)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(padding,
                                                           kernel)):
        implicit = tuple(lo for lo, _ in padding)
        x = data
    else:
        implicit = (0,) * nsp
        flat = [v for lo_hi in reversed(padding) for v in lo_hi]
        fill = float("-inf") if pool_type == "max" else 0.0
        x = F.pad(data, flat, value=fill)
    if pool_type == "max":
        return _MAX_POOL[nsp](x, kernel, stride, implicit)
    avg = _AVG_POOL[nsp](x, kernel, stride, implicit,
                         count_include_pad=True)
    if pool_type == "avg":
        return avg
    denom = 1
    for k in kernel:
        denom *= k
    return avg * denom


@defop("UpSampling", variadic=True)
def upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=1, workspace=512):
    """Nearest (every input, concatenated on channels) or bilinear (the
    first input; half-pixel centers) upsampling by ``scale``."""
    s = int(scale)
    if sample_type == "nearest":
        outs = [a.repeat_interleave(s, 2).repeat_interleave(s, 3)
                for a in args]
    else:
        outs = [F.interpolate(args[0], scale_factor=s, mode="bilinear",
                              align_corners=False)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def _stats_cast(x):
    """Normalization statistics in float32 for bf16/fp16 inputs."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


@defop("BatchNorm", aliases=["BatchNorm_v1", "CuDNNBatchNorm"],
       needs_mode=True, num_aux=2,
       arg_names=["data", "gamma", "beta"],
       aux_names=["moving_mean", "moving_var"])
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=False):
    """Batch normalization over every axis but ``axis``.

    In training mode (and without ``use_global_stats``) it normalizes
    by the batch's mean and biased variance, taken in float32 for
    bf16/fp16 data (cuDNN's fused kernel, through
    ``torch.native_batch_norm``, whose saved inverse std gives the
    variance back), and returns (out, new_moving_mean, new_moving_var)
    with new = momentum * moving + (1 - momentum) * batch.  Otherwise
    it normalizes by the moving stats.  ``fix_gamma`` uses 1 for gamma
    (gamma then gets no gradient)."""
    ax = int(axis) % data.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _training and not use_global_stats:
        x = data if ax == 1 else data.movedim(ax, 1)
        out, mean, invstd = torch.native_batch_norm(
            x, g, beta, None, None, True, 0.0, eps)
        if ax != 1:
            out = out.movedim(1, ax)
        with torch.no_grad():
            var = (invstd.float().reciprocal().square() - eps) \
                .clamp_min(0.0)
            new_mean = (momentum * moving_mean
                        + (1 - momentum) * mean.to(moving_mean.dtype))
            new_var = (momentum * moving_var
                       + (1 - momentum) * var.to(moving_var.dtype))
        return out, new_mean, new_var
    bshape = [1] * data.ndim
    bshape[ax] = data.shape[ax]
    inv = torch.rsqrt(moving_var + eps)
    scale = (g * inv).to(data.dtype)
    shift = (beta - moving_mean * g * inv).to(data.dtype)
    out = data * scale.reshape(bshape) + shift.reshape(bshape)
    if _training:
        return out, moving_mean, moving_var
    return out


@defop("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Layer normalization over ``axis`` (statistics in float32 inside
    torch's kernel for bf16/fp16 inputs)."""
    ax = int(axis) % data.ndim
    x = data if ax == data.ndim - 1 else data.movedim(ax, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return out if ax == data.ndim - 1 else out.movedim(-1, ax)


@defop("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    """Instance norm over the spatial axes; float32 statistics for
    low-precision inputs."""
    red = tuple(range(2, data.ndim))
    x = _stats_cast(data)
    var, mean = torch.var_mean(x, red, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    out = ((x - mean) * torch.rsqrt(var + eps)
           * _stats_cast(gamma).reshape(shape)
           + _stats_cast(beta).reshape(shape))
    return out.to(data.dtype)


@defop("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """x / sqrt(sum(x^2) + eps) over the instance, channel or spatial
    axes."""
    if mode == "instance":
        red = tuple(range(1, data.ndim))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.ndim))
    else:
        raise ValueError(mode)
    return data / torch.sqrt(data.square().sum(red, keepdim=True) + eps)


@defop("LRN")
def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across ``nsize`` channels."""
    n = int(nsize)
    sq = F.pad(data.square(), (0, 0, 0, 0, (n - 1) // 2, n // 2))
    acc = sq.unfold(1, n, 1).sum(-1)
    return data / torch.pow(knorm + alpha / n * acc, beta)


# ---------------------------------------------------------------------------
# activations / softmax
# ---------------------------------------------------------------------------

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": F.softplus, "softsign": F.softsign}


@defop("Activation")
def activation(data, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign."""
    try:
        fn = _ACTS[act_type]
    except KeyError:
        raise ValueError(f"unknown act_type {act_type}") from None
    return fn(data)


@defop("LeakyReLU", variadic=True, needs_rng=True, needs_mode=True)
def leaky_relu(*args, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334, _rng=None, _training=False):
    """leaky, prelu (args[1] the per-channel slope), elu, selu or rrelu
    (a uniform slope per element in training, the mid-point else)."""
    data = args[0]
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        gamma = args[1].reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data > 0, data, gamma * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        scale, a = 1.0507009873554805, 1.6732632423543772
        return scale * torch.where(data > 0, data, a * torch.expm1(data))
    if act_type == "rrelu":
        if _training and _rng is not None:
            s = torch.rand(data.shape, generator=_rng, device=data.device,
                           dtype=data.dtype) \
                * (upper_bound - lower_bound) + lower_bound
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise ValueError(f"unknown act_type {act_type}")


@defop("softmax", aliases=["SoftmaxActivation"])
def softmax(data, axis=-1, temperature=None, mode="instance"):
    """Softmax over ``axis`` (``mode="channel"``: axis 1)."""
    ax = 1 if mode == "channel" else int(axis)
    x = data / temperature if temperature else data
    return torch.softmax(x, ax)


@defop("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, int(axis))


@defop("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Cross-entropy with integer labels, summed over the batch."""
    logp = torch.log_softmax(data, -1)
    return -logp.gather(-1, label.long()[:, None]).sum()


# ---------------------------------------------------------------------------
# output heads: identity or softmax forward, the loss's gradient backward
# ---------------------------------------------------------------------------


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, cfg):
        grad_scale, ignore_label, multi_output, use_ignore, \
            preserve_shape, normalization = cfg
        ax = 1 if (multi_output or preserve_shape) else -1
        out = torch.softmax(data, ax)
        ctx.save_for_backward(out, label)
        ctx.cfg, ctx.ax = cfg, ax
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, _, use_ignore, _, normalization = ctx.cfg
        ax = ctx.ax % out.ndim
        lbl = label.long()
        onehot = F.one_hot(lbl, out.shape[ax]).to(out.dtype) \
            .movedim(-1, ax)
        grad = out - onehot
        if use_ignore:
            keep = (lbl != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(ax)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            valid = (lbl != int(ignore_label)).to(out.dtype).sum() \
                .clamp_min(1.0)
            grad = grad / valid
        return grad * scale, None, None


@defop("SoftmaxOutput", aliases=["Softmax"])
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """Softmax forward; the cross-entropy gradient (softmax - onehot,
    scaled) backward, whatever gradient arrives from above."""
    cfg = (float(grad_scale), float(ignore_label), bool(multi_output),
           bool(use_ignore), bool(preserve_shape), str(normalization))
    return _SoftmaxOutput.apply(data, label, cfg)


class _RegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "LogisticRegressionOutput" \
            else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        if ctx.kind == "MAERegressionOutput":
            diff = torch.sign(diff)
        num = 1
        for s in out.shape[1:]:
            num *= s
        return diff * (ctx.grad_scale / num), None, None, None


def _make_regression(name):
    def _op(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, name, float(grad_scale))
    _op.__name__ = name
    _op.__doc__ = (f"{name}: link forward, (out - label) / n "
                   "gradient backward.")
    return _op


for _name in ("LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput"):
    defop(_name)(_make_regression(_name))


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        ind = F.one_hot(label.long(), d.shape[-1]).to(d.dtype) * 2 - 1
        gap = margin - d * ind
        viol = gap > 0
        if use_linear:
            grad = torch.where(viol, -ind * reg, torch.zeros_like(d))
        else:
            grad = torch.where(viol, -2.0 * reg * gap * ind,
                               torch.zeros_like(d))
        return grad, None, None, None, None


@defop("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity forward, hinge-loss gradient backward."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


@defop("Dropout", needs_rng=True, needs_mode=True)
def dropout(data, p=0.5, mode="training", axes=(), _rng=None,
            _training=False):
    """Inverted dropout: each element kept with probability 1 - p and
    scaled by 1 / (1 - p), the mask shared along ``axes``; the input
    itself outside training (unless ``mode="always"``)."""
    if (not _training and mode != "always") or p <= 0.0 or _rng is None:
        return data
    shape = list(data.shape)
    for a in (axes or ()):
        shape[a] = 1
    keep = torch.rand(shape, generator=_rng, device=data.device) >= p
    return torch.where(keep, data / (1.0 - p),
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device))


# ---------------------------------------------------------------------------
# sequence ops
# ---------------------------------------------------------------------------


def _time_index(n, device):
    return torch.arange(n, device=device)


@defop("SequenceMask", variadic=True)
def sequence_mask(*args, use_sequence_length=False, value=0.0, axis=0):
    """Set positions past each sequence's length to ``value``; data is
    (T, B, ...) with axis=0, (B, T, ...) with axis=1."""
    data = args[0]
    if not use_sequence_length:
        return data
    seqlen = args[1].long()
    t = _time_index(data.shape[int(axis)], data.device)
    if int(axis) == 0:
        mask = t[:, None] < seqlen[None, :]
    else:
        mask = t[None, :] < seqlen[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))


@defop("SequenceLast", variadic=True)
def sequence_last(*args, use_sequence_length=False, axis=0):
    """The last valid step of each sequence."""
    data = args[0]
    ax = int(axis)
    if not use_sequence_length:
        return data.select(ax, data.shape[ax] - 1)
    idx = (args[1].long() - 1).clamp(0, data.shape[ax] - 1)
    d = data.movedim(0, 1) if ax == 0 else data
    idx = idx.reshape((-1, 1) + (1,) * (d.ndim - 2)) \
        .expand((d.shape[0], 1) + d.shape[2:])
    return d.gather(1, idx).squeeze(1)


@defop("SequenceReverse", variadic=True)
def sequence_reverse(*args, use_sequence_length=False, axis=0):
    """Reverse (T, B, ...) along time, each sequence within its
    length."""
    data = args[0]
    if not use_sequence_length:
        return data.flip(0)
    seqlen = args[1].long()
    t = _time_index(data.shape[0], data.device)[:, None]
    idx = torch.where(t < seqlen[None, :], seqlen[None, :] - 1 - t, t)
    b = _time_index(data.shape[1], data.device)[None, :]
    return data[idx, b]


# ---------------------------------------------------------------------------
# spatial ops
# ---------------------------------------------------------------------------


@defop("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """Sampling grid (N, 2, H, W) in [-1, 1]: from (N, 6) affine
    parameters, or a (N, 2, H, W) flow field ("warp")."""
    dev, dt = data.device, data.dtype
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        n = data.shape[0]
        theta = data.reshape(n, 2, 3)
        gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=dev,
                                               dtype=dt),
                                torch.linspace(-1.0, 1.0, w, device=dev,
                                               dtype=dt), indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)], 0)
        return torch.einsum("nij,jk->nik", theta, coords) \
            .reshape(n, 2, h, w)
    _, _, hh, ww = data.shape
    gy, gx = torch.meshgrid(torch.arange(hh, device=dev, dtype=dt),
                            torch.arange(ww, device=dev, dtype=dt),
                            indexing="ij")
    x = (data[:, 0] + gx) * 2.0 / max(ww - 1, 1) - 1.0
    y = (data[:, 1] + gy) * 2.0 / max(hh - 1, 1) - 1.0
    return torch.stack([x, y], 1)


def _bilinear_sample(data, grid):
    """Bilinear sampling of data (N, C, H, W) at grid (N, 2, h, w) in
    [-1, 1]; points whose cell starts outside [-1, size - 1] give 0,
    corners outside the image read the nearest edge."""
    n, c, hin, win = data.shape
    x = (grid[:, 0] + 1.0) * (win - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (hin - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    bidx = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(yy, xx):
        yy = yy.clamp(0, hin - 1).long()
        xx = xx.clamp(0, win - 1).long()
        return data.permute(0, 2, 3, 1)[bidx, yy, xx]     # (n, h, w, c)

    inside = ((x0 >= -1) & (x0 <= win - 1) & (y0 >= -1)
              & (y0 <= hin - 1)).to(data.dtype)[..., None]
    out = ((1 - wy) * ((1 - wx) * gather(y0, x0) + wx * gather(y0, x0 + 1))
           + wy * ((1 - wx) * gather(y0 + 1, x0)
                   + wx * gather(y0 + 1, x0 + 1))) * inside
    return out.permute(0, 3, 1, 2)


@defop("BilinearSampler")
def bilinear_sampler(data, grid):
    """Sample data at the grid's points, bilinearly."""
    return _bilinear_sample(data, grid)


@defop("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear"):
    """Affine spatial transformer: the grid from ``loc``, then bilinear
    sampling."""
    return _bilinear_sample(data, grid_generator(loc, "affine",
                                                 target_shape))


@defop("Crop", variadic=True)
def crop_legacy(*args, offset=(0, 0), h_w=(0, 0), num_args=1,
                center_crop=False):
    """Crop args[0] to ``h_w``, or to args[1]'s spatial size."""
    data = args[0]
    if len(args) > 1:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy = (data.shape[2] - th) // 2
        ox = (data.shape[3] - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]
