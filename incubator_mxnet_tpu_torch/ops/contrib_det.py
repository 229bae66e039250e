"""Detection ops (twin of ``incubator_mxnet_tpu/ops/contrib_det.py``):
the reference's SSD and R-CNN op set (ref:
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, src/operator/roi_pooling.cc,
src/operator/contrib/proposal.cc, psroi_pooling.cu,
deformable_convolution-inl.h).

Every shape is static and nothing is read on the host, so each op runs
inside a CUDA-graph capture and on ``meta`` tensors (shape inference):

- rows the reference drops are marked (class -1), not removed;
- the bipartite matching of MultiBoxTarget is L rounds over the static
  label rows, batched over the images; negative mining ranks by stable
  sorts;
- the greedy NMS of MultiBoxDetection, Proposal and MultiProposal (a
  (k, k) IoU mask swept by a ``lax.while_loop`` and a ``lax.fori_loop``
  in the JAX package) is ``nms_boxes``: for CUDA tensors the
  hand-written kernels of ``csrc/nms_sweep.cu``, a pair test that packs
  the suppression bits 32 a word and a sweep that takes 32 rows a
  barrier, the trip count a device tensor and no (B, k, k) tensor made;
  for CPU and ``meta`` tensors its plain version, the IoU mask in torch
  ops an image at a time and a loop over the static row count with
  ``torch.where`` masking.  The kernel does the torch ops' arithmetic op
  for op, so the two are bit-equal.  ``nms_sweep`` is that loop over a
  given mask, for CPU and ``meta`` tensors only;
- ROIPooling's two-stage masked max is a ``torch.autograd.Function``
  whose backward splits a tie's gradient evenly among the tied entries
  of each stage, as the JAX op's ``max`` reductions do, without the
  (rois, C, H, pw, W) tensor a direct autograd would keep;
- DeformableConvolution is a bilinear-gather im2col and one grouped
  matmul.

Constants (anchor sizes, base anchors) are made by device fills, never
copied from the host, so a capture holds them too.
"""
import ctypes
import math

import numpy as np
import torch

from . import _build
from .registry import defop

__all__ = ["nms_boxes", "nms_sweep"]

_F32 = torch.float32


def _tuple(v, n=None, dtype=float):
    """Normalise tuple-ish params (tuple, list or str)."""
    if isinstance(v, str):
        v = v.strip("()[] ")
        v = tuple(dtype(t) for t in v.split(",") if t.strip())
    elif isinstance(v, (int, float)):
        v = (dtype(v),)
    else:
        v = tuple(dtype(t) for t in v)
    if n is not None and len(v) == 1:
        v = v * n
    return v


def _const(values, device):
    """A float32 vector of Python numbers, made by fills on ``device``
    (no host-to-device copy, which a CUDA-graph capture refuses)."""
    return torch.stack([torch.full((), float(v), dtype=_F32, device=device)
                        for v in values])


def _div(x, d):
    """x / d for a Python number d, as a true division on every device:
    torch multiplies a CUDA tensor by the reciprocal of a Python number
    instead, which rounds otherwise and moves a floor or a ceil."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _rdiv(n, x):
    """n / x for a Python number n, as a true division (torch takes the
    reciprocal of x and multiplies)."""
    return torch.full_like(x, float(n)) / x


def _iou_corner(a, b):
    """IoU between corner boxes a (..., A, 4) and b (..., L, 4) ->
    (..., A, L); union <= 0 gives 0 (the reference's safe_divide)."""
    w = torch.clamp_min(torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
                        - torch.maximum(a[..., :, None, 0],
                                        b[..., None, :, 0]), 0.0)
    h = torch.clamp_min(torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
                        - torch.maximum(a[..., :, None, 1],
                                        b[..., None, :, 1]), 0.0)
    inter = w * h
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


# ---------------------------------------------------------------------------
# greedy NMS: csrc/nms_sweep.cu and its plain versions
# ---------------------------------------------------------------------------

_SIGNATURES = {
    "mxt_nms_boxes": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                      + [ctypes.c_float] + [ctypes.c_int] * 2
                      + [ctypes.c_void_p], ctypes.c_int),
    "mxt_nms_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _sweep_plain(sup, alive, nkeep):
    """The plain version: rows 0..n-1 in order, each (while below the
    image's ``nkeep``) clearing what it suppresses if it is alive."""
    for i in range(sup.shape[1]):
        take = alive[:, i] & (nkeep > i)
        alive = torch.where(take[:, None], alive & ~sup[:, i], alive)
    return alive


def _words(n):
    return (n + 31) // 32


def _pack_plain(sup):
    """(B, r, n) bool -> (B, r, ceil(n / 32)) int32 words, bit j % 32 of
    word j / 32: the kernels' packed layout (an image at a time; r rows
    of an (n, n) mask, or all of them)."""
    r, n = sup.shape[-2:]
    shifts = torch.arange(32, device=sup.device)
    weights = torch.bitwise_left_shift(torch.ones_like(shifts), shifts)
    out = []
    for one in sup:
        cols = torch.nn.functional.pad(one.to(torch.int64),
                                       (0, _words(n) * 32 - n))
        words = (cols.reshape(r, -1, 32) * weights).sum(-1)
        out.append(torch.where(words >= 2 ** 31, words - 2 ** 32, words)
                   .to(torch.int32))
    return torch.stack(out)


def nms_sweep(sup, alive, nkeep):
    """Greedy suppression: for each image b and each row i below
    ``nkeep[b]`` in order, an alive row i clears the rows it suppresses.

    sup (B, n, n) bool, ``sup[b, i, j]``: row i suppresses row j;
    alive (B, n) bool, the rows in play; nkeep (B,) integer.  Returns
    the alive mask (B, n).  CPU and ``meta`` tensors only: it is the
    plain version of ``nms_boxes``'s sweep, and on the card the NMS is
    ``nms_boxes``, which makes no mask, so CUDA tensors raise."""
    if sup.dtype != torch.bool or alive.dtype != torch.bool:
        raise TypeError("nms_sweep takes bool sup and alive masks")
    if sup.dim() != 3 or alive.dim() != 2 \
            or sup.shape != alive.shape[:1] + alive.shape[1:] * 2 \
            or nkeep.shape != alive.shape[:1]:
        raise ValueError(f"nms_sweep: sup (B, n, n), alive (B, n), nkeep "
                         f"(B,); got {tuple(sup.shape)}, "
                         f"{tuple(alive.shape)}, {tuple(nkeep.shape)}")
    if sup.device.type not in ("cpu", "meta"):
        raise ValueError(f"nms_sweep runs on cpu or meta, not "
                         f"{sup.device}: on the card, nms_boxes")
    return _sweep_plain(sup, alive, nkeep)


def _boxes_mask(boxes, cls, alive, threshold, force_suppress,
                pixel_offset, rows=slice(None)):
    """sup (k, k) of one image, or its rows ``rows``: row i suppresses a
    later row j when both are alive, their IoU (``_iou_corner``, or
    ``_proposal_iou`` with ``pixel_offset``) is at or above the
    threshold and, unless ``force_suppress`` or ``cls`` is None, their
    classes are equal."""
    iou = (_proposal_iou if pixel_offset else _iou_corner)(boxes[rows],
                                                           boxes)
    sup = iou >= threshold
    if cls is not None and not force_suppress:
        sup &= cls[rows, None] == cls[None, :]
    rank = torch.arange(boxes.shape[0], device=boxes.device)
    return sup & (rank[None, :] > rank[rows, None]) & alive[rows, None] \
        & alive[None, :]


def _boxes_masks(boxes, cls, alive, nkeep, threshold, force_suppress=False,
                 pixel_offset=False):
    """The (B, k, k) masks that ``nms_boxes`` sweeps, from its arguments
    (``nkeep`` unused), an image at a time: with ``alive`` and
    ``nkeep`` they are ``nms_sweep``'s arguments."""
    return torch.stack([
        _boxes_mask(boxes[b], None if cls is None else cls[b], alive[b],
                    threshold, force_suppress, pixel_offset)
        for b in range(boxes.shape[0])])


def _boxes_launch(boxes, cls, alive, nkeep, threshold, force_suppress,
                  pixel_offset, sweep=True):
    """Run csrc/nms_sweep.cu on CUDA tensors: the pair test and, with
    ``sweep``, the sweep.  Returns (alive (B, k) bool, or None
    without ``sweep``; the packed words (B, k, ceil(k / 32)) int32, of
    which only rows below nkeep and words from each row's diagonal word
    on are written).  Raises on sizes the kernel does not take or on a
    failed launch."""
    batch, n = alive.shape
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:                 # float4 loads
        boxes = boxes.clone()
    cls = None if cls is None or force_suppress else cls.contiguous()
    alive = alive.contiguous()
    nkeep = nkeep.to(torch.int64).contiguous()
    out = torch.empty_like(alive)
    words = torch.empty((batch, n, _words(n)), dtype=torch.int32,
                        device=alive.device)
    lib = _build.load("nms_sweep", _SIGNATURES)
    with torch.cuda.device(alive.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mxt_nms_boxes(
            boxes.data_ptr(), None if cls is None else cls.data_ptr(),
            alive.data_ptr(), nkeep.data_ptr(), out.data_ptr(),
            words.data_ptr(), batch, n, float(threshold),
            int(bool(pixel_offset)), int(sweep), stream)
    if rc != 0:
        raise RuntimeError("nms_boxes launch failed: "
                           + lib.mxt_nms_error_string(rc).decode())
    _build.LAUNCHES["nms_boxes"] += 1
    return (out if sweep else None), words


def nms_boxes(boxes, cls, alive, nkeep, threshold, force_suppress=False,
              pixel_offset=False):
    """Greedy NMS from the boxes: ``nms_sweep`` of the mask in which row
    i suppresses a later row j when both are alive, their IoU is at or
    above ``threshold`` (compared in float32) and their classes are
    equal (any classes with ``force_suppress`` or ``cls`` None).

    boxes (B, k, 4) float32 corner boxes sorted by score; cls (B, k)
    float32 or None; alive (B, k) bool, the rows in play; nkeep (B,)
    integer, a device tensor (never read on the host).  The IoU is
    ``_iou_corner``'s (union <= 0 gives 0) or, with ``pixel_offset``,
    ``_proposal_iou``'s (+1-pixel widths).  Returns the alive mask
    (B, k).  CUDA tensors launch ``csrc/nms_sweep.cu``, which makes no
    (B, k, k) tensor and takes any size whose scratch of k * k / 8 bytes
    an image fits, or raise; CPU tensors run the plain version,
    ``_boxes_masks`` then ``_sweep_plain``, and ``meta`` ones give the
    result's shape."""
    if boxes.dtype != _F32 or alive.dtype != torch.bool \
            or (cls is not None and cls.dtype != _F32):
        raise TypeError("nms_boxes takes float32 boxes and classes and a "
                        "bool alive mask")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or alive.shape != boxes.shape[:2] \
            or (cls is not None and cls.shape != boxes.shape[:2]) \
            or nkeep.shape != boxes.shape[:1]:
        raise ValueError(
            f"nms_boxes: boxes (B, k, 4), cls (B, k) or None, alive "
            f"(B, k), nkeep (B,); got {tuple(boxes.shape)}, "
            f"{None if cls is None else tuple(cls.shape)}, "
            f"{tuple(alive.shape)}, {tuple(nkeep.shape)}")
    if any(t.device != boxes.device for t in (cls, alive, nkeep)
           if t is not None):
        raise ValueError("nms_boxes: every tensor on one device")
    if boxes.device.type == "cuda":
        return _boxes_launch(boxes, cls, alive, nkeep, threshold,
                             force_suppress, pixel_offset)[0]
    if boxes.device.type not in ("cpu", "meta"):
        raise ValueError(f"nms_boxes runs on cuda, cpu or meta, not "
                         f"{boxes.device}")
    if boxes.device.type == "meta":        # shapes only: no (B, k, k) walk
        return torch.empty_like(alive)
    if boxes.shape[0] == 0:
        return alive.clone()
    return _sweep_plain(_boxes_masks(boxes, cls, alive, nkeep, threshold,
                                     force_suppress, pixel_offset),
                        alive, nkeep)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------

@defop("_contrib_MultiBoxPrior", differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Prior (anchor) boxes of a feature map (ref:
    src/operator/contrib/multibox_prior-inl.h MultiBoxPriorForward).
    data (B, C, H, W) -> (1, H*W*num_anchors, 4) corner boxes."""
    sizes = _tuple(sizes)
    ratios = _tuple(ratios)
    steps = _tuple(steps, 2)
    offsets = _tuple(offsets, 2)
    in_h, in_w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    cy = (torch.arange(in_h, dtype=_F32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=_F32, device=dev) + offsets[1]) * step_x
    # per location: every size at ratio 1, then ratios[1:] at sizes[0];
    # (size * H / W) keeps squares square in pixel space
    ws, hs = [], []
    for s in sizes:
        ws.append(s * in_h / in_w / 2.0)
        hs.append(s / 2.0)
    for r in ratios[1:]:
        sq = float(r) ** 0.5
        ws.append(sizes[0] * in_h / in_w * sq / 2.0)
        hs.append(sizes[0] / sq / 2.0)
    w = _const(ws, dev)
    h = _const(hs, dev)
    cxg = cx[None, :, None]
    cyg = cy[:, None, None]
    boxes = torch.stack(torch.broadcast_tensors(
        cxg - w, cyg - h, cxg + w, cyg + h), dim=-1)     # (H, W, K, 4)
    out = boxes.reshape(1, -1, 4).to(data.dtype)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------

def _take(x, idx):
    """x (B, A, ...) rows at idx (B, n) per image."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _set_rows(x, idx, values):
    """x (B, A) with x[b, idx[b]] = values[b]."""
    return x.scatter(1, idx[:, None], values[:, None])


@defop("_contrib_MultiBoxTarget", num_outputs=3, differentiable=False)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5,
                    minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training target assignment (ref:
    src/operator/contrib/multibox_target-inl.h), every image at once.
    anchor (1, A, 4), label (B, L, >=5), cls_pred (B, C, A) ->
    loc_target (B, 4A), loc_mask (B, 4A), cls_target (B, A), in the
    label's dtype.  ``minimum_negative_samples`` is accepted and unused,
    as in the reference kernel (multibox_target.cc:185)."""
    vx, vy, vw, vh = _tuple(variances, 4)
    overlap_threshold = float(overlap_threshold)
    ignore_label = float(ignore_label)
    neg_ratio = float(negative_mining_ratio)
    neg_thresh = float(negative_mining_thresh)
    anchors = anchor.reshape(-1, 4).to(_F32)
    lab = label.to(_F32)
    A = anchors.shape[0]
    B, L = lab.shape[:2]
    dev = lab.device

    valid = torch.cumprod((lab[:, :, 0] != -1.0).to(torch.int32), 1) == 1
    gt = lab[:, :, 1:5]
    overlaps = torch.where(valid[:, None, :], _iou_corner(anchors, gt),
                           -1.0)                            # (B, A, L)

    # stage 1: greedy bipartite matching, L rounds
    aflag = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    agt = torch.zeros((B, A), dtype=torch.int64, device=dev)
    gused = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for _ in range(L):
        mask = (aflag != 1)[:, :, None] & ~gused[:, None, :] \
            & valid[:, None, :]
        masked = torch.where(mask, overlaps, -1.0).reshape(B, -1)
        flat = torch.argmax(masked, dim=1)          # first maximal index
        bi, bj = flat // L, flat % L
        best = masked.gather(1, flat[:, None])[:, 0]
        do = best > 1e-6
        aflag = _set_rows(aflag, bi, torch.where(
            do, 1, aflag.gather(1, bi[:, None])[:, 0]).to(torch.int32))
        agt = _set_rows(agt, bi, torch.where(
            do, bj, agt.gather(1, bi[:, None])[:, 0]))
        gused = _set_rows(gused, bj, do | gused.gather(1, bj[:, None])[:, 0])

    # stage 2: each anchor's best ground truth, threshold positives
    best_iou = overlaps.amax(dim=2)
    best_gt = torch.argmax(overlaps, dim=2)
    if overlap_threshold > 0:
        promote = (aflag != 1) & (best_iou > overlap_threshold)
        agt = torch.where(promote, best_gt, agt)
        aflag = torch.where(promote, 1, aflag)
    positive = aflag == 1
    num_pos = positive.sum(dim=1)

    # stage 3: negatives, by hard mining or all
    if neg_ratio > 0:
        num_neg = torch.minimum((num_pos * neg_ratio).to(torch.int64),
                                A - num_pos)
        # background probability per anchor; hardest = lowest
        probs = torch.softmax(cls_pred.to(_F32), dim=1)[:, 0, :]
        cand = ~positive & (best_iou < neg_thresh)
        key = torch.where(cand, probs, math.inf)
        order = torch.sort(key, dim=1, stable=True).indices
        rank = torch.sort(order, dim=1, stable=True).indices
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    cls_t = torch.where(positive, lab[:, :, 0].gather(1, agt) + 1.0,
                        torch.where(negative, 0.0, ignore_label))
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    g = _take(gt, agt)                                      # (B, A, 4)
    gx = (g[..., 0] + g[..., 2]) * 0.5
    gy = (g[..., 1] + g[..., 3]) * 0.5
    gw = torch.clamp_min(g[..., 2] - g[..., 0], 1e-12)
    gh = torch.clamp_min(g[..., 3] - g[..., 1], 1e-12)
    enc = torch.stack([_div((gx - ax) / aw, vx), _div((gy - ay) / ah, vy),
                       _div(torch.log(gw / aw), vw),
                       _div(torch.log(gh / ah), vh)],
                      dim=2)                                # (B, A, 4)
    pos4 = positive[:, :, None]
    loc_t = torch.where(pos4, enc, 0.0).reshape(B, -1)
    loc_m = torch.where(pos4, 1.0, torch.zeros_like(enc)).reshape(B, -1)

    # an image without ground truth keeps every output at its start value
    has_gt = (valid.sum(dim=1) > 0)[:, None]
    loc_t = torch.where(has_gt, loc_t, 0.0)
    loc_m = torch.where(has_gt, loc_m, 0.0)
    cls_t = torch.where(has_gt, cls_t, ignore_label)
    dt = label.dtype
    return loc_t.to(dt), loc_m.to(dt), cls_t.to(dt)


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------

def _decode_boxes(anchors, loc, variances, clip):
    """Inverse of the loc encoding (ref: multibox_detection-inl.h
    TransformLocations).  anchors (A, 4), loc (B, A, 4)."""
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    vx, vy, vw, vh = variances
    ox = loc[..., 0] * vx * aw + ax
    oy = loc[..., 1] * vy * ah + ay
    ow = torch.exp(loc[..., 2] * vw) * aw * 0.5
    oh = torch.exp(loc[..., 3] * vh) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def detection_sweep_inputs(cls_prob, loc_pred, anchor, clip=True,
                           threshold=0.01, nms_threshold=0.5,
                           force_suppress=False,
                           variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """MultiBoxDetection up to its NMS: ``(boxes, cls, in_nms, nkeep,
    nms_threshold, force_suppress, False)`` of the window (the top k
    rows), the arguments of ``nms_boxes``, and the rows sorted by score,
    ``(cls_s, score_s, boxes_s, present)``."""
    variances = _tuple(variances, 4)
    anchors = anchor.reshape(-1, 4).to(_F32)
    cls_prob = cls_prob.to(_F32)
    A = anchors.shape[0]
    B = cls_prob.shape[0]
    dev = cls_prob.device

    score, cid = cls_prob[:, 1:, :].max(dim=1)
    cid = torch.where(score < float(threshold), 0, cid + 1)   # 1-based
    valid = cid > 0
    boxes = _decode_boxes(anchors, loc_pred.to(_F32).reshape(B, A, 4),
                          variances, bool(clip))
    # valid rows first, by score descending (stable)
    order = torch.sort(torch.where(valid, -score, math.inf), dim=1,
                       stable=True).indices
    cls_s = (cid.gather(1, order) - 1).to(_F32)
    score_s = score.gather(1, order)
    boxes_s = _take(boxes, order)
    present = valid.gather(1, order)                # a prefix of True

    # the NMS window: the top k rows only
    nms_topk = int(nms_topk)
    k = A if nms_topk <= 0 else min(nms_topk, A)
    nkeep = torch.clamp_max(valid.sum(dim=1), k)
    in_nms = present[:, :k] & (torch.arange(k, device=dev)[None, :]
                               < nkeep[:, None])
    return ((boxes_s[:, :k].contiguous(), cls_s[:, :k].contiguous(), in_nms,
             nkeep, float(nms_threshold), bool(force_suppress), False),
            (cls_s, score_s, boxes_s, present))


@defop("_contrib_MultiBoxDetection", differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0,
                       nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and per-class NMS for SSD inference (ref:
    src/operator/contrib/multibox_detection-inl.h).  Output (B, A, 6),
    rows [class_id, score, xmin, ymin, xmax, ymax] sorted by score;
    suppressed and invalid rows carry class_id -1.

    As the JAX op: with ``nms_topk`` > 0 the rows past top-k are marked
    suppressed (the reference leaves stale duplicates there), and
    ``background_id`` is accepted but class 0 is always the background,
    as in the reference kernel.  The NMS is ``nms_boxes`` over the
    window (k = A = 8732 for SSD300 at the default ``nms_topk``)."""
    nms, (cls_s, score_s, boxes_s, present) = detection_sweep_inputs(
        cls_prob, loc_pred, anchor, clip, threshold, nms_threshold,
        force_suppress, variances, nms_topk)
    alive_k = nms_boxes(*nms)
    B, A = present.shape
    alive = torch.cat([alive_k, torch.zeros(
        (B, A - alive_k.shape[1]), dtype=torch.bool, device=present.device)],
        dim=1)
    out_cls = torch.where(alive, cls_s, -1.0)
    out = torch.cat([out_cls[..., None], score_s[..., None], boxes_s],
                    dim=2)                                  # (B, A, 6)
    return torch.where(present[..., None], out, -1.0).to(cls_prob.dtype)


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

def _bin_bounds(start, end, extent):
    """The bins [lo, hi) as int64 (R, pooled), from float starts and
    ends clipped to [0, extent]."""
    lo = torch.clamp(start, 0, extent).to(torch.int64)
    hi = torch.clamp(end, 0, extent).to(torch.int64)
    return lo, hi


def _bin_masks(start, end, extent):
    """Membership masks (R, pooled, extent) of the bins [start, end)
    (start, end: (R, pooled) floats, clipped to [0, extent])."""
    lo, hi = _bin_bounds(start, end, extent)
    idx = torch.arange(extent, device=start.device)
    return (idx >= lo[..., None]) & (idx < hi[..., None])


_ROI_CHUNK = 32     # rois a chunk: their columns' (C, H) samples at once


def _bin_pairs(lo, hi, extent):
    """Each roi's (bin, column) pairs, bin by bin, as (R, M) tensors: the
    bin, the column and whether the pair is real.  Consecutive bins
    share at most one column, so a roi has at most M = extent + pooled
    - 1 pairs: a bound that reads no value on the host."""
    R, pooled = lo.shape
    M = extent + pooled - 1
    length = (hi - lo).clamp_min(0)
    cum = length.cumsum(1)
    m = torch.arange(M, device=lo.device).expand(R, M).contiguous()
    q = torch.searchsorted(cum, m, right=True)
    valid = q < pooled
    q = q.clamp_max(pooled - 1)
    w = lo.gather(1, q) + m - cum.gather(1, q) + length.gather(1, q)
    return q, torch.where(valid, w, 0), valid


def _rows(x, idx):
    """x (r, n, ...) at idx (r, M) along its second axis: (r, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _roi_stage1(cols, bidx, pairs, pooled):
    """t (R, C, H, pw): the max over each column bin, a chunk of rois at
    a time, from the columns of its pairs only; cols is the data as
    (B, W, C, H)."""
    q, w, valid = pairs
    neg = torch.finfo(cols.dtype).min
    out = []
    for r0 in range(0, bidx.shape[0], _ROI_CHUNK):
        sl = slice(r0, r0 + _ROI_CHUNK)
        v = torch.where(valid[sl, :, None, None],
                        cols[bidx[sl, None], w[sl]], neg)
        t = torch.full((v.shape[0], pooled) + v.shape[2:], neg,
                       dtype=v.dtype, device=v.device)
        out.append(t.scatter_reduce(1, q[sl, :, None, None].expand_as(v),
                                    v, "amax"))
    return torch.cat(out).permute(0, 2, 3, 1)


def _split_ties(vals, best, member, g):
    """The gradient of a masked max over the last axis of ``vals``,
    split evenly among the entries equal to ``best`` (as ``jnp.max``)."""
    tied = (vals == best[..., None]) & member
    return tied * (g / torch.clamp_min(tied.sum(dim=-1), 1))[..., None]


class _ROIPool(torch.autograd.Function):
    """The two-stage masked max of ROIPooling (columns, then rows).  The
    backward splits each stage's gradient among its tied entries, so it
    is the JAX op's gradient, from the saved stage-one maxima."""

    @staticmethod
    def forward(ctx, data, bidx, mh, col_lo, col_hi, empty):
        neg = torch.finfo(data.dtype).min
        pairs = _bin_pairs(col_lo, col_hi, data.shape[3])
        cols = data.permute(0, 3, 1, 2).contiguous()         # (B, W, C, H)
        t = _roi_stage1(cols, bidx, pairs, col_lo.shape[1])  # (R, C, H, pw)
        out = torch.stack(
            [torch.where(mh[:, p, None, :, None], t, neg).amax(dim=2)
             for p in range(mh.shape[1])], dim=2)             # (R, C, ph, pw)
        out = torch.where(empty[:, None], 0.0, out)
        ctx.save_for_backward(cols, bidx, mh, empty, t, out, *pairs)
        return out

    @staticmethod
    def backward(ctx, g):
        cols, bidx, mh, empty, t, out, q, w, valid = ctx.saved_tensors
        g = torch.where(empty[:, None], 0.0, g)
        # stage 2: rows of each bin p, for every (c, q)
        gt = 0
        tt = t.permute(0, 1, 3, 2)                            # (R, C, pw, H)
        for p in range(mh.shape[1]):
            gt = gt + _split_ties(tt, out[:, :, p], mh[:, p, None, None, :],
                                  g[:, :, p])
        gt = gt.permute(0, 2, 1, 3).contiguous()              # (R, pw, C, H)
        tp = t.permute(0, 3, 1, 2).contiguous()               # (R, pw, C, H)
        # stage 1: the columns of each bin, over the pairs
        B, W, C, H = cols.shape
        grad = torch.zeros((B * W, C, H), dtype=cols.dtype,
                           device=cols.device)
        for r0 in range(0, bidx.shape[0], _ROI_CHUNK):
            sl = slice(r0, r0 + _ROI_CHUNK)
            v = cols[bidx[sl, None], w[sl]]                   # (r, M, C, H)
            tied = (v == _rows(tp[sl], q[sl])) & valid[sl, :, None, None]
            n = torch.zeros_like(gt[sl]).scatter_add(
                1, q[sl, :, None, None].expand_as(v), tied.to(v.dtype))
            share = gt[sl] / torch.clamp_min(n, 1)            # (r, pw, C, H)
            grad.index_add_(0, (bidx[sl, None] * W + w[sl]).reshape(-1),
                            (tied * _rows(share, q[sl])).reshape(-1, C, H))
        return (grad.reshape(B, W, C, H).permute(0, 2, 3, 1), None, None,
                None, None, None)


@defop("ROIPooling", aliases=("_contrib_ROIPooling",))
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max pooling over quantised ROI bins (ref:
    src/operator/roi_pooling.cc ROIPoolForward).
    data (B, C, H, W), rois (R, 5) [batch_idx, x1, y1, x2, y2] ->
    (R, C, ph, pw); an empty bin gives 0."""
    ph, pw = (int(v) for v in _tuple(pooled_size, 2, int))
    H, W = data.shape[2:]
    scale = float(spatial_scale)
    r = rois.to(_F32)
    bidx = r[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(r[:, i] * scale).to(torch.int32)
                      for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1, 1).to(_F32)
    rw = torch.clamp_min(x2 - x1 + 1, 1).to(_F32)
    bh, bw = _div(rh, ph), _div(rw, pw)
    p = torch.arange(ph, dtype=_F32, device=data.device)
    q = torch.arange(pw, dtype=_F32, device=data.device)
    mh = _bin_masks(torch.floor(p * bh[:, None]) + y1[:, None],
                    torch.ceil((p + 1) * bh[:, None]) + y1[:, None], H)
    col_lo, col_hi = _bin_bounds(
        torch.floor(q * bw[:, None]) + x1[:, None],
        torch.ceil((q + 1) * bw[:, None]) + x1[:, None], W)
    empty = (~mh.any(dim=2))[:, :, None] | (col_hi <= col_lo)[:, None, :]
    return _ROIPool.apply(data, bidx, mh, col_lo, col_hi, empty)


# ---------------------------------------------------------------------------
# PSROIPooling
# ---------------------------------------------------------------------------

@defop("_contrib_PSROIPooling")
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                  pooled_size=1, group_size=0):
    """Position-sensitive ROI average pooling, R-FCN style (ref:
    src/operator/contrib/psroi_pooling.cu PSROIPoolForwardKernel).
    data (B, C=output_dim*g*g, H, W), rois (R, 5) ->
    (R, output_dim, p, p).  Each bin reads its own output_dim channels,
    gathered for every roi at once."""
    p = int(pooled_size)
    g = int(group_size) if int(group_size) > 0 else p
    od = int(output_dim)
    H, W = data.shape[2:]
    scale = float(spatial_scale)
    dev = data.device
    r = rois.to(_F32)
    bidx = r[:, 0].to(torch.int64)
    x1 = torch.round(r[:, 1]) * scale
    y1 = torch.round(r[:, 2]) * scale
    x2 = (torch.round(r[:, 3]) + 1.0) * scale
    y2 = (torch.round(r[:, 4]) + 1.0) * scale
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bh, bw = _div(rh, p), _div(rw, p)
    qs = torch.arange(p, dtype=_F32, device=dev)
    mh = _bin_masks(torch.floor(qs * bh[:, None] + y1[:, None]),
                    torch.ceil((qs + 1) * bh[:, None] + y1[:, None]), H)
    mw = _bin_masks(torch.floor(qs * bw[:, None] + x1[:, None]),
                    torch.ceil((qs + 1) * bw[:, None] + x1[:, None]), W)
    mhf, mwf = mh.to(_F32), mw.to(_F32)
    cnt = mhf.sum(dim=2)[:, :, None] * mwf.sum(dim=2)[:, None, :]  # (R,p,p)
    ods = torch.arange(od, device=dev)
    x = data.to(_F32)
    rows = []
    for i in range(p):
        gh = min(i * g // p, g - 1)
        cols = []
        for j in range(p):
            gw = min(j * g // p, g - 1)
            # out channel ct at bin (i, j) reads input channel
            # (ct*g + gh)*g + gw
            xs = x[bidx[:, None], ((ods * g + gh) * g + gw)[None, :]]
            sums = torch.einsum("rchw,rh,rw->rc", xs, mhf[:, i], mwf[:, j])
            c = cnt[:, i, j, None]
            cols.append(torch.where(c > 0, sums / torch.clamp_min(c, 1.0),
                                    0.0))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2).to(data.dtype)


# ---------------------------------------------------------------------------
# Proposal / MultiProposal
# ---------------------------------------------------------------------------

def _gen_base_anchors(stride, scales, ratios):
    """(ref: proposal-inl.h GenerateAnchors, whose floor/round
    quantisation is kept) -> (K, 4) as float64 numbers."""
    base = np.array([0.0, 0.0, stride - 1.0, stride - 1.0])
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    x_ctr = base[0] + 0.5 * (w - 1.0)
    y_ctr = base[1] + 0.5 * (h - 1.0)
    size = w * h
    out = []
    for r in ratios:
        size_r = np.floor(size / r)
        new_w = np.floor(np.sqrt(size_r) + 0.5)
        new_h = np.floor((new_w * r) + 0.5)
        for s in scales:
            ws, hs = new_w * s, new_h * s
            out.append([x_ctr - 0.5 * (ws - 1.0), y_ctr - 0.5 * (hs - 1.0),
                        x_ctr + 0.5 * (ws - 1.0), y_ctr + 0.5 * (hs - 1.0)])
    return out


def _proposal_iou(a, b=None):
    """IoU (A, L) of one image's boxes a against b (a itself when None)
    with the +1 pixel convention (ref: proposal.cc
    NonMaximumSuppression)."""
    b = a if b is None else b
    w = torch.clamp_min(torch.minimum(a[:, None, 2], b[None, :, 2])
                        - torch.maximum(a[:, None, 0], b[None, :, 0])
                        + 1.0, 0.0)
    h = torch.clamp_min(torch.minimum(a[:, None, 3], b[None, :, 3])
                        - torch.maximum(a[:, None, 1], b[None, :, 1])
                        + 1.0, 0.0)
    inter = w * h
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def proposal_sweep_inputs(fg, deltas, im_info, base, stride, pre_n,
                          thresh, min_size):
    """Proposal up to its sweep: fg (B, K, H, W), deltas (B, 4K, H, W),
    im_info (B, 3) -> ``(boxes, None, alive, nkeep, thresh, False,
    True)``, the arguments of ``nms_boxes`` (+1-pixel IoU, every row in
    play), and the top ``pre`` boxes and scores by score."""
    B, K, H, W = fg.shape
    dev = fg.device
    shift_x = torch.arange(W, dtype=_F32, device=dev) * stride
    shift_y = torch.arange(H, dtype=_F32, device=dev) * stride
    anc = (base[None, None, :, :] + torch.stack(torch.broadcast_tensors(
        shift_x[None, :, None], shift_y[:, None, None],
        shift_x[None, :, None], shift_y[:, None, None]), dim=-1)) \
        .reshape(-1, 4)                     # index h*(W*K) + w*K + k
    deltas = deltas.reshape(B, K, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    scores = fg.permute(0, 2, 3, 1).reshape(B, -1)

    im_h, im_w, im_scale = (im_info[:, i:i + 1] for i in range(3))
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    ax = anc[:, 0] + 0.5 * (aw - 1.0)
    ay = anc[:, 1] + 0.5 * (ah - 1.0)
    px = deltas[..., 0] * aw + ax
    py = deltas[..., 1] * ah + ay
    pw = torch.exp(deltas[..., 2]) * aw
    phh = torch.exp(deltas[..., 3]) * ah

    def clip(v, hi):
        return torch.minimum(torch.clamp_min(v, 0.0), hi)

    x1 = clip(px - 0.5 * (pw - 1.0), im_w - 1.0)
    y1 = clip(py - 0.5 * (phh - 1.0), im_h - 1.0)
    x2 = clip(px + 0.5 * (pw - 1.0), im_w - 1.0)
    y2 = clip(py + 0.5 * (phh - 1.0), im_h - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=2)            # (B, N, 4)

    # the padded region (past the real feature extent) and min_size
    hw = torch.arange(H * W * K, device=dev) // K
    hh, ww = hw // W, hw % W
    padded = (hh >= _div(im_h, stride).to(torch.int32)) \
        | (ww >= _div(im_w, stride).to(torch.int32))
    ms = min_size * im_scale
    small = ((x2 - x1 + 1.0) < ms) | ((y2 - y1 + 1.0) < ms)
    sc = torch.where(padded | small, -1.0, scores)

    # the top pre_n by score (stable, descending)
    n_total = boxes.shape[1]
    pre = min(pre_n, n_total) if pre_n > 0 else n_total
    sel = torch.sort(-sc, dim=1, stable=True).indices[:, :pre]
    b = _take(boxes, sel)
    s = sc.gather(1, sel)

    return (b, None, torch.ones((B, pre), dtype=torch.bool, device=dev),
            torch.full((B,), pre, dtype=torch.int64, device=dev),
            float(thresh), False, True), (b, s)


def _proposals(fg, deltas, im_info, base, stride, pre_n, post_n, thresh,
               min_size):
    """-> rois (B, post_n, 5) with batch index 0, scores (B, post_n)."""
    nms, (b, s) = proposal_sweep_inputs(fg, deltas, im_info, base, stride,
                                        pre_n, thresh, min_size)
    alive = nms_boxes(*nms)
    B, pre = alive.shape
    dev = alive.device

    # the first post_n alive rows, cycled to fill (ref: out[i] =
    # keep[i % out_size]); a suppressed row writes to a slot past the end
    keep_rank = torch.cumsum(alive.to(torch.int64), dim=1) - 1
    out_size = torch.clamp_min(alive.sum(dim=1), 1)
    slot = torch.where(alive, keep_rank, pre)
    kept = torch.zeros((B, pre + 1), dtype=torch.int64, device=dev).scatter(
        1, slot, torch.arange(pre, device=dev).expand(B, pre))[:, :pre]
    idx = kept.gather(1, torch.arange(post_n, device=dev)[None, :]
                      % out_size[:, None])
    rois = torch.cat([torch.zeros((B, post_n, 1), dtype=_F32, device=dev),
                      _take(b, idx)], dim=2)
    return rois, s.gather(1, idx)


def _proposal_args(cls_prob, bbox_pred, im_info, scales, ratios,
                   feature_stride):
    K = cls_prob.shape[1] // 2
    stride = float(feature_stride)
    base = _const([v for row in _gen_base_anchors(
        stride, _tuple(scales), _tuple(ratios)) for v in row],
        cls_prob.device).reshape(-1, 4)
    return (cls_prob[:, K:].to(_F32), bbox_pred.to(_F32),
            im_info.to(_F32), base, stride)


@defop("_contrib_Proposal", num_outputs=lambda p:
       2 if p.get("output_score", False) else 1, differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposal generation (ref: src/operator/contrib/proposal.cc;
    batch 1, as the reference).  cls_prob (1, 2K, H, W), bbox_pred
    (1, 4K, H, W), im_info (1, 3) -> rois (post_n, 5)
    [+ scores (post_n, 1)]."""
    assert not iou_loss, "iou_loss=True path not implemented"
    fg, deltas, info, base, stride = _proposal_args(
        cls_prob[:1], bbox_pred[:1], im_info[:1], scales, ratios,
        feature_stride)
    rois, sc = _proposals(fg, deltas, info, base, stride,
                          int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n),
                          float(threshold), float(rpn_min_size))
    rois = rois[0].to(cls_prob.dtype)
    if output_score:
        return rois, sc[0, :, None].to(cls_prob.dtype)
    return rois


@defop("_contrib_MultiProposal", num_outputs=lambda p:
       2 if p.get("output_score", False) else 1, differentiable=False)
def multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7,
                   rpn_min_size=16, scales=(4.0, 8.0, 16.0, 32.0),
                   ratios=(0.5, 1.0, 2.0), feature_stride=16,
                   output_score=False, iou_loss=False):
    """Batched Proposal (ref: src/operator/contrib/multi_proposal-inl.h)
    -> rois (B*post_n, 5) with each image's batch index."""
    assert not iou_loss, "iou_loss=True path not implemented"
    rois, scs = _proposals(*_proposal_args(
        cls_prob, bbox_pred, im_info, scales, ratios, feature_stride),
        int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n), float(threshold),
        float(rpn_min_size))
    B, post = rois.shape[:2]
    bidx = torch.arange(B, dtype=_F32, device=rois.device) \
        .repeat_interleave(post)[:, None]
    rois = torch.cat([bidx, rois.reshape(B * post, 5)[:, 1:]], dim=1) \
        .to(cls_prob.dtype)
    if output_score:
        return rois, scs.reshape(-1, 1).to(cls_prob.dtype)
    return rois


# ---------------------------------------------------------------------------
# DeformableConvolution
# ---------------------------------------------------------------------------

def _bilinear_sample(img, y, x):
    """img (B, G, c, H, W); y, x (B, G, P) float coordinates -> (B, G,
    c, P), zero outside [0, H) x [0, W) (ref: deformable_im2col.cuh
    deformable_im2col_bilinear and its boundary guard)."""
    H, W = img.shape[-2:]
    inb = (y >= 0) & (x >= 0) & (y < H) & (x < W)
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    ly, lx = (y - y0)[:, :, None], (x - x0)[:, :, None]
    flat = img.reshape(img.shape[:3] + (H * W,))

    def at(yi, xi):
        idx = (yi * W + xi)[:, :, None, :].expand(
            flat.shape[:3] + yi.shape[-1:])
        return torch.gather(flat, 3, idx)

    v = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
         + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)
    return torch.where(inb[:, :, None], v, 0.0)


@defop("_contrib_DeformableConvolution", variadic=True)
def deformable_convolution(*inputs, kernel=(3, 3), stride=(1, 1),
                           dilate=(1, 1), pad=(0, 0), num_filter=1,
                           num_group=1, num_deformable_group=1,
                           workspace=1024, no_bias=False, layout=None):
    """Deformable convolution v1 (ref:
    src/operator/contrib/deformable_convolution-inl.h): bilinear im2col
    at offset-shifted taps, then one grouped matmul.
    inputs: data (B, C, H, W), offset (B, 2*K*K*dg, H', W'),
    weight (O, C/g, kh, kw)[, bias (O,)]."""
    data, offset, weight = inputs[0], inputs[1], inputs[2]
    bias = None if no_bias or len(inputs) < 4 else inputs[3]
    kh, kw = _tuple(kernel, 2, int)
    sh, sw = _tuple(stride, 2, int)
    dh, dw = _tuple(dilate, 2, int)
    ph, pw = _tuple(pad, 2, int)
    B, C, H, W = data.shape
    O = int(num_filter)
    G = int(num_group)
    DG = int(num_deformable_group)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = data.device

    # sampling coordinates per (dg, kh*kw, Ho, Wo): the grid plus the
    # learned offsets
    base_y = (torch.arange(kh, device=dev) * dh)[:, None, None, None] \
        + (torch.arange(Ho, device=dev) * sh - ph)[None, None, :, None]
    base_x = (torch.arange(kw, device=dev) * dw)[None, :, None, None] \
        + (torch.arange(Wo, device=dev) * sw - pw)[None, None, None, :]
    gy = torch.broadcast_to(base_y, (kh, kw, Ho, Wo)).reshape(-1, Ho, Wo)
    gx = torch.broadcast_to(base_x, (kh, kw, Ho, Wo)).reshape(-1, Ho, Wo)
    off = offset.to(_F32).reshape(B, DG, kh * kw, 2, Ho, Wo)
    ys = (gy + off[:, :, :, 0]).reshape(B, DG, -1)
    xs = (gx + off[:, :, :, 1]).reshape(B, DG, -1)
    # channels within a deformable group share their coordinates
    cols = _bilinear_sample(data.to(_F32).reshape(B, DG, C // DG, H, W),
                            ys, xs)                 # (B, DG, cpg, K2*P)
    cols = cols.reshape(B, G, (C // G) * kh * kw, Ho * Wo)
    wmat = weight.reshape(G, O // G, (C // G) * kh * kw).to(_F32)
    out = torch.einsum("gok,bgkp->bgop", wmat, cols).reshape(B, O, Ho, Wo)
    if bias is not None:
        out = out + bias.to(_F32)[None, :, None, None]
    return out.to(data.dtype)
