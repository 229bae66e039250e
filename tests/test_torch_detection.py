"""The port's detection ops (``ops/contrib_det.py``) against the JAX
package's, on the CPU with the same numpy inputs.

- ``MultiBoxPrior`` (clip, steps, offsets) within 1e-6.
- ``MultiBoxTarget`` on three images (two boxes; none; four, two of them
  the same box, over anchors of which some are the same box, so the
  bipartite matching meets ties), with hard negative mining and
  without: ``cls_target`` and ``loc_mask`` equal, ``loc_target`` within
  1e-5; the image without ground truth keeps every output at its start
  value.
- ``MultiBoxDetection`` with ``force_suppress`` both ways and
  ``nms_topk`` both ways (off with -1, on with 20): classes equal,
  scores and boxes within 1e-5.
- ``nms_sweep``'s plain version (what CPU and ``meta`` tensors run)
  against the JAX op's ``lax.while_loop`` (with a trip count below the
  rows) and ``lax.fori_loop`` on random masks: equal.
- The NMS's traps, the port's plain route against the JAX op: 96 boxes
  on a 1/32 grid through ``MultiBoxDetection`` (``force_suppress``,
  ``nms_topk`` and the threshold 0.45 or 0.5 each both ways) with exact
  duplicates, zero areas (union 0), a NaN box, two classes, rows past
  the window and pairs whose fp32 IoU is exactly 1/2 and 9/20
  (float32(0.45): a float64 threshold would keep the row); the same for
  ``Proposal`` at +1 pixel (boxes moved by whole pixels, clipped to the
  image): classes equal, boxes within 1e-5.
- ``_pack_plain`` (the kernels' packed layout) against ``np.packbits``
  at a row length that is not a multiple of 32; ``_boxes_mask`` and
  ``_pack_plain`` of a few rows equal to those rows of the whole mask
  and its packing (a large window's plain mask is built so, in row
  chunks); ``nms_boxes`` on ``meta`` tensors, its checks, and its plain
  route the sweep of ``_boxes_masks``.
- ``ROIPooling`` on data with flat (tied) regions and zeros, and
  ``PSROIPooling``: outputs within 1e-5, gradients within 1e-5 (a tie's
  gradient split evenly, as the JAX op's max).
- ``Proposal`` and ``MultiProposal``: rois and scores within 1e-5 and
  rel 1e-6 (coordinates in pixels, up to 95).
- ``DeformableConvolution``: output within 1e-4, gradients of data,
  offset, weight and bias within 1e-4.
- The ops on ``meta`` tensors (shape inference) give the CPU's shapes.
- The slice as a whole: 3 steps of ``examples/ssd_train.py``'s training
  loop (its data, net and forward run on either package, with
  ``MultiBoxPrior``; ``MultiBoxTarget`` with mining, the masked losses,
  ``gluon.Trainer`` SGD with momentum and wd, blocks hybridized) at 32
  px and 4 images a step from the same weights (the port's Xavier draw, set into
  the JAX net): losses within rel 1e-4, and
  the port's ``MultiBoxDetection`` on the trained net agrees with
  the JAX one's.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu.ops.registry import OPS as JOPS  # noqa: E402
from incubator_mxnet_tpu_torch.ops import contrib_det as tdet  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import ssd_train  # noqa: E402

CPU = mt.cpu()
NUM_CLASSES = 2


def _j(name, *arrays, **params):
    fn = jax.jit(lambda *a: JOPS[name].fn(*a, **params))
    out = fn(*(jnp.asarray(a) for a in arrays))
    if isinstance(out, (tuple, list)):
        return [np.asarray(o) for o in out]
    return np.asarray(out)


def _t(name, *arrays, **params):
    short = name[len("_contrib_"):] if name.startswith("_contrib_") else name
    fn = getattr(mt.nd.contrib, short, None) or getattr(mt.nd, name)
    out = fn(*(mt.nd.array(a, ctx=CPU) for a in arrays), **params)
    if isinstance(out, list):
        return [o.asnumpy() for o in out]
    return out.asnumpy()


def _anchors():
    """Two feature maps' anchors: 6x6 and 3x3 with 4 boxes a pixel; the
    repeated size makes boxes that are the same box (matching ties)."""
    out = []
    for hw in (6, 3):
        feat = np.zeros((1, 1, hw, hw), np.float32)
        out.append(_j("_contrib_MultiBoxPrior", feat, sizes=(0.4, 0.4),
                      ratios=(1.0, 2.0, 0.5)))
    return np.concatenate(out, axis=1)                  # (1, 180, 4)


def _labels():
    lab = np.full((3, 4, 5), -1.0, np.float32)
    lab[0, :2] = [[0, 0.1, 0.1, 0.5, 0.45], [1, 0.55, 0.3, 0.9, 0.95]]
    box = [0, 0.3, 0.3, 0.7, 0.7]
    lab[2] = [box, [1, 0.3, 0.3, 0.7, 0.7], [1, 0.0, 0.6, 0.35, 1.0],
              [0, 0.62, 0.05, 0.98, 0.4]]
    return lab                                           # image 1: none


@pytest.mark.parametrize("params", [
    dict(sizes=(0.3, 0.6), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.5,), ratios=(1.0, 3.0), clip=True, steps=(0.2, 0.25),
         offsets=(0.3, 0.6))])
def test_multibox_prior(params):
    feat = np.zeros((2, 3, 5, 7), np.float32)
    want = _j("_contrib_MultiBoxPrior", feat, **params)
    got = _t("_contrib_MultiBoxPrior", feat, **params)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mining", [-1.0, 3.0])
def test_multibox_target(mining):
    anchor, label = _anchors(), _labels()
    A = anchor.shape[1]
    rs = np.random.RandomState(1)
    cls_pred = rs.randn(3, NUM_CLASSES + 1, A).astype(np.float32)
    params = dict(negative_mining_ratio=mining, overlap_threshold=0.5)
    want = _j("_contrib_MultiBoxTarget", anchor, label, cls_pred, **params)
    got = _t("_contrib_MultiBoxTarget", anchor, label, cls_pred, **params)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # the image without ground truth: start values
    assert (got[0][1] == 0).all() and (got[1][1] == 0).all() \
        and (got[2][1] == -1).all()
    assert (got[2][2] > 0).sum() >= 4           # every box matched
    if mining > 0:
        assert ((got[2] == 0).sum(1) <= 3 * (got[2] > 0).sum(1)).all()


@pytest.mark.parametrize("force,topk", [(False, -1), (True, 20)])
def test_multibox_detection(force, topk):
    anchor = _anchors()
    A = anchor.shape[1]
    rs = np.random.RandomState(2)
    logits = rs.randn(2, NUM_CLASSES + 1, A).astype(np.float32) * 2
    cls_prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, 4 * A) * 0.2).astype(np.float32)
    params = dict(threshold=0.2, nms_threshold=0.4, force_suppress=force,
                  nms_topk=topk)
    want = _j("_contrib_MultiBoxDetection", cls_prob, loc, anchor, **params)
    got = _t("_contrib_MultiBoxDetection", cls_prob, loc, anchor, **params)
    assert got.shape == want.shape == (2, A, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-5)
    kept = (got[..., 0] >= 0).sum()
    assert 0 < kept < (got[..., 1] >= 0).sum()          # NMS did work


def _jax_while_sweep(sup, alive, nkeep):
    def cond(st):
        return st[0] < nkeep

    def body(st):
        i, a = st
        return i + 1, jnp.where(a[i], a & ~sup[i], a)

    return lax.while_loop(cond, body, (jnp.int32(0), alive))[1]


def _jax_fori_sweep(sup):
    def body(i, a):
        return jnp.where(a[i], a & ~sup[i], a)

    return lax.fori_loop(0, sup.shape[0], body,
                         jnp.ones((sup.shape[0],), bool))


def test_nms_sweep_plain_matches_jax_loops():
    rs = np.random.RandomState(3)
    n = 40
    sup = np.triu(rs.rand(3, n, n) < 0.15, k=1)
    alive = rs.rand(3, n) < 0.8
    nkeep = np.array([n, 25, 0])
    want = np.asarray(jax.jit(jax.vmap(_jax_while_sweep))(sup, alive,
                                                           nkeep))
    got = tdet.nms_sweep(torch.from_numpy(sup), torch.from_numpy(alive),
                         torch.from_numpy(nkeep)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.jit(jax.vmap(_jax_fori_sweep))(sup))
    got = tdet.nms_sweep(torch.from_numpy(sup), torch.ones(3, n, dtype=bool),
                         torch.full((3,), n)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    meta = tdet.nms_sweep(torch.from_numpy(sup).to("meta"),
                          torch.from_numpy(alive).to("meta"),
                          torch.from_numpy(nkeep).to("meta"))
    assert meta.shape == (3, n) and meta.device.type == "meta"


# ------------------------------------- the NMS's adversarial cases: exact
# ties at the threshold, duplicates, zero areas, NaN, classes, the window

U = 1.0 / 32            # corner boxes on a 1/32 grid: every IoU is exact


def _adversarial_detection():
    """(cls_prob (2, 3, A), loc (2, 4A), anchor (1, A, 4), rows): A = 96
    anchors on a 1/32 grid with zero offsets, so the decoded boxes are
    the anchors exactly; image 0 holds the designed rows by score
    (``rows`` names each by its score), image 1 random ones."""
    designed = [                        # (box in 1/32 units, class)
        ([0, 0, 2, 1], 0), ([0, 0, 1, 1], 0),          # IoU 1/2
        ([0, 2, 10, 3], 1), ([1, 2, 20, 3], 1),        # IoU 9/20
        ([4, 4, 12, 12], 0), ([4, 4, 12, 12], 1),      # duplicate, 2 classes
        ([14, 4, 22, 12], 1), ([14, 4, 22, 12], 1),    # duplicate, 1 class
        ([5, 25, 5, 25], 0), ([5, 25, 5, 25], 0),      # points: union 0
        ([20, 24, 28, 30], 1), ([24, 24, 24, 30], 1),  # a line: area 0
        ([14, 4, 22, 12], 1),                          # NaN offsets
    ]
    names = ["half_a", "half_b", "tie45_a", "tie45_b", "dup2_a", "dup2_b",
             "dup1_a", "dup1_b", "point_a", "point_b", "box", "line", "nan"]
    rs = np.random.RandomState(10)
    A = 96
    boxes = np.zeros((A, 4), np.float32)
    cls = rs.randint(0, 2, (2, A))
    score = np.empty((2, A), np.float32)
    for r, (box, c) in enumerate(designed):
        boxes[r] = np.array(box, np.float32) * U
        cls[0, r] = c
        score[0, r] = 0.99 - 0.01 * r           # in order, the top rows
    lo = rs.randint(0, 28, (A, 2))
    hi = lo + rs.randint(0, 5, (A, 2))
    rnd = np.concatenate([lo, hi], 1)[:, [0, 1, 2, 3]] * U
    n = len(designed)
    boxes[n:] = rnd[n:].astype(np.float32)
    score[0, n:] = rs.uniform(0.05, 0.85, A - n)   # some below 0.2
    score[1] = rs.permutation(np.linspace(0.05, 0.95, A)).astype(np.float32)
    prob = np.zeros((2, 3, A), np.float32)
    for b in range(2):
        prob[b, 1 + cls[b], np.arange(A)] = score[b]
        prob[b, 2 - cls[b], np.arange(A)] = score[b] * 0.5
        prob[b, 0] = 1.0 - score[b]
    loc = np.zeros((2, A, 4), np.float32)
    loc[0, names.index("nan")] = np.nan
    return prob, loc.reshape(2, -1), boxes[None], dict(
        zip(names, score[0, :n]))


def _row(out, score):
    return int(np.flatnonzero(out[0, :, 1] == score)[0])


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("topk", [-1, 40])
@pytest.mark.parametrize("thr", [0.45, 0.5])
def test_multibox_detection_adversarial(force, topk, thr):
    prob, loc, anchor, rows = _adversarial_detection()
    params = dict(threshold=0.2, nms_threshold=thr, force_suppress=force,
                  nms_topk=topk)
    want = _j("_contrib_MultiBoxDetection", prob, loc, anchor, **params)
    got = _t("_contrib_MultiBoxDetection", prob, loc, anchor, **params)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-5)
    kept = {k: got[0, _row(got, v), 0] >= 0 for k, v in rows.items()}
    # fp32 IoU 9/20 == float32(0.45): suppressed at 0.45 (a float64
    # threshold would keep it), kept at 0.5
    assert kept["tie45_b"] == (thr == 0.5)
    assert not kept["half_b"] and not kept["dup1_b"]
    assert kept["dup2_b"] != force
    assert kept["point_a"] and kept["point_b"] and kept["line"]
    assert kept["nan"] and np.isnan(got[0, _row(got, rows["nan"]), 2:]).all()
    if topk > 0:                  # rows past the window are marked
        assert (got[:, topk:, 0] == -1).all()
    assert (got[1, :, 0] >= 0).sum() < (got[1, :, 1] >= 0).sum()


def _adversarial_rpn():
    """Proposal inputs, 1 x 96 boxes (K = 3 square anchors of 16, 32 and
    64 pixels on a 4 x 8 map, stride 16) moved by whole pixels (offsets
    m / width, no scaling), so every +1-pixel IoU is exact: two pairs at
    the image's corner at 9/20 and 1/2, duplicates, and boxes clipped to
    the image's right edge.  Scores put the designed pairs first."""
    K, H, W = 3, 4, 8
    rs = np.random.RandomState(11)
    shift = rs.randint(-20, 21, (K, H, W, 2)).astype(np.float32)
    score = rs.uniform(0.05, 0.9, (K, H, W)).astype(np.float32)
    width = np.array([16.0, 32.0, 64.0], np.float32)

    def corner(k, h, w, x2, y2, s):
        """anchor (k, h, w) moved so that its x2, y2 are these (its x1,
        y1 fall below 0 and clip)"""
        half = (width[k] - 1) / 2
        shift[k, h, w] = [x2 - (16 * w + 7.5 + half),
                          y2 - (16 * h + 7.5 + half)]
        score[k, h, w] = s

    corner(2, 0, 0, 19, 9, 0.99)        # 20 x 10
    corner(1, 0, 0, 8, 9, 0.98)         # 9 x 10: IoU 9/20 with it
    corner(2, 1, 1, 19, 39, 0.97)       # 20 x 40
    corner(2, 1, 2, 9, 39, 0.96)        # 10 x 40: IoU 1/2 with it
    shift[0, 2, 3] = shift[0, 2, 2] - [16, 0]   # a duplicate
    deltas = np.zeros((K, 4, H, W), np.float32)
    deltas[:, 0] = shift[..., 0] / width[:, None, None]
    deltas[:, 1] = shift[..., 1] / width[:, None, None]
    cls_prob = np.concatenate([1 - score, score])[None]
    bbox = deltas.reshape(1, 4 * K, H, W)
    im_info = np.array([[70, 100, 1.0]], np.float32)   # clips the right
    return cls_prob, bbox, im_info


@pytest.mark.parametrize("thr", [0.45, 0.5])
def test_proposal_adversarial(thr):
    inputs = _adversarial_rpn()
    params = dict(rpn_pre_nms_top_n=96, rpn_post_nms_top_n=30,
                  threshold=thr, rpn_min_size=1, output_score=True,
                  scales=(1.0, 2.0, 4.0), ratios=(1.0,))
    want = _j("_contrib_Proposal", *inputs, **params)
    got = _t("_contrib_Proposal", *inputs, **params)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
    top = got[0][:4, 1:].tolist()
    assert top[0] == [0, 0, 19, 9]
    # fp32 IoU 9/20 == float32(0.45): the 9 x 10 box goes at 0.45 only
    assert ([0, 0, 8, 9] in top) == (thr == 0.5)
    assert [0, 0, 19, 39] in top and [0, 0, 9, 39] not in top


def test_pack_plain_matches_numpy_packbits():
    rs = np.random.RandomState(12)
    n = 45                                  # not a multiple of 32
    sup = rs.rand(2, n, n) < 0.3
    got = tdet._pack_plain(torch.from_numpy(sup)).numpy()
    want = np.packbits(np.pad(sup, ((0, 0), (0, 0), (0, 64 - n))),
                       axis=-1, bitorder="little").view("<u4") \
        .view(np.int32)
    assert got.shape == (2, n, 2) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pixel", [False, True])
def test_boxes_mask_and_pack_by_rows(pixel):
    rs = np.random.RandomState(14)
    k = 70
    lo = rs.randint(0, 6, (k, 2))
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + rs.randint(0, 5, (k, 2))], 1).astype(np.float32))
    boxes[5, 2] = float("nan")
    cls = torch.from_numpy(rs.randint(0, 3, k).astype(np.float32))
    alive = torch.from_numpy(rs.rand(k) < 0.9)
    whole = tdet._boxes_mask(boxes, cls, alive, 0.45, False, pixel)
    packed = tdet._pack_plain(whole[None])[0]
    assert 0 < whole.sum() < whole.numel()
    for rows in (slice(0, 33), slice(33, 64), slice(64, k)):
        part = tdet._boxes_mask(boxes, cls, alive, 0.45, False, pixel, rows)
        assert torch.equal(part, whole[rows])
        assert torch.equal(tdet._pack_plain(part[None])[0], packed[rows])


def test_nms_boxes_on_meta_and_its_checks():
    B, k = 3, 50
    args = [torch.zeros(B, k, 4, device="meta"),
            torch.zeros(B, k, device="meta"),
            torch.ones(B, k, dtype=torch.bool, device="meta"),
            torch.full((B,), k, device="meta")]
    for pixel in (False, True):
        out = tdet.nms_boxes(*args, 0.45, pixel_offset=pixel)
        assert out.shape == (B, k) and out.dtype == torch.bool \
            and out.device.type == "meta"
    with pytest.raises(TypeError):
        tdet.nms_boxes(args[0].double(), *args[1:], 0.5)
    with pytest.raises(ValueError):
        tdet.nms_boxes(args[0][:, :, :3], *args[1:], 0.5)
    # the plain route is the mask's sweep
    rs = np.random.RandomState(13)
    lo = rs.rand(B, k, 2).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + rs.rand(B, k, 2).astype(np.float32) * 0.3], 2))
    cls = torch.from_numpy(rs.randint(0, 3, (B, k)).astype(np.float32))
    alive = torch.from_numpy(rs.rand(B, k) < 0.9)
    nkeep = torch.tensor([k, 30, 0])
    got = tdet.nms_boxes(boxes, cls, alive, nkeep, 0.3)
    sup = tdet._boxes_masks(boxes, cls, alive, nkeep, 0.3)
    assert torch.equal(got, tdet.nms_sweep(sup, alive, nkeep))
    assert torch.equal(tdet.nms_boxes(boxes, None, alive, nkeep, 0.3),
                       tdet.nms_boxes(boxes, cls, alive, nkeep, 0.3,
                                      force_suppress=True))


def _grads_both(name, inputs, wrt, params, tol):
    """Forward and the gradient of a weighted sum with respect to the
    inputs ``wrt``, in both packages."""
    jfn = JOPS[name].fn

    def jf(*diff):
        args = [jnp.asarray(a) for a in inputs]
        for i, d in zip(wrt, diff):
            args[i] = d
        return jfn(*args, **params)

    diff = [jnp.asarray(inputs[i]) for i in wrt]
    shape = jax.eval_shape(jf, *diff).shape
    ct = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jout, jgrads = jax.jit(lambda c, *d: (jf(*d), jax.vjp(jf, *d)[1](c)))(
        jnp.asarray(ct), *diff)
    xs = [mt.nd.array(a, ctx=CPU) for a in inputs]
    for i in wrt:
        xs[i].attach_grad()
    short = name[len("_contrib_"):] if name.startswith("_contrib_") else name
    fn = getattr(mt.nd.contrib, short, None) or getattr(mt.nd, name)
    with mt.autograd.record():
        out = fn(*xs, **params)
    out.backward(mt.nd.array(ct, ctx=CPU))
    np.testing.assert_allclose(out.asnumpy(), np.asarray(jout), rtol=0,
                               atol=tol)
    for i, jg in zip(wrt, jgrads):
        np.testing.assert_allclose(xs[i].grad.asnumpy(), np.asarray(jg),
                                   rtol=0, atol=tol, err_msg=f"d/dx{i}")
    return out.asnumpy()


def _rois():
    return np.array([[0, 0, 0, 7, 7], [1, 2.4, 1.6, 13.2, 9.8],
                     [0, 5, 5, 5, 5], [1, -3, 4, 30, 30],
                     [0, 8.6, 0.2, 15.1, 6.7]], np.float32)


def test_roi_pooling_with_ties():
    rs = np.random.RandomState(6)
    data = rs.randn(2, 3, 12, 16).astype(np.float32)
    data[0, :, 2:6, 1:5] = 0.75             # a flat region: ties
    data[1, 1, 3:8, 4:9] = 0.0
    data[1, 2] = np.round(data[1, 2])       # many small ties
    out = _grads_both("ROIPooling", [data, _rois()], [0],
                      dict(pooled_size=(3, 4), spatial_scale=0.5), 1e-5)
    assert out.shape == (5, 3, 3, 4)


def test_psroi_pooling():
    rs = np.random.RandomState(7)
    od, g = 2, 3
    data = rs.randn(2, od * g * g, 10, 14).astype(np.float32)
    out = _grads_both("_contrib_PSROIPooling", [data, _rois()], [0],
                      dict(spatial_scale=0.5, output_dim=od,
                           pooled_size=3, group_size=g), 1e-5)
    assert out.shape == (5, od, 3, 3)


@pytest.mark.parametrize("dg,group,bias", [(1, 1, True), (2, 2, False)])
def test_deformable_convolution(dg, group, bias):
    rs = np.random.RandomState(8)
    data = rs.randn(2, 4, 7, 8).astype(np.float32)
    offset = (rs.randn(2, 2 * 9 * dg, 7, 8) * 1.3).astype(np.float32)
    weight = (rs.randn(6, 4 // group, 3, 3) * 0.3).astype(np.float32)
    inputs = [data, offset, weight]
    if bias:
        inputs.append(rs.randn(6).astype(np.float32))
    params = dict(kernel=(3, 3), pad=(1, 1), num_filter=6,
                  num_group=group, num_deformable_group=dg,
                  no_bias=not bias)
    out = _grads_both("_contrib_DeformableConvolution", inputs,
                      list(range(len(inputs))), params, 1e-4)
    assert out.shape == (2, 6, 7, 8)


def _rpn_inputs(B, rs):
    K, H, W = 12, 5, 6
    cls_prob = rs.rand(B, 2 * K, H, W).astype(np.float32)
    bbox = (rs.randn(B, 4 * K, H, W) * 0.3).astype(np.float32)
    im_info = np.array([[80, 96, 1.0], [70, 90, 0.8]], np.float32)[:B]
    return cls_prob, bbox, im_info


@pytest.mark.parametrize("name,B", [("_contrib_Proposal", 1),
                                    ("_contrib_MultiProposal", 2)])
def test_proposal(name, B):
    inputs = _rpn_inputs(B, np.random.RandomState(9))
    params = dict(rpn_pre_nms_top_n=120, rpn_post_nms_top_n=40,
                  threshold=0.5, rpn_min_size=4, output_score=True)
    want = _j(name, *inputs, **params)
    got = _t(name, *inputs, **params)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
    assert got[0].shape == (B * 40, 5)
    # fewer rows survive than the window held, so the rows cycle
    assert len(np.unique(got[0], axis=0)) < B * 40


def test_ops_on_meta_tensors():
    anchor = torch.zeros(1, 180, 4, device="meta")
    out = tdet.multibox_target(anchor, torch.zeros(3, 4, 5, device="meta"),
                               torch.zeros(3, 3, 180, device="meta"),
                               negative_mining_ratio=3.0)
    assert [tuple(o.shape) for o in out] == [(3, 720), (3, 720), (3, 180)]
    det = tdet.multibox_detection(torch.zeros(2, 3, 180, device="meta"),
                                  torch.zeros(2, 720, device="meta"),
                                  anchor)
    assert det.shape == (2, 180, 6) and det.device.type == "meta"
    rois = tdet.multi_proposal(torch.zeros(2, 24, 5, 6, device="meta"),
                               torch.zeros(2, 48, 5, 6, device="meta"),
                               torch.zeros(2, 3, device="meta"),
                               rpn_pre_nms_top_n=50, rpn_post_nms_top_n=10)
    assert rois.shape == (20, 5)


# ---------------------------------------------------- the slice as a whole:
# examples/ssd_train.py's data, net and forward, its loss (:221-235)

def _ssd_loss(nd, anchor, cls_pred, loc_pred, lb, one):
    cp_t = nd.transpose(cls_pred, axes=(0, 2, 1))
    loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
        anchor, lb, cp_t, negative_mining_ratio=3.0)
    valid = cls_t >= 0
    logp = nd.log_softmax(cls_pred, axis=-1)
    lc = -nd.pick(logp, nd.maximum(cls_t, 0), axis=-1) * valid
    n_valid = nd.maximum(valid.sum(), one)
    n_pos = nd.maximum(loc_m.sum() / 4.0, one)
    ll = nd.smooth_l1((loc_pred - loc_t) * loc_m, scalar=1.0)
    return lc.sum() / n_valid + ll.sum() / n_pos


def test_ssd_train_loop_matches_jax():
    rs = np.random.RandomState(0)
    x, labels = ssd_train.make_dataset(rs, 8, 32)
    batches = [rs.randint(0, 8, 4) for _ in range(3)]
    losses, dets = {}, {}
    weights = None
    for pkg in (mt, mx):          # the port's Xavier weights go to JAX
        kw = {"ctx": CPU} if pkg is mt else {}
        mt.random.seed(0)
        net, down, heads = ssd_train.build_net(pkg)
        blocks = [net, down] + [h for pair in heads for h in pair]
        for blk in blocks:
            blk.initialize(pkg.initializer.Xavier() if pkg is mt
                           else pkg.initializer.Zero(), **kw)
            blk.hybridize()

        def forward(xb):
            return ssd_train.forward(pkg, pkg.nd, net, down, heads, xb)

        forward(pkg.nd.array(x[:4], **kw))              # settle shapes
        if weights is None:
            weights = [{k: p.data().asnumpy()
                        for k, p in blk.collect_params().items()}
                       for blk in blocks]
        else:
            for blk, w in zip(blocks, weights):
                for k, p in blk.collect_params().items():
                    p.set_data(pkg.nd.array(w[k]))
        params = {}
        for blk in blocks:
            params.update(blk.collect_params())
        trainer = pkg.gluon.Trainer(params, "sgd", dict(
            learning_rate=0.1, momentum=0.9, wd=1e-4))
        one = pkg.nd.array([1.0], **kw)
        losses[pkg] = []
        for sel in batches:
            xb = pkg.nd.array(x[sel], **kw)
            lb = pkg.nd.array(labels[sel], **kw)
            with pkg.autograd.record():
                loss = _ssd_loss(pkg.nd, *forward(xb), lb, one)
            loss.backward()
            trainer.step(4)
            losses[pkg].append(float(loss.asnumpy()[0]))
        anchor, cls_pred, loc_pred = forward(pkg.nd.array(x[:4], **kw))
        cls_prob = pkg.nd.transpose(pkg.nd.softmax(cls_pred, axis=-1),
                                    axes=(0, 2, 1))
        dets[pkg] = pkg.nd.contrib.MultiBoxDetection(
            cls_prob, loc_pred, anchor, threshold=0.3,
            nms_threshold=0.45).asnumpy()
    np.testing.assert_allclose(losses[mt], losses[mx], rtol=1e-4)
    assert np.isfinite(losses[mt]).all()
    np.testing.assert_array_equal(dets[mt][..., 0], dets[mx][..., 0])
    np.testing.assert_allclose(dets[mt][..., 1:], dets[mx][..., 1:],
                               rtol=0, atol=1e-4)


def _cluster_case(rs, clusters, per, batch):
    """``clusters`` groups of ``per`` boxes, each group inside a cell of
    its own on a grid (cells 1 apart, boxes within 0.8 of a cell), rows
    in score order with the groups interleaved: every row block mixes
    groups, and no box of one group meets another's.  Returns boxes (B,
    k, 4), classes, alive, nkeep and each row's group (B, k)."""
    k = clusters * per
    side = int(np.ceil(np.sqrt(clusters)))
    group = np.stack([rs.permutation(k) // per for _ in range(batch)])
    origin = np.stack([group % side, group // side], -1).astype(np.float32)
    lo = rs.rand(batch, k, 2).astype(np.float32) * 0.5
    hi = lo + 0.05 + rs.rand(batch, k, 2).astype(np.float32) * 0.25
    boxes = np.concatenate([origin + lo, origin + hi], -1)
    cls = rs.randint(0, 2, (batch, k)).astype(np.float32)
    alive = rs.rand(batch, k) < 0.95
    nkeep = rs.randint(k // 2, k + 1, batch)
    return (torch.from_numpy(boxes), torch.from_numpy(cls),
            torch.from_numpy(alive), torch.from_numpy(nkeep), group)


def _cluster_oracle(boxes, cls, alive, nkeep, group, thr):
    """Greedy NMS splits by group when no box meets another group's: the
    plain version run on each group's rows alone (in order, each group's
    nkeep its rows below the image's), scattered back."""
    out = torch.zeros_like(alive)
    for b in range(boxes.shape[0]):
        for g in np.unique(group[b]):
            rows = torch.from_numpy(np.flatnonzero(group[b] == g))
            keep = (rows < nkeep[b]).sum().reshape(1)
            out[b, rows] = tdet.nms_boxes(
                boxes[b, rows][None], cls[b, rows][None],
                alive[b, rows][None], keep, thr)[0]
    return out


def test_nms_boxes_above_65536_rows_and_the_cluster_oracle():
    # the card now takes any size its scratch holds (C8): on meta the
    # route takes the sizes above the old limits (131072 rows, a batch
    # above 65535) and makes no (B, k, k) walk
    for B, k in ((2, 131072), (65537, 8)):
        out = tdet.nms_boxes(torch.zeros(B, k, 4, device="meta"), None,
                             torch.ones(B, k, dtype=torch.bool,
                                        device="meta"),
                             torch.full((B,), k, device="meta"), 0.5)
        assert out.shape == (B, k) and out.device.type == "meta"
    # chip_smoke's check at 131072 rows, here at 512: the plain route
    # equals the per-group oracle
    case = _cluster_case(np.random.RandomState(21), 64, 8, 2)
    boxes, cls, alive, nkeep, group = case
    got = tdet.nms_boxes(boxes, cls, alive, nkeep, 0.45)
    assert torch.equal(got, _cluster_oracle(*case, 0.45))
    assert 0 < int(got.sum()) < int(alive.sum())
