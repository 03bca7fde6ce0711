"""The port's spatial-transformer, ROI and detection ops against the JAX
package's: ``BilinearSampler``, ``GridGenerator``,
``SpatialTransformer``, ``ROIPooling``, ``ROIAlign``, ``box_iou``,
``box_nms``, ``MultiBoxPrior``, ``MultiBoxTarget`` and
``MultiBoxDetection``.

The same seeded numpy inputs go through both packages' ``nd`` op under
``autograd.record()`` with a seeded head gradient; values and the
gradient of every float input the op differentiates are compared.
Small sizes: maps of 2 x 4 x 12 x 12, a few dozen boxes.

Tolerances: values and gradients within rtol 1e-5, atol 1e-5 (the same
float32 formulas; bilinear sampling normalizes its coordinates and back
in another order, by a few ulp).  Which rows are -1 (suppressed, not
kept, ignored) must be identical, and the class targets and masks, whole
numbers, are held within atol 1e-5, which only equal numbers meet.
"""
import logging

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-5

torch.set_num_threads(1)


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _run(pkg, call, inputs, grad):
    """Values of ``call(nd, *arrays)`` and the gradients of the inputs
    whose index is in ``grad`` (a seeded head gradient on the first
    output; none when ``grad`` is empty)."""
    xs = [pkg.nd.array(a, dtype=a.dtype) for a in inputs]
    for i in grad:
        xs[i].attach_grad()
    with pkg.autograd.record():
        out = call(pkg.nd, *xs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    if grad:
        hg = onp.random.RandomState(1).uniform(0.5, 1.5, outs[0].shape)
        outs[0].backward(pkg.nd.array(hg.astype("float32")))
    return [o.asnumpy() for o in outs], [xs[i].grad.asnumpy() for i in grad]


def _both(call, inputs, grad=(0,), exact=False):
    want = _run(mx, call, inputs, grad)
    with tmx.cpu():
        got = _run(tmx, call, inputs, grad)
    for kind, w, g in (("value", want[0], got[0]), ("grad", want[1],
                                                    got[1])):
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape and a.dtype == b.dtype, (kind, i)
            if exact:
                onp.testing.assert_array_equal(a == -1, b == -1,
                                               err_msg=f"{kind} {i}")
            onp.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                        err_msg=f"{kind} {i}")
    return got


def _boxes(seed, n, lo=0.0, hi=1.0):
    """n corner boxes inside [lo, hi]^2, width and height at least 2 %
    of the span."""
    rs = onp.random.RandomState(seed)
    c = rs.uniform(lo, hi, (n, 2, 2))
    c.sort(axis=1)
    c[:, 1] += 0.02 * (hi - lo)
    return onp.concatenate([c[:, :, 0], c[:, :, 1]], axis=1)[:, [0, 2, 1, 3]
                                                              ].astype(
        "float32")


# ------------------------------------------------------- spatial sampling

def _affine(n, seed):
    rs = onp.random.RandomState(seed)
    eye = onp.tile(onp.array([1, 0, 0, 0, 1, 0], "float32"), (n, 1))
    return (eye + 0.3 * rs.randn(n, 6)).astype("float32")


@pytest.mark.parametrize("case", ["affine", "warp"])
def test_grid_generator(case):
    if case == "affine":
        _both(lambda nd, t: nd.GridGenerator(t, "affine", (5, 7)),
              [_affine(2, 0)])
    else:
        _both(lambda nd, t: nd.GridGenerator(t, "warp"),
              [_rand(0, 2, 2, 6, 5)])


def test_bilinear_sampler_data_and_grid_gradients():
    """Grid points inside, on the edge and outside the map (zeros
    outside); gradients to the data and to the grid."""
    grid = onp.random.RandomState(3).uniform(-1.2, 1.2, (2, 2, 5, 6))
    _both(lambda nd, x, g: nd.BilinearSampler(x, g),
          [_rand(0, 2, 4, 12, 12), grid.astype("float32")], grad=(0, 1))


def test_spatial_transformer_data_and_loc_gradients():
    _both(lambda nd, x, t: nd.SpatialTransformer(x, t, target_shape=(6, 6)),
          [_rand(0, 2, 4, 12, 12), _affine(2, 1)], grad=(0, 1))


# ---------------------------------------------------------------- ROI ops

def _rois(seed, n, size=12.0, scale=1.0):
    """(n, 5) ROIs over 2 images of ``size`` pixels, in image units
    (``size / scale``), a few extending past the map."""
    rs = onp.random.RandomState(seed)
    b = _boxes(seed, n, -0.1 * size, 1.1 * size) / scale
    return onp.concatenate([rs.randint(0, 2, (n, 1)), b], axis=1).astype(
        "float32")


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pooling(scale):
    _both(lambda nd, x, r: nd.ROIPooling(x, r, (3, 2), scale),
          [_rand(0, 2, 4, 12, 12), _rois(1, 9, scale=scale)])


def test_roi_pooling_ties_split_the_gradient_as_the_reference():
    """A map of repeated values (as after a ReLU): tied maxima in a bin
    share its gradient at each stage, rows then columns, as jax's max
    splits it; an empty bin gives 0."""
    x = onp.round(onp.abs(_rand(0, 2, 4, 12, 12)))
    rois = onp.array([[0, 0, 0, 11, 11], [1, 2, 3, 4, 3],
                      [1, 5, 5, 5, 5], [0, -3, -3, -1, -1]], "float32")
    _both(lambda nd, x, r: nd.ROIPooling(x, r, (4, 3), 1.0), [x, rois])


@pytest.mark.parametrize("ratio", [2, 1, -1])
def test_roi_align(ratio, caplog):
    with caplog.at_level(logging.WARNING):
        _both(lambda nd, x, r: nd.ROIAlign(x, r, (3, 3), 0.5, ratio),
              [_rand(0, 2, 4, 12, 12), _rois(2, 7, scale=0.5)],
              grad=(0, 1))


def test_roi_align_position_sensitive():
    _both(lambda nd, x, r: nd.ROIAlign(x, r, (2, 2), 1.0, 2,
                                       position_sensitive=True),
          [_rand(0, 2, 8, 12, 12), _rois(3, 5)], grad=(0, 1))


def test_roi_ops_chunk_over_rois(monkeypatch):
    """The same answers when the ROIs are taken a few at a time (the
    card's bound on a temporary)."""
    from mxnet_tpu_torch.ndarray import detection
    monkeypatch.setattr(detection, "_CHUNK_ELEMS", 4 * 12 * 12 * 2)
    x, r = _rand(0, 2, 4, 12, 12), _rois(4, 9)
    _both(lambda nd, x, r: nd.ROIPooling(x, r, (3, 3), 1.0), [x, r])
    _both(lambda nd, x, r: nd.ROIAlign(x, r, (3, 3), 1.0, 2), [x, r],
          grad=(0, 1))


# -------------------------------------------------------------- detection

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    _both(lambda nd, a, b: nd.box_iou(a, b, format=fmt),
          [_boxes(0, 7), _boxes(1, 5)], grad=(0, 1))


def _nms_rows(seed, n, classes=3, batch=None):
    """Detection rows [id, score, x1, y1, x2, y2] with clustered boxes
    (many overlaps), a few tied scores and a few invalid ones."""
    rs = onp.random.RandomState(seed)
    shape = (n,) if batch is None else (batch, n)
    centers = rs.uniform(0.2, 0.8, (4, 2))
    c = centers[rs.randint(0, 4, shape)] + 0.05 * rs.randn(*shape, 2)
    wh = rs.uniform(0.1, 0.3, shape + (2,))
    score = onp.round(rs.uniform(-0.2, 1.0, shape), 1)     # ties
    ids = rs.randint(0, classes, shape)
    return onp.concatenate([ids[..., None], score[..., None], c - wh / 2,
                            c + wh / 2], axis=-1).astype("float32")


NMS_CASES = {
    "default": dict(),
    "topk": dict(topk=5),
    "id_index": dict(id_index=0),
    "force_suppress": dict(id_index=0, force_suppress=True),
    "thresh": dict(overlap_thresh=0.3, valid_thresh=0.25),
    "center_in": dict(in_format="center", out_format="center"),
    "to_center": dict(out_format="center"),
    "from_center": dict(in_format="center"),
}


@pytest.mark.parametrize("kw", list(NMS_CASES.values()), ids=list(NMS_CASES))
def test_box_nms(kw):
    """The kept rows (and the -1 rows) exactly; the gradient flows to
    the kept rows."""
    _both(lambda nd, x: nd.box_nms(x, **kw), [_nms_rows(0, 40)],
          exact=True)


def test_box_nms_batched_and_other_columns():
    _both(lambda nd, x: nd.box_nms(x, coord_start=1, score_index=0,
                                   id_index=5, topk=12),
          [_nms_rows(1, 30, batch=3)[..., [1, 2, 3, 4, 5, 0]]], exact=True)


def test_box_nms_chain_needs_rounds():
    """A chain a > b > c > ... where each box suppresses the next: the
    greedy answer keeps every second one, which the fixed point reaches
    only after rounds that pass the chain along."""
    rows = [[0, 1.0 - 0.01 * i, 0.05 * i, 0, 0.05 * i + 0.1, 0.1]
            for i in range(12)]
    _both(lambda nd, x: nd.box_nms(x, overlap_thresh=0.3),
          [onp.array(rows, "float32")], exact=True)


SSD_SIZES = [(0.2, 0.272), (0.37, 0.447)]


def test_multibox_prior():
    for sizes, ratios, kw in [((0.2, 0.272), (1, 2, 0.5), {}),
                              ((0.37, 0.447), (1, 2, 0.5, 3, 1 / 3),
                               dict(clip=True)),
                              ((0.5,), (1,), dict(steps=(0.2, 0.25),
                                                  offsets=(0.3, 0.6)))]:
        _both(lambda nd, x: nd.MultiBoxPrior(x, sizes=sizes, ratios=ratios,
                                             **kw),
              [_rand(0, 2, 3, 5, 4)], grad=())


def _anchors():
    with tmx.cpu():
        a = tmx.nd.MultiBoxPrior(tmx.nd.zeros((1, 1, 4, 4)),
                                 sizes=(0.3, 0.5), ratios=(1, 2, 0.5))
    return a.asnumpy()                              # (1, 64, 4)


def _labels(seed, batch=3, m=6):
    """Ground truth [cls, x1, y1, x2, y2] with -1 padding rows."""
    rs = onp.random.RandomState(seed)
    lab = -onp.ones((batch, m, 5), "float32")
    for b in range(batch):
        k = rs.randint(1, m + 1)
        lab[b, :k, 0] = rs.randint(0, 4, k)
        lab[b, :k, 1:] = _boxes(seed + b, k, 0.05, 0.95)
    return lab


@pytest.mark.parametrize("mining", [-1.0, 3.0])
def test_multibox_target(mining):
    a = _anchors()
    cp = onp.random.RandomState(5).uniform(0, 1, (3, 5, a.shape[1])
                                           ).astype("float32")
    cp[:, :, ::7] = 0.5                               # tied hardness
    _both(lambda nd, a, l, c: nd.MultiBoxTarget(
        a, l, c, overlap_threshold=0.5, negative_mining_ratio=mining,
        negative_mining_thresh=0.5),
        [a, _labels(0), cp], grad=(), exact=True)


def test_multibox_target_duplicate_forced_match():
    """Two ground-truth rows whose best anchor is the same one (equal
    boxes of other classes): the later row claims it, as the
    reference's scatter leaves it."""
    a = _anchors()
    lab = -onp.ones((2, 4, 5), "float32")
    lab[:, :3, 0] = [[1, 2, 3], [3, 0, 2]]
    lab[:, :3, 1:] = onp.array([[0.1, 0.1, 0.4, 0.4]] * 2 +
                               [[0.55, 0.5, 0.9, 0.95]], "float32")
    cp = onp.full((2, 5, a.shape[1]), 0.2, "float32")
    got = _both(lambda nd, a, l, c: nd.MultiBoxTarget(a, l, c),
                [a, lab, cp], grad=(), exact=True)
    iou = _run(mx, lambda nd, a, b: nd.box_iou(a, b), [a[0], lab[0, :1, 1:]],
               ())[0][0][:, 0]
    forced = int(onp.argmax(iou))                    # both rows' best
    assert list(got[0][2][:, forced]) == [3.0, 1.0]  # the later row's


def test_multibox_detection():
    a = _anchors()
    rs = onp.random.RandomState(7)
    logits = rs.randn(2, 5, a.shape[1]) * 2
    cp = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    lp = 0.5 * rs.randn(2, a.shape[1] * 4)
    for kw in (dict(), dict(nms_topk=10, threshold=0.3, nms_threshold=0.3),
               dict(force_suppress=True, clip=False)):
        _both(lambda nd, c, l, a: nd.MultiBoxDetection(c, l, a, **kw),
              [cp.astype("float32"), lp.astype("float32"), a], grad=(),
              exact=True)
