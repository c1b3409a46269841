"""The contrib ops of the port (``ops/contrib_ops.py``) against the JAX
package's, on the CPU, from identical numpy inputs: ``_contrib_fft``,
``_contrib_ifft`` and ``_contrib_count_sketch`` forward and gradient
(the harness of ``tests/test_torch_nn_ops.py``, float32 rtol = atol =
1e-5, bf16 2e-2), and the detection ops ``_contrib_MultiBoxPrior``,
``_contrib_MultiBoxTarget``, ``_contrib_MultiBoxDetection`` and
``_contrib_Proposal`` forward (they take no gradient).

Discrete outputs are equal exactly: ``loc_mask``, ``cls_target``, the
detections' class ids (NMS keeps) and Proposal's choice of boxes.  Besides
tie-free random inputs, the cases hold the places where the JAX package's
order is subtle: a box whose best anchor is anchor 0 beside padded label
rows (whose best anchor is anchor 0 too: the last row's write wins), two
boxes sharing a best anchor, hard negatives with tied scores, and NMS over
tied scores (the lower index first)."""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op
from mxnet_tpu_torch.ops import OpContext, get_op
from test_torch_nn_ops import _check_case, _f


def _signs(*shape):
    return lambda rng: np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(
        np.float32)


def _ints(*shape, high):
    return lambda rng: rng.randint(0, high, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,attrs,makers", [
    ("_contrib_fft", {}, [_f(3, 8)]),
    ("_contrib_fft", {"compute_size": 64}, [_f(2, 3, 5)]),
    ("_contrib_ifft", {}, [_f(3, 8)]),
    ("_contrib_ifft", {}, [_f(2, 2, 6)]),
    ("_contrib_count_sketch", {"out_dim": 5},
     [_f(4, 9), _ints(9, high=5), _signs(9)]),
    ("_contrib_count_sketch", {"out_dim": 3, "processing_batch_size": 8},
     [_f(2, 6), _ints(1, 6, high=3), _signs(1, 6)]),
], ids=["fft", "fft-3d", "ifft", "ifft-3d", "count_sketch",
        "count_sketch-2d-hash"])
def test_contrib_op_forward_and_gradient_match_jax(name, attrs, makers,
                                                   dtype):
    _check_case(name, attrs, makers, [], dtype)


def _both(name, attrs, inputs):
    """The op's outputs in both packages as float64 numpy, forward only,
    and the port's outputs again on ``meta`` tensors (shapes only)."""
    import jax.numpy as jnp

    jop, op = jget_op(name), get_op(name)
    jouts, _ = jop.apply(JOpContext(), jop.parse_attrs(attrs),
                         [jnp.asarray(x) for x in inputs])
    touts, _ = op.apply(OpContext(), op.parse_attrs(attrs),
                        [torch.from_numpy(x) for x in inputs])
    metas, _ = op.apply(OpContext(device=torch.device("meta")),
                        op.parse_attrs(attrs),
                        [torch.empty(x.shape, device="meta") for x in inputs])
    assert [tuple(m.shape) for m in metas] == [tuple(j.shape) for j in jouts]
    ishapes = [x.shape for x in inputs]
    got = op.infer_shape(op.parse_attrs(attrs), ishapes)
    ref = jop.infer_shape(jop.parse_attrs(attrs), ishapes)
    assert [tuple(g) for g in got[1]] == [tuple(r) for r in ref[1]]
    return ([np.asarray(j, np.float64) for j in jouts],
            [t.double().numpy() for t in touts])


def _close(got, ref, what):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attrs,shape", [
    ({}, (2, 3, 4, 5)),
    ({"sizes": (0.2, 0.272), "ratios": (1.0, 2.0, 0.5)}, (1, 8, 5, 5)),
    ({"sizes": (0.5, 0.7, 0.9), "ratios": (1.0, 3.0), "clip": True,
      "offsets": (0.25, 0.75), "steps": (0.1, 0.1)}, (1, 2, 3, 6)),
])
def test_multibox_prior_matches_jax(attrs, shape):
    x = np.zeros(shape, np.float32)
    (j,), (t,) = _both("_contrib_MultiBoxPrior", attrs, [x])
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------


def _anchors(h=6, w=6, sizes=(0.3, 0.45), ratios=(1.0, 2.0, 0.5)):
    op = get_op("_contrib_MultiBoxPrior")
    (a,), _ = op.apply(OpContext(), op.parse_attrs(
        {"sizes": sizes, "ratios": ratios}),
        [torch.zeros(1, 1, h, w)])
    return a.numpy()


def _labels(rng, n, rows, boxes_per=(1, 3), classes=3):
    label = np.full((n, rows, 5), -1.0, np.float32)
    for i in range(n):
        for r in range(rng.randint(*boxes_per)):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.35 + 0.05
            label[i, r] = [rng.randint(classes), x0, y0, x0 + w, y0 + h]
    return label


TARGET_ATTRS = [
    {},
    {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5,
     "minimum_negative_samples": 0, "overlap_threshold": 0.5,
     "ignore_label": -1.0, "variances": (0.1, 0.1, 0.2, 0.2)},
    {"negative_mining_ratio": 2.0, "minimum_negative_samples": 20,
     "overlap_threshold": 0.3, "variances": (0.2, 0.2, 0.5, 0.5)},
]


def _check_target(attrs, anchors, label, cls_pred):
    (jl, jm, jc), (tl, tm, tc) = _both(
        "_contrib_MultiBoxTarget", attrs, [anchors, label, cls_pred])
    np.testing.assert_array_equal(tm, jm, err_msg="loc_mask")
    np.testing.assert_array_equal(tc, jc, err_msg="cls_target")
    _close(tl, jl, "loc_target")
    return jl, jm, jc


@pytest.mark.parametrize("attrs", TARGET_ATTRS)
@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_target_matches_jax(attrs, seed):
    rng = np.random.RandomState(seed)
    anchors = _anchors()
    a = anchors.shape[1]
    label = _labels(rng, 4, 5)
    cls_pred = rng.randn(4, 4, a).astype(np.float32)
    _, jm, jc = _check_target(attrs, anchors, label, cls_pred)
    assert jm.sum() > 0 and (jc > 0).sum() > 0  # some anchors matched
    if attrs.get("negative_mining_ratio", -1) > 0:
        assert (jc == -1).sum() > 0 and (jc == 0).sum() > 0


def test_multibox_target_best_anchor_0_beside_padded_rows():
    """A valid box whose best anchor is anchor 0, below the overlap
    threshold there, with padded rows after it: the padded rows' best
    anchor is anchor 0 too (their IoUs are all -1), and the last row's
    write wins, so the box loses its forced match in both packages; a
    second sample holds the same box with no padded row after it, where
    the forced match stays."""
    anchors = _anchors(4, 4, sizes=(0.3,), ratios=(1.0,))
    # anchor 0 is (-0.025, -0.025, 0.275, 0.275): this box overlaps it by
    # IoU 0.25 and no other anchor at all
    assert np.allclose(anchors[0, 0], [-0.025, -0.025, 0.275, 0.275])
    box = [2.0, 0.0, 0.0, 0.15, 0.15]
    label = np.full((2, 4, 5), -1.0, np.float32)
    label[0, 0] = box
    label[1, 3] = box  # the last row: nothing writes after it
    cls_pred = np.random.RandomState(2).randn(
        2, 4, anchors.shape[1]).astype(np.float32)
    for attrs in TARGET_ATTRS[:2]:
        _, jm, jc = _check_target(attrs, anchors, label, cls_pred)
        assert jc[0, 0] != 3.0 and jm[0, :4].sum() == 0
        assert jc[1, 0] == 3.0 and jm[1, :4].sum() == 4


def test_multibox_target_two_boxes_sharing_a_best_anchor():
    """Two valid boxes whose best anchor is the same: the later row's
    forced match wins that anchor."""
    anchors = _anchors(4, 4, sizes=(0.3,), ratios=(1.0,))
    a = anchors[0, 5]
    label = np.full((1, 3, 5), -1.0, np.float32)
    label[0, 0] = [0.0, a[0] + 0.01, a[1], a[2] + 0.02, a[3]]
    label[0, 1] = [1.0, a[0], a[1] + 0.02, a[2], a[3] + 0.03]
    cls_pred = np.random.RandomState(3).randn(
        1, 3, anchors.shape[1]).astype(np.float32)
    for attrs in TARGET_ATTRS:
        _, _, jc = _check_target(attrs, anchors, label, cls_pred)
        assert jc[0, 5] == 2.0


@pytest.mark.parametrize("attrs", TARGET_ATTRS[1:])
def test_multibox_target_hard_negatives_with_tied_scores(attrs):
    """Negatives ranked by tied scores (a few distinct values): among
    equal scores the lower anchor index is mined first."""
    rng = np.random.RandomState(5)
    anchors = _anchors()
    a = anchors.shape[1]
    label = _labels(rng, 3, 4)
    cls_pred = rng.randint(0, 3, (3, 4, a)).astype(np.float32)
    _, _, jc = _check_target(attrs, anchors, label, cls_pred)
    assert (jc == -1).sum() > 0


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


DETECT_ATTRS = [
    {},
    {"nms_threshold": 0.45, "nms_topk": 20, "threshold": 0.2},
    {"nms_threshold": 0.3, "force_suppress": True, "clip": False,
     "variances": (0.2, 0.2, 0.3, 0.3)},
    {"nms_topk": 1000, "threshold": 0.0},
]


def _check_detection(attrs, cls_prob, loc_pred, anchors):
    (j,), (t,) = _both("_contrib_MultiBoxDetection", attrs,
                       [cls_prob, loc_pred, anchors])
    np.testing.assert_array_equal(t[..., 0], j[..., 0], err_msg="ids")
    np.testing.assert_array_equal(t[..., 1], j[..., 1], err_msg="scores")
    _close(t[..., 2:], j[..., 2:], "boxes")
    return j


@pytest.mark.parametrize("attrs", DETECT_ATTRS)
@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_detection_matches_jax(attrs, seed):
    rng = np.random.RandomState(seed)
    anchors = _anchors()
    a = anchors.shape[1]
    cls_prob = _softmax(rng.randn(3, 4, a).astype(np.float32) * 2, 1)
    loc_pred = (rng.randn(3, a * 4) * 0.5).astype(np.float32)
    j = _check_detection(attrs, cls_prob, loc_pred, anchors)
    kept = j[..., 0] >= 0
    assert kept.sum() > 0 and (~kept).sum() > 0


def test_multibox_detection_nms_over_tied_scores():
    """Scores from a few distinct values, boxes that overlap: NMS visits
    equal scores lower index first, as ``argsort(-scores)`` does."""
    rng = np.random.RandomState(7)
    anchors = _anchors(3, 3, sizes=(0.5, 0.6))
    a = anchors.shape[1]
    levels = np.array([0.1, 0.3, 0.6], np.float32)
    cls_prob = np.zeros((2, 3, a), np.float32)
    cls_prob[:, 1] = levels[rng.randint(0, 3, (2, a))]
    cls_prob[:, 2] = levels[rng.randint(0, 3, (2, a))]
    cls_prob[:, 0] = 1.0 - cls_prob[:, 1:].max(axis=1)
    loc_pred = np.zeros((2, a * 4), np.float32)
    for attrs in ({"nms_threshold": 0.3}, {"nms_threshold": 0.3,
                                           "force_suppress": True,
                                           "nms_topk": 5}):
        j = _check_detection(attrs, cls_prob, loc_pred, anchors)
        assert (j[..., 0] == -1).sum() > 0


# ---------------------------------------------------------------------------
# Proposal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attrs", [
    {"rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 10, "rpn_min_size": 4,
     "feature_stride": 8, "scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0)},
    {"rpn_pre_nms_top_n": 200, "rpn_post_nms_top_n": 30, "threshold": 0.5,
     "rpn_min_size": 2, "feature_stride": 4, "scales": (1.0, 3.0),
     "ratios": (1.0,), "output_score": False, "iou_loss": False},
])
def test_proposal_matches_jax(attrs):
    rng = np.random.RandomState(3)
    k = len(attrs["scales"]) * len(attrs["ratios"])
    n, h, w = 2, 5, 6
    stride = attrs["feature_stride"]
    logits = rng.randn(n, 2 * k, h, w).astype(np.float32)
    cls_prob = np.concatenate([1 / (1 + np.exp(logits[:, k:])),
                               1 / (1 + np.exp(-logits[:, k:]))], 1)
    bbox_pred = (rng.randn(n, 4 * k, h, w) * 0.2).astype(np.float32)
    im_info = np.array([[h * stride, w * stride, 1.0],
                        [h * stride - 5, w * stride - 3, 0.8]], np.float32)
    (j,), (t,) = _both("_contrib_Proposal", attrs,
                       [cls_prob.astype(np.float32), bbox_pred, im_info])
    assert t.shape == (n * attrs["rpn_post_nms_top_n"], 5)
    _close(t, j, "proposals")


@pytest.mark.parametrize("name", [
    "_contrib_fft", "_contrib_ifft", "_contrib_count_sketch",
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_MultiBoxDetection", "_contrib_Proposal"])
def test_contrib_op_surface_matches_jax(name):
    jop, op = jget_op(name), get_op(name)
    assert (op.name, op.hint, op.stochastic, op.no_grad_inputs) == \
        (jop.name, jop.hint, jop.stochastic, jop.no_grad_inputs)
    assert list(op.params) == list(jop.params)
    for key, p in op.params.items():
        jp = jop.params[key]
        assert (p.typ, p.default, p.required, p.enum) == \
            (jp.typ, jp.default, jp.required, jp.enum), (name, key)
    attrs = {k: 2 for k, p in op.params.items() if p.required}
    pa, ja = op.parse_attrs(attrs), jop.parse_attrs(attrs)
    assert op.input_names(pa) == jop.input_names(ja)
    assert op.output_names(pa, "n") == jop.output_names(ja, "n")
    assert op.num_outputs(pa) == jop.num_outputs(ja)


def test_nms_block_boundary_changes_nothing():
    """The NMS rounds run in blocks of ``NMS_BLOCK`` (one overlap pass a
    block): any block size gives the same keeps."""
    from mxnet_tpu_torch.ops import contrib_ops

    rng = np.random.RandomState(11)
    anchors = _anchors(5, 5, sizes=(0.4, 0.5))
    a = anchors.shape[1]
    cls_prob = _softmax(rng.randn(2, 3, a).astype(np.float32) * 2, 1)
    loc_pred = (rng.randn(2, a * 4) * 0.3).astype(np.float32)
    op = get_op("_contrib_MultiBoxDetection")
    attrs = op.parse_attrs({"nms_topk": 60, "threshold": 0.0})
    outs = []
    for block in (64, 7, 1):
        old, contrib_ops.NMS_BLOCK = contrib_ops.NMS_BLOCK, block
        try:
            (o,), _ = op.apply(OpContext(), attrs, [
                torch.from_numpy(x) for x in (cls_prob, loc_pred, anchors)])
        finally:
            contrib_ops.NMS_BLOCK = old
        outs.append(o)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
