"""Contrib ops: FFT/IFFT, CountSketch, and the SSD / Faster-RCNN detection
ops (``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget``,
``_contrib_MultiBoxDetection``, ``_contrib_Proposal``).

Counterparts of ``mxnet_tpu/ops/contrib_ops.py``, with the same names,
parameters, outputs and shape inference.  Where the JAX package maps a
per-sample function over the batch with ``vmap``, these ops are written
over the whole batch.  Plain torch throughout, as the JAX package leaves
all of it to XLA.

Discrete results follow the JAX package exactly:

* ``MultiBoxTarget``'s forced matches write through indices that repeat (a
  padded label row's best anchor is anchor 0; two boxes may share one).
  XLA's scatter applies the updates in order, so the last row wins; here
  each anchor takes the largest row index that names it
  (``scatter_reduce(amax)``), the same answer, and deterministic on the
  card, where an indexed write with repeated indices is not.
* Every ranking (hard negatives, the NMS order, Proposal's top boxes) is a
  stable sort of the negated scores, as ``jnp.argsort(-score)`` is: among
  equal scores the lower index comes first.
* NMS visits the ``k = min(nms_topk, A)`` best boxes in order, one round
  each, on the device: no ``.item()`` and no host sync inside a round.  The
  overlaps of a block of rounds' boxes with every box are computed in one
  pass; each round then only masks.

The detection ops take no gradient (every input is in ``no_grad_inputs``,
and anchors and labels carry none in the graphs that use them): they run
under ``torch.no_grad()``, inside a ``torch.profiler`` range of the op's
name, which a trace shows on the device timeline (``_detecting``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .param import Param
from .registry import register

# ---------------------------------------------------------------------------
# FFT / IFFT: the last axis, complex values packed as (real, imag) pairs
# ---------------------------------------------------------------------------


@register("_contrib_fft", params={"compute_size": Param(int, 128)},
          infer_shape=lambda attrs, s: (
              s, [tuple(s[0][:-1]) + (s[0][-1] * 2,)] if s[0] else [None],
              []),
          hint="fft")
def _fft(opctx, attrs, x):
    """The DFT of the last axis, in float32; the output interleaves real
    and imaginary parts, doubling that axis."""
    out = torch.fft.fft(x.to(torch.float32), dim=-1)
    packed = torch.stack([out.real, out.imag], dim=-1)
    return packed.reshape(x.shape[:-1] + (x.shape[-1] * 2,)).to(x.dtype)


@register("_contrib_ifft", params={"compute_size": Param(int, 128)},
          infer_shape=lambda attrs, s: (
              s, [tuple(s[0][:-1]) + (s[0][-1] // 2,)] if s[0] else [None],
              []),
          hint="ifft")
def _ifft(opctx, attrs, x):
    """The unnormalized inverse DFT (cuFFT's: n times numpy's) of
    interleaved (real, imag) pairs; its real part."""
    n = x.shape[-1] // 2
    pairs = x.reshape(x.shape[:-1] + (n, 2)).to(torch.float32)
    out = torch.fft.ifft(torch.complex(pairs[..., 0], pairs[..., 1]), dim=-1)
    return (out.real * n).to(x.dtype)


@register("_contrib_count_sketch", inputs=("data", "h", "s"),
          params={"out_dim": Param(int, required=True),
                  "processing_batch_size": Param(int, 32)},
          no_grad_inputs=("h", "s"),
          infer_shape=lambda attrs, shapes: (
              shapes, [(shapes[0][0], attrs["out_dim"]) if shapes[0]
                       else None], []),
          hint="count_sketch")
def _count_sketch(opctx, attrs, data, h, s):
    """out[n, h[i]] += s[i] · data[n, i] (count_sketch-inl.h)."""
    idx = h.reshape(-1).to(torch.int64)
    vals = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], attrs["out_dim"]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, vals)


# ---------------------------------------------------------------------------
# Box utilities shared by the detection ops
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _detecting(name):
    """No gradient, and a profiler range named after the op."""
    with torch.no_grad(), torch.profiler.record_function(name):
        yield


def _iou(a, b):
    """IoU between corner boxes a (..., 4) and b (..., 4), broadcasting;
    the JAX package's arithmetic, term for term."""
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) -
                     torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) -
                     torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _descending(scores):
    """Positions ranked by descending score along the last axis, stable:
    ``jnp.argsort(-scores)``."""
    return torch.sort(-scores, dim=-1, stable=True).indices


#: NMS rounds whose overlaps are computed in one pass (bounds the
#: (N, block, A) temporaries: 64 rounds of 32 x 29,272 boxes is 240 MB)
NMS_BLOCK = 64


def _nms_keep(boxes, scores, ids, valid, nms_thresh, force_suppress, topk):
    """Greedy NMS over a batch: boxes (N, A, 4), scores, ids (N, A), valid
    (N, A) bool.  Rounds i = 0 .. k-1 (k = min(topk, A), A when topk <=
    0) visit the i-th best box; if it is still kept and valid, it
    suppresses every later-ranked box of its class (any class with
    ``force_suppress``) that overlaps it by more than ``nms_thresh``.
    Returns the keep mask (N, A): the JAX package's ``_nms_suppress``
    mapped over the batch."""
    n, a = scores.shape
    k = min(topk if topk > 0 else a, a)
    order = _descending(scores)
    sboxes = torch.gather(boxes, 1, order.unsqueeze(-1).expand(n, a, 4))
    sids = torch.gather(ids, 1, order)
    svalid = torch.gather(valid, 1, order)
    keep = torch.ones((n, a), dtype=torch.bool, device=scores.device)
    for lo in range(0, k, NMS_BLOCK):
        hi = min(lo + NMS_BLOCK, k)
        head = sboxes[:, lo:hi]  # the block's boxes, ranks lo .. hi-1
        overlap = _iou(head.unsqueeze(2), sboxes[:, lo:].unsqueeze(1)) \
            > nms_thresh  # (n, hi - lo, a - lo)
        if not force_suppress:
            overlap &= sids[:, lo:hi].unsqueeze(2) == \
                sids[:, lo:].unsqueeze(1)
        overlap &= svalid[:, lo:hi].unsqueeze(2)
        for i in range(lo, hi):
            hit = overlap[:, i - lo, i + 1 - lo:] & keep[:, i:i + 1]
            keep[:, i + 1:] &= ~hit
    out = torch.empty_like(keep)
    return out.scatter_(1, order, keep)


# ---------------------------------------------------------------------------
# MultiBoxPrior: anchor generation (multibox_prior-inl.h)
# ---------------------------------------------------------------------------


def _mbp_num_anchors(attrs):
    return len(attrs.get("sizes", (1.0,))) + \
        len(attrs.get("ratios", (1.0,))) - 1


def _mbp_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    na = _mbp_num_anchors(attrs)
    return in_shapes, [(1, d[2] * d[3] * na, 4)], []


@register("_contrib_MultiBoxPrior",
          params={"sizes": Param("float-shape", (1.0,)),
                  "ratios": Param("float-shape", (1.0,)),
                  "clip": Param(bool, False),
                  "steps": Param("float-shape", (-1.0, -1.0)),
                  "offsets": Param("float-shape", (0.5, 0.5))},
          infer_shape=_mbp_infer, no_grad_inputs=("data",),
          hint="multibox_prior")
def _multibox_prior(opctx, attrs, data):
    """Anchors (1, H·W·n, 4) as corner boxes in [0, 1] units: at each
    feature-map cell's centre ((i + offset) / extent), one box per ratio
    at the first size, then one per further size at the first ratio; half
    widths size·sqrt(ratio)/2, half heights size/sqrt(ratio)/2 (float64
    on the host, rounded to float32, as the JAX op's constants are).
    ``steps`` is taken and ignored, as in the JAX op."""
    sizes = tuple(attrs.get("sizes") or (1.0,))
    ratios = tuple(attrs.get("ratios") or (1.0,))
    offy, offx = tuple(attrs.get("offsets") or (0.5, 0.5))
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    cy = (torch.arange(h, device=dev, dtype=torch.float32) + offy) / h
    cx = (torch.arange(w, device=dev, dtype=torch.float32) + offx) / w
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")  # (H, W)
    whs = [(sizes[0] * np.sqrt(r) / 2.0, sizes[0] / np.sqrt(r) / 2.0)
           for r in ratios]
    whs += [(s * np.sqrt(ratios[0]) / 2.0, s / np.sqrt(ratios[0]) / 2.0)
            for s in sizes[1:]]
    half = torch.tensor(whs, dtype=torch.float32, device=dev)  # (n, 2)
    hw, hh = half[:, 0], half[:, 1]
    gx, gy = gx.unsqueeze(-1), gy.unsqueeze(-1)  # (H, W, 1)
    out = torch.stack([gx - hw, gy - hh, gx + hw, gy + hh], dim=-1)
    out = out.reshape(1, -1, 4)  # (1, H*W*n, 4)
    if attrs.get("clip"):
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# MultiBoxTarget: anchor/GT matching and target encoding
# (multibox_target-inl.h)
# ---------------------------------------------------------------------------


def _mbt_infer(attrs, in_shapes):
    anchor, label, cls = in_shapes
    if anchor is None or label is None:
        return in_shapes, [None, None, None], []
    a = anchor[1]
    n = label[0]
    return in_shapes, [(n, a * 4), (n, a * 4), (n, a)], []


def _match(anchors, label):
    """Each anchor's ground truth over a batch of labels (N, O, 5), rows
    [class, xmin, ymin, xmax, ymax], padded with class -1: (positive
    mask (N, A), its row per anchor (N, A)), with the IoU threshold still
    to apply.  Each valid row forces a match at its best anchor; where
    rows share an anchor (padded rows' best is anchor 0) the last row
    wins, as the JAX package's ordered scatter writes."""
    n, o = label.shape[:2]
    a = anchors.shape[0]
    valid = label[:, :, 0] >= 0  # (N, O)
    ious = _iou(anchors[None, :, None, :], label[:, None, :, 1:5])
    ious = torch.where(valid[:, None, :], ious,
                       torch.tensor(-1.0, dtype=ious.dtype,
                                    device=ious.device))  # (N, A, O)
    best_iou, best_gt = torch.max(ious, dim=2)  # first maximum
    best_anchor = torch.argmax(ious, dim=1)  # (N, O), first maximum
    rows = torch.arange(o, device=label.device).expand(n, o)
    winner = torch.full((n, a), -1, dtype=torch.int64, device=label.device)
    winner = winner.scatter_reduce(1, best_anchor, rows, reduce="amax")
    named = winner >= 0
    forced_gt = torch.where(named, winner, 0)
    forced = named & torch.gather(valid, 1, forced_gt)
    gt_idx = torch.where(forced, forced_gt, best_gt)
    return forced, best_iou, gt_idx


@register("_contrib_MultiBoxTarget", inputs=("anchor", "label", "cls_pred"),
          params={"overlap_threshold": Param(float, 0.5),
                  "ignore_label": Param(float, -1.0),
                  "negative_mining_ratio": Param(float, -1.0),
                  "negative_mining_thresh": Param(float, 0.5),
                  "minimum_negative_samples": Param(int, 0),
                  "variances": Param("float-shape", (0.1, 0.1, 0.2, 0.2))},
          num_outputs=3, infer_shape=_mbt_infer,
          no_grad_inputs=("anchor", "label", "cls_pred"),
          output_names=lambda attrs: ["loc_target", "loc_mask", "cls_target"],
          hint="multibox_target")
def _multibox_target(opctx, attrs, anchor, label, cls_pred):
    """(loc_target (N, A·4), loc_mask (N, A·4), cls_target (N, A)).  An
    anchor is positive if forced or its best IoU reaches
    ``overlap_threshold``; its loc target is its box encoded against the
    anchor with ``variances``, its class target class + 1; the rest are
    background (0).  With ``negative_mining_ratio`` > 0 only the
    max(ratio·positives, ``minimum_negative_samples``) negatives with the
    highest non-background ``cls_pred`` stay background, the rest -1
    (ignored)."""
    with _detecting("_contrib_MultiBoxTarget"):
        return _multibox_target_impl(attrs, anchor, label, cls_pred)


def _multibox_target_impl(attrs, anchor, label, cls_pred):
    v0, v1, v2, v3 = tuple(attrs.get("variances") or (0.1, 0.1, 0.2, 0.2))
    anchors = anchor.reshape(-1, 4)  # (A, 4)
    n, a = label.shape[0], anchors.shape[0]
    forced, best_iou, gt_idx = _match(anchors, label)
    pos = forced | (best_iou >= attrs.get("overlap_threshold", 0.5))
    gt = torch.gather(label, 1, gt_idx.unsqueeze(-1).expand(n, a, 5))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = gt[..., 3] - gt[..., 1]
    gh = gt[..., 4] - gt[..., 2]
    gcx = (gt[..., 1] + gt[..., 3]) / 2
    gcy = (gt[..., 2] + gt[..., 4]) / 2
    aw_, ah_ = torch.clamp(aw, min=1e-12), torch.clamp(ah, min=1e-12)
    tx = (gcx - acx) / aw_ / v0
    ty = (gcy - acy) / ah_ / v1
    tw = torch.log(torch.clamp(gw / aw_, min=1e-12)) / v2
    th = torch.log(torch.clamp(gh / ah_, min=1e-12)) / v3
    posf = pos.to(anchors.dtype)
    loc_t = torch.stack([tx, ty, tw, th], dim=-1) * posf.unsqueeze(-1)
    loc_m = posf.unsqueeze(-1).expand(n, a, 4)
    zero = torch.zeros((), dtype=label.dtype, device=label.device)
    cls_t = torch.where(pos, gt[..., 0] + 1.0, zero)
    mining = attrs.get("negative_mining_ratio", -1.0)
    if mining is not None and mining > 0:
        # hard negatives: ranked by their best non-background prediction
        neg_score = torch.amax(cls_pred[:, 1:, :], dim=1)  # (N, A)
        neg_score = torch.where(pos, torch.tensor(
            -np.inf, dtype=neg_score.dtype, device=neg_score.device),
            neg_score)
        num_pos = pos.sum(dim=1, dtype=torch.int32)
        # (num_pos * ratio) in float32, truncated, as the JAX op computes
        wanted = (num_pos.to(torch.float32) * mining).to(torch.int32)
        k = torch.clamp(torch.clamp(
            wanted, min=attrs.get("minimum_negative_samples", 0)), max=a)
        order = _descending(neg_score)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a, device=order.device).expand(n, a))
        keep_neg = rank < k.unsqueeze(1)
        cls_t = torch.where(pos, cls_t, torch.where(keep_neg, zero,
                                                    zero - 1.0))
    return loc_t.reshape(n, -1), loc_m.reshape(n, -1), cls_t


# ---------------------------------------------------------------------------
# MultiBoxDetection: decode and per-class NMS (multibox_detection-inl.h)
# ---------------------------------------------------------------------------


def _mbd_infer(attrs, in_shapes):
    cls = in_shapes[0]
    if cls is None:
        return in_shapes, [None], []
    return in_shapes, [(cls[0], cls[2], 6)], []


@register("_contrib_MultiBoxDetection",
          inputs=("cls_prob", "loc_pred", "anchor"),
          params={"clip": Param(bool, True), "threshold": Param(float, 0.01),
                  "background_id": Param(int, 0),
                  "nms_threshold": Param(float, 0.5),
                  "force_suppress": Param(bool, False),
                  "variances": Param("float-shape", (0.1, 0.1, 0.2, 0.2)),
                  "nms_topk": Param(int, -1)},
          infer_shape=_mbd_infer,
          no_grad_inputs=("cls_prob", "loc_pred", "anchor"),
          hint="multibox_detection")
def _multibox_detection(opctx, attrs, cls_prob, loc_pred, anchor):
    """Rows [class id, score, xmin, ymin, xmax, ymax] (N, A, 6): each
    anchor's box decoded from ``loc_pred`` with ``variances`` (clipped to
    [0, 1] with ``clip``), its best non-background class and probability;
    the id is -1 where the score is at most ``threshold`` or NMS
    suppressed the box.  Class 0 is the background, whatever
    ``background_id`` says, as in the JAX op."""
    with _detecting("_contrib_MultiBoxDetection"):
        return _multibox_detection_impl(attrs, cls_prob, loc_pred, anchor)


def _decode(attrs, loc_pred, anchors):
    v0, v1, v2, v3 = tuple(attrs.get("variances") or (0.1, 0.1, 0.2, 0.2))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    d = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    cx = d[..., 0] * v0 * aw + acx
    cy = d[..., 1] * v1 * ah + acy
    w_ = torch.exp(d[..., 2] * v2) * aw / 2
    h_ = torch.exp(d[..., 3] * v3) * ah / 2
    boxes = torch.stack([cx - w_, cy - h_, cx + w_, cy + h_], dim=-1)
    if attrs.get("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _multibox_detection_impl(attrs, cls_prob, loc_pred, anchor):
    anchors = anchor.reshape(-1, 4)
    boxes = _decode(attrs, loc_pred, anchors)  # (N, A, 4)
    scores, ids = torch.max(cls_prob[:, 1:, :], dim=1)  # first maximum
    ids = ids.to(torch.float32)
    valid = scores > attrs.get("threshold", 0.01)
    if cls_prob.device.type == "meta":
        keep = valid
    else:
        keep = _nms_keep(boxes, scores, ids, valid,
                         attrs.get("nms_threshold", 0.5),
                         bool(attrs.get("force_suppress", False)),
                         int(attrs.get("nms_topk", -1)))
    out_ids = torch.where(valid & keep, ids, torch.tensor(
        -1.0, dtype=ids.dtype, device=ids.device))
    return torch.cat([out_ids.unsqueeze(-1).to(scores.dtype),
                      scores.unsqueeze(-1), boxes], dim=-1)


# ---------------------------------------------------------------------------
# Proposal: RPN proposal generation (proposal-inl.h)
# ---------------------------------------------------------------------------


def _proposal_infer(attrs, in_shapes):
    cls = in_shapes[0]
    if cls is None:
        return in_shapes, [None], []
    n = attrs.get("rpn_post_nms_top_n", 300)
    return in_shapes, [(cls[0] * n, 5)], []


def _base_anchors(stride, ratios, scales):
    """The (K, 4) anchors of one cell, ratio-major, in float64."""
    base = stride
    anchors = []
    for r in ratios:
        for s in scales:
            ws = np.sqrt(base * base / r)
            hs = ws * r
            w_, h_ = ws * s, hs * s
            c = (base - 1) / 2.0
            anchors.append([c - (w_ - 1) / 2, c - (h_ - 1) / 2,
                            c + (w_ - 1) / 2, c + (h_ - 1) / 2])
    return np.array(anchors)


@register("_contrib_Proposal", inputs=("cls_prob", "bbox_pred", "im_info"),
          params={"rpn_pre_nms_top_n": Param(int, 6000),
                  "rpn_post_nms_top_n": Param(int, 300),
                  "threshold": Param(float, 0.7),
                  "rpn_min_size": Param(int, 16),
                  "scales": Param("float-shape", (4, 8, 16, 32)),
                  "ratios": Param("float-shape", (0.5, 1, 2)),
                  "feature_stride": Param(int, 16),
                  "output_score": Param(bool, False),
                  "iou_loss": Param(bool, False)},
          infer_shape=_proposal_infer,
          no_grad_inputs=("cls_prob", "bbox_pred", "im_info"),
          hint="proposal")
def _proposal(opctx, attrs, cls_prob, bbox_pred, im_info):
    """Region proposals (N·post_n, 5), rows [0, x0, y0, x1, y1]: every
    cell's anchors shifted over the feature map, decoded by ``bbox_pred``,
    clipped to the image, boxes under ``rpn_min_size``·scale dropped, NMS
    at ``threshold`` over every class at once among the
    ``rpn_pre_nms_top_n`` best, then the ``rpn_post_nms_top_n`` best
    kept."""
    with _detecting("_contrib_Proposal"):
        return _proposal_impl(attrs, cls_prob, bbox_pred, im_info)


def _proposal_impl(attrs, cls_prob, bbox_pred, im_info):
    scales = tuple(attrs.get("scales") or (4.0, 8.0, 16.0, 32.0))
    ratios = tuple(attrs.get("ratios") or (0.5, 1.0, 2.0))
    stride = attrs.get("feature_stride", 16)
    n, _, fh, fw = cls_prob.shape
    dev, dtype = cls_prob.device, cls_prob.dtype
    base = torch.tensor(_base_anchors(stride, ratios, scales), dtype=dtype,
                        device=dev)  # (K, 4)
    k = base.shape[0]
    sy = torch.arange(fh, device=dev) * stride
    sx = torch.arange(fw, device=dev) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], dim=-1).reshape(-1, 1, 4)
    anchors = (base[None, :, :] + shifts.to(dtype)).reshape(-1, 4)
    a = anchors.shape[0]
    post_n = int(attrs.get("rpn_post_nms_top_n", 300))
    # cls_prob (2K, H, W) per sample: K background, then K foreground
    scores = cls_prob[:, k:].permute(0, 2, 3, 1).reshape(n, -1)
    d = bbox_pred.permute(0, 2, 3, 1).reshape(n, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * (aw - 1)
    acy = anchors[:, 1] + 0.5 * (ah - 1)
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w_ = torch.exp(d[..., 2]) * aw
    h_ = torch.exp(d[..., 3]) * ah
    x0, y0 = cx - 0.5 * (w_ - 1), cy - 0.5 * (h_ - 1)
    x1, y1 = cx + 0.5 * (w_ - 1), cy + 0.5 * (h_ - 1)
    imh, imw = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros((), dtype=dtype, device=dev)
    boxes = torch.stack([torch.clamp(x0, zero, imw - 1),
                         torch.clamp(y0, zero, imh - 1),
                         torch.clamp(x1, zero, imw - 1),
                         torch.clamp(y1, zero, imh - 1)], dim=-1)
    min_size = attrs.get("rpn_min_size", 16) * im_info[:, 2:3]
    keep_size = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
    ninf = torch.tensor(-np.inf, dtype=dtype, device=dev)
    scores_f = torch.where(keep_size, scores, ninf)
    if dev.type == "meta":
        keep = keep_size
    else:
        keep = _nms_keep(boxes, scores_f,
                         torch.zeros((n, a), dtype=torch.float32, device=dev),
                         keep_size, attrs.get("threshold", 0.7), True,
                         int(attrs.get("rpn_pre_nms_top_n", 6000)))
    final = torch.where(keep, scores_f, ninf)
    top = _descending(final)[:, :post_n]
    sel = torch.gather(boxes, 1, top.unsqueeze(-1).expand(
        n, top.shape[1], 4))
    out = torch.cat([torch.zeros(sel.shape[:2] + (1,), dtype=sel.dtype,
                                 device=dev), sel], dim=-1)
    return out.reshape(-1, 5)
