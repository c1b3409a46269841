"""SSD single-shot detector (BASELINE config #4): the counterpart of
``mxnet_tpu/models/ssd.py``, graph JSON byte for byte the same.

The reference SSD graph (example/ssd/symbol/): a body,
multi-scale feature maps, per-scale loc/conf heads with MultiBoxPrior
anchors, MultiBoxTarget matching, then a SoftmaxOutput class loss and a
smooth-L1 loc loss; the detection graph swaps the losses for
MultiBoxDetection's NMS.  The body is the JAX package's compact conv body,
not VGG16_reduced; train and detect graphs share every parameter name.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_ssd_train", "get_ssd_detect", "get_ssd_symbols"]


def _conv_block(data, num_filter, name, stride=(1, 1), pool=True):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=(3, 3),
                          pad=(1, 1), stride=stride, name=name + "_conv")
    net = sym.BatchNorm(data=net, name=name + "_bn")
    net = sym.Activation(data=net, act_type="relu", name=name + "_relu")
    if pool:
        net = sym.Pooling(data=net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max", name=name + "_pool")
    return net


def _multibox_layer(feats, num_classes, sizes, ratios):
    """Per-scale heads; returns (loc_preds, cls_preds, anchors) with the
    reference layouts: loc (b, A*4), cls (b, num_cls+1, A), anchors
    (1, A, 4)."""
    loc_layers = []
    cls_layers = []
    anchor_layers = []
    num_cls_total = num_classes + 1  # background class 0
    for i, feat in enumerate(feats):
        na = len(sizes[i]) + len(ratios[i]) - 1
        loc = sym.Convolution(data=feat, num_filter=na * 4, kernel=(3, 3),
                              pad=(1, 1), name="loc_pred_%d" % i)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(loc))
        cls = sym.Convolution(data=feat, num_filter=na * num_cls_total,
                              kernel=(3, 3), pad=(1, 1),
                              name="cls_pred_%d" % i)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Flatten(cls))
        anchors = sym._contrib_MultiBoxPrior(
            feat, sizes=tuple(sizes[i]), ratios=tuple(ratios[i]),
            name="anchors_%d" % i)
        anchor_layers.append(sym.Reshape(anchors, shape=(0, -1, 4)))
    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(cls_preds, shape=(0, -1, num_cls_total))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")
    anchors = sym.Concat(*anchor_layers, dim=1, name="multibox_anchors")
    return loc_preds, cls_preds, anchors


def _ssd_graph(num_classes, num_filters):
    data = sym.Variable("data")
    # body: three downsampling blocks; heads tap the last three maps
    net = _conv_block(data, num_filters[0], "b1")          # stride 2
    f1 = _conv_block(net, num_filters[1], "b2")            # stride 4
    f2 = _conv_block(f1, num_filters[2], "b3")             # stride 8
    f3 = _conv_block(f2, num_filters[3], "b4")             # stride 16
    feats = [f1, f2, f3]
    sizes = [(0.2, 0.272), (0.37, 0.447), (0.54, 0.619)]
    ratios = [(1.0, 2.0, 0.5)] * 3
    return data, _multibox_layer(feats, num_classes, sizes, ratios)


def get_ssd_train(num_classes=20, num_filters=(16, 32, 64, 64)):
    """Training symbol: outputs [cls_prob, loc_loss, cls_label] (the
    reference example's get_symbol_train)."""
    label = sym.Variable("label")
    _, (loc_preds, cls_preds, anchors) = _ssd_graph(num_classes, num_filters)
    tmp = sym._contrib_MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3.0,
        minimum_negative_samples=0, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    loc_target = tmp[0]
    loc_target_mask = tmp[1]
    cls_target = tmp[2]
    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1.0, use_ignore=True,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0.0,
                             name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def get_ssd_detect(num_classes=20, num_filters=(16, 32, 64, 64),
                   nms_thresh=0.5, force_suppress=False, nms_topk=400):
    """Inference symbol: MultiBoxDetection output (b, A, 6) rows
    [cls_id, score, xmin, ymin, xmax, ymax]."""
    _, (loc_preds, cls_preds, anchors) = _ssd_graph(num_classes, num_filters)
    cls_prob = sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                     name="cls_prob")
    return sym._contrib_MultiBoxDetection(
        cls_prob, loc_preds, anchors, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)


def get_ssd_symbols(num_classes=20, **kwargs):
    return (get_ssd_train(num_classes, **kwargs),
            get_ssd_detect(num_classes, **kwargs))
