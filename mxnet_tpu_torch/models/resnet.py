"""ResNet v1 (depths 18, 34, 50, 101, 152; a cifar stem for images of 64 px or
less, else the 7x7/2 convolution and a 3x3/2 max pool) symbol builder, the
counterpart of ``mxnet_tpu/models/resnet.py``.  The graph is built from the
same ops with the same names in the same order, so under a fresh
``NameManager`` its JSON is byte-identical to the JAX package's and one
checkpoint serves both.
"""

from .. import symbol as sym


def _conv_bn_act(data, num_filter, kernel, stride, pad, name, act=True):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad, no_bias=True,
                          name=name + "_conv")
    net = sym.BatchNorm(data=net, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name=name + "_bn")
    if act:
        net = sym.Activation(data=net, act_type="relu", name=name + "_relu")
    return net


def _bottleneck(data, num_filter, stride, dim_match, name):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut when shapes
    change (resnet-50/101/152 unit)."""
    net = _conv_bn_act(data, num_filter // 4, (1, 1), (1, 1), (0, 0),
                       name + "_a")
    net = _conv_bn_act(net, num_filter // 4, (3, 3), stride, (1, 1),
                       name + "_b")
    net = _conv_bn_act(net, num_filter, (1, 1), (1, 1), (0, 0), name + "_c",
                       act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn_act(data, num_filter, (1, 1), stride, (0, 0),
                                name + "_sc", act=False)
    return sym.Activation(data=net + shortcut, act_type="relu",
                          name=name + "_out")


def _basic(data, num_filter, stride, dim_match, name):
    """3x3 -> 3x3 basic unit (resnet-18/34)."""
    net = _conv_bn_act(data, num_filter, (3, 3), stride, (1, 1), name + "_a")
    net = _conv_bn_act(net, num_filter, (3, 3), (1, 1), (1, 1), name + "_b",
                       act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn_act(data, num_filter, (1, 1), stride, (0, 0),
                                name + "_sc", act=False)
    return sym.Activation(data=net + shortcut, act_type="relu",
                          name=name + "_out")


_DEPTH_CONFIGS = {
    18: ([2, 2, 2, 2], [64, 128, 256, 512], _basic),
    34: ([3, 4, 6, 3], [64, 128, 256, 512], _basic),
    50: ([3, 4, 6, 3], [256, 512, 1024, 2048], _bottleneck),
    101: ([3, 4, 23, 3], [256, 512, 1024, 2048], _bottleneck),
    152: ([3, 8, 36, 3], [256, 512, 1024, 2048], _bottleneck),
}


def get_resnet(num_classes=1000, num_layers=50, image_shape=(3, 224, 224)):
    if num_layers not in _DEPTH_CONFIGS:
        raise ValueError("resnet depth must be one of %s"
                         % sorted(_DEPTH_CONFIGS))
    units, filters, block = _DEPTH_CONFIGS[num_layers]

    data = sym.Variable("data")
    small_image = image_shape[-1] <= 64
    if small_image:  # cifar-style stem
        net = _conv_bn_act(data, 64, (3, 3), (1, 1), (1, 1), "stem")
    else:  # imagenet stem: 7x7/2 + 3x3/2 maxpool
        net = _conv_bn_act(data, 64, (7, 7), (2, 2), (3, 3), "stem")
        net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3),
                          stride=(2, 2), pad=(1, 1), name="stem_pool")

    for stage, (n_units, n_filter) in enumerate(zip(units, filters)):
        for unit in range(n_units):
            stride = (1, 1) if stage == 0 or unit > 0 else (2, 2)
            dim_match = unit > 0
            net = block(net, n_filter, stride, dim_match,
                        "stage%d_unit%d" % (stage + 1, unit + 1))

    net = sym.Pooling(data=net, global_pool=True, pool_type="avg",
                      kernel=(7, 7), name="global_pool")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
