"""VGG (11, 13, 16, 19 layers; optional BatchNorm) symbol builder, the
counterpart of ``mxnet_tpu/models/vgg.py``.  The graph is built from the
same ops with the same names in the same order, so under a fresh
``NameManager`` its JSON is byte-identical to the JAX package's and one
checkpoint serves both.
"""

from .. import symbol as sym

_CONFIGS = {
    11: ((64,), (128,), (256, 256), (512, 512), (512, 512)),
    13: ((64, 64), (128, 128), (256, 256), (512, 512), (512, 512)),
    16: ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
         (512, 512, 512)),
    19: ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512),
         (512, 512, 512, 512)),
}


def get_vgg(num_classes=1000, num_layers=16, batch_norm=False):
    if num_layers not in _CONFIGS:
        raise ValueError("vgg depth must be one of %s" % sorted(_CONFIGS))
    net = sym.Variable("data")
    for si, widths in enumerate(_CONFIGS[num_layers]):
        for ci, width in enumerate(widths):
            name = "conv%d_%d" % (si + 1, ci + 1)
            net = sym.Convolution(net, num_filter=width, kernel=(3, 3),
                                  pad=(1, 1), name=name)
            if batch_norm:
                net = sym.BatchNorm(net, fix_gamma=False, name=name + "_bn")
            net = sym.Activation(net, act_type="relu", name=name + "_relu")
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2),
                          name="pool%d" % (si + 1))
    net = sym.Flatten(net)
    for i, width in enumerate((4096, 4096)):
        net = sym.FullyConnected(net, num_hidden=width, name="fc%d" % (i + 6))
        net = sym.Activation(net, act_type="relu", name="relu%d" % (i + 6))
        net = sym.Dropout(net, p=0.5, name="drop%d" % (i + 6))
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(net, name="softmax")
