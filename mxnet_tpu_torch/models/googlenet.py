"""GoogLeNet / Inception-v1 symbol builder, the counterpart of
``mxnet_tpu/models/googlenet.py``.  The graph is built from the same ops
with the same names in the same order, so under a fresh ``NameManager`` its
JSON is byte-identical to the JAX package's and one checkpoint serves both.
"""

from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="%s_conv" % name)
    return sym.Activation(c, act_type="relu", name="%s_relu" % name)


def _inception(data, f1, f3r, f3, f5r, f5, proj, name):
    b1 = _conv(data, f1, (1, 1), name="%s_1x1" % name)
    b3 = _conv(data, f3r, (1, 1), name="%s_3x3r" % name)
    b3 = _conv(b3, f3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    b5 = _conv(data, f5r, (1, 1), name="%s_5x5r" % name)
    b5 = _conv(b5, f5, (5, 5), pad=(2, 2), name="%s_5x5" % name)
    bp = sym.Pooling(data, pool_type="max", kernel=(3, 3), stride=(1, 1),
                     pad=(1, 1), name="%s_pool" % name)
    bp = _conv(bp, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b3, b5, bp, dim=1, name="%s_out" % name)


def get_googlenet(num_classes=1000):
    net = sym.Variable("data")
    net = _conv(net, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="stem1")
    net = sym.Pooling(net, pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="pool1")
    net = _conv(net, 64, (1, 1), name="stem2r")
    net = _conv(net, 192, (3, 3), pad=(1, 1), name="stem2")
    net = sym.Pooling(net, pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="pool2")
    net = _inception(net, 64, 96, 128, 16, 32, 32, "in3a")
    net = _inception(net, 128, 128, 192, 32, 96, 64, "in3b")
    net = sym.Pooling(net, pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="pool3")
    net = _inception(net, 192, 96, 208, 16, 48, 64, "in4a")
    net = _inception(net, 160, 112, 224, 24, 64, 64, "in4b")
    net = _inception(net, 128, 128, 256, 24, 64, 64, "in4c")
    net = _inception(net, 112, 144, 288, 32, 64, 64, "in4d")
    net = _inception(net, 256, 160, 320, 32, 128, 128, "in4e")
    net = sym.Pooling(net, pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="pool4")
    net = _inception(net, 256, 160, 320, 32, 128, 128, "in5a")
    net = _inception(net, 384, 192, 384, 48, 128, 128, "in5b")
    net = sym.Pooling(net, global_pool=True, pool_type="avg", kernel=(7, 7),
                      name="global_pool")
    net = sym.Dropout(net, p=0.4, name="drop")
    net = sym.FullyConnected(sym.Flatten(net), num_hidden=num_classes,
                             name="fc")
    return sym.SoftmaxOutput(net, name="softmax")
