"""Inception-BN (v2) symbol builder, the counterpart of
``mxnet_tpu/models/inception_bn.py``.  The graph is built from the same ops
with the same names in the same order, so under a fresh ``NameManager`` its
JSON is byte-identical to the JAX package's and one checkpoint serves both.
"""

from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=""):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad, no_bias=True,
                          name="conv_%s" % name)
    net = sym.BatchNorm(data=net, fix_gamma=False, name="bn_%s" % name)
    return sym.Activation(data=net, act_type="relu", name="relu_%s" % name)


def _inception_a(data, n1, n3r, n3, d3r, d3, pool, proj, name):
    c1 = _conv_factory(data, n1, (1, 1), name="%s_1x1" % name)
    c3 = _conv_factory(data, n3r, (1, 1), name="%s_3x3r" % name)
    c3 = _conv_factory(c3, n3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    cd = _conv_factory(data, d3r, (1, 1), name="%s_d3x3r" % name)
    cd = _conv_factory(cd, d3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    cd = _conv_factory(cd, d3, (3, 3), pad=(1, 1), name="%s_d3x3b" % name)
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name="%s_pool" % name)
    p = _conv_factory(p, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1, c3, cd, p, name="ch_concat_%s" % name)


def _inception_b(data, n3r, n3, d3r, d3, name):
    c3 = _conv_factory(data, n3r, (1, 1), name="%s_3x3r" % name)
    c3 = _conv_factory(c3, n3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_3x3" % name)
    cd = _conv_factory(data, d3r, (1, 1), name="%s_d3x3r" % name)
    cd = _conv_factory(cd, d3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    cd = _conv_factory(cd, d3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_d3x3b" % name)
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max", name="%s_pool" % name)
    return sym.Concat(c3, cd, p, name="ch_concat_%s" % name)


def get_inception_bn(num_classes=1000):
    data = sym.Variable("data")
    net = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _conv_factory(net, 64, (1, 1), name="2_red")
    net = _conv_factory(net, 192, (3, 3), pad=(1, 1), name="2")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _inception_a(net, 64, 64, 64, 64, 96, "avg", 32, "3a")
    net = _inception_a(net, 64, 64, 96, 64, 96, "avg", 64, "3b")
    net = _inception_b(net, 128, 160, 64, 96, "3c")
    net = _inception_a(net, 224, 64, 96, 96, 128, "avg", 128, "4a")
    net = _inception_a(net, 192, 96, 128, 96, 128, "avg", 128, "4b")
    net = _inception_a(net, 160, 128, 160, 128, 160, "avg", 128, "4c")
    net = _inception_a(net, 96, 128, 192, 160, 192, "avg", 128, "4d")
    net = _inception_b(net, 128, 192, 192, 256, "4e")
    net = _inception_a(net, 352, 192, 320, 160, 224, "avg", 128, "5a")
    net = _inception_a(net, 352, 192, 320, 192, 224, "max", 128, "5b")
    net = sym.Pooling(data=net, global_pool=True, pool_type="avg",
                      kernel=(7, 7), name="global_pool")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
