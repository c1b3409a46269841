"""Inception-v3 (3x299x299 inputs) symbol builder, the counterpart of
``mxnet_tpu/models/inception_v3.py``.  The graph is built from the same ops
with the same names in the same order, so under a fresh ``NameManager`` its
JSON is byte-identical to the JAX package's and one checkpoint serves both.
"""

from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=""):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad, no_bias=True,
                          name="%s_conv" % name)
    net = sym.BatchNorm(data=net, fix_gamma=True, eps=2e-5,
                        name="%s_bn" % name)
    return sym.Activation(data=net, act_type="relu", name="%s_relu" % name)


def _pool(data, kernel, stride, pad, pool_type, name):
    return sym.Pooling(data=data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


def _block_a(data, pool_proj, name):
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool-proj branches."""
    b1 = _conv(data, 64, name="%s_1x1" % name)
    b5 = _conv(data, 48, name="%s_5x5r" % name)
    b5 = _conv(b5, 64, kernel=(5, 5), pad=(2, 2), name="%s_5x5" % name)
    b3 = _conv(data, 64, name="%s_3x3r" % name)
    b3 = _conv(b3, 96, kernel=(3, 3), pad=(1, 1), name="%s_3x3a" % name)
    b3 = _conv(b3, 96, kernel=(3, 3), pad=(1, 1), name="%s_3x3b" % name)
    bp = _pool(data, (3, 3), (1, 1), (1, 1), "avg", "%s_pool" % name)
    bp = _conv(bp, pool_proj, name="%s_proj" % name)
    return sym.Concat(b1, b5, b3, bp, name="%s_concat" % name)


def _block_b(data, name):
    """Grid reduction 35x35 -> 17x17."""
    b3 = _conv(data, 384, kernel=(3, 3), stride=(2, 2), name="%s_3x3" % name)
    bd = _conv(data, 64, name="%s_d3x3r" % name)
    bd = _conv(bd, 96, kernel=(3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    bd = _conv(bd, 96, kernel=(3, 3), stride=(2, 2), name="%s_d3x3b" % name)
    bp = _pool(data, (3, 3), (2, 2), (0, 0), "max", "%s_pool" % name)
    return sym.Concat(b3, bd, bp, name="%s_concat" % name)


def _block_c(data, c7, name):
    """17x17 block with factorized 7x7 (1x7 then 7x1) branches."""
    b1 = _conv(data, 192, name="%s_1x1" % name)
    b7 = _conv(data, c7, name="%s_7x7r" % name)
    b7 = _conv(b7, c7, kernel=(1, 7), pad=(0, 3), name="%s_7x7a" % name)
    b7 = _conv(b7, 192, kernel=(7, 1), pad=(3, 0), name="%s_7x7b" % name)
    bd = _conv(data, c7, name="%s_d7r" % name)
    bd = _conv(bd, c7, kernel=(7, 1), pad=(3, 0), name="%s_d7a" % name)
    bd = _conv(bd, c7, kernel=(1, 7), pad=(0, 3), name="%s_d7b" % name)
    bd = _conv(bd, c7, kernel=(7, 1), pad=(3, 0), name="%s_d7c" % name)
    bd = _conv(bd, 192, kernel=(1, 7), pad=(0, 3), name="%s_d7d" % name)
    bp = _pool(data, (3, 3), (1, 1), (1, 1), "avg", "%s_pool" % name)
    bp = _conv(bp, 192, name="%s_proj" % name)
    return sym.Concat(b1, b7, bd, bp, name="%s_concat" % name)


def _block_d(data, name):
    """Grid reduction 17x17 -> 8x8."""
    b3 = _conv(data, 192, name="%s_3x3r" % name)
    b3 = _conv(b3, 320, kernel=(3, 3), stride=(2, 2), name="%s_3x3" % name)
    b7 = _conv(data, 192, name="%s_7x7r" % name)
    b7 = _conv(b7, 192, kernel=(1, 7), pad=(0, 3), name="%s_7x7a" % name)
    b7 = _conv(b7, 192, kernel=(7, 1), pad=(3, 0), name="%s_7x7b" % name)
    b7 = _conv(b7, 192, kernel=(3, 3), stride=(2, 2), name="%s_7x7c" % name)
    bp = _pool(data, (3, 3), (2, 2), (0, 0), "max", "%s_pool" % name)
    return sym.Concat(b3, b7, bp, name="%s_concat" % name)


def _block_e(data, pool_type, name):
    """8x8 block with expanded (split 1x3 / 3x1) branches."""
    b1 = _conv(data, 320, name="%s_1x1" % name)
    b3 = _conv(data, 384, name="%s_3x3r" % name)
    b3a = _conv(b3, 384, kernel=(1, 3), pad=(0, 1), name="%s_3x3a" % name)
    b3b = _conv(b3, 384, kernel=(3, 1), pad=(1, 0), name="%s_3x3b" % name)
    bd = _conv(data, 448, name="%s_d3r" % name)
    bd = _conv(bd, 384, kernel=(3, 3), pad=(1, 1), name="%s_d3" % name)
    bda = _conv(bd, 384, kernel=(1, 3), pad=(0, 1), name="%s_d3a" % name)
    bdb = _conv(bd, 384, kernel=(3, 1), pad=(1, 0), name="%s_d3b" % name)
    bp = _pool(data, (3, 3), (1, 1), (1, 1), pool_type, "%s_pool" % name)
    bp = _conv(bp, 192, name="%s_proj" % name)
    return sym.Concat(b1, b3a, b3b, bda, bdb, bp, name="%s_concat" % name)


def get_inception_v3(num_classes=1000):
    """Inception-v3 for 3x299x299 inputs -> SoftmaxOutput symbol."""
    data = sym.Variable("data")
    # stem: 299 -> 35
    net = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name="stem1")
    net = _conv(net, 32, kernel=(3, 3), name="stem2")
    net = _conv(net, 64, kernel=(3, 3), pad=(1, 1), name="stem3")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max", "stem_pool1")
    net = _conv(net, 80, name="stem4")
    net = _conv(net, 192, kernel=(3, 3), name="stem5")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max", "stem_pool2")
    # 35x35
    net = _block_a(net, 32, "mixed0")
    net = _block_a(net, 64, "mixed1")
    net = _block_a(net, 64, "mixed2")
    net = _block_b(net, "mixed3")
    # 17x17
    net = _block_c(net, 128, "mixed4")
    net = _block_c(net, 160, "mixed5")
    net = _block_c(net, 160, "mixed6")
    net = _block_c(net, 192, "mixed7")
    net = _block_d(net, "mixed8")
    # 8x8
    net = _block_e(net, "avg", "mixed9")
    net = _block_e(net, "max", "mixed10")
    net = sym.Pooling(data=net, kernel=(8, 8), global_pool=True,
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(data=net, name="flatten")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
