"""Multi-layer perceptron symbol builder, the counterpart of
``mxnet_tpu/models/mlp.py``.  The graph is built from the same ops with the
same names in the same order, so under a fresh ``NameManager`` its JSON is
byte-identical to the JAX package's and one checkpoint serves both.
"""

from .. import symbol as sym


def get_mlp(num_classes=10, hidden=(128, 64)):
    net = sym.Variable("data")
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(data=net, num_hidden=h, name="fc%d" % (i + 1))
        net = sym.Activation(data=net, act_type="relu", name="relu%d" % (i + 1))
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc_out")
    return sym.SoftmaxOutput(data=net, name="softmax")
