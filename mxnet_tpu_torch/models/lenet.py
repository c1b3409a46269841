"""LeNet-5 style conv net for MNIST symbol builder, the counterpart of
``mxnet_tpu/models/lenet.py``.  The graph is built from the same ops with
the same names in the same order, so under a fresh ``NameManager`` its JSON
is byte-identical to the JAX package's and one checkpoint serves both.
"""

from .. import symbol as sym


def get_lenet(num_classes=10):
    data = sym.Variable("data")
    net = sym.Convolution(data=data, kernel=(5, 5), num_filter=20, name="conv1")
    net = sym.Activation(data=net, act_type="tanh")
    net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = sym.Convolution(data=net, kernel=(5, 5), num_filter=50, name="conv2")
    net = sym.Activation(data=net, act_type="tanh")
    net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=500, name="fc1")
    net = sym.Activation(data=net, act_type="tanh")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(data=net, name="softmax")
