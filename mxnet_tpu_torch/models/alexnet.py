"""AlexNet symbol builder, the counterpart of ``mxnet_tpu/models/alexnet.py``.
The graph is built from the same ops with the same names in the same order,
so under a fresh ``NameManager`` its JSON is byte-identical to the JAX
package's and one checkpoint serves both.
"""

from .. import symbol as sym


def get_alexnet(num_classes=1000):
    data = sym.Variable("data")
    net = sym.Convolution(data=data, kernel=(11, 11), stride=(4, 4),
                          num_filter=96, name="conv1")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.LRN(data=net, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3), stride=(2, 2))
    net = sym.Convolution(data=net, kernel=(5, 5), pad=(2, 2), num_filter=256,
                          name="conv2")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.LRN(data=net, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3), stride=(2, 2))
    net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1), num_filter=384,
                          name="conv3")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1), num_filter=384,
                          name="conv4")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1), num_filter=256,
                          name="conv5")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3), stride=(2, 2))
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc1")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=4096, name="fc2")
    net = sym.Activation(data=net, act_type="relu")
    net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(data=net, name="softmax")
