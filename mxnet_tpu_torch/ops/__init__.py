"""Operator library of the port.  Importing this package registers every
op family ported so far into the central registry
(``mxnet_tpu_torch.ops.registry``), from which ``mx.sym`` is generated.
"""
from .registry import Op, OpContext, register, get_op, registered_ops
from .param import Param
from .kernel_op import register_kernel_op

from . import elemwise  # noqa: F401
from . import matrix  # noqa: F401
from . import indexing  # noqa: F401
from . import nn  # noqa: F401
from . import attention  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import init_ops  # noqa: F401
from . import sample  # noqa: F401
from . import ordering  # noqa: F401
from . import contrib_ops  # noqa: F401
from . import spatial  # noqa: F401
from . import paged  # noqa: F401
from . import sequence  # noqa: F401
from . import rnn_op  # noqa: F401
from . import ctc  # noqa: F401
from .registry import mark_batch_local as _mark
from .registry import mark_loss as _mark_loss
from .registry import mark_partition as _mark_partition


def _reshape_rule(attrs):
    """Reshape keeps axis 0 the batch's when the target's first dim is
    copied (0) or inferred (-1) in forward order."""
    shape = tuple(attrs.get("shape") or ())
    return bool(shape) and shape[0] in (0, -1) and \
        not attrs.get("reverse", False)


def _axis_rule(key, default):
    """An op over an axis keeps the batch's pieces when that axis is not
    0."""
    return lambda attrs: int(attrs.get(key, default)) != 0


# how a partitioned executor splits an op beyond the batch
# (``Op.partition``): the ops that map each element on its own run on any
# split of their same-shape inputs
_ELEMWISE = [
    "abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "ceil", "cos", "cosh", "degrees", "erf", "exp", "expm1", "fix",
    "floor", "gamma", "gammaln", "gelu", "identity", "log", "log10",
    "log1p", "log2", "negative", "radians", "relu", "rint", "round",
    "rsqrt", "sigmoid", "sign", "sin", "sinh", "sqrt", "square", "tan",
    "tanh", "clip", "Cast", "cast", "_copy", "BlockGrad", "stop_gradient",
    "_Plus", "_Minus", "_Mul", "_Div", "_Power", "_Maximum", "_Minimum",
    "_Mod", "_plus", "_minus", "_mul", "_div", "_power", "_maximum",
    "_minimum", "_mod", "_add", "_sub", "_hypot", "elemwise_add",
    "elemwise_sub", "elemwise_mul", "elemwise_div", "ElementWiseSum",
    "add_n", "_PlusScalar", "_MinusScalar", "_RMinusScalar",
    "_MulScalar", "_DivScalar", "_RDivScalar", "_PowerScalar",
    "_RPowerScalar", "_MaximumScalar", "_MinimumScalar", "_plus_scalar",
    "_minus_scalar", "_rminus_scalar", "_mul_scalar", "_div_scalar",
    "_rdiv_scalar", "_power_scalar", "_rpower_scalar", "_maximum_scalar",
    "_minimum_scalar", "_mod_scalar", "_rmod_scalar", "_hypot_scalar",
    "broadcast_add", "broadcast_plus", "broadcast_sub", "broadcast_minus",
    "broadcast_mul", "broadcast_div", "broadcast_power",
    "broadcast_maximum", "broadcast_minimum", "broadcast_mod",
    "broadcast_hypot", "Activation"]
_mark_partition(_ELEMWISE, "elementwise")
_mark_partition(["FullyConnected"], "dense")
_mark_partition(["Reshape", "reshape", "Flatten", "flatten"], "reshape")

# the loss layers (``Op.loss``): each ignores its head gradient
_LOSSES = ["SoftmaxOutput", "LinearRegressionOutput",
           "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
           "MakeLoss", "WarpCTC"]
_mark_loss(_LOSSES)

# the ops a data-parallel executor runs per shard (``Op.is_batch_local``);
# every other op runs once on the whole batch
_mark(_ELEMWISE + [
    "FullyConnected", "Convolution", "Convolution_v1", "Deconvolution",
    "Pooling", "Pooling_v1", "Embedding", "Flatten", "flatten",
    "_contrib_FlashAttention", "_contrib_SplashAttention"])
_mark(["Reshape", "reshape"], _reshape_rule)
_mark(["SliceChannel", "split"], _axis_rule("axis", 1))
_mark(["Concat", "concat"], _axis_rule("dim", 1))
_mark(["LayerNorm"], _axis_rule("axis", -1))
_mark(["SoftmaxOutput", "MakeLoss"],
      lambda attrs: attrs.get("normalization", "null") == "null")
_mark(["LinearRegressionOutput", "LogisticRegressionOutput",
       "MAERegressionOutput", "SVMOutput"])
_mark(["BatchNorm"], lambda attrs: bool(attrs.get("use_global_stats")))
# out of training a loss layer's forward maps each row on its own, Dropout
# is the identity and BatchNorm reads its moving statistics
_mark(_LOSSES + ["BatchNorm", "Dropout", "LeakyReLU"], is_train=False)
_mark(["LeakyReLU"], lambda attrs: attrs.get("act_type", "leaky") != "rrelu")

__all__ = ["Op", "OpContext", "register", "get_op", "registered_ops",
           "Param", "register_kernel_op"]
