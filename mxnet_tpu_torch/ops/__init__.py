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

__all__ = ["Op", "OpContext", "register", "get_op", "registered_ops",
           "Param", "register_kernel_op"]
