"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``, the framework
with the API surface of Apache MXNet 0.9, for an NVIDIA Hopper card.

It keeps the JAX package's op names and attrs, its symbol JSON and its
``.params`` bytes, so a symbol or checkpoint written by one package loads
in the other.  Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a hand-written CUDA kernel (``csrc/``).  Entry points run
on the card (``gpu(0)``) unless the caller passes ``mx.cpu()``.

Ported so far: the serving path — ``Predictor`` over a transformer LM
(``models.transformer.get_transformer_lm``) with the flash-attention
forward kernel — and the training path — ``mod.Module`` with
``forward_backward``/``update`` (the fused step), SGD and Adam, the
initializers, ``io.NDArrayIter``, metrics and checkpoints, with the
flash-attention backward kernels.  This package imports neither ``jax``
nor ``mxnet_tpu``.
"""
from . import base
from .base import MXNetError
from .context import Context, cpu, gpu, current_context
from .attribute import AttrScope
from .name import NameManager, Prefix
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from .executor import Executor
from . import kernels
from . import models
from .predictor import Predictor
from .ops import register_kernel_op, Param
from . import random
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import io
from . import metric
from . import callback
from . import model
from . import module
from . import module as mod
from . import convert
