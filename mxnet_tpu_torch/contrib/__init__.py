"""``mt.contrib`` — the experimental-op namespaces and the TensorBoard
callback; counterpart of ``mxnet_tpu/contrib/``.

Reference user scripts spell contrib ops as ``mx.contrib.sym.MultiBoxPrior
(...)`` / ``mx.contrib.nd.fft(...)``; the registry stores them under their
C-registration names (``_contrib_*``), and these modules re-export every
``_contrib_`` op of the port's registry under its short name.
"""
from . import ndarray
from . import symbol
from . import tensorboard

# reference aliases (contrib/__init__.py re-exports symbol as sym, ndarray
# as nd)
sym = symbol
nd = ndarray

__all__ = ["symbol", "ndarray", "sym", "nd", "tensorboard"]
