"""``mt.contrib.nd`` — imperative contrib ops under their reference short
names (reference python/mxnet/contrib/ndarray.py)."""
from .. import ndarray as _ndarray
from ._export import populate as _populate

__all__ = []

_populate(globals(), _ndarray, __all__)
