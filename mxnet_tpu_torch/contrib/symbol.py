"""``mt.contrib.sym`` — contrib ops under their reference short names
(reference python/mxnet/contrib/symbol.py: the codegen registers
``_contrib_Foo`` ops into the contrib module as ``Foo``)."""
from .. import symbol as _symbol
from ._export import populate as _populate

__all__ = []

_populate(globals(), _symbol, __all__)
