"""Extra imperative-op documents (reference
python/mxnet/ndarray_doc.py). The reference's import-time codegen merges
``NDArrayDoc`` subclass docstrings into generated functions; here op
docstrings come from the registry's declarative ``Param`` docs, and this
registry exists so downstream code subclassing ``NDArrayDoc`` keeps
working — docs registered here are appended at access time via
``get_extra_doc``.
Counterpart of ``mxnet_tpu/ndarray_doc.py``."""
from __future__ import annotations

_EXTRA = {}


class NDArrayDoc:
    """Subclass as ``class <op>(NDArrayDoc): '<extra doc>'`` (the
    reference pattern); the docstring is recorded for the op name."""

    def __init_subclass__(cls):
        if cls.__doc__:
            _EXTRA[cls.__name__] = cls.__doc__


def get_extra_doc(op_name):
    return _EXTRA.get(op_name, "")
