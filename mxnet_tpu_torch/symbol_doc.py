"""Extra symbol documents (reference python/mxnet/symbol_doc.py) — see
ndarray_doc.py; one registry per surface, same mechanism.
Counterpart of ``mxnet_tpu/symbol_doc.py``."""
from __future__ import annotations

_EXTRA = {}


class SymbolDoc:
    """Subclass as ``class <op>(SymbolDoc): '<extra doc>'``; also carries
    the reference's debug-utility spirit (get_output_shape below)."""

    def __init_subclass__(cls):
        if cls.__doc__:
            _EXTRA[cls.__name__] = cls.__doc__

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """Dict of output name -> shape for given input shapes."""
        _, s_outputs, _ = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), s_outputs))


def get_extra_doc(op_name):
    return _EXTRA.get(op_name, "")
