"""Internal-op namespace for symbols (reference
python/mxnet/_symbol_internal.py); counterpart of
``mxnet_tpu/_symbol_internal.py``.  See ``_ndarray_internal``."""
from . import symbol as _sym


def __getattr__(name):
    if name.startswith("_") and not name.startswith("__") \
            and hasattr(_sym, name):
        return getattr(_sym, name)
    raise AttributeError("no internal Symbol op %r" % name)


def __dir__():
    return [n for n in dir(_sym) if n.startswith("_") and
            not n.startswith("__")]
