"""Internal-op namespace (reference python/mxnet/_ndarray_internal.py);
counterpart of ``mxnet_tpu/_ndarray_internal.py``.  Every registered op,
public and internal, is generated into ``mxnet_tpu_torch.ndarray``; this
module re-exports the underscore subset under the reference's import path,
for code that does ``from mxnet._ndarray_internal import _plus_scalar``."""
from . import ndarray as _nd


def __getattr__(name):
    if name.startswith("_") and not name.startswith("__") \
            and hasattr(_nd, name):
        return getattr(_nd, name)
    raise AttributeError("no internal NDArray op %r" % name)


def __dir__():
    return [n for n in dir(_nd) if n.startswith("_") and
            not n.startswith("__")]
