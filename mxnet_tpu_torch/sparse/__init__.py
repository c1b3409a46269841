"""Sparse parameter plane, counterpart of ``mxnet_tpu/sparse/``: row-sparse
values, sharded embedding tables on the kvstore servers, and server-placed
optimizers.

Import discipline: ``kvstore_server`` imports this package (for
``row_merge``) during the package import, so the eager surface here stays
numpy-only.  The plane and module layers, which pull in the kvstore, the
comm engine and ``Module``, load on first attribute access.
"""
from .array import RowSparseArray, row_merge  # noqa: F401
from .updaters import (SparseAdaGrad, SparseSGD,  # noqa: F401
                       get_sparse_updater)

__all__ = ["RowSparseArray", "row_merge", "SparseSGD", "SparseAdaGrad",
           "get_sparse_updater", "SparseParamPlane",
           "SparseEmbeddingModule"]

_LAZY = {
    "SparseParamPlane": ("mxnet_tpu_torch.sparse.plane", "SparseParamPlane"),
    "plane": ("mxnet_tpu_torch.sparse.plane", None),
    "SparseEmbeddingModule": ("mxnet_tpu_torch.sparse.module",
                              "SparseEmbeddingModule"),
    "module": ("mxnet_tpu_torch.sparse.module", None),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    import importlib

    mod = importlib.import_module(target[0])
    obj = mod if target[1] is None else getattr(mod, target[1])
    globals()[name] = obj
    return obj
