"""Notebook helpers (reference python/mxnet/notebook/: live
training-curve plotting); counterpart of ``mxnet_tpu/notebook/``.  See
callback.py."""
from . import callback  # noqa: F401

__all__ = ["callback"]
