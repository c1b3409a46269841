"""Gather ops of the serving slice: ``Embedding`` and ``take``.

Counterparts of ``mxnet_tpu/ops/indexing.py`` (``:27``, ``:60``).  Indices
arrive as floats or ints and are truncated toward zero, as ``astype(int32)``
does in the JAX package.  Out-of-range Embedding ids are clipped to the
table (the reference's Take semantics); JAX fills such rows with NaN, so the
two packages agree on every in-range id.
"""
from __future__ import annotations

import torch

from .param import Param
from .registry import register


def _embedding_infer(attrs, in_shapes):
    data, weight = in_shapes
    w = (attrs["input_dim"], attrs["output_dim"])
    out = None if data is None else tuple(data) + (attrs["output_dim"],)
    return [data, w], [out], []


def _gather(a, indices, axis):
    """``a`` indexed along ``axis`` by an index tensor of any shape."""
    axis = axis % a.ndim
    flat = torch.index_select(a, axis, indices.reshape(-1))
    return flat.reshape(a.shape[:axis] + indices.shape + a.shape[axis + 1:])


@register("Embedding", inputs=("data", "weight"),
          params={"input_dim": Param(int, required=True),
                  "output_dim": Param(int, required=True),
                  "dtype": Param("dtype", "float32")},
          infer_shape=_embedding_infer, no_grad_inputs=("data",),
          hint="embedding")
def _embedding(opctx, attrs, data, weight):
    ids = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return _gather(weight, ids, 0)


@register("take", inputs=("a", "indices"),
          params={"axis": Param(int, 0),
                  "mode": Param(str, "clip", enum=("clip", "wrap", "raise"))},
          no_grad_inputs=("indices",))
def _take(opctx, attrs, a, indices):
    axis = attrs.get("axis", 0)
    n = a.shape[axis]
    ids = indices.to(torch.int64)
    if attrs.get("mode", "clip") == "wrap":
        ids = torch.remainder(ids, n)
    else:
        ids = ids.clamp(0, n - 1)
    return _gather(a, ids, axis)
