"""Gather ops: ``Embedding``, ``take`` and ``_onehot_encode``.

Counterparts of ``mxnet_tpu/ops/indexing.py`` (``:27``, ``:60``, ``:129``).  Indices
arrive as floats or ints and are truncated toward zero, as ``astype(int32)``
does in the JAX package.  Out-of-range Embedding ids are clipped to the
table (the reference's Take semantics); JAX fills such rows with NaN, so the
two packages agree on every in-range id.

``Embedding``'s weight gradient is summed in a fixed order
(``_EmbeddingRows``): the backward of ``index_select`` on CUDA adds rows with
atomics, in an order that changes from run to run, and rounds after every
add in a bf16 table.
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


class _EmbeddingRows(torch.autograd.Function):
    """Rows ``ids`` (1-d, in range) of ``weight``.  The gradient of the
    table sums the rows of each id in float32 in a fixed order (ids sorted
    stably, one ``segment_reduce`` over the runs of equal ids), rounds each
    sum once to the table's dtype and writes it to its row: the same bits on
    every run, on the CPU and the card, as the JAX package's scatter-add
    is reproducible."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.table = (weight.shape[0], weight.dtype)
        return torch.index_select(weight, 0, ids)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        ids, = ctx.saved_tensors
        n_rows, dtype = ctx.table
        order = torch.argsort(ids, stable=True)
        uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
        sums = torch.segment_reduce(grad[order].to(torch.float32), "sum",
                                    lengths=counts, axis=0)
        table = torch.zeros((n_rows,) + tuple(grad.shape[1:]), dtype=dtype,
                            device=grad.device)
        table[uniq] = sums.to(dtype)  # one write per row: no accumulation
        return table, None


@register("Embedding", inputs=("data", "weight"),
          params={"input_dim": Param(int, required=True),
                  "output_dim": Param(int, required=True),
                  "dtype": Param("dtype", "float32")},
          infer_shape=_embedding_infer, no_grad_inputs=("data",),
          hint="embedding")
def _embedding(opctx, attrs, data, weight):
    ids = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    rows = _EmbeddingRows.apply(weight, ids.reshape(-1))
    return rows.reshape(ids.shape + weight.shape[1:])


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


@register("_onehot_encode", inputs=("lhs", "rhs"), no_grad_inputs=("lhs",))
def _onehot_encode(opctx, attrs, lhs, rhs):
    """One-hot rows of ``lhs``'s indices in ``rhs``'s shape and dtype (the
    NDArray function behind ``nd.onehot_encode``).  An index outside
    [0, depth) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(rhs.shape[1], device=lhs.device)
    return (lhs.to(torch.int64).unsqueeze(-1) == classes).to(rhs.dtype)
