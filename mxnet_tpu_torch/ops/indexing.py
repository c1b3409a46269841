"""Gather ops: ``Embedding``, ``take``, ``_onehot_encode``, ``batch_take``,
``one_hot``, ``pick`` (``choose_element_0index``) and
``fill_element_0index``.

Counterparts of ``mxnet_tpu/ops/indexing.py``.  Indices
arrive as floats or ints and are truncated toward zero, as ``astype(int32)``
does in the JAX package.  Out-of-range Embedding ids are clipped to the
table (the reference's Take semantics); JAX fills such rows with NaN, so the
two packages agree on every in-range id.

``embedding_row_sparse_grad`` is the row-sparse plane's numpy gradient of
an Embedding (only the touched rows).  ``Embedding``'s weight gradient is
summed in a fixed order (``_EmbeddingRows``): the backward of
``index_select`` on CUDA adds rows with atomics, in an order that changes
from run to run, and rounds after every add in a bf16 table.
"""
from __future__ import annotations

import numpy as np
import torch

from .param import Param, torch_dtype
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
        if grad.device.type == "meta":
            # the runs of equal ids have data-dependent shapes: on meta
            # tensors (the cost model) the same table gradient as a
            # scatter-add
            return torch.zeros((n_rows,) + tuple(grad.shape[1:]),
                               dtype=dtype, device=grad.device).index_add(
                0, ids, grad.to(dtype)), None
        order = torch.argsort(ids, stable=True)
        uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
        sums = torch.segment_reduce(grad[order].to(torch.float32), "sum",
                                    lengths=counts, axis=0)
        table = torch.zeros((n_rows,) + tuple(grad.shape[1:]), dtype=dtype,
                            device=grad.device)
        table[uniq] = sums.to(dtype)  # one write per row: no accumulation
        return table, None


def gather_rows(table, ids):
    """Rows ``ids`` (1-d int64, in range) of the 2-d ``table``, whose
    gradient is ``_EmbeddingRows``'s sorted segment sum: the same bits on
    every run (the spatial ops' gathers use it)."""
    return _EmbeddingRows.apply(table, ids)


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


def embedding_row_sparse_grad(data, out_grad, input_dim):
    """Row-sparse weight gradient for Embedding (``mxnet_tpu/ops/
    indexing.py``'s, numpy): only the touched rows, as a RowSparseArray,
    never a dense (input_dim, output_dim) table.

    data: integer index array of any shape; out_grad: data.shape +
    (output_dim,).  Allocation is O(touched_rows * output_dim), never
    O(input_dim).  Duplicate indices sum, as the dense gradient does."""
    from ..sparse.array import RowSparseArray

    data = np.asarray(data).astype(np.int64).reshape(-1)
    out_grad = np.asarray(out_grad)
    dim = out_grad.shape[-1]
    rows = out_grad.reshape(-1, dim)
    if rows.shape[0] != data.shape[0]:
        raise ValueError("out_grad rows %d != index count %d"
                         % (rows.shape[0], data.shape[0]))
    uniq, inverse = np.unique(data, return_inverse=True)
    merged = np.zeros((uniq.shape[0], dim), dtype=rows.dtype)
    np.add.at(merged, inverse, rows)
    return RowSparseArray(uniq, merged, (int(input_dim), dim))


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


@register("batch_take", inputs=("a", "indices"), no_grad_inputs=("indices",))
def _batch_take(opctx, attrs, a, indices):
    """Row i's element at column indices[i]."""
    idx = indices.to(torch.int64).reshape(-1)
    return a[torch.arange(a.shape[0], device=a.device), idx]


def _one_hot_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(ishape) + (attrs["depth"],)], []


@register("one_hot", inputs=("indices",),
          params={"depth": Param(int, required=True),
                  "on_value": Param(float, 1.0),
                  "off_value": Param(float, 0.0),
                  "dtype": Param("dtype", "float32")},
          infer_shape=_one_hot_infer, no_grad_inputs=("indices",))
def _one_hot(opctx, attrs, indices):
    """One-hot rows of ``depth`` (``off_value`` everywhere but
    ``on_value`` at the index; an index outside [0, depth) gives a row of
    ``off_value``, as ``jax.nn.one_hot`` does)."""
    depth = attrs["depth"]
    on, off = attrs.get("on_value", 1.0), attrs.get("off_value", 0.0)
    classes = torch.arange(depth, device=indices.device)
    oh = (indices.to(torch.int64).unsqueeze(-1) == classes).to(
        torch_dtype(attrs.get("dtype", "float32")))
    return oh * (on - off) + off


def _pick_infer(attrs, in_shapes):
    data, index = in_shapes
    if data is None:
        return in_shapes, [None], []
    axis = attrs.get("axis", -1) % len(data)
    out = list(data)
    if attrs.get("keepdims", False):
        out[axis] = 1
    else:
        del out[axis]
    return in_shapes, [tuple(out)], []


@register("pick", inputs=("data", "index"),
          params={"axis": Param(int, -1), "keepdims": Param(bool, False)},
          infer_shape=_pick_infer, no_grad_inputs=("index",),
          aliases=("choose_element_0index",))
def _pick(opctx, attrs, data, index):
    """The element at ``index`` along ``axis`` (indices clipped to the
    axis, the reference's mode)."""
    axis = attrs.get("axis", -1) % data.ndim
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    if not attrs.get("keepdims", False):
        out = out.squeeze(axis)
    return out


@register("fill_element_0index", inputs=("lhs", "mhs", "rhs"),
          no_grad_inputs=("rhs",))
def _fill_element_0index(opctx, attrs, lhs, mhs, rhs):
    """A copy of ``lhs`` with lhs[i, rhs[i]] = mhs[i]."""
    out = lhs.clone()
    out[torch.arange(lhs.shape[0], device=lhs.device),
        rhs.to(torch.int64)] = mhs
    return out
