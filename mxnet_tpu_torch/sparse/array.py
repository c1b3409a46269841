"""RowSparseArray: the 'row_sparse' storage type over a dense logical shape,
the port's own copy of ``mxnet_tpu/sparse/array.py`` (numpy only).

Mirrors MXNet's RowSparseNDArray (indices + values rows over shape
(dim0, dim1, ...)): only the rows named in `indices` are materialised,
everything else is implicitly zero.  This is the value type the sparse
parameter plane moves over the wire — an embedding gradient touching 4k
rows of a 10M-row table ships 4k rows, not 10M.

Invariant maintained by the constructor: indices are int64, strictly
increasing (sorted, unique), and values.shape == (len(indices),) +
shape[1:].  Use `row_merge` to reduce duplicate indices by summation
before constructing.
"""
from __future__ import annotations

import numpy as np

__all__ = ["RowSparseArray", "row_merge"]


def row_merge(indices, values):
    """Sum rows that share an index.  Returns (uniq_indices, merged_values)
    with uniq_indices sorted ascending, int64, and merged_values of shape
    (len(uniq),) + values.shape[1:].  O(nnz log nnz) on the host."""
    indices = np.asarray(indices, dtype=np.int64).reshape(-1)
    values = np.asarray(values)
    if values.shape[0] != indices.shape[0]:
        raise ValueError(
            "row_merge: %d indices but %d value rows"
            % (indices.shape[0], values.shape[0]))
    uniq, inverse = np.unique(indices, return_inverse=True)
    if uniq.shape[0] == indices.shape[0]:
        # already unique; np.unique sorted them for us
        order = np.argsort(indices, kind="stable")
        return uniq, np.ascontiguousarray(values[order])
    merged = np.zeros((uniq.shape[0],) + values.shape[1:], dtype=values.dtype)
    np.add.at(merged, inverse, values)
    return uniq, merged


class RowSparseArray(object):
    """indices (nnz,) int64 + values (nnz, ...) rows of a dense logical
    `shape`.  Construction merges duplicate indices by summation so the
    representation is canonical (sorted unique indices)."""

    stype = "row_sparse"

    def __init__(self, indices, values, shape):
        self.shape = tuple(int(s) for s in shape)
        if not self.shape:
            raise ValueError("row_sparse needs a >=1-d logical shape")
        indices, values = row_merge(indices, values)
        if values.shape[1:] != self.shape[1:]:
            raise ValueError(
                "value rows %r do not match logical row shape %r"
                % (values.shape[1:], self.shape[1:]))
        if indices.shape[0] and (indices[0] < 0
                                 or indices[-1] >= self.shape[0]):
            raise IndexError(
                "row index out of bounds for dim0=%d" % self.shape[0])
        self.indices = indices
        self.values = values

    @property
    def nnz(self):
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @classmethod
    def from_dense(cls, dense):
        """Keep only rows with any non-zero entry."""
        dense = np.asarray(dense)
        flat = dense.reshape(dense.shape[0], -1)
        idx = np.flatnonzero(np.any(flat != 0, axis=1)).astype(np.int64)
        return cls(idx, dense[idx], dense.shape)

    def to_dense(self, out=None):
        if out is None:
            out = np.zeros(self.shape, dtype=self.values.dtype)
        else:
            out[:] = 0
        out[self.indices] = self.values
        return out

    def __add__(self, other):
        if not isinstance(other, RowSparseArray):
            return NotImplemented
        if other.shape != self.shape:
            raise ValueError("shape mismatch %r vs %r"
                             % (self.shape, other.shape))
        return RowSparseArray(
            np.concatenate([self.indices, other.indices]),
            np.concatenate([self.values, other.values]), self.shape)

    def __repr__(self):
        return "RowSparseArray(nnz=%d, shape=%r, dtype=%s)" % (
            self.nnz, self.shape, self.values.dtype)
