"""Bucketed batches over shared-weight Predictors — counterpart of
``mxnet_tpu/serving/batcher.py`` (its errors, ``pow2_buckets`` and
``BucketedPredictor``; the micro-batcher is not ported yet, ROADMAP.md A.5).

Requests are padded up to a small fixed set of batch sizes, so a bounded
set of executors serves every occupancy and :meth:`BucketedPredictor.
warmup` can run each once before traffic arrives.  Weights are shared
across bucket executors through ``Predictor.reshape`` (NDArrays already on
the context pass through the rebind), so N buckets cost one copy of the
parameters.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..base import MXNetError

__all__ = ["pow2_buckets", "BucketedPredictor", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError", "DrainTimeoutError"]


class QueueFullError(MXNetError):
    """Admission control rejected the request (queue at capacity)."""


class DeadlineExceededError(MXNetError):
    """The request's deadline passed before it reached an executor."""


class ServerClosedError(MXNetError):
    """The server is stopped (or stopping) and not accepting work."""


class DrainTimeoutError(MXNetError):
    """The drain deadline expired with work still outstanding: the
    remaining futures are force-cancelled with this typed error (callers
    retry on another replica)."""


def pow2_buckets(max_batch_size: int) -> tuple:
    """Power-of-two batch buckets up to and including ``max_batch_size``
    (which is appended as-is when it is not itself a power of two)."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


class BucketedPredictor:
    """A family of shared-weight Predictors, one per batch bucket.

    Parameters
    ----------
    symbol, params, ctx, dtype
        As for :class:`mxnet_tpu_torch.Predictor` (``ctx`` defaults to
        ``gpu(0)``).
    item_shapes : dict
        ``{input_name: per-item shape}`` — shapes WITHOUT the leading
        batch axis; every bucket ``b`` binds ``(b,) + item_shape``.
    buckets : sequence of int
        Allowed batch sizes, e.g. ``pow2_buckets(16)``.
    """

    def __init__(self, symbol, params, item_shapes: Dict[str, Sequence[int]],
                 buckets: Sequence[int], ctx=None, dtype=np.float32):
        from ..predictor import Predictor

        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("need at least one bucket")
        self.item_shapes = {k: tuple(v) for k, v in item_shapes.items()}
        self._dtype = np.dtype(dtype)
        base_b = self.buckets[-1]
        base = Predictor(symbol, params,
                         {k: (base_b,) + s
                          for k, s in self.item_shapes.items()},
                         ctx=ctx, dtype=dtype)
        self._preds = {base_b: base}
        for b in self.buckets[:-1]:
            self._preds[b] = base.reshape(
                {k: (b,) + s for k, s in self.item_shapes.items()})
        self.executor_calls = 0
        # buckets whose executor warmup() ran, and how many post-warmup
        # flushes hit a bucket warmup never touched (the "steady state
        # runs only warmed shapes" contract is exactly cold_runs == 0)
        self.warmed_buckets = set()
        self.cold_runs = 0

    @property
    def max_batch_size(self):
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise MXNetError("batch of %d exceeds largest bucket %d"
                         % (n, self.buckets[-1]))

    def warmup(self):
        """Run one zero-filled forward per bucket before traffic arrives."""
        for b in self.buckets:
            pred = self._preds[b]
            for name, shape in self.item_shapes.items():
                pred.set_input(name, np.zeros((b,) + shape, self._dtype))
            pred._exec.forward(is_train=False)
            for out in pred.get_outputs():
                out.asnumpy()  # wait until it ran
            # release the outputs: on the card a (4, 1024) LM prefill's
            # are 0.9 GB, and no caller reads a warmup's
            pred._exec._output_arrays = []
            self.warmed_buckets.add(b)

    def forward_padded(self, items: List[Dict[str, np.ndarray]]):
        """Run one padded batch; returns ``(bucket, outputs)`` with the
        outputs left on the device, the batch axis padded to the bucket —
        for callers that keep the results on the card."""
        n = len(items)
        b = self.bucket_for(n)
        if b not in self.warmed_buckets:
            self.cold_runs += 1
            self.warmed_buckets.add(b)
        pred = self._preds[b]
        for name, shape in self.item_shapes.items():
            buf = np.zeros((b,) + shape, self._dtype)
            for i, item in enumerate(items):
                buf[i] = item[name]
            pred.set_input(name, buf)
        pred._exec.forward(is_train=False)
        self.executor_calls += 1
        outs = pred.get_outputs()
        pred._exec._output_arrays = []  # the caller holds them now
        return b, outs

    def forward_batch(self, items: List[Dict[str, np.ndarray]]):
        """Run one padded batch; returns per-item output lists on the host
        (the batch axis is stripped from every output that carries one)."""
        n = len(items)
        b, outs = self.forward_padded(items)
        outs = [o.asnumpy() for o in outs]
        per_item = []
        for i in range(n):
            per_item.append([o[i] if (o.ndim >= 1 and o.shape[0] == b) else o
                             for o in outs])
        return b, per_item
