"""Micro-batcher over bucketed shared-weight Predictors — counterpart of
``mxnet_tpu/serving/batcher.py``: the serving errors, ``pow2_buckets``,
``BucketedPredictor`` and the ``MicroBatcher`` that coalesces in-flight
requests into padded bucket batches.

Requests are padded up to a small fixed set of batch sizes, so a bounded
set of executors serves every occupancy and :meth:`BucketedPredictor.
warmup` can run each once before traffic arrives.  Weights are shared
across bucket executors through ``Predictor.reshape`` (NDArrays already on
the context pass through the rebind), so N buckets cost one copy of the
parameters.  With the compile cache on (``MXNET_COMPILE_CACHE_DIR`` or an
attached AOT bundle) every bucket's forward primes through it at warm-up,
on the card as a CUDA graph in one memory pool the buckets share
(``compile_cache.GraphPool``); ``compiled_entries()`` lists the primed
entries.  Each flushed batch is a profiler span, ``serving/batch[n=...]``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import profiler
from ..base import MXNetError

__all__ = ["pow2_buckets", "BucketedPredictor", "MicroBatcher",
           "QueueFullError", "DeadlineExceededError", "ServerClosedError",
           "DrainTimeoutError"]


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
        from ..compile_cache import GraphPool

        pool = GraphPool()
        for pred in self._preds.values():
            pred._exec._graph_pool = pool
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

    def compiled_entries(self):
        """Every bucket's primed ``compile_cache.CachedFunction`` (empty
        when the compile cache is off) — the input to
        ``checkpoint.save_aot_bundle``."""
        from ..compile_cache import entries_of

        out = []
        for b in self.buckets:
            out.extend(entries_of(self._preds[b]._exec))
        return out

    def release(self):
        """Drop every bucket executor's compile-cache entries and CUDA
        graphs (their pool's memory comes back with them)."""
        for pred in self._preds.values():
            pred._exec.release_cache()

    def forward_padded(self, items: List[Dict[str, np.ndarray]],
                       copy: bool = True):
        """Run one padded batch; returns ``(bucket, outputs)`` with the
        outputs left on the device, the batch axis padded to the bucket —
        for callers that keep the results on the card.  An output of a
        CUDA graph is the graph's own buffer, which its next replay
        overwrites, so the caller gets a copy of it, unless ``copy`` is
        False (a caller done with them before this bucket runs again)."""
        b, outs = self._forward(items)
        if copy and self._preds[b]._exec._jit_cache:
            from ..ndarray import NDArray

            outs = [NDArray(o._data.clone(), o.context) for o in outs]
        return b, outs

    def _forward(self, items: List[Dict[str, np.ndarray]]):
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
        b, outs = self._forward(items)
        outs = [o.asnumpy() for o in outs]
        per_item = []
        for i in range(n):
            per_item.append([o[i] if (o.ndim >= 1 and o.shape[0] == b) else o
                             for o in outs])
        return b, per_item


class _WorkItem:
    __slots__ = ("inputs", "future", "t_enqueue", "deadline")

    def __init__(self, inputs, future, deadline=None):
        self.inputs = inputs
        self.future = future
        self.t_enqueue = time.monotonic()
        self.deadline = deadline  # absolute monotonic seconds, or None


class MicroBatcher:
    """Bounded request queue + flush loop over one or more replicas.

    A flush happens when ``max_batch_size`` requests are queued or the
    oldest queued request has waited ``max_wait_us`` — whichever comes
    first.  Queued items stay in the queue until flush time, so
    ``len(queue)`` is the real backlog admission control sees.  Each
    replica (a :class:`BucketedPredictor`, typically one per device
    ``Context``) gets its own worker thread pulling from the shared
    queue, which is how multi-replica dispatch falls out for free.  The
    forwards run under ``torch.no_grad`` (``Executor.forward``).
    """

    def __init__(self, replicas: List[BucketedPredictor], metrics,
                 max_wait_us: int = 2000, max_queue: int = 256):
        if not replicas:
            raise ValueError("need at least one replica")
        self._replicas = replicas
        self._metrics = metrics
        self.max_batch_size = min(r.max_batch_size for r in replicas)
        self.max_wait_us = int(max_wait_us)
        self.max_queue = int(max_queue)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._inflight: set = set()  # _WorkItems dequeued but unfinished
        self._dead_workers: List[str] = []  # "name: exc" per crashed worker
        self._workers = [
            threading.Thread(target=self._run, args=(i,),
                             name="mxtpu-serving-%d" % i, daemon=True)
            for i in range(len(replicas))]
        self._started = False

    def start(self):
        if not self._started:
            self._started = True
            for w in self._workers:
                w.start()

    def swap_replicas(self, replicas: List[BucketedPredictor]):
        """Atomically replace the predictor families the worker threads
        execute on (the in-place checkpoint hot-swap).  Workers re-read
        their replica slot at the top of every flush, so the batch in
        flight finishes on the old weights and the very next flush runs
        on the new ones — no queue teardown, no dropped work."""
        if len(replicas) != len(self._replicas):
            raise ValueError("swap must keep the replica count (%d != %d)"
                             % (len(replicas), len(self._replicas)))
        with self._cv:
            self._replicas = list(replicas)
            self.max_batch_size = min(r.max_batch_size for r in replicas)
            self._cv.notify_all()

    def put(self, inputs, future, deadline=None):
        with self._cv:
            if self._closed:
                self._metrics.on_reject()
                raise ServerClosedError("server is stopped")
            if len(self._q) >= self.max_queue:
                self._metrics.on_reject()
                raise QueueFullError(
                    "queue full (%d pending); retry with backoff"
                    % len(self._q))
            item = _WorkItem(inputs, future, deadline)
            self._q.append(item)
            self._metrics.on_submit(len(self._q))
            self._cv.notify()
        return item

    def queue_depth(self):
        with self._cv:
            return len(self._q)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty AND no dequeued batch is still
        executing — the drain barrier a graceful page-out waits on before
        releasing device memory.  Returns False on timeout (workers may
        re-check on a short poll: completions do not notify the CV)."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            with self._cv:
                if not self._q and not self._inflight:
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def dead_workers(self):
        """``["thread-name: exception", ...]`` for worker threads that died
        on an unexpected error (health endpoints report these as degraded
        capacity — the server still works through its surviving replicas)."""
        with self._cv:
            return list(self._dead_workers)

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting work; with ``drain`` the workers flush whatever
        is queued before exiting, otherwise pending futures fail with
        :class:`ServerClosedError`.

        ``timeout`` (seconds) is a HARD drain deadline: if the workers
        have not flushed by then — a wedged executor, a worker stuck in a
        hung backend call — every still-pending future (queued or
        mid-batch) is force-cancelled with :class:`DrainTimeoutError`
        instead of hanging retirement forever.  ``None`` waits
        indefinitely (the legacy behaviour; :class:`InferenceServer`
        always passes its ``MXNET_SERVING_DRAIN_TIMEOUT_MS`` budget)."""
        with self._cv:
            self._closed = True
            if not drain:
                while self._q:
                    item = self._q.popleft()
                    item.future.set_exception(
                        ServerClosedError("server stopped before execution"))
                    self._metrics.on_fail()
            self._cv.notify_all()
        if self._started:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            for w in self._workers:
                w.join(timeout if deadline is None
                       else max(0.0, deadline - time.monotonic()))
            if drain and any(w.is_alive() for w in self._workers):
                self._force_cancel()

    def release(self):
        """Drop the predictor references after :meth:`stop` so a paged-out
        server stops pinning device memory.  The worker threads have
        exited (or, post drain-timeout, can only be wedged inside a
        backend call that already holds its own transient reference), so
        nothing dereferences the replica list again; without this, a
        stopped in-process server keeps every bucket executable and the
        parameter arrays alive through this closure."""
        with self._cv:
            replicas, self._replicas = self._replicas, []
        for rep in replicas:
            rep.release()

    def _force_cancel(self):
        """Drain deadline expired: fail every future still outstanding
        (queued or dequeued-but-unfinished) with the typed drain error.
        The wedged worker may eventually finish its batch — ``_execute``
        guards every ``set_result`` with ``done()`` so a late completion
        is dropped, never raised."""
        exc = DrainTimeoutError(
            "drain deadline exceeded with a worker still busy; "
            "outstanding requests force-cancelled")
        cancelled = 0
        with self._cv:
            while self._q:
                item = self._q.popleft()
                if not item.future.done():
                    item.future.set_exception(exc)
                    cancelled += 1
            for item in list(self._inflight):
                if not item.future.done():
                    item.future.set_exception(exc)
                    cancelled += 1
            self._inflight.clear()
            self._cv.notify_all()
        if cancelled:
            self._metrics.on_fail(cancelled)
            from .. import telemetry as _tm

            _tm.log_event("serving_drain_timeout", cancelled=cancelled,
                          dead_workers=self.dead_workers())
        return cancelled

    # -- worker side ------------------------------------------------------
    def _collect(self):
        """Return the next batch of work items, None when closed+empty."""
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait(0.05)
            if not self._q:
                return None  # closed and drained
            # wait for the batch to fill, bounded by the flush deadline of
            # the OLDEST queued item; closing flushes immediately
            flush_at = self._q[0].t_enqueue + self.max_wait_us / 1e6
            while (len(self._q) < self.max_batch_size
                   and not self._closed and self._q):
                now = time.monotonic()
                if now >= flush_at:
                    break
                self._cv.wait(min(flush_at - now, 0.05))
                if not self._q:
                    return []  # another replica stole the backlog
            batch = []
            while self._q and len(batch) < self.max_batch_size:
                batch.append(self._q.popleft())
            self._inflight.update(batch)
            self._metrics.on_dequeue(len(self._q))
            return batch

    def _run(self, slot):
        # _execute already confines per-batch executor failures to the
        # affected futures; anything escaping to here kills this replica's
        # thread, so record it — a fully-working-looking server with dead
        # workers is exactly the failure mode /healthz must surface.
        # The replica is re-read from its slot per flush so that
        # swap_replicas() takes effect between batches.
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                if not batch:
                    continue
                self._execute(self._replicas[slot], batch)
        except BaseException as exc:
            with self._cv:
                self._dead_workers.append(
                    "%s: %r" % (threading.current_thread().name, exc))
            self._metrics.on_worker_crash()
            raise

    def _execute(self, replica, batch):
        try:
            self._execute_inner(replica, batch)
        finally:
            with self._cv:
                self._inflight.difference_update(batch)

    def _execute_inner(self, replica, batch):
        now = time.monotonic()
        live = []
        for item in batch:
            if item.future.done():
                continue  # force-cancelled by a drain deadline
            if item.deadline is not None and now > item.deadline:
                item.future.set_exception(DeadlineExceededError(
                    "request waited past its deadline"))
                self._metrics.on_expire()
            else:
                live.append(item)
        if not live:
            return
        try:
            n = len(live)
            with profiler.Frame("serving/batch[n=%d]" % n,
                                category="serving"):
                bucket, results = replica.forward_batch(
                    [item.inputs for item in live])
            self._metrics.on_batch(bucket, n)
            done = time.monotonic()
            for item, res in zip(live, results):
                # a drain-deadline force-cancel may have failed this
                # future already; a late completion is dropped, not raised
                if not item.future.done():
                    item.future.set_result(res)
                    self._metrics.on_complete((done - item.t_enqueue) * 1e3)
        except Exception as exc:  # propagate to every waiting caller
            self._metrics.on_fail(len(live))
            for item in live:
                if not item.future.done():
                    item.future.set_exception(exc)
