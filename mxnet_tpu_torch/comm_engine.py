"""comm_engine — dependency-scheduled asynchronous kvstore communication,
counterpart of ``mxnet_tpu/comm_engine.py``.

* :class:`CommEngine` — every operation names the keys it touches; ops on
  one key run in submission order, ops on disjoint keys run concurrently on
  a worker pool (``MXNET_KVSTORE_ASYNC_THREADS``), and among *ready* ops the
  highest ``priority`` wins (Module passes ``priority=-index``).  Failures
  are recorded and raised at the next barrier.
* :class:`AsyncKVStore` — wraps any store and turns push/pull into engine
  submissions.  Completion is observed through ``wait(keys)``/
  ``wait_all()``, or when a pulled-into NDArray is read (``asnumpy``/
  ``wait_to_read``: the read guard installed in ``ndarray.py``).  The
  executor reads parameter tensors directly, so ``Module`` waits
  (``_wait_async_comm``) before a forward reads them.
* Gradient coalescing — keys whose payload is at most
  ``MXNET_KVSTORE_BUCKET_BYTES`` are packed into fused bucket messages when
  the wrapped store speaks the batched wire protocol (``push_multi``/
  ``pull_multi``: ``dist_async``); a bucket travels under one idempotency
  token, so exactly-once replay covers it whole.

An op submitted from a thread that runs CUDA work is launched by the worker
on the stream the submitter was using on each device its arrays live on,
so the updater's kernels queue behind the backward that produced the
gradients, and the next forward's behind them.

Per-key FIFO makes the per-key update sequence identical to the
synchronous path, so async training reaches bit-identical weights.  Each
op runs inside a profiler span named by its label (``comm.push``,
``comm.pull_bucket``, ...) on its worker's track, and while the tracer is
active a flow event links the submitting thread to it.
:meth:`AsyncKVStore.sparse_plane` binds the row-sparse plane
(``sparse/plane.py``) to the engine's chains.
"""
from __future__ import annotations

import atexit
import contextlib
import heapq
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List

import numpy as np

from . import profiler as _prof
from .base import MXNetError, register_env
from .ndarray import NDArray
from . import ndarray as _nd_mod
from .kvstore import KVStore, _key_list, _val_list
from .telemetry import tracer as _tracer

__all__ = ["CommEngine", "AsyncKVStore", "CommMetrics", "make_async",
           "maybe_async"]

register_env("MXNET_KVSTORE_ASYNC", 1, int,
             "Wrap the Module kvstore update path in the async comm "
             "engine (0 restores the fully synchronous push/pull loop).")
register_env("MXNET_KVSTORE_ASYNC_THREADS", 2, int,
             "Worker threads in the kvstore comm engine.")
register_env("MXNET_KVSTORE_BUCKET_BYTES", 65536, int,
             "Coalesce pushes/pulls of keys under this many bytes into "
             "fused bucket RPCs (0 disables bucketing).")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
class CommMetrics:
    """Comm-plane counters on a per-store telemetry ``Registry``
    (``mxtpu_comm_*`` series, registered as a collector so they appear in
    the global Prometheus render); ``snapshot()`` is the dict view
    ``comm_stats()`` returns."""

    _COUNTERS = ("pushes", "pulls", "bytes_pushed", "bytes_pulled",
                 "bucket_flushes", "bucket_keys", "wait_calls")

    def __init__(self):
        from . import telemetry as _tm

        self._reg = _tm.Registry()
        self._c = {k: self._reg.counter("mxtpu_comm_%s" % k)
                   for k in self._COUNTERS}
        self._c["wait_ms_total"] = self._reg.counter(
            "mxtpu_comm_wait_ms_total",
            "Total time blocked in engine waits (ms).")
        self._fill_sum = self._reg.counter(
            "mxtpu_comm_bucket_fill_ratio_sum",
            "Sum of per-flush bucket fill ratios (/ flushes = avg fill).")
        self._wait_hist = self._reg.histogram(
            "mxtpu_comm_wait_ms_hist",
            "Per-call engine wait time (ms).",
            start=0.05, factor=4.0, count=10)
        _tm.register_collector(self)

    def add(self, name, n=1):
        self._c[name].inc(n)

    def note_bucket(self, nkeys, nbytes, capacity):
        self._c["bucket_flushes"].inc()
        self._c["bucket_keys"].inc(nkeys)
        if capacity > 0:
            self._fill_sum.inc(min(1.0, nbytes / float(capacity)))

    def note_wait(self, seconds):
        ms = seconds * 1e3
        self._c["wait_calls"].inc()
        self._c["wait_ms_total"].inc(ms)
        self._wait_hist.observe(ms)

    def add_live_gauge(self, name, fn, doc=""):
        """Register a callback gauge (queue depth, inflight RPCs) read at
        render/snapshot time."""
        self._reg.gauge("mxtpu_comm_%s" % name, doc, fn=fn)

    def render_prometheus(self):
        return self._reg.render_prometheus()

    def snapshot(self):
        d = {k: c.value for k, c in self._c.items()}
        flushes = d["bucket_flushes"]
        d["bucket_fill_ratio"] = (self._fill_sum.value / flushes
                                  if flushes else 0.0)
        d["avg_wait_ms"] = (d["wait_ms_total"] / d["wait_calls"]
                            if d["wait_calls"] else 0.0)
        return d


# ---------------------------------------------------------------------------
# the dependency-tracking dispatcher
# ---------------------------------------------------------------------------
class _Op:
    __slots__ = ("fn", "keys", "priority", "seq", "label", "nleft",
                 "event", "exc", "cleanup", "flow_id")

    def __init__(self, fn, keys, priority, seq, label, cleanup):
        self.fn = fn
        self.keys = keys          # unique, in submission order
        self.priority = priority
        self.seq = seq
        self.label = label
        self.cleanup = cleanup
        self.nleft = 0            # chains where a predecessor still runs
        self.event = threading.Event()
        self.exc = None
        self.flow_id = None


_ENGINES = weakref.WeakSet()


@atexit.register
def _drain_at_exit():
    """Let every live engine finish its queue before the interpreter tears
    down: a worker thread still inside a tensor op at shutdown aborts the
    process."""
    for eng in list(_ENGINES):
        eng.shutdown()


class CommEngine:
    """Per-key FIFO chains + a priority heap over the ready set + a worker
    pool.  An op is *ready* when it is at the head of every key chain it
    participates in; among ready ops the highest ``priority`` (FIFO within
    a priority, by submission seq) runs first."""

    def __init__(self, num_threads=None, name="kvcomm"):
        if num_threads is None:
            num_threads = int(os.environ.get(
                "MXNET_KVSTORE_ASYNC_THREADS", "2"))
        self.num_threads = max(1, int(num_threads))
        self._lock = threading.Lock()
        self._ready_cv = threading.Condition(self._lock)
        self._idle_cv = threading.Condition(self._lock)
        self._chains: Dict[object, deque] = {}
        self._ready: List[tuple] = []   # heap of (-priority, seq, op)
        self._seq = 0
        self._outstanding = 0
        self.peak_outstanding = 0
        self._failures: List[_Op] = []
        self._stop = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name="%s-%d" % (name, i))
            for i in range(self.num_threads)]
        for t in self._threads:
            t.start()
        _ENGINES.add(self)

    # -- submission --------------------------------------------------------
    def submit(self, fn, keys, priority=0, label=None, cleanup=None) -> _Op:
        """Enqueue ``fn`` touching ``keys``; returns the op handle (its
        ``event`` is set on completion, ``exc`` carries a failure)."""
        ukeys = list(dict.fromkeys(keys))
        with self._lock:
            if self._stop:
                raise MXNetError("CommEngine is shut down")
            self._seq += 1
            op = _Op(fn, ukeys, priority, self._seq, label, cleanup)
            for k in ukeys:
                chain = self._chains.setdefault(k, deque())
                chain.append(op)
                if len(chain) > 1:
                    op.nleft += 1
            self._outstanding += 1
            if self._outstanding > self.peak_outstanding:
                self.peak_outstanding = self._outstanding
            if op.nleft == 0:
                heapq.heappush(self._ready, (-op.priority, op.seq, op))
                self._ready_cv.notify()
        if _tracer.active():
            # flow arrow from the submitting thread to the worker-thread
            # span executing the op (the finish lands in _worker)
            op.flow_id = "comm-%d-%d" % (os.getpid(), op.seq)
            _tracer.flow_event(op.label or "comm.op", "s", op.flow_id)
        return op

    def outstanding(self):
        with self._lock:
            return self._outstanding

    # -- worker ------------------------------------------------------------
    def _worker(self):
        while True:
            with self._lock:
                while not self._ready and not self._stop:
                    self._ready_cv.wait()
                if self._stop and not self._ready:
                    return
                _, _, op = heapq.heappop(self._ready)
            try:
                with _prof.Frame(op.label or "comm.op", "comm"):
                    if op.flow_id is not None:
                        _tracer.flow_event(op.label or "comm.op", "f",
                                           op.flow_id)
                    op.fn()
            except BaseException as e:  # recorded, raised at the barrier
                op.exc = e
            if op.cleanup is not None:
                try:
                    op.cleanup(op)
                except Exception:
                    pass
            with self._lock:
                for k in op.keys:
                    chain = self._chains[k]
                    chain.popleft()  # == op: it was the head everywhere
                    if not chain:
                        del self._chains[k]
                    else:
                        nxt = chain[0]
                        nxt.nleft -= 1
                        if nxt.nleft == 0:
                            heapq.heappush(self._ready,
                                           (-nxt.priority, nxt.seq, nxt))
                            self._ready_cv.notify()
                self._outstanding -= 1
                if op.exc is not None:
                    self._failures.append(op)
                op.event.set()
                if self._outstanding == 0:
                    self._idle_cv.notify_all()

    # -- barriers ----------------------------------------------------------
    def wait(self, keys):
        """Block until every submitted op touching ``keys`` completed
        (the engine's WaitForVar)."""
        tails = []
        with self._lock:
            for k in keys:
                chain = self._chains.get(k)
                if chain:
                    tails.append(chain[-1])
        for op in tails:
            op.event.wait()
        self.raise_failures()

    def wait_all(self, timeout=None):
        """Block until the engine drains (WaitForAll), then surface the
        first recorded failure.  With ``timeout`` (seconds) the wait is
        bounded: returns False if ops were still outstanding when it
        expired (nothing is cancelled), True when drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle_cv:
            while self._outstanding:
                if deadline is None:
                    self._idle_cv.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle_cv.wait(left)
        self.raise_failures()
        return True

    def raise_failures(self):
        with self._lock:
            if not self._failures:
                return
            failed, self._failures = self._failures[:], []
        first = failed[0]
        raise MXNetError(
            "async kvstore op %r failed: %s: %s%s"
            % (first.label or "comm.op", type(first.exc).__name__, first.exc,
               (" (+%d more failures)" % (len(failed) - 1))
               if len(failed) > 1 else "")) from first.exc

    def shutdown(self):
        """Stop taking ops; the workers finish the queued ones and exit."""
        with self._lock:
            self._stop = True
            self._ready_cv.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()


# ---------------------------------------------------------------------------
# implicit completion: the NDArray read guard (WaitToRead contract)
# ---------------------------------------------------------------------------
class _ReadTicket:
    """Marks NDArrays an in-flight pull writes into."""

    __slots__ = ("owner", "ids", "op")

    def __init__(self, owner, ids):
        self.owner = owner
        self.ids = ids
        self.op = None


_READS: Dict[int, _ReadTicket] = {}
_READS_LOCK = threading.Lock()


def _read_guard(arr):
    ticket = _READS.get(id(arr))
    if ticket is not None:
        ticket.owner._resolve_ticket(ticket)


def _install_read_guard():
    if _nd_mod._async_read_guard is None:
        _nd_mod._async_read_guard = _read_guard


def _register_ticket(ticket):
    with _READS_LOCK:
        for aid in ticket.ids:
            _READS[aid] = ticket


def _drop_ticket(ticket):
    with _READS_LOCK:
        for aid in ticket.ids:
            if _READS.get(aid) is ticket:
                del _READS[aid]


def _est_bytes(arr):
    size = 1
    for d in arr.shape:
        size *= int(d)
    dt = arr.dtype
    return size * (2 if dt == "bfloat16" else np.dtype(dt).itemsize)


def _streams_of(arrays):
    """The streams the calling thread is using now, on each CUDA device of
    ``arrays``, as {device: stream}."""
    import torch

    devices = {a._data.device for a in arrays
               if isinstance(a, NDArray) and a._data.is_cuda}
    return {d: torch.cuda.current_stream(d) for d in devices}


def _scope(streams):
    """A context manager that puts the calling thread on ``streams``."""
    import torch

    stack = contextlib.ExitStack()
    for s in streams.values():
        stack.enter_context(torch.cuda.stream(s))
    return stack


class _PendingEntry:
    """A push or pull waiting in a coalescing bucket."""

    __slots__ = ("key", "vals", "outs", "priority", "nbytes", "ticket",
                 "streams")

    def __init__(self, key, vals=None, outs=None, priority=0, nbytes=0,
                 ticket=None, streams=None):
        self.key = key
        self.vals = vals
        self.outs = outs
        self.priority = priority
        self.nbytes = nbytes
        self.ticket = ticket
        self.streams = streams


# ---------------------------------------------------------------------------
# the async wrapper
# ---------------------------------------------------------------------------
class AsyncKVStore(KVStore):
    """Non-blocking facade over a KVStore: ``push``/``pull`` return at once
    (engine submissions with per-key FIFO + priority), ``wait``/
    ``wait_all`` are the explicit barriers, and reading a pulled-into
    NDArray blocks implicitly.  Control-plane calls (init, set_optimizer,
    barrier, optimizer-state IO) drain the engine first.

    Keys whose payload is at most ``bucket_bytes`` coalesce into fused
    multi-key RPCs when the wrapped store implements ``push_multi``/
    ``pull_multi`` (``dist_async`` does); ``bucket_bytes=0`` disables
    coalescing.  A bucket is submitted when it fills, when a later op on
    one of its keys needs it out first (per-key order holds across
    buckets), and at every wait."""

    def __init__(self, kv, num_threads=None, bucket_bytes=None):
        if isinstance(kv, AsyncKVStore):
            raise MXNetError("kvstore is already async")
        self._kv = kv
        self._type = kv.type
        if num_threads is None and "_sync" in kv.type:
            # collective push path: the collectives' issue order must be
            # identical on every worker — one thread keeps it serial
            num_threads = 1
        self._engine = CommEngine(num_threads)
        if bucket_bytes is None:
            bucket_bytes = int(os.environ.get(
                "MXNET_KVSTORE_BUCKET_BYTES", "65536"))
        can_bucket = hasattr(kv, "push_multi") and hasattr(kv, "pull_multi")
        self._bucket_bytes = int(bucket_bytes) if can_bucket else 0
        self._buf_lock = threading.RLock()
        self._push_buf: List[_PendingEntry] = []
        self._push_keys = set()
        self._push_bytes = 0
        self._pull_buf: List[_PendingEntry] = []
        self._pull_keys = set()
        self._pull_bytes = 0
        self.metrics = CommMetrics()
        eng = self._engine
        self.metrics.add_live_gauge(
            "queue_depth", eng.outstanding,
            "Ops queued or running in the comm engine.")
        self.metrics.add_live_gauge(
            "queue_peak", lambda e=eng: e.peak_outstanding,
            "High-watermark of engine queue depth.")
        wself = weakref.ref(self)

        def inflight():
            s = wself()
            clients = getattr(s._kv, "_clients", None) if s else None
            return sum(len(getattr(c, "_inflight", ()))
                       for c in clients) if clients else 0

        self.metrics.add_live_gauge(
            "inflight_rpcs", inflight,
            "Pipelined RPCs awaiting replies across transport clients.")
        _install_read_guard()

    # -- identity ----------------------------------------------------------
    @property
    def inner(self):
        return self._kv

    @property
    def rank(self):
        return self._kv.rank

    @property
    def num_workers(self):
        return self._kv.num_workers

    def __getattr__(self, name):
        # anything not overridden falls through to the wrapped store
        return getattr(self.__dict__["_kv"], name)

    # -- bucketing ---------------------------------------------------------
    def _flush_pushes_locked(self):
        if not self._push_buf:
            return
        entries, self._push_buf = self._push_buf, []
        self._push_keys = set()
        nbytes, self._push_bytes = self._push_bytes, 0
        keys = [e.key for e in entries]
        pri = max(e.priority for e in entries)
        streams = {d: s for e in entries for d, s in e.streams.items()}
        if len(entries) == 1:
            e = entries[0]

            def fn(kv=self._kv, e=e):
                with _scope(streams):
                    kv.push(e.key, e.vals, priority=e.priority)
            label = "comm.push"
        else:
            pairs = [(e.key, e.vals) for e in entries]

            def fn(kv=self._kv, pairs=pairs):
                with _scope(streams):
                    kv.push_multi(pairs)
            label = "comm.push_bucket"
            self.metrics.note_bucket(len(entries), nbytes,
                                     self._bucket_bytes)
        self._engine.submit(fn, keys, pri, label=label)

    def _flush_pulls_locked(self):
        if not self._pull_buf:
            return
        entries, self._pull_buf = self._pull_buf, []
        self._pull_keys = set()
        nbytes, self._pull_bytes = self._pull_bytes, 0
        keys = [e.key for e in entries]
        pri = max(e.priority for e in entries)
        tickets = [e.ticket for e in entries]
        streams = {d: s for e in entries for d, s in e.streams.items()}

        def cleanup(op, tickets=tickets):
            for t in tickets:
                _drop_ticket(t)

        if len(entries) == 1:
            e = entries[0]

            def fn(kv=self._kv, e=e):
                with _scope(streams):
                    kv.pull(e.key, e.outs, priority=e.priority)
            label = "comm.pull"
        else:
            pairs = [(e.key, e.outs) for e in entries]

            def fn(kv=self._kv, pairs=pairs):
                with _scope(streams):
                    kv.pull_multi(pairs)
            label = "comm.pull_bucket"
            self.metrics.note_bucket(len(entries), nbytes,
                                     self._bucket_bytes)
        op = self._engine.submit(fn, keys, pri, label=label,
                                 cleanup=cleanup)
        for t in tickets:
            t.op = op

    def flush(self):
        """Submit any coalescing buffers to the engine (non-blocking)."""
        with self._buf_lock:
            self._flush_pushes_locked()
            self._flush_pulls_locked()

    def _resolve_ticket(self, ticket):
        """Read-guard path: an NDArray a pending pull targets is being
        read — flush the pull if it is still buffered, then wait it out."""
        if ticket.op is None:
            with self._buf_lock:
                if ticket.op is None:
                    self._flush_pulls_locked()
        op = ticket.op
        if op is None:
            return
        if not op.event.is_set():
            t0 = time.perf_counter()
            op.event.wait()
            self.metrics.note_wait(time.perf_counter() - t0)
        if op.exc is not None:
            self._engine.raise_failures()

    # -- data plane --------------------------------------------------------
    def push(self, key, value, priority=0):
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            # hold the current tensors: the executor rebinds its gradient
            # arrays to new tensors next batch, so the deferred push reads
            # this batch's values
            snap = [NDArray(v._data, v.context) if isinstance(v, NDArray)
                    else _nd_mod.array(v) for v in vlist]
            nbytes = _est_bytes(snap[0])
            self.metrics.add("pushes")
            self.metrics.add("bytes_pushed", nbytes)
            streams = _streams_of(snap)
            with self._buf_lock:
                if k in self._pull_keys:
                    self._flush_pulls_locked()  # keep per-key FIFO
                if 0 < nbytes <= self._bucket_bytes:
                    self._push_buf.append(_PendingEntry(
                        k, vals=snap, priority=priority, nbytes=nbytes,
                        streams=streams))
                    self._push_keys.add(k)
                    self._push_bytes += nbytes
                    if self._push_bytes >= self._bucket_bytes:
                        self._flush_pushes_locked()
                    continue
                if k in self._push_keys:
                    self._flush_pushes_locked()

                def fn(kv=self._kv, k=k, snap=snap, p=priority):
                    with _scope(streams):
                        kv.push(k, snap, priority=p)

                self._engine.submit(fn, [k], priority, label="comm.push")

    def pull(self, key, out=None, priority=0):
        keys, _ = _key_list(key)
        outs = _val_list(out, len(keys))
        for k, olist in zip(keys, outs):
            nbytes = _est_bytes(olist[0])
            self.metrics.add("pulls")
            self.metrics.add("bytes_pulled", nbytes)
            ticket = _ReadTicket(self, [id(o) for o in olist])
            _register_ticket(ticket)
            streams = _streams_of(olist)
            with self._buf_lock:
                if k in self._push_keys:
                    self._flush_pushes_locked()  # the pull sees the push
                if k in self._pull_keys:
                    self._flush_pulls_locked()
                if 0 < nbytes <= self._bucket_bytes:
                    self._pull_buf.append(_PendingEntry(
                        k, outs=olist, priority=priority, nbytes=nbytes,
                        ticket=ticket, streams=streams))
                    self._pull_keys.add(k)
                    self._pull_bytes += nbytes
                    if self._pull_bytes >= self._bucket_bytes:
                        self._flush_pulls_locked()
                    continue

                def fn(kv=self._kv, k=k, olist=olist, p=priority):
                    with _scope(streams):
                        kv.pull(k, olist, priority=p)

                ticket.op = self._engine.submit(
                    fn, [k], priority, label="comm.pull",
                    cleanup=lambda op, t=ticket: _drop_ticket(t))

    # -- barriers ----------------------------------------------------------
    def wait(self, keys=None):
        """Block until ops touching ``keys`` (or everything, when None)
        completed."""
        if keys is None:
            return self.wait_all()
        keys, _ = _key_list(keys)
        self.flush()
        t0 = time.perf_counter()
        self._engine.wait(keys)
        self.metrics.note_wait(time.perf_counter() - t0)

    def wait_all(self, timeout=None):
        self.flush()
        t0 = time.perf_counter()
        done = self._engine.wait_all(timeout)
        self.metrics.note_wait(time.perf_counter() - t0)
        return done

    def drain(self, timeout=None):
        """The preemption drain: flush the buckets and wait — bounded by
        ``timeout`` seconds — for every in-flight op, swallowing op
        failures (a worker about to leave gets its last gradients out if
        it can).  Returns True when the engine drained."""
        try:
            return bool(self.wait_all(timeout))
        except MXNetError:
            return True  # drained; pending failures surfaced and dropped

    def sparse_plane(self):
        """Build (once) the row-sparse parameter plane bound to this
        engine: sparse pushes ride the same per-key FIFO chains as dense
        traffic (keys ``("sparse", key)``), so they pipeline with compute
        and a pull always observes the pushes submitted before it."""
        plane = self.__dict__.get("_sparse_plane")
        if plane is None:
            from .sparse.plane import SparseParamPlane

            plane = SparseParamPlane(self)
            self.__dict__["_sparse_plane"] = plane
        return plane

    # -- control plane (drain first) ----------------------------------------
    def init(self, key, value):
        self.wait_all()
        self._kv.init(key, value)

    def set_optimizer(self, optimizer):
        self.wait_all()
        self._kv.set_optimizer(optimizer)

    def _set_updater(self, updater):
        self.wait_all()
        self._kv._set_updater(updater)

    def _barrier(self):
        self.wait_all()
        self._kv._barrier()

    def _send_command_to_servers(self, head, body):
        self.wait_all()
        self._kv._send_command_to_servers(head, body)

    def save_optimizer_states(self, fname):
        self.wait_all()
        self._kv.save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        self.wait_all()
        self._kv.load_optimizer_states(fname)

    def get_num_dead_node(self, node_id=0, timeout=None):
        return self._kv.get_num_dead_node(node_id, timeout) \
            if hasattr(self._kv, "get_num_dead_node") else 0

    # -- observability -----------------------------------------------------
    def comm_stats(self):
        """Snapshot of the comm counters and live gauges: the engine's
        queue depth and peak and, over a server fleet, the transport's
        in-flight requests."""
        d = self.metrics.snapshot()
        d["queue_depth"] = self._engine.outstanding()
        d["queue_peak"] = self._engine.peak_outstanding
        clients = getattr(self._kv, "_clients", None)
        if clients:
            d["inflight_requests"] = sum(
                len(getattr(c, "_inflight", ())) for c in clients)
            d["inflight_peak"] = max(
                getattr(c, "max_inflight", 0) for c in clients)
        return d

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        try:
            self.wait_all()
        except MXNetError:
            pass  # teardown: pending failures already surfaced or moot
        self._engine.shutdown()
        if hasattr(self._kv, "close"):
            self._kv.close()

    def __del__(self):
        try:
            self._engine.shutdown()
        except Exception:
            pass


def make_async(kv, num_threads=None, bucket_bytes=None) -> AsyncKVStore:
    """Wrap ``kv`` in the comm engine; a no-op on an already-async store."""
    if isinstance(kv, AsyncKVStore):
        return kv
    return AsyncKVStore(kv, num_threads=num_threads,
                        bucket_bytes=bucket_bytes)


def maybe_async(kv):
    """Module's policy hook: wrap unless ``MXNET_KVSTORE_ASYNC=0``."""
    if os.environ.get("MXNET_KVSTORE_ASYNC", "1") == "0":
        return kv
    if kv is None or isinstance(kv, AsyncKVStore):
        return kv
    return AsyncKVStore(kv)
