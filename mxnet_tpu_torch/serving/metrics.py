"""Serving metrics — counterpart of ``mxnet_tpu/serving/metrics.py``: QPS,
latency quantiles, queue depth and batch histograms for one server.

The counters live on a private :class:`~mxnet_tpu_torch.telemetry.Registry`
registered as a collector, so the series also appear in
``telemetry.render_prometheus()``; :meth:`ServingMetrics.render_text` is the
JAX package's exposition byte for byte (the same ``mxtpu_serving_*`` names
and lines).  The latency reservoir and the QPS window are summary estimates
with no registry analogue and stay local.  Each flushed batch is also a
profiler span (``serving/batch[n=...]``, drawn by the batcher), so a
``profiler_set_state("run")``/``dump_profile()`` or the telemetry tracer
around serving traffic shows it on the timeline.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .. import telemetry as _telemetry

__all__ = ["ServingMetrics"]

# sliding window for QPS, seconds
_QPS_WINDOW = 60.0
# bounded reservoir of per-request latencies for the quantile estimates
_LATENCY_SAMPLES = 4096

_COUNTER_KEYS = ("requests_total", "requests_completed", "requests_rejected",
                 "requests_expired", "requests_failed", "worker_crashes",
                 "batches_total", "padded_items_total")


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class ServingMetrics:
    """Thread-safe counters for one :class:`InferenceServer`.

    ``batch_size_hist`` is keyed by the *bucket* (padded shape) each flush
    ran at — its key set is exactly the set of distinct compiled shapes the
    server exercised, and the sum of its counts is the number of underlying
    executor invocations.  ``occupancy_hist`` is keyed by the number of
    real (un-padded) requests in each flush.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        reg = self._registry = _telemetry.Registry()
        self._c = {k: reg.counter("mxtpu_serving_%s" % k)
                   for k in _COUNTER_KEYS}
        self._g_depth = reg.gauge("mxtpu_serving_queue_depth")
        self._g_peak = reg.gauge("mxtpu_serving_queue_depth_peak")
        self._batch_hist = reg.labeled_counter("mxtpu_serving_batch_size",
                                               "bucket")
        self._occ_hist = reg.labeled_counter("mxtpu_serving_batch_occupancy",
                                             "n")
        self._latencies = deque(maxlen=_LATENCY_SAMPLES)
        self._completions = deque()  # monotonic stamps inside _QPS_WINDOW
        _telemetry.register_collector(self)

    # -- update hooks (called by the batcher/server) ----------------------
    def on_submit(self, queue_depth):
        self._c["requests_total"].inc()
        self._g_depth.set(queue_depth)
        self._g_peak.set_max(queue_depth)

    def on_reject(self):
        self._c["requests_rejected"].inc()

    def on_expire(self, n=1):
        self._c["requests_expired"].inc(n)

    def on_fail(self, n=1):
        self._c["requests_failed"].inc(n)

    def on_worker_crash(self):
        self._c["worker_crashes"].inc()

    def on_dequeue(self, queue_depth):
        self._g_depth.set(queue_depth)

    def on_batch(self, bucket, occupancy):
        self._c["batches_total"].inc()
        self._c["padded_items_total"].inc(bucket - occupancy)
        self._batch_hist.inc(int(bucket))
        self._occ_hist.inc(int(occupancy))

    def on_complete(self, latency_ms):
        now = time.monotonic()
        self._c["requests_completed"].inc()
        with self._lock:
            self._latencies.append(latency_ms)
            self._completions.append(now)
            cutoff = now - _QPS_WINDOW
            while self._completions and self._completions[0] < cutoff:
                self._completions.popleft()

    # -- export -----------------------------------------------------------
    def qps(self):
        now = time.monotonic()
        with self._lock:
            cutoff = now - _QPS_WINDOW
            while self._completions and self._completions[0] < cutoff:
                self._completions.popleft()
            span = min(max(now - self._t0, 1e-9), _QPS_WINDOW)
            return len(self._completions) / span

    def snapshot(self):
        """One consistent dict of everything (the JSON-side export)."""
        qps = self.qps()
        with self._lock:
            lat = sorted(self._latencies)
        out = {k: self._c[k].value for k in _COUNTER_KEYS}
        out.update({
            "queue_depth": self._g_depth.value,
            "queue_depth_peak": self._g_peak.value,
            "batch_size_hist": self._batch_hist.snapshot(),
            "occupancy_hist": self._occ_hist.snapshot(),
            "latency_ms_p50": _percentile(lat, 0.50),
            "latency_ms_p99": _percentile(lat, 0.99),
            "qps": qps,
        })
        return out

    def render_text(self):
        """Prometheus text exposition of :meth:`snapshot` — byte-compatible
        with the pre-registry renderer for every metric name."""
        s = self.snapshot()
        lines = []
        for key in _COUNTER_KEYS:
            lines.append("# TYPE mxtpu_serving_%s counter" % key)
            lines.append("mxtpu_serving_%s %d" % (key, s[key]))
        lines.append("# TYPE mxtpu_serving_queue_depth gauge")
        lines.append("mxtpu_serving_queue_depth %d" % s["queue_depth"])
        lines.append("mxtpu_serving_queue_depth_peak %d"
                     % s["queue_depth_peak"])
        lines.append("# TYPE mxtpu_serving_batch_size histogram")
        for b in sorted(s["batch_size_hist"]):
            lines.append('mxtpu_serving_batch_size{bucket="%d"} %d'
                         % (b, s["batch_size_hist"][b]))
        for n in sorted(s["occupancy_hist"]):
            lines.append('mxtpu_serving_batch_occupancy{n="%d"} %d'
                         % (n, s["occupancy_hist"][n]))
        lines.append("# TYPE mxtpu_serving_latency_ms summary")
        lines.append('mxtpu_serving_latency_ms{quantile="0.5"} %.3f'
                     % s["latency_ms_p50"])
        lines.append('mxtpu_serving_latency_ms{quantile="0.99"} %.3f'
                     % s["latency_ms_p99"])
        lines.append("# TYPE mxtpu_serving_qps gauge")
        lines.append("mxtpu_serving_qps %.3f" % s["qps"])
        return "\n".join(lines) + "\n"

    def render_prometheus(self):
        """Collector hook for ``telemetry.render_prometheus()``."""
        return self.render_text()
