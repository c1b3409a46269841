"""mxnet_tpu_torch.telemetry — the observability core; counterpart of
``mxnet_tpu/telemetry/``.

One shared, thread-safe home for the instruments:

* a metrics :class:`Registry` (counters / gauges / exponential-bucket
  histograms) with a Prometheus text renderer and a JSONL structured-event
  log (:func:`log_event`);
* a span tracer whose spans from ANY thread (Module step, comm-engine
  workers, kvstore-server RPC handlers, the serving batcher) merge with
  the ``profiler.py`` events into ONE Chrome-trace timeline with
  per-thread tracks (:func:`dump_trace`);
* a :class:`StepMonitor` recording per-step wall time, data-wait,
  throughput, the card's memory watermark and achieved model-MFU (the
  eager plan's cost count, once per step key);
* a recompile detector warning — with the offending shape diff — when the
  step's input shapes change after warmup;
* the flight recorder (postmortems) and fleet aggregation
  (``distributed``).

Cost model: everything is gated by ``MXNET_TELEMETRY``.  Off (the
default), every hook in the hot path is a single module-global bool read —
no locks, no allocations, mirroring ``faults.fire``'s plan-is-None idiom.
Activate with ``MXNET_TELEMETRY=1`` in the environment or
:func:`enable` in-process.  Span capture stays on the host: telemetry
never starts ``torch.profiler`` (``profiler.profiler_set_state`` does).
Counters and gauges of the registry always count.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Optional

from ..base import env, register_env
from . import distributed, flight_recorder, tracer
from .distributed import (FleetAggregator, proc_identity, proc_label,
                          start_pusher, stop_pusher)
from .registry import (Counter, EventLog, Gauge, Histogram, LabeledCounter,
                       Registry)
from .step_monitor import (RecompileWarning, StepMonitor, fused_cost_analysis,
                           lower_and_analyze, peak_flops)

__all__ = [
    "enabled", "enable", "disable", "dump_dir", "registry", "counter",
    "gauge",
    "histogram", "labeled_counter", "log_event", "events", "events_of",
    "event_log",
    "span", "dump_trace", "merged_trace", "validate_trace",
    "render_prometheus", "register_collector", "summary",
    "current_step_monitor", "Registry", "Counter", "Gauge", "Histogram",
    "LabeledCounter", "EventLog", "StepMonitor", "RecompileWarning",
    "peak_flops", "fused_cost_analysis", "lower_and_analyze",
    "distributed", "flight_recorder", "FleetAggregator", "proc_identity",
    "proc_label", "start_pusher", "stop_pusher",
]

register_env("MXNET_TELEMETRY", 0, int,
             "Master switch for the telemetry subsystem (metrics registry, "
             "span capture, StepMonitor, recompile detector). Off: every "
             "hook is one global bool read.")
register_env("MXNET_TELEMETRY_TRACE", 1, int,
             "With telemetry on, capture Frame spans from all threads into "
             "the merged Chrome trace even when the legacy profiler is "
             "stopped (0 keeps only the profiler-run capture path).")
register_env("MXNET_TELEMETRY_TRACE_BUFFER", 65536, int,
             "Max spans kept in the telemetry trace ring buffer.")
register_env("MXNET_TELEMETRY_DIR", "", str,
             "Directory for the JSONL structured-event log "
             "(events.jsonl); empty keeps events in memory only.")
register_env("MXNET_TELEMETRY_DUMP_DIR", "", str,
             "Directory for telemetry artifacts (exit-time trace-*.json, "
             "flight-recorder postmortems when their own dirs are unset); "
             "empty uses <tmpdir>/mxnet_tpu_torch-artifacts — never the "
             "cwd.")
register_env("MXNET_TELEMETRY_MFU", 1, int,
             "Count the fused step's operations once per step key to "
             "derive achieved MFU (0 skips the count).")

# the single hot-path gate: plain module-global read, no locks
_ENABLED = False
_lock = threading.Lock()
_registry: Optional[Registry] = None
_event_log: Optional[EventLog] = None
_collectors = []  # weakrefs to objects exposing render_prometheus()
_current_monitor = None  # weakref to the most recent StepMonitor

span = tracer.span
merged_trace = tracer.merged_trace
validate_trace = tracer.validate_trace
dump_trace = tracer.dump_trace


def enabled() -> bool:
    return _ENABLED


def dump_dir() -> str:
    """Where telemetry artifacts (traces, postmortems without an explicit
    dir) land: ``MXNET_TELEMETRY_DUMP_DIR``, defaulting to a per-tmpdir
    artifacts directory.  Deliberately NEVER the cwd — test and bench
    runs must not litter the working tree."""
    d = env("MXNET_TELEMETRY_DUMP_DIR", "", str)
    if not d:
        import tempfile

        d = os.path.join(tempfile.gettempdir(), "mxnet_tpu_torch-artifacts")
    return d


def registry() -> Registry:
    """The process-global metrics registry (created on first use)."""
    global _registry
    if _registry is None:
        with _lock:
            if _registry is None:
                _registry = Registry()
    return _registry


def counter(name, doc="") -> Counter:
    return registry().counter(name, doc)


def gauge(name, doc="", fn=None) -> Gauge:
    return registry().gauge(name, doc, fn)


def histogram(name, doc="", start=0.5, factor=2.0, count=16) -> Histogram:
    return registry().histogram(name, doc, start, factor, count)


def labeled_counter(name, label, doc="") -> LabeledCounter:
    return registry().labeled_counter(name, label, doc)


def event_log() -> EventLog:
    global _event_log
    if _event_log is None:
        with _lock:
            if _event_log is None:
                d = env("MXNET_TELEMETRY_DIR", "", str)
                path = None
                if d:
                    os.makedirs(d, exist_ok=True)
                    path = os.path.join(d, "events.jsonl")
                _event_log = EventLog(path)
    return _event_log


def log_event(kind, **fields):
    """Append one structured event (no-op while telemetry is off)."""
    if not _ENABLED:
        return None
    return event_log().emit(kind, **fields)


def events(n=None):
    return event_log().tail(n) if _event_log is not None else []


def events_of(kind, n=None):
    """The tail of the structured-event log filtered to one ``kind``."""
    out = [e for e in events() if e.get("kind") == kind]
    return out if n is None else out[-int(n):]


_atexit_hooked = False


def _atexit_flush():
    """Process-exit flush for cluster observability: land one final
    metrics push on the fleet aggregator (short-lived workers would
    otherwise miss the last interval) and, with MXNET_TELEMETRY_DIR set,
    dump this process's trace to ``trace-<role><rank>.json`` so
    ``python -m mxnet_tpu_torch.tools.trace_merge`` can stitch the fleet
    timeline."""
    if not _ENABLED:
        return
    distributed.push_once()
    # trace routing: an explicit MXNET_TELEMETRY_DIR keeps its contract
    # (trace_merge stitches from there); otherwise traces go to the
    # artifacts dump dir — never the cwd
    d = env("MXNET_TELEMETRY_DIR", "", str) or dump_dir()
    if tracer.active():
        try:
            os.makedirs(d, exist_ok=True)
            dump_trace(os.path.join(
                d, "trace-%s.json" % distributed.proc_label()))
        except Exception:
            pass


def enable(trace: Optional[bool] = None) -> None:
    """Turn telemetry on in-process (the env-var path calls this at
    import).  ``trace`` overrides MXNET_TELEMETRY_TRACE."""
    global _ENABLED, _atexit_hooked
    with _lock:
        _ENABLED = True
    if trace is None:
        trace = bool(env("MXNET_TELEMETRY_TRACE", 1, int))
    if trace:
        tracer.start(env("MXNET_TELEMETRY_TRACE_BUFFER", 65536, int))
    # cluster-wide pieces: metrics pusher (only when an aggregator
    # address is configured), crash flight recorder, exit-time flush
    distributed.start_pusher()
    flight_recorder.install_excepthooks()
    if not _atexit_hooked:
        import atexit

        atexit.register(_atexit_flush)
        _atexit_hooked = True


def disable() -> None:
    global _ENABLED, _event_log
    with _lock:
        _ENABLED = False
    tracer.stop()
    distributed.stop_pusher()
    flight_recorder.uninstall_excepthooks()
    if _event_log is not None:
        _event_log.close()
        _event_log = None


def _reset_for_tests() -> None:
    """Drop all global state (registry contents, collectors, monitors)."""
    import sys

    global _registry, _event_log, _current_monitor
    disable()
    with _lock:
        _registry = None
        _event_log = None
        _current_monitor = None
        del _collectors[:]
    # instrumented modules cache registry handles lazily; stale handles
    # would keep writing to the dropped registry
    pkg = __name__.rpartition(".")[0]
    for modname, attr in (("io", "_PREFETCH_TELEM"),
                          ("kvstore_server", "_TELEM"),
                          ("compile_cache", "_instruments"),
                          ("autotune", "_instruments")):
        m = sys.modules.get("%s.%s" % (pkg, modname))
        if m is not None:
            setattr(m, attr, None)


def _set_current_monitor(mon) -> None:
    global _current_monitor
    _current_monitor = weakref.ref(mon)


def current_step_monitor() -> Optional[StepMonitor]:
    ref = _current_monitor
    return ref() if ref is not None else None


def register_collector(obj) -> None:
    """Include ``obj.render_prometheus()`` in the global metrics render —
    how per-object registries (serving servers, async kvstores) surface
    their series without sharing counters across instances.  Held by
    weakref: dead collectors drop out on the next render."""
    with _lock:
        _collectors.append(weakref.ref(obj))


def render_prometheus() -> str:
    """Prometheus text exposition: global registry + live collectors."""
    parts = [registry().render_prometheus()]
    with _lock:
        refs = list(_collectors)
    alive = []
    for ref in refs:
        obj = ref()
        if obj is None:
            continue
        alive.append(ref)
        try:
            parts.append(obj.render_prometheus())
        except Exception:
            pass
    with _lock:
        _collectors[:] = alive
    return "".join(p if p.endswith("\n") or not p else p + "\n"
                   for p in parts if p)


def summary() -> dict:
    """Compact run summary for embedding in a run's record: non-zero
    counters/gauges from the global registry plus the active StepMonitor
    report."""
    out = {}
    if _registry is not None:
        flat = {}
        for name, val in _registry.snapshot().items():
            if isinstance(val, dict):
                n = val.get("count")
                if n:
                    flat[name] = {"count": n,
                                  "sum": round(val.get("sum", 0.0), 3)}
            elif val:
                flat[name] = round(val, 3) if isinstance(val, float) else val
        if flat:
            out["counters"] = flat
    mon = current_step_monitor()
    if mon is not None:
        out["step"] = mon.report()
    if _event_log is not None and _event_log.path:
        out["events_jsonl"] = _event_log.path
    return out


# env activation at import: a process launched with MXNET_TELEMETRY=1 is
# instrumented from its very first step
if env("MXNET_TELEMETRY", 0, int):
    enable()
