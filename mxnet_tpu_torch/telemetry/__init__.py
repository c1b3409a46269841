"""Telemetry — the metrics registry half of ``mxnet_tpu/telemetry/``.

A process-global :class:`Registry` (counters / gauges / exponential-bucket
histograms / labeled counters) with a Prometheus text renderer, per-object
registries attached to that render through :func:`register_collector`
(weak references: a collected engine drops out), and a bounded
structured-event log (:func:`log_event`).

Structured events are recorded only while telemetry is on
(``MXNET_TELEMETRY=1`` at import), as in the JAX package; counters and
gauges always count.  The tracer, the flight recorder, the step monitor,
distributed aggregation, ``enable``/``disable`` and ``summary`` are not
ported yet (ROADMAP.md A.6).
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Optional

from ..base import env, register_env
from .registry import (Counter, EventLog, Gauge, Histogram, LabeledCounter,
                       Registry)

__all__ = [
    "enabled", "registry", "counter", "gauge", "histogram",
    "labeled_counter", "log_event", "events", "events_of", "event_log",
    "render_prometheus", "register_collector", "Registry", "Counter",
    "Gauge", "Histogram", "LabeledCounter", "EventLog",
]

register_env("MXNET_TELEMETRY", 0, int,
             "Master switch for the telemetry subsystem; off, structured "
             "events are not recorded (one global bool read).")
register_env("MXNET_TELEMETRY_DIR", "", str,
             "Directory for the JSONL structured-event log "
             "(events.jsonl); empty keeps events in memory only.")

# the single hot-path gate: plain module-global read, no locks
_ENABLED = bool(env("MXNET_TELEMETRY", 0, int))
_lock = threading.Lock()
_registry: Optional[Registry] = None
_event_log: Optional[EventLog] = None
_collectors = []  # weakrefs to objects exposing render_prometheus()


def enabled() -> bool:
    return _ENABLED


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


def register_collector(obj) -> None:
    """Include ``obj.render_prometheus()`` in the global metrics render —
    how per-object registries (a generation engine, its KV pool) surface
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
