"""Metrics registry — counters, gauges, histograms, and a JSONL event log.

Counterpart of ``mxnet_tpu/telemetry/registry.py``, carried whole (stdlib
only): the storage layer of ``mxnet_tpu_torch.telemetry``.  Instrumented
subsystems (the generation engine and its KV pool) create their
instruments here, and one Prometheus text renderer / one snapshot walk
exports them all.

Thread-safety: each instrument carries its own lock; the registry dict is
guarded separately for get-or-create.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "LabeledCounter", "Registry",
           "EventLog"]


def _fmt(v):
    """Prometheus sample value: ints render bare, floats keep precision."""
    if isinstance(v, float) and not v.is_integer():
        return "%.6g" % v
    return "%d" % int(v)


class Counter:
    """Monotonic counter (float increments allowed for ms/bytes totals)."""

    __slots__ = ("name", "doc", "_lock", "_v")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def render(self) -> List[str]:
        return ["# TYPE %s counter" % self.name,
                "%s %s" % (self.name, _fmt(self._v))]


class Gauge:
    """Last-value gauge; ``fn`` makes it a live probe read at render time
    (queue depths, inflight counts) instead of a stored sample."""

    __slots__ = ("name", "doc", "_lock", "_v", "_fn")

    def __init__(self, name: str, doc: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._v = 0
        self._fn = fn

    def set(self, v):
        with self._lock:
            self._v = v

    def inc(self, n=1):
        with self._lock:
            self._v += n

    def dec(self, n=1):
        self.inc(-n)

    def set_max(self, v):
        """Watermark update: keep the max of the current and new value."""
        with self._lock:
            if v > self._v:
                self._v = v

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return 0
        return self._v

    def render(self) -> List[str]:
        return ["# TYPE %s gauge" % self.name,
                "%s %s" % (self.name, _fmt(self.value))]


class Histogram:
    """Histogram over exponential buckets: upper bounds
    ``start * factor**i`` for i in [0, count), plus +Inf."""

    __slots__ = ("name", "doc", "_lock", "bounds", "_counts", "_sum", "_n")

    def __init__(self, name: str, doc: str = "", start: float = 0.5,
                 factor: float = 2.0, count: int = 16):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self.bounds = [start * (factor ** i) for i in range(count)]
        self._counts = [0] * (count + 1)  # last slot: +Inf
        self._sum = 0.0
        self._n = 0

    def observe(self, v):
        i = 0
        bounds = self.bounds
        while i < len(bounds) and v > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self):
        return self._n

    @property
    def sum(self):
        return self._sum

    def snapshot(self):
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        cum, buckets = 0, []
        for bound, c in zip(self.bounds + [float("inf")], counts):
            cum += c
            buckets.append((bound, cum))
        return {"buckets": buckets, "sum": total, "count": n}

    def render(self) -> List[str]:
        s = self.snapshot()
        lines = ["# TYPE %s histogram" % self.name]
        for bound, cum in s["buckets"]:
            le = "+Inf" if bound == float("inf") else "%.6g" % bound
            lines.append('%s_bucket{le="%s"} %d' % (self.name, le, cum))
        lines.append("%s_sum %s" % (self.name, _fmt(s["sum"])))
        lines.append("%s_count %d" % (self.name, s["count"]))
        return lines


class LabeledCounter:
    """Counter family over one label dimension — sparse exact-value
    histograms (batch buckets, fault kinds, RPC commands)."""

    __slots__ = ("name", "doc", "label", "_lock", "_c")

    def __init__(self, name: str, label: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self.label = label
        self._lock = threading.Lock()
        self._c: Dict[object, float] = {}

    def inc(self, label_value, n=1):
        with self._lock:
            self._c[label_value] = self._c.get(label_value, 0) + n

    def get(self, label_value, default=0):
        return self._c.get(label_value, default)

    def snapshot(self):
        with self._lock:
            return dict(self._c)

    @property
    def value(self):
        with self._lock:
            return sum(self._c.values())

    def render(self) -> List[str]:
        lines = ["# TYPE %s counter" % self.name]
        for k in sorted(self._c, key=str):
            lines.append('%s{%s="%s"} %s'
                         % (self.name, self.label, k, _fmt(self._c[k])))
        return lines


class Registry:
    """Named instrument collection with get-or-create semantics.

    One process-global instance backs the framework (``telemetry.registry()``);
    subsystems that need isolated counts per object (a serving server, an
    async kvstore) build their own and attach it to the global render via
    ``telemetry.register_collector``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: "OrderedDict[str, object]" = OrderedDict()

    def _get_or_create(self, name, cls, *args, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError("instrument %r already registered as %s"
                                % (name, type(inst).__name__))
            return inst

    def counter(self, name, doc="") -> Counter:
        return self._get_or_create(name, Counter, doc)

    def gauge(self, name, doc="", fn=None) -> Gauge:
        return self._get_or_create(name, Gauge, doc, fn)

    def histogram(self, name, doc="", start=0.5, factor=2.0,
                  count=16) -> Histogram:
        return self._get_or_create(name, Histogram, doc, start, factor, count)

    def labeled_counter(self, name, label, doc="") -> LabeledCounter:
        return self._get_or_create(name, LabeledCounter, label, doc)

    def get(self, name):
        return self._instruments.get(name)

    def snapshot(self) -> Dict[str, object]:
        """name -> scalar (counter/gauge) or dict (histogram/labeled)."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            if isinstance(inst, (Histogram, LabeledCounter)):
                out[name] = inst.snapshot()
            else:
                out[name] = inst.value
        return out

    def render_prometheus(self) -> str:
        with self._lock:
            items = list(self._instruments.values())
        lines: List[str] = []
        for inst in items:
            lines.extend(inst.render())
        return "\n".join(lines) + ("\n" if lines else "")


class EventLog:
    """Bounded in-memory structured-event buffer, optionally mirrored to a
    JSONL file (``MXNET_TELEMETRY_DIR/events.jsonl``) for post-hoc tooling
    (tools/telemetry_dump.py)."""

    def __init__(self, path: Optional[str] = None, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._buf = deque(maxlen=maxlen)
        self._path = path
        self._fh = open(path, "a", buffering=1) if path else None

    @property
    def path(self):
        return self._path

    def emit(self, kind: str, **fields):
        rec = {"ts": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._buf.append(rec)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec, default=str) + "\n")
                except ValueError:  # closed file during teardown
                    pass
        return rec

    def tail(self, n: Optional[int] = None):
        with self._lock:
            evs = list(self._buf)
        return evs if n is None else evs[-n:]

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None
