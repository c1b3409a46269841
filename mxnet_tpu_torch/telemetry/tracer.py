"""Span tracer — one merged Chrome-trace timeline across every thread;
counterpart of ``mxnet_tpu/telemetry/tracer.py``.

``profiler.Frame`` spans (Module steps, comm-engine workers, the serving
batcher) normally record only while the legacy profiler is in the "run"
state.  When telemetry tracing is active this module installs itself as
the profiler's external sink, so every Frame from any thread ALSO lands in
a bounded buffer here — no profiler_set_state dance needed — and
``merged_trace()`` combines both buffers (deduplicating spans that were
recorded to each) plus per-thread ``thread_name`` metadata into a single
chrome://tracing / Perfetto-loadable JSON with one track per thread.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import profiler as _prof

__all__ = ["start", "stop", "active", "events", "merged_trace",
           "dump_trace", "validate_trace", "span", "flow_event"]

_lock = threading.Lock()
_buf: Optional[deque] = None
_tnames: Dict[int, str] = {}


def _sink(ev, tname):
    """Called by profiler.Frame/record_event on the recording thread."""
    buf = _buf
    if buf is not None:
        buf.append(ev)  # deque.append is atomic under the GIL
        _tnames[ev["tid"]] = tname


def start(buffer_size: int = 65536):
    """Begin capturing spans from all threads into a bounded buffer."""
    global _buf
    with _lock:
        if _buf is None:
            _buf = deque(maxlen=max(1, int(buffer_size)))
        _prof._set_sink(_sink)


def stop():
    global _buf
    with _lock:
        _prof._set_sink(None)
        _buf = None
        _tnames.clear()


def active() -> bool:
    return _buf is not None


def events() -> List[dict]:
    buf = _buf
    return list(buf) if buf is not None else []


def flow_event(name, phase, flow_id):
    """Record one flow event ("s" start / "f" finish) binding a span on
    this thread to its counterpart across a thread or process boundary —
    how a worker's kvstore RPC span links to the server-side handler
    span in the merged fleet trace.  No-op unless tracing is active."""
    buf = _buf
    if buf is None:
        return
    ev = {"name": name, "cat": "flow", "ph": phase, "id": flow_id,
          "ts": time.perf_counter_ns() // 1000, "pid": 0,
          "tid": _prof.trace_tid()}
    if phase == "f":
        ev["bp"] = "e"  # bind to the enclosing slice's end
    buf.append(ev)
    _tnames.setdefault(ev["tid"], threading.current_thread().name)


def span(name, category="telemetry"):
    """A named span on the merged timeline — records whenever the legacy
    profiler is running OR telemetry tracing is active (profiler.Frame
    carries the sink hookup)."""
    return _prof.Frame(name, category)


def merged_trace() -> dict:
    """ONE timeline: legacy profiler events + telemetry spans, deduped
    (a Frame recorded while both were active is the same dict object in
    both buffers), with thread_name/process_name metadata so each thread
    renders as its own named track."""
    prof_events, prof_tnames = _prof._snapshot_events()
    mine = events()
    tnames = dict(prof_tnames)
    tnames.update(_tnames)
    seen = set()
    merged = []
    for ev in prof_events + mine:
        if id(ev) in seen:
            continue
        seen.add(id(ev))
        merged.append(ev)
    # role/rank-qualified track names: dumps from different processes of
    # one job carry identically-named threads (comm-worker-0 exists in
    # every worker), so the process label keeps multi-process merges
    # (``python -m mxnet_tpu_torch.tools.trace_merge``) collision-free
    # and readable
    from .distributed import proc_label

    label = proc_label()
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": label}}]
    for tid in sorted(tnames):
        meta.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                     "args": {"name": "%s/%s" % (label, tnames[tid])}})
    return {"traceEvents": meta + merged, "displayTimeUnit": "ms"}


def dump_trace(path: str) -> str:
    payload = merged_trace()
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def validate_trace(payload: dict) -> bool:
    """Assert trace-event-schema validity (the checks chrome://tracing's
    importer actually trips on); raises ValueError on violation."""
    evs = payload.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for ev in evs:
        if not isinstance(ev, dict):
            raise ValueError("trace event is not an object: %r" % (ev,))
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str) or not isinstance(ph, str):
            raise ValueError("trace event needs string name+ph: %r" % (ev,))
        if ph == "M":
            continue
        for field in ("ts", "pid", "tid"):
            if not isinstance(ev.get(field), (int, float)):
                raise ValueError("event %r missing numeric %s"
                                 % (ev.get("name"), field))
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError("complete event %r missing dur" % ev["name"])
    return True
