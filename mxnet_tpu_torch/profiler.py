"""Profiler — counterpart of ``mxnet_tpu/profiler.py`` (the reference's
python/mxnet/profiler.py:10-38 over src/engine/profiler.{h,cc}).

The API is the reference's: ``profiler_set_config``, ``profiler_set_state``,
``dump_profile``, ``pause``/``resume``, plus the JAX package's ``Frame``
span and ``trace_tid``.  ``dump_profile`` writes the python-level spans as
a Chrome-trace JSON, loadable in chrome://tracing.

Where the JAX package starts a ``jax.profiler`` trace of the TPU,
``profiler_set_state("run")`` starts a ``torch.profiler`` trace of CPU and
CUDA activity (CUPTI on the card); ``"stop"`` writes it as a Chrome trace
beside ``filename`` (``<filename without extension>_kineto.json``, where
the JAX package writes its ``_xplane`` directory).  While that trace runs,
every ``Frame`` also opens a ``torch.profiler.record_function`` range, so
the card's kernels group under the span's name on the device timeline.

Telemetry's span capture (``MXNET_TELEMETRY=1``) goes through the sink
(``_set_sink``) and never starts ``torch.profiler``: spans stay host-side,
and the device trace runs only when the caller asks for it.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .base import env, register_env

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "pause", "resume", "Frame", "trace_tid", "device_trace_path"]

_state = {"mode": "symbolic", "filename": "profile.json", "running": False,
          "events": [], "tnames": {}, "torch_prof": None,
          "device_trace": None, "lock": threading.Lock()}

# Synthetic per-thread track ids.  ``threading.get_ident()`` values are
# recycled by the OS the moment a thread exits, so a fresh worker could
# inherit a dead worker's ident and rename its track in the merged
# thread_name metadata.  Every thread gets a monotonically increasing id on
# first use: one track per actual thread for the life of the process.
_tid_local = threading.local()
_tid_next = [1]


def trace_tid() -> int:
    """This thread's stable trace-track id (never reused across threads)."""
    tid = getattr(_tid_local, "tid", None)
    if tid is None:
        with _state["lock"]:
            tid = _tid_next[0]
            _tid_next[0] += 1
        _tid_local.tid = tid
    return tid


# external span sink installed by telemetry.tracer: when set, Frame and
# record_event deliver each event (plus the recording thread's name) there
# too, so telemetry captures spans without the profiler's run state
_sink = None


def _set_sink(fn):
    global _sink
    _sink = fn


def _snapshot_events():
    """Consistent copy of (events, thread-name map) for trace mergers."""
    with _state["lock"]:
        return list(_state["events"]), dict(_state["tnames"])


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Set profiler config (reference profiler.py:10): mode in
    {'symbolic', 'all'}; filename receives the chrome trace on dump."""
    if mode not in ("symbolic", "all"):
        raise ValueError("profiler mode must be 'symbolic' or 'all'")
    _state["mode"] = mode
    _state["filename"] = filename


def profiler_set_state(state="stop"):
    """Start/stop profiling (reference profiler.py:22).  'run' also starts
    a torch.profiler trace of CPU and (where there is a card) CUDA
    activity; 'stop' writes it to ``<filename stem>_kineto.json``."""
    if state not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop'")
    if state == "run" and not _state["running"]:
        # mutate under the lock: a Frame closing on another thread must
        # never append into the buffer being replaced
        with _state["lock"]:
            _state["running"] = True
            _state["events"] = []
            _state["tnames"] = {}
        _state["device_trace"] = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            _state["torch_prof"] = prof
        except Exception:
            _state["torch_prof"] = None
    elif state == "stop" and _state["running"]:
        with _state["lock"]:
            _state["running"] = False
        prof, _state["torch_prof"] = _state["torch_prof"], None
        if prof is not None:
            try:
                import torch

                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.stop()
                path = os.path.splitext(_state["filename"])[0] + \
                    "_kineto.json"
                prof.export_chrome_trace(path)
                _state["device_trace"] = path
            except Exception:
                pass


def device_trace_path():
    """Path of the torch.profiler trace the last 'run'..'stop' wrote, or
    None."""
    return _state["device_trace"]


def pause():
    with _state["lock"]:
        _state["running"] = False


def resume():
    with _state["lock"]:
        _state["running"] = True


class Frame:
    """Context manager recording one named span into the chrome trace (the
    python-level analogue of OprExecStat, profiler.h:20-42)."""

    def __init__(self, name, category="python", args=None):
        self.name = name
        self.category = category
        # optional chrome-trace args payload (e.g. the distributed trace
        # id a kvstore RPC envelope carried); read at exit so callers may
        # attach fields while the span is open
        self.args = args
        self._range = None

    def __enter__(self):
        self._t0 = time.perf_counter_ns() // 1000
        if _state["torch_prof"] is not None:
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        sink = _sink
        if _state["running"] or sink is not None:
            t1 = time.perf_counter_ns() // 1000
            # per-thread id: spans from worker threads (comm engine,
            # serving batcher, kvstore handlers) land on their own tracks
            tid = trace_tid()
            ev = {"name": self.name, "cat": self.category, "ph": "X",
                  "ts": self._t0, "dur": t1 - self._t0, "pid": 0, "tid": tid}
            if self.args:
                ev["args"] = dict(self.args)
            tname = threading.current_thread().name
            if _state["running"]:
                with _state["lock"]:
                    _state["events"].append(ev)
                    _state["tnames"][tid] = tname
            if sink is not None:
                sink(ev, tname)


def record_event(name, t0_us, dur_us, category="op"):
    sink = _sink
    if _state["running"] or sink is not None:
        tid = trace_tid()
        ev = {"name": name, "cat": category, "ph": "X", "ts": t0_us,
              "dur": dur_us, "pid": 0, "tid": tid}
        tname = threading.current_thread().name
        if _state["running"]:
            with _state["lock"]:
                _state["events"].append(ev)
                _state["tnames"][tid] = tname
        if sink is not None:
            sink(ev, tname)


def dump_profile():
    """Write the chrome trace file (reference profiler.py:34 → DumpProfile,
    profiler.h:88).  Safe to call mid-run: pending events are flushed
    under ``_state["lock"]`` whether or not ``profiler_set_state("stop")``
    ever ran."""
    with _state["lock"]:
        payload = {"traceEvents": list(_state["events"]),
                   "displayTimeUnit": "ms"}
    with open(_state["filename"], "w") as f:
        json.dump(payload, f)
    return _state["filename"]


register_env("MXNET_PROFILER_AUTOSTART", 0, int, "Start profiler at import.")
if env("MXNET_PROFILER_AUTOSTART", 0, int):
    profiler_set_state("run")
