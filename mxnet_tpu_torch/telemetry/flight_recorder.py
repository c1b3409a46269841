"""Flight recorder — postmortem evidence for every process death;
counterpart of ``mxnet_tpu/telemetry/flight_recorder.py``.

The telemetry core already keeps bounded in-memory rings: the tracer's
span buffer, the EventLog ring, and the metrics registry.  This module
snapshots the last ``MXNET_TELEMETRY_FLIGHT_RING`` spans/events plus a
full metrics snapshot and writes them atomically to
``postmortem-<role><rank>-<ts>.json`` when the process is about to die:

* SIGTERM preemption drain (``kvstore.install_preemption_handler``),
* a fault-injected ``kill`` (``faults.FaultPlan.fire``, just before
  ``os._exit(137)``),
* a membership eviction (the kvstore server dumps its view of the round
  state when it removes ranks),
* an unhandled exception (``sys.excepthook`` / ``threading.excepthook``,
  installed while telemetry is enabled).

The write path deliberately does NOT go through ``filesystem.atomic_write``:
that primitive fires the fault layer, and a ``*:kill`` plan would
re-enter the kill while the postmortem is mid-write.  A plain
tmp+fsync+``os.replace`` gives the same atomicity without re-arming the
trap that is killing us.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from ..base import env, register_env

__all__ = ["dump", "install_excepthooks", "uninstall_excepthooks",
           "last_path"]

register_env("MXNET_TELEMETRY_FLIGHT_RING", 256, int,
             "Max spans and events kept in a flight-recorder postmortem "
             "dump (the in-memory rings may hold more).")
register_env("MXNET_TELEMETRY_POSTMORTEM_DIR", "", str,
             "Directory for flight-recorder postmortem dumps; empty "
             "falls back to MXNET_TELEMETRY_DUMP_DIR, then "
             "MXNET_TELEMETRY_DIR, then <tmpdir>/mxnet_tpu-artifacts "
             "(never the cwd).")

_lock = threading.Lock()
_in_dump = False
_last_path: Optional[str] = None


def last_path() -> Optional[str]:
    return _last_path


def _postmortem_dir() -> str:
    from . import dump_dir

    return env("MXNET_TELEMETRY_POSTMORTEM_DIR", "", str) or \
        env("MXNET_TELEMETRY_DUMP_DIR", "", str) or \
        env("MXNET_TELEMETRY_DIR", "", str) or dump_dir()


def dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Write the postmortem for this process; returns its path, or None
    when telemetry is off / a dump is already in flight (re-entrancy
    guard: the crash path must never recurse into itself)."""
    global _in_dump, _last_path
    from . import enabled, events, registry
    from . import tracer
    from .distributed import proc_identity, proc_label

    if not enabled():
        return None
    with _lock:
        if _in_dump:
            return None
        _in_dump = True
    try:
        n = max(1, env("MXNET_TELEMETRY_FLIGHT_RING", 256, int))
        role, rank = proc_identity()
        payload = {
            "reason": reason,
            "role": role,
            "rank": rank,
            "pid": os.getpid(),
            "time": round(time.time(), 6),
            "spans": tracer.events()[-n:],
            "events": events(n),
            "metrics": registry().snapshot(),
        }
        if extra:
            payload["extra"] = extra
        d = _postmortem_dir()
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            import tempfile

            d = tempfile.gettempdir()
        path = os.path.join(d, "postmortem-%s-%d.json"
                            % (proc_label(), int(time.time() * 1e3)))
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _last_path = path
        return path
    except Exception:
        return None
    finally:
        with _lock:
            _in_dump = False


# -- unhandled-exception hooks ----------------------------------------------

_orig_excepthook = None
_orig_threading_hook = None


def install_excepthooks():
    """Chain onto sys/threading excepthooks so an unhandled exception in
    any thread leaves a postmortem before the default reporting runs."""
    global _orig_excepthook, _orig_threading_hook
    if _orig_excepthook is not None:
        return

    _orig_excepthook = sys.excepthook
    _orig_threading_hook = threading.excepthook

    def hook(tp, val, tb):
        try:
            dump("exception:%s" % getattr(tp, "__name__", tp),
                 extra={"message": str(val)[:500]})
        except Exception:
            pass
        (_orig_excepthook or sys.__excepthook__)(tp, val, tb)

    def thook(args):
        try:
            dump("thread-exception:%s"
                 % getattr(args.exc_type, "__name__", args.exc_type),
                 extra={"thread": getattr(args.thread, "name", None),
                        "message": str(args.exc_value)[:500]})
        except Exception:
            pass
        (_orig_threading_hook or threading.__excepthook__)(args)

    sys.excepthook = hook
    threading.excepthook = thook


def uninstall_excepthooks():
    global _orig_excepthook, _orig_threading_hook
    if _orig_excepthook is not None:
        sys.excepthook = _orig_excepthook
        _orig_excepthook = None
    if _orig_threading_hook is not None:
        threading.excepthook = _orig_threading_hook
        _orig_threading_hook = None
