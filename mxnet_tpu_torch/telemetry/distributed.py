"""Cluster-wide telemetry: process identity, RPC trace contexts, and
fleet metrics aggregation; counterpart of
``mxnet_tpu/telemetry/distributed.py``.

Three small pieces turn the per-process telemetry core into a fleet
view:

* :func:`proc_identity` / :func:`proc_label` — a stable ``(role, rank)``
  for this process derived from the DMLC launch contract
  (``DMLC_ROLE`` / ``DMLC_WORKER_ID`` / ``DMLC_SERVER_ID``), used to
  label trace tracks, postmortems, and aggregated metrics.
* :func:`new_trace_ctx` — a compact trace/span context dict stamped into
  kvstore RPC envelopes so the server-side handler span carries the same
  trace id as the worker-side client span (``python -m
  mxnet_tpu_torch.tools.trace_merge`` renders the pair as linked flow
  events across process tracks).
* :class:`FleetAggregator` + :func:`start_pusher` — a stdlib-HTTP
  federation endpoint: every process pushes its Prometheus text
  (``telemetry.render_prometheus()``) to ``MXNET_TELEMETRY_AGG_ADDR``;
  the aggregator relabels each sample with ``role``/``rank`` and serves
  ONE ``/metrics`` page plus derived fleet gauges (min/median/max worker
  step time, sync-round wait skew).

Everything here is off the training hot path: contexts are built only
when telemetry is enabled, and the pusher is a daemon thread.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import threading
import time
from typing import Dict, Optional, Tuple

from ..base import env, register_env

__all__ = ["proc_identity", "proc_label", "new_trace_ctx",
           "FleetAggregator", "start_pusher", "stop_pusher", "push_once"]

register_env("MXNET_TELEMETRY_AGG_ADDR", "", str,
             "host:port of the fleet metrics aggregator this process "
             "pushes its Prometheus text to (empty: no pushing). "
             "A launcher exports it to every child process.")
register_env("MXNET_TELEMETRY_AGG_INTERVAL", 2.0, float,
             "Seconds between metrics pushes to the aggregator.")
register_env("MXNET_TELEMETRY_ROLE", "", str,
             "Override for this process's telemetry role label; default "
             "derives from DMLC_ROLE (worker/server) or 'proc'.")


def proc_identity() -> Tuple[str, int]:
    """``(role, rank)`` for this process from the DMLC launch contract.
    Serving replicas and standalone processes (no DMLC role) report as
    ``('proc', pid)`` so concurrent dumps never collide on a name."""
    role = os.environ.get("MXNET_TELEMETRY_ROLE") or \
        os.environ.get("DMLC_ROLE")
    if not role:
        role = "worker" if os.environ.get("DMLC_WORKER_ID") else "proc"
    try:
        if role == "server":
            rank = int(os.environ.get("DMLC_SERVER_ID", "0") or 0)
        elif role == "worker":
            rank = int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
        else:
            rank = os.getpid()
    except ValueError:
        rank = os.getpid()
    return role, rank


def proc_label() -> str:
    """``worker0`` / ``server1`` / ``proc<pid>`` — the process-track name
    in merged traces and the ``<role><rank>`` part of postmortem files."""
    role, rank = proc_identity()
    return "%s%d" % (role, rank)


_ctx_counter = itertools.count(1)


def new_trace_ctx(seed: Optional[str] = None) -> dict:
    """A trace/span context for one RPC: globally unique trace id (the
    originating process label + pid + a counter, or a caller-provided
    seed such as the kvstore client id), plus the origin's role/rank so
    the server can label its handler span with the caller."""
    role, rank = proc_identity()
    if seed is None:
        trace = "%s-%d-%d" % (proc_label(), os.getpid(),
                              next(_ctx_counter))
    else:
        trace = "%s-%d" % (seed, next(_ctx_counter))
    return {"trace": trace, "parent": trace, "role": role, "rank": rank}


# -- fleet metrics aggregation ----------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")
_MODEL_RE = re.compile(r'model="([^"]*)"')


def _relabel(text: str, role: str, rank) -> str:
    """Inject ``role``/``rank`` labels into every sample of a Prometheus
    text page (the Registry's LabeledCounter carries only one label
    dimension, so federation labels are applied at the text layer)."""
    extra = 'role="%s",rank="%s"' % (role, rank)
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            out.append(line)
            continue
        name, labels, val = m.groups()
        merged = "{%s,%s}" % (labels[1:-1], extra) if labels \
            else "{%s}" % extra
        out.append("%s%s %s" % (name, merged, val))
    return "\n".join(out)


def _sample_value(text: str, name: str) -> Optional[float]:
    """First sample value of ``name`` (bare or labeled) in a text page."""
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        m = _SAMPLE_RE.match(line)
        if m is not None and m.group(1) == name:
            try:
                return float(m.group(3))
            except ValueError:
                return None
    return None


class FleetAggregator:
    """Federates per-process metrics pages into one Prometheus endpoint.

    HTTP surface (stdlib ``http.server``, same pattern as serving's
    ``serve_http``):

    * ``POST /push?role=R&rank=N`` — a process replaces its latest page.
    * ``GET /metrics`` — every page relabeled with ``role``/``rank``
      plus derived fleet gauges: ``mxtpu_fleet_step_ms{stat=min|median|
      max}`` over the workers' ``mxtpu_step_last_ms`` and
      ``mxtpu_fleet_sync_skew_ms`` (max of the servers'
      ``mxtpu_kvsrv_round_skew_ms``).
    * ``GET /healthz`` — liveness + contributing process count.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import http.server

        self._lock = threading.Lock()
        self._pages: Dict[Tuple[str, str], Tuple[str, float]] = {}
        agg = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code, body, ctype="text/plain; version=0.0.4"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    self._reply(200, agg.render())
                elif self.path.startswith("/healthz"):
                    with agg._lock:
                        n = len(agg._pages)
                    self._reply(200, json.dumps(
                        {"status": "ok", "processes": n}),
                        ctype="application/json")
                else:
                    self._reply(404, "not found\n")

            def do_POST(self):
                if not self.path.startswith("/push"):
                    self._reply(404, "not found\n")
                    return
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                role = (q.get("role") or ["proc"])[0]
                rank = (q.get("rank") or ["0"])[0]
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n).decode("utf-8", "replace")
                with agg._lock:
                    agg._pages[(role, rank)] = (body, time.time())
                self._reply(200, "ok\n")

        class Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self.addr = "%s:%d" % (self._server.server_address[0], self.port)
        self._thread = None

    def render(self) -> str:
        with self._lock:
            pages = dict(self._pages)
        parts = []
        step_ms = []
        skew_ms = []
        models = set()
        for (role, rank), (text, _t) in sorted(pages.items()):
            parts.append(_relabel(text, role, rank))
            models.update(_MODEL_RE.findall(text))
            if role == "worker":
                v = _sample_value(text, "mxtpu_step_last_ms")
                if v:
                    step_ms.append(v)
            if role == "server":
                v = _sample_value(text, "mxtpu_kvsrv_round_skew_ms")
                if v is not None:
                    skew_ms.append(v)
        fleet = ["# TYPE mxtpu_fleet_processes gauge",
                 "mxtpu_fleet_processes %d" % len(pages)]
        if step_ms:
            fleet.append("# TYPE mxtpu_fleet_step_ms gauge")
            for stat, v in (("min", min(step_ms)),
                            ("median", statistics.median(step_ms)),
                            ("max", max(step_ms))):
                fleet.append('mxtpu_fleet_step_ms{stat="%s"} %.6g'
                             % (stat, v))
        if skew_ms:
            fleet.append("# TYPE mxtpu_fleet_sync_skew_ms gauge")
            fleet.append("mxtpu_fleet_sync_skew_ms %.6g" % max(skew_ms))
        if models:
            # distinct model= labels across every contributed page —
            # the platform's per-model cost-attribution sanity signal
            fleet.append("# TYPE mxtpu_fleet_models gauge")
            fleet.append("mxtpu_fleet_models %d" % len(models))
        parts.append("\n".join(fleet))
        return "\n".join(p.rstrip("\n") for p in parts if p) + "\n"

    def processes(self):
        with self._lock:
            return sorted(self._pages)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, kwargs={"poll_interval":
                                                           0.1},
                name="telemetry-aggregator", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- per-process metrics pusher ---------------------------------------------

_pusher_stop: Optional[threading.Event] = None
_pusher_thread: Optional[threading.Thread] = None


def push_once(addr: Optional[str] = None, timeout: float = 2.0) -> bool:
    """POST this process's current metrics page to the aggregator once.
    Quietly returns False when the aggregator is unreachable — telemetry
    must never take the training job down with it."""
    from urllib import request as _rq

    from . import render_prometheus

    addr = addr or env("MXNET_TELEMETRY_AGG_ADDR", "", str)
    if not addr:
        return False
    role, rank = proc_identity()
    url = "http://%s/push?role=%s&rank=%s" % (addr, role, rank)
    try:
        req = _rq.Request(url, data=render_prometheus().encode(),
                          method="POST")
        with _rq.urlopen(req, timeout=timeout):
            pass
        return True
    except Exception:
        return False


def start_pusher(addr: Optional[str] = None,
                 interval: Optional[float] = None) -> bool:
    """Background daemon pushing this process's metrics page to the
    aggregator every ``MXNET_TELEMETRY_AGG_INTERVAL`` seconds (plus one
    immediate push).  Idempotent; returns whether a pusher is running."""
    global _pusher_stop, _pusher_thread
    addr = addr or env("MXNET_TELEMETRY_AGG_ADDR", "", str)
    if not addr:
        return False
    if _pusher_thread is not None and _pusher_thread.is_alive():
        return True
    if interval is None:
        interval = max(0.05, env("MXNET_TELEMETRY_AGG_INTERVAL", 2.0, float))
    stop = threading.Event()

    def loop():
        push_once(addr)
        while not stop.wait(interval):
            push_once(addr)

    _pusher_stop = stop
    _pusher_thread = threading.Thread(target=loop, name="telemetry-pusher",
                                      daemon=True)
    _pusher_thread.start()
    return True


def stop_pusher():
    global _pusher_stop, _pusher_thread
    if _pusher_stop is not None:
        _pusher_stop.set()
    if _pusher_thread is not None:
        _pusher_thread.join(timeout=2)
    _pusher_stop = None
    _pusher_thread = None
