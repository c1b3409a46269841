"""ReplicaRegistry — counterpart of ``mxnet_tpu/serving/registry.py``: the
shared live-set behind router replication.  The HTTP face speaks the JAX
package's JSON, so a client of either package works against a registry of
the other.

A single :class:`~mxnet_tpu_torch.serving.router.Router` is itself a single
point of failure: kill the front door and every client loses the fleet,
even though the replicas behind it are fine.  The fix is the same one
the elastic kvstore applied to training workers (its membership
table): replicas **register** into a shared table with monotonic
generations, **heartbeat** to stay live, and are **evicted** on stale
heartbeats — and N stateless routers watching that table converge on
the same live set, so any router can serve any request and killing one
mid-load loses nothing.

This module is that membership-table machinery re-hosted at the serving
layer (the contract of ``KVStoreServer``'s join/leave/evict/membership
commands: a generation counter bumped on every change lets a poller detect
churn with one integer compare; stale-heartbeat eviction turns kill -9
into a membership event instead of a hang).  Members are keyed by name
and carry a backend — either a ``host:port`` string (cross-process) or
a live in-process object such as an :class:`InferenceServer` (the chaos
scenarios run whole fleets in one process).

Three faces:

* :class:`ReplicaRegistry` — the table itself, embeddable in-process.
* ``ReplicaRegistry.serve_http()`` — the same table as a stdlib HTTP
  service (``POST /register|/heartbeat|/deregister``,
  ``GET /replicas|/healthz``) for multi-process fleets.
* :class:`RegistryClient` — the HTTP face re-exposed under the same
  method signatures, so routers and replicas take either one.

Registry I/O is a ``faults`` dotted op (``serving.registry.call``) so
chaos runs can partition a router from the registry deterministically.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from .. import faults
from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env

__all__ = ["ReplicaRegistry", "RegistryClient", "start_heartbeater"]

register_env("MXNET_SERVING_REGISTRY_TTL_MS", 3000.0, float,
             "Heartbeat staleness budget: a registered serving replica "
             "(or router) silent for longer is evicted from the live "
             "set, exactly like the kvstore membership table's "
             "MXNET_KVSTORE_EVICT_TIMEOUT.")
register_env("MXNET_SERVING_REGISTRY_HEARTBEAT_MS", 1000.0, float,
             "Period of a registered replica's keep-alive heartbeats to "
             "the replica registry.")


class ReplicaRegistry:
    """Name -> backend live-set with generations and stale eviction.

    ``gen`` is bumped on every register/deregister/evict, never on a
    heartbeat, so a router syncing against the registry re-reads the
    member list only when it actually changed.  Eviction is lazy (every
    read sweeps stale members first) — no background thread to leak, and
    a table nobody reads costs nothing.
    """

    def __init__(self, ttl_ms: Optional[float] = None):
        self._ttl_s = (env("MXNET_SERVING_REGISTRY_TTL_MS", 3000.0, float)
                       if ttl_ms is None else float(ttl_ms)) / 1e3
        self._lock = threading.Lock()
        self._members: Dict[str, dict] = {}  # name -> record
        self._gen = 0
        self._httpd = None
        self._http_thread = None

    # -- membership --------------------------------------------------------
    def register(self, name: str, backend, meta: Optional[dict] = None):
        """Admit (or refresh) a member; returns the new generation."""
        if not name:
            raise MXNetError("registry member needs a non-empty name")
        with self._lock:
            fresh = name not in self._members
            self._members[name] = {
                "backend": backend,
                "meta": dict(meta or {}),
                "beat": time.monotonic(),
            }
            if fresh:
                self._gen += 1
            gen = self._gen
        _telemetry.log_event("serving_registry", op="register", name=name,
                             gen=gen)
        return gen

    def heartbeat(self, name: str) -> bool:
        """Refresh one member's liveness; False when it is not (or no
        longer) a member — the signal a replica uses to re-register after
        an eviction it slept through."""
        with self._lock:
            rec = self._members.get(name)
            if rec is None:
                return False
            rec["beat"] = time.monotonic()
            return True

    def deregister(self, name: str):
        """Graceful leave; returns the new generation (unchanged when the
        member was already gone)."""
        with self._lock:
            if self._members.pop(name, None) is not None:
                self._gen += 1
            gen = self._gen
        _telemetry.log_event("serving_registry", op="deregister", name=name,
                             gen=gen)
        return gen

    def _evict_stale_locked(self):
        now = time.monotonic()
        stale = [n for n, rec in self._members.items()
                 if now - rec["beat"] > self._ttl_s]
        for n in stale:
            del self._members[n]
            self._gen += 1
        return stale

    def live(self) -> dict:
        """``{"gen": G, "replicas": {name: backend}, "meta": {name:
        dict}}`` after sweeping stale members (the poll every router
        syncs against).  ``meta`` is additive — pre-platform consumers
        that only read ``replicas`` keep working, and a member that
        registered without meta shows an empty dict (the default-model
        convention the per-model router filter relies on)."""
        with self._lock:
            stale = self._evict_stale_locked()
            out = {"gen": self._gen,
                   "replicas": {n: rec["backend"]
                                for n, rec in self._members.items()},
                   "meta": {n: dict(rec["meta"])
                            for n, rec in self._members.items()}}
        for n in stale:
            _telemetry.log_event("serving_registry", op="evict", name=n,
                                 gen=out["gen"])
        return out

    def gen(self) -> int:
        with self._lock:
            self._evict_stale_locked()
            return self._gen

    # -- HTTP face ---------------------------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Expose the table as a stdlib HTTP service; returns the bound
        ``(host, port)``.  Backends must be ``host:port`` strings in this
        mode (an in-process object cannot cross the wire)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/replicas":
                    self._reply(200, registry.live())
                elif self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "gen": registry.gen()})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    name = req.get("name", "")
                    if self.path == "/register":
                        backend = req["backend"]
                        if not isinstance(backend, str):
                            raise MXNetError(
                                "HTTP registry backends must be host:port "
                                "strings")
                        gen = registry.register(name, backend,
                                                req.get("meta"))
                        self._reply(200, {"gen": gen})
                    elif self.path == "/heartbeat":
                        self._reply(200, {"ok": registry.heartbeat(name)})
                    elif self.path == "/deregister":
                        self._reply(200, {"gen": registry.deregister(name)})
                    else:
                        self._reply(404, {"error": "not found"})
                except (MXNetError, ValueError, TypeError, KeyError,
                        json.JSONDecodeError) as exc:
                    self._reply(400, {"error": repr(exc)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-registry-http",
            daemon=True)
        self._http_thread.start()
        return self._httpd.server_address

    @property
    def addr(self) -> str:
        if self._httpd is None:
            raise MXNetError("registry is not serving HTTP")
        host, port = self._httpd.server_address[:2]
        return "%s:%d" % (host, port)

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._http_thread is not None:
                self._http_thread.join(timeout=5)
                self._http_thread = None


class RegistryClient:
    """HTTP client with the same surface as :class:`ReplicaRegistry`, so
    a router or replica takes either without caring which process hosts
    the table."""

    def __init__(self, addr: str, timeout: float = 2.0):
        self.addr = addr
        self._base = "http://%s" % addr
        self._timeout = timeout

    def _post(self, path, payload):
        import urllib.request

        faults.fire("serving.registry.call")
        req = urllib.request.Request(
            self._base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            return json.loads(resp.read())

    def _get(self, path):
        import urllib.request

        faults.fire("serving.registry.call")
        with urllib.request.urlopen(self._base + path,
                                    timeout=self._timeout) as resp:
            return json.loads(resp.read())

    def register(self, name, backend, meta=None):
        return self._post("/register", {"name": name, "backend": backend,
                                        "meta": meta or {}})["gen"]

    def heartbeat(self, name) -> bool:
        return bool(self._post("/heartbeat", {"name": name})["ok"])

    def deregister(self, name):
        return self._post("/deregister", {"name": name})["gen"]

    def live(self) -> dict:
        return self._get("/replicas")

    def gen(self) -> int:
        return self._get("/healthz")["gen"]


def start_heartbeater(registry, name: str, backend,
                      interval_ms: Optional[float] = None,
                      meta: Optional[dict] = None):
    """Register ``name`` and keep it alive with background heartbeats
    (re-registering after any eviction/registry restart — the member,
    not the table, owns its liveness).  Returns a ``stop()`` callable
    that deregisters and joins the thread; used by serving replicas and
    by replicated routers alike."""
    interval_s = (env("MXNET_SERVING_REGISTRY_HEARTBEAT_MS", 1000.0, float)
                  if interval_ms is None else float(interval_ms)) / 1e3
    registry.register(name, backend, meta)
    stop_evt = threading.Event()

    def loop():
        while not stop_evt.wait(interval_s):
            try:
                if not registry.heartbeat(name):
                    registry.register(name, backend, meta)
            except Exception:
                pass  # registry blip: keep beating, it may come back

    thread = threading.Thread(target=loop, name="mxtpu-registry-beat",
                              daemon=True)
    thread.start()

    def stop(deregister: bool = True):
        stop_evt.set()
        thread.join(timeout=5)
        if deregister:
            try:
                registry.deregister(name)
            except Exception:
                pass

    return stop
