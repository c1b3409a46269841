"""FrontDoor — the multi-model, multi-tenant request path (counterpart of
``mxnet_tpu/platform/frontdoor.py``; its HTTP codes and JSON bodies are the
JAX front door's).

One front door serves every registered model: requests name their model
in the URL path (``POST /v1/<model>/predict``) or the ``X-MXNet-Model``
header, and their tenant in ``X-Tenant``.  Per model, the front door
keeps a model-scoped :class:`~mxnet_tpu_torch.serving.router.Router` view
over the manager's ONE shared replica registry (the satellite fix:
registration meta carries the model label, so N routers filter one
table instead of needing a registry each).  Admission runs through
:class:`~mxnet_tpu_torch.platform.quotas.TenantQuotas` BEFORE the router —
a flooding tenant is 429d at the door, its neighbours never queue
behind it — and every admitted request feeds the manager's demand
EWMA, which is what earns a paged-out model its fault-in.

A request for a paged-out model blocks on the fault-in (a build plus
a warm-up of every bucket, from the model's AOT bundle when the compile
cache wrote one: no nvcc, no NVRTC, no tuning) and then routes normally — demand
paging, model edition.  Only the FIRST
such request pays that stall: while the model's fault-in window is open,
later arrivals are rejected with 503 + ``Retry-After`` set to the
remaining fault-in ETA (:class:`~.manager.FaultInProgressError`), and
the queued-or-rejected decision is logged with the plan generation.
When the degradation ladder has engaged brownout,
:class:`~.quotas.BrownoutError` maps to the same 503 + ``Retry-After``
family.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..serving.batcher import (DeadlineExceededError, QueueFullError,
                               ServerClosedError)
from ..serving.router import (NoReplicaAvailableError, Router,
                              RouterOverloadError)
from .manager import FaultInProgressError, ModelManager
from .quotas import BrownoutError, TenantQuotaExceededError, TenantQuotas
from .spec import SLO_RANK

__all__ = ["FrontDoor"]


class FrontDoor:
    """Quota-gated, model-routed entry point over a :class:`ModelManager`.

    Parameters
    ----------
    manager : ModelManager
        Owns the catalog, placement, and the shared replica registry.
    quotas : TenantQuotas, optional
        Defaults to a fresh gate whose pressure signal is the max
        pressure across this front door's live routers.
    slo_classes : dict, optional
        Passed through to each per-model router.
    registry_sync_ms : float
        Per-model router registry sync period; kept tight (50ms) so a
        fault-in becomes routable fast, and forced synchronously after
        every fault-in anyway.
    """

    def __init__(self, manager: ModelManager,
                 quotas: Optional[TenantQuotas] = None,
                 slo_classes: Optional[dict] = None,
                 registry_sync_ms: float = 50.0):
        self.manager = manager
        self.quotas = TenantQuotas(pressure_fn=self._pressure) \
            if quotas is None else quotas
        # the degradation ladder browns this gate out on capacity loss
        manager.bind_quotas(self.quotas)
        self._slo_classes = slo_classes
        self._sync_ms = float(registry_sync_ms)
        self._routers: Dict[str, Router] = {}
        self._httpd = None
        self._http_thread = None
        self._closed = False

    # -- routing -----------------------------------------------------------
    def router_for(self, model: str) -> Router:
        """The model-scoped router view, created on first use."""
        r = self._routers.get(model)
        if r is None:
            self.manager.spec(model)  # raises for unknown models
            r = self._routers.get(model)
            if r is None:
                r = Router(registry=self.manager.registry, model=model,
                           slo_classes=self._slo_classes,
                           registry_sync_ms=self._sync_ms)
                self._routers[model] = r
        return r

    def _pressure(self) -> float:
        """Fleet pressure signal for the quota gate: worst live router.
        Routers with no replicas — or only draining corpses mid-reap —
        report pressure 1.0; a model mid-fault-in (or mid-host-loss)
        must not trip fair-share shedding, so only routers with a
        dispatchable replica count."""
        worst = 0.0
        for r in list(self._routers.values()):
            if any(not rep.draining for rep in r.replicas()):
                worst = max(worst, r.pressure())
        return worst

    def _resolve_slo(self, model: str, slo: Optional[str]) -> str:
        """An explicit per-request ``slo`` wins; omitted, the request is
        admitted as the MODEL's registered SLO class — a batch model's
        tenant must not dodge a brownout by leaving the field blank."""
        if slo:
            return slo
        try:
            return self.manager.spec(model).slo
        except Exception:
            return "interactive"

    def _admit(self, model: str, tenant: str,
               slo: str = "interactive") -> Router:
        if self._closed:
            raise ServerClosedError("front door is closed")
        self.quotas.admit(tenant, slo_rank=SLO_RANK.get(slo, 2))
        self.manager.record_demand(model)
        router = self.router_for(model)
        if self.manager.server_for(model) is None:
            gen = self.manager.plan_generation()
            eta = self.manager.fault_in_window(model)
            if eta is not None:
                # another request already owns the fault-in: shed with
                # the remaining ETA instead of piling threads up behind
                # the build
                _telemetry.log_event(
                    "platform_faultin_wait", model=model, tenant=tenant,
                    decision="rejected", retry_after=round(eta, 3),
                    gen=gen)
                raise FaultInProgressError(
                    "model %r is faulting in (plan gen %d); retry in "
                    "%.2fs" % (model, gen, eta), retry_after=eta)
            # demand paging: fault the model in (built and warmed) and
            # make it routable before dispatching
            _telemetry.log_event("platform_faultin_wait", model=model,
                                 tenant=tenant, decision="queued",
                                 gen=gen)
            self.manager.fault_in(model)
            router.sync_registry()
        elif not any(not r.draining and r.ready()
                     for r in router.replicas()):
            # the model is resident (e.g. a replan faulted it in) but
            # this router's 50ms background sync has not caught up yet —
            # a corpse handle awaiting removal does not count as caught
            # up, or a post-host-loss re-fault stays unroutable for a
            # full sync period
            router.sync_registry()
        return router

    def submit(self, model: str, tenant: str = "default",
               slo: Optional[str] = None,
               deadline_ms: Optional[float] = None, **inputs):
        """Admit + route one request; returns the router future.  Raises
        :class:`TenantQuotaExceededError` (tenant over quota / fair
        share) or :class:`RouterOverloadError` (fleet shed) — both the
        429 family — synchronously.  ``slo=None`` admits as the model's
        registered SLO class."""
        slo = self._resolve_slo(model, slo)
        router = self._admit(model, tenant, slo=slo)
        return router.submit(slo=slo, deadline_ms=deadline_ms, **inputs)

    def predict(self, model: str, tenant: str = "default",
                slo: Optional[str] = None,
                deadline_ms: Optional[float] = None, **inputs):
        return self.submit(model, tenant=tenant, slo=slo,
                           deadline_ms=deadline_ms, **inputs).result()

    def generate(self, model: str, prompt, max_new_tokens=None,
                 tenant: str = "default", slo: Optional[str] = None,
                 deadline_ms: Optional[float] = None):
        slo = self._resolve_slo(model, slo)
        router = self._admit(model, tenant, slo=slo)
        return router.generate(prompt, max_new_tokens, slo=slo,
                               deadline_ms=deadline_ms)

    def describe(self) -> dict:
        d = self.manager.describe()
        d["tenants"] = self.quotas.snapshot()
        d["routers"] = {m: [rep["name"] for rep in r.describe()]
                        for m, r in self._routers.items()}
        return d

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._http_thread is not None:
                self._http_thread.join(timeout=5)
                self._http_thread = None
        for r in self._routers.values():
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- HTTP --------------------------------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Stdlib HTTP face; returns the bound ``(host, port)``.

        * ``POST /v1/<model>/predict`` — body as the router's
          ``/predict`` (``inputs`` / ``slo`` / ``deadline_ms``); model
          from the path, or ``X-MXNet-Model`` on bare ``/predict``;
          tenant from ``X-Tenant`` (default ``default``).  429 +
          ``Retry-After`` when THIS tenant is over quota or the class
          was shed, 503 when no replica, 504 past deadline.
        * ``POST /v1/<model>/generate`` — NDJSON token stream, same
          admission rules.
        * ``GET /models`` — catalog, placement, demand, tenant stats.
        * ``GET /metrics`` — process-wide Prometheus text (platform
          gauges included).
        * ``GET /healthz`` — 200 until ``close``.
        """
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        door = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, body, ctype="application/json",
                       headers=()):
                data = body if isinstance(body, bytes) else body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _route(self):
                """(model, verb) from ``/v1/<model>/<verb>`` or the
                bare ``/<verb>`` + ``X-MXNet-Model`` header."""
                parts = [p for p in self.path.split("/") if p]
                if len(parts) == 3 and parts[0] == "v1":
                    return parts[1], parts[2]
                if len(parts) == 1:
                    return self.headers.get("X-MXNet-Model"), parts[0]
                return None, None

            def do_GET(self):
                if self.path == "/models":
                    self._reply(200, json.dumps(door.describe()))
                elif self.path == "/metrics":
                    self._reply(200, _telemetry.render_prometheus(),
                                ctype="text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    if door._closed:
                        self._reply(503, json.dumps({"status": "closed"}))
                    else:
                        self._reply(200, "ok", ctype="text/plain")
                else:
                    self._reply(404, json.dumps({"error": "not found"}))

            def do_POST(self):
                model, verb = self._route()
                if verb not in ("predict", "generate") or not model:
                    self._reply(404, json.dumps(
                        {"error": "POST /v1/<model>/predict|generate"}))
                    return
                tenant = self.headers.get("X-Tenant") or "default"
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if verb == "generate":
                        self._generate(model, tenant, req)
                        return
                    fut = door.submit(
                        model, tenant=tenant,
                        slo=req.get("slo"),
                        deadline_ms=req.get("deadline_ms"),
                        **req.get("inputs", {}))
                    import numpy as np

                    outs = fut.result()
                    self._reply(200, json.dumps(
                        {"outputs": [np.asarray(o).tolist()
                                     for o in outs]}))
                except (TenantQuotaExceededError,
                        RouterOverloadError) as exc:
                    self._reply(429, json.dumps({"error": str(exc)}),
                                headers=(("Retry-After", "%g"
                                          % exc.retry_after),))
                except (FaultInProgressError, BrownoutError) as exc:
                    # the platform is coming up / running degraded:
                    # retryable, with an honest ETA
                    self._reply(503, json.dumps({"error": str(exc)}),
                                headers=(("Retry-After", "%g"
                                          % exc.retry_after),))
                except DeadlineExceededError as exc:
                    self._reply(504, json.dumps({"error": str(exc)}))
                except (NoReplicaAvailableError, ServerClosedError,
                        QueueFullError) as exc:
                    self._reply(503, json.dumps({"error": str(exc)}))
                except (MXNetError, ValueError, TypeError, KeyError,
                        OSError, json.JSONDecodeError) as exc:
                    self._reply(400, json.dumps({"error": repr(exc)}))

            def _generate(self, model, tenant, req):
                it = door.generate(
                    model, req.get("prompt", []),
                    req.get("max_new_tokens"), tenant=tenant,
                    slo=req.get("slo"),
                    deadline_ms=req.get("deadline_ms"))
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                self.close_connection = True
                n = 0
                try:
                    for tok in it:
                        self.wfile.write(
                            (json.dumps({"token": int(tok)}) + "\n")
                            .encode())
                        self.wfile.flush()
                        n += 1
                    self.wfile.write((json.dumps(
                        {"done": True, "n": n}) + "\n").encode())
                    self.wfile.flush()
                except BrokenPipeError:
                    it.close()
                except BaseException as exc:
                    try:
                        self.wfile.write((json.dumps(
                            {"error": repr(exc)}) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-frontdoor-http",
            daemon=True)
        self._http_thread.start()
        return self._httpd.server_address
