"""Multi-tenant model platform over the serving fleet (counterpart of
``mxnet_tpu/platform``).

The serving stack below this package (router, autoscaler, registry)
assumes ONE model per fleet.  The platform turns that fleet into a
shared pool serving many models for many tenants:

* :class:`ModelSpec` — one registered model: checkpoint prefix, input
  shapes, tenant, SLO class, and an estimated device **footprint**
  (param bytes from the checkpoint's size, KV-pool bytes for generator
  specs, an executable overhead as a fraction of the params).
* :class:`PlacementPlanner` — bin-packs registered models onto a
  :class:`DevicePool` by footprint, demand, and SLO class; emits a
  :class:`PlacementPlan` plus the page-out / fault-in / migrate actions
  that reconcile the current placement to it.
* :class:`ModelManager` — actuates plans: hot models live as
  :class:`~mxnet_tpu_torch.serving.server.InferenceServer` replicas
  (registered with ``model``/``tenant`` meta so per-model routers can
  filter one shared registry); cold models are paged out (their device
  memory released, after an AOT bundle is written beside the
  checkpoint when the compile cache is on) and faulted back in — from
  the bundle when there is one, so zero cold-bucket runs once serving.
* :class:`TenantQuotas` — per-tenant admission control: token-bucket
  rate limits plus weighted fair sharing under pressure, so one
  tenant's flood sheds THAT tenant (429 + Retry-After), never its
  neighbours.
* :class:`HealthPlane` — failure-domain liveness: the pool's devices
  group into host-sized domains probed via registry heartbeats and
  injectable faults; K consecutive misses flip a domain dead, which
  drives the manager's **degradation ladder** — reap dead replicas,
  re-fault evicted models onto survivors, brown out lower SLO
  classes (:class:`BrownoutError`, 503 + Retry-After) when not
  everything fits, and gracefully page out the lowest-score models
  (drained, streams handed off mid-generate, transcripts
  bit-identical).
* :class:`FrontDoor` — the multi-model request path: model name in the
  URL path or ``X-MXNet-Model`` header, tenant in ``X-Tenant``, routed
  through per-model router views over one replica registry.  Arrivals
  during a model's fault-in window get 503 + Retry-After with the
  fault-in ETA (:class:`FaultInProgressError`).

Every planner decision is a ``mxnet_tpu_torch.faults`` dotted op
(``platform.plan`` / ``platform.page_out`` / ``platform.fault_in`` /
``platform.migrate`` / ``platform.health.domain.<d>``), so the chaos
harness drives placement churn and host loss deterministically.  A device
index is bookkeeping: every replica runs on its manager's context.
"""
from .spec import ModelSpec
from .planner import DevicePool, PlacementPlan, PlacementPlanner
from .quotas import BrownoutError, TenantQuotaExceededError, TenantQuotas
from .healthplane import HealthPlane
from .manager import FaultInProgressError, ModelManager, PlatformMetrics
from .frontdoor import FrontDoor

__all__ = [
    "ModelSpec", "DevicePool", "PlacementPlan", "PlacementPlanner",
    "TenantQuotas", "TenantQuotaExceededError", "BrownoutError",
    "HealthPlane", "ModelManager", "PlatformMetrics",
    "FaultInProgressError", "FrontDoor",
]
