"""TenantQuotas — per-tenant admission control with weighted fairness
(counterpart of ``mxnet_tpu/platform/quotas.py``).

The router's shed machinery is *global*: past the pressure threshold,
every sheddable request gets a 429.  That is the wrong failure isolation
for a multi-tenant platform — one tenant's flood must 429 THAT tenant
while its neighbours keep their SLOs.  Two mechanisms compose here:

* **Token-bucket rate limits** — a hard per-tenant requests/s ceiling
  (``MXNET_PLATFORM_TENANT_RATE`` / per-tenant overrides) with a burst
  allowance.  Exceeding it rejects with a computed ``Retry-After``
  (time until the bucket refills one token), independent of fleet load.
* **Weighted fair sharing under pressure** — when the fleet's measured
  queue pressure crosses the shed threshold, each tenant is entitled to
  a ``weight``-proportional share of the *observed aggregate* request
  rate; tenants running above their entitlement are shed first.  A
  tenant inside its share is never shed by a neighbour's overload —
  that is the cross-tenant isolation property the chaos tenant-storm
  scenario asserts.

Both paths raise :class:`TenantQuotaExceededError`, which the front
door maps to HTTP 429 + ``Retry-After`` exactly like the router's
:class:`~mxnet_tpu_torch.serving.router.RouterOverloadError`.

A third, platform-driven gate is **brownout**: when the degradation
ladder sheds capacity (a failure domain died and not every model fits
the survivors), the manager calls :meth:`TenantQuotas.set_brownout` with
the highest SLO rank still admitted.  Requests of lower-priority
classes raise :class:`BrownoutError` — the 503 + ``Retry-After``
family, distinct from the tenant's own 429s: the *platform* is degraded,
not the tenant misbehaving.  One recovery or successful re-plan clears
it via :meth:`TenantQuotas.clear_brownout`.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env

__all__ = ["TenantQuotas", "TenantQuotaExceededError", "BrownoutError"]

register_env("MXNET_PLATFORM_TENANT_RATE", 0.0, float,
             "Default per-tenant admission rate limit in requests/s "
             "(token bucket); 0 disables the hard ceiling and leaves "
             "only pressure-driven fair-share shedding.")
register_env("MXNET_PLATFORM_TENANT_BURST", 32.0, float,
             "Token-bucket burst allowance (requests) a tenant may spend "
             "above its steady rate before hard-limit 429s begin.")
register_env("MXNET_PLATFORM_FAIR_PRESSURE", 0.75, float,
             "Fleet queue-pressure fraction beyond which per-tenant "
             "weighted fair-share shedding engages (tenants above their "
             "share are 429d; tenants inside it are never shed).")
register_env("MXNET_PLATFORM_BROWNOUT_RETRY_S", 2.0, float,
             "Retry-After the brownout gate attaches to 503s for SLO "
             "classes shed while the platform runs degraded on a "
             "partial device pool.")

_EWMA_ALPHA = 0.2


class TenantQuotaExceededError(MXNetError):
    """Per-tenant admission rejection — HTTP 429 + Retry-After for ONE
    tenant, not the fleet."""

    def __init__(self, msg, retry_after=1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class BrownoutError(MXNetError):
    """Platform-degraded admission rejection (a failure domain is down
    and this request's SLO class is below the brownout floor) — HTTP 503
    + Retry-After.  Distinct from :class:`TenantQuotaExceededError`: the
    platform is shedding, not the tenant flooding."""

    def __init__(self, msg, retry_after=2.0):
        super().__init__(msg)
        self.retry_after = retry_after


class _Tenant:
    __slots__ = ("rate", "burst", "weight", "tokens", "last_refill",
                 "ewma_rps", "last_seen", "admitted", "shed", "browned")

    def __init__(self, rate, burst, weight):
        self.rate = rate
        self.burst = burst
        self.weight = weight
        self.tokens = burst
        self.last_refill = time.monotonic()
        self.ewma_rps = 0.0
        self.last_seen = self.last_refill
        self.admitted = 0
        self.shed = 0
        self.browned = 0


class TenantQuotas:
    """Admission gate shared by every front door over one fleet."""

    def __init__(self, pressure_fn=None,
                 fair_pressure: Optional[float] = None):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}
        self._pressure_fn = pressure_fn
        self._fair_pressure = (
            env("MXNET_PLATFORM_FAIR_PRESSURE", 0.75, float)
            if fair_pressure is None else float(fair_pressure))
        self._default_rate = env("MXNET_PLATFORM_TENANT_RATE", 0.0, float)
        self._default_burst = env("MXNET_PLATFORM_TENANT_BURST", 32.0, float)
        self._brownout = None  # (max_admitted_rank, plan_gen, retry_after)

    def set_quota(self, tenant: str, rate: Optional[float] = None,
                  burst: Optional[float] = None, weight: float = 1.0):
        """Pin one tenant's rate ceiling / burst / fair-share weight
        (None keeps the env default)."""
        with self._lock:
            t = self._tenant_locked(tenant)
            if rate is not None:
                t.rate = float(rate)
            if burst is not None:
                t.burst = float(burst)
                t.tokens = min(t.tokens, t.burst)
            t.weight = float(weight)

    def _tenant_locked(self, tenant) -> _Tenant:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant(
                self._default_rate, self._default_burst, 1.0)
        return t

    def _observe_locked(self, t, now):
        # request-rate EWMA from inter-arrival gaps: 1/gap is the
        # instantaneous rate; the EWMA smooths it into the fair-share
        # comparison signal
        gap = now - t.last_seen
        t.last_seen = now
        if gap > 0:
            inst = min(1.0 / gap, 1e6)
            t.ewma_rps = (inst if t.ewma_rps == 0.0 else
                          _EWMA_ALPHA * inst
                          + (1 - _EWMA_ALPHA) * t.ewma_rps)

    # -- brownout (degradation-ladder rung 2) ------------------------------
    def set_brownout(self, max_rank: int, gen: int = 0,
                     retry_after: Optional[float] = None):
        """Engage brownout: only requests whose SLO rank is <=
        ``max_rank`` are admitted (rank 0 = interactive; see
        ``spec.SLO_RANK``).  ``gen`` is the plan generation that caused
        it, stamped on shed events."""
        retry = (env("MXNET_PLATFORM_BROWNOUT_RETRY_S", 2.0, float)
                 if retry_after is None else float(retry_after))
        with self._lock:
            prev = self._brownout
            self._brownout = (int(max_rank), int(gen), retry)
        if prev is None or prev[:2] != (int(max_rank), int(gen)):
            _telemetry.log_event("platform_brownout", engaged=True,
                                 max_rank=int(max_rank), gen=int(gen))

    def clear_brownout(self, gen: int = 0):
        with self._lock:
            prev = self._brownout
            self._brownout = None
        if prev is not None:
            _telemetry.log_event("platform_brownout", engaged=False,
                                 gen=int(gen))

    def brownout(self):
        """The active ``(max_rank, gen, retry_after)`` or None."""
        with self._lock:
            return self._brownout

    def admit(self, tenant: str = "default", slo_rank=None):
        """Admit one request for ``tenant`` or raise
        :class:`TenantQuotaExceededError` (over quota / fair share — the
        tenant's fault, 429) or :class:`BrownoutError` (platform
        degraded and ``slo_rank`` is below the brownout floor — 503).
        Never raises for tenants inside both their rate ceiling and
        their fair share while the platform is whole.  ``slo_rank`` None
        bypasses the brownout gate (legacy callers)."""
        now = time.monotonic()
        with self._lock:
            t = self._tenant_locked(tenant)
            self._observe_locked(t, now)
            b = self._brownout
            if b is not None and slo_rank is not None \
                    and int(slo_rank) > b[0]:
                t.browned += 1
                _telemetry.log_event(
                    "platform_quota_shed", tenant=tenant,
                    reason="brownout", slo_rank=int(slo_rank),
                    max_rank=b[0], gen=b[1])
                raise BrownoutError(
                    "platform degraded (plan gen %d): SLO rank %d not "
                    "admitted during brownout (floor %d)"
                    % (b[1], int(slo_rank), b[0]), retry_after=b[2])
            # hard ceiling first: refill, then spend
            if t.rate > 0:
                t.tokens = min(t.burst,
                               t.tokens + (now - t.last_refill) * t.rate)
                t.last_refill = now
                if t.tokens < 1.0:
                    t.shed += 1
                    retry = max((1.0 - t.tokens) / t.rate, 1e-3)
                    _telemetry.log_event("platform_quota_shed",
                                         tenant=tenant, reason="rate",
                                         rps=round(t.ewma_rps, 1))
                    raise TenantQuotaExceededError(
                        "tenant %r over its %.1f req/s quota"
                        % (tenant, t.rate), retry_after=retry)
                t.tokens -= 1.0
            # fair share second: only under fleet pressure, only for
            # tenants running above their weight-proportional slice
            pressure = self._pressure_fn() if self._pressure_fn else 0.0
            if pressure >= self._fair_pressure:
                total_w = sum(x.weight for x in self._tenants.values())
                total_rps = sum(x.ewma_rps for x in self._tenants.values())
                share = total_rps * (t.weight / total_w) if total_w else 0.0
                if total_rps > 0 and t.ewma_rps > share * 1.25:
                    t.shed += 1
                    _telemetry.log_event(
                        "platform_quota_shed", tenant=tenant, reason="fair",
                        rps=round(t.ewma_rps, 1), share=round(share, 1),
                        pressure=round(pressure, 3))
                    raise TenantQuotaExceededError(
                        "tenant %r over fair share (%.1f > %.1f req/s) at "
                        "%.0f%% pressure"
                        % (tenant, t.ewma_rps, share, pressure * 100),
                        retry_after=0.5)
            t.admitted += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {name: {"admitted": t.admitted, "shed": t.shed,
                           "browned": t.browned,
                           "rate": t.rate, "weight": t.weight,
                           "ewma_rps": round(t.ewma_rps, 2)}
                    for name, t in self._tenants.items()}
