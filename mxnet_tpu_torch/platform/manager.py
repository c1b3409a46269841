"""ModelManager — actuates placement plans over real InferenceServers
(counterpart of ``mxnet_tpu/platform/manager.py``).

The planner decides *what should be resident*; the manager makes it so:

* **fault_in** — build an :class:`InferenceServer` via
  ``from_checkpoint`` and warm every bucket, so ``cold_bucket_runs()`` is 0
  once it serves; register it in the shared replica registry with
  ``{"model", "tenant", "device", "replica"}`` meta so model-scoped
  routers adopt it and the health plane can group it into a failure
  domain, and start its heartbeat.  Exactly one fault-in builds at a
  time per model (the **fault-in window**): concurrent callers wait,
  and the front door 503s arrivals with a Retry-After derived from the
  fault-in ETA.  A fault-in that fails midway (an injected warmup
  IOError) unwinds completely — ``resident_bytes()`` returns to its
  pre-attempt value.
* **page_out** — deregister, then ``stop()`` — which releases the
  device-resident params, the bucket executors and the generator's KV
  pool.  ``graceful=True`` is the SLO-aware preemption path: quiesce
  arrivals (readiness off + deregister), drain the batcher, hand live
  generate streams to a surviving replica via the router's mid-stream
  failover, and only then release memory — transcripts stay
  bit-identical.
* **migrate** — page one replica out at its old device, fault it in at
  the new one.
* **replan** — one planner pass + actuation under a monotonic **plan
  generation** stamped on every platform telemetry event, with a
  minimum-residency anti-thrash guard.
* **degradation ladder** — on a failure-domain death (health-plane
  callback): reap the dead replicas, re-plan over surviving capacity
  (rung 1: re-faults onto surviving domains), engage brownout when
  not everything fits (rung 2: only higher-SLO classes admitted), and
  gracefully page out the lowest-score models (rung 3).

Every actuation is a ``faults`` dotted op (``platform.fault_in`` /
``platform.page_out`` / ``platform.migrate``) and counts in the
model-labeled platform telemetry.

Compile-once, as in the JAX manager: a fault-in attaches the model's AOT
bundle (``prefix-NNNN.aot/``) when there is one, a cold build writes its
bundle at once (bundle-on-first-build: a replica reaped with its host
saves nothing, and the ladder's re-fault must still come back warm), a
page-out refreshes it before the server stops, and the compile cache's
measured bytes (the CUDA graphs' pool and static buffers) refine the
spec's executable estimate (``_observe_exec_bytes``).  With the compile
cache off there is nothing to bundle: every fault-in builds and warms.

Kept differences from the JAX package.  The default context is per thread, and a fault-in may run on the replan
loop's thread, a front door handler's or the health plane's: the manager
resolves the constructing thread's context once, in its constructor, and
every server whose ``server_kwargs`` name no ``ctx`` runs there.  A
device index is bookkeeping in both packages — the planner's placement
and the replica's meta — never a context.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

from .. import faults
from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env
from ..context import current_context
from ..serving.registry import ReplicaRegistry, start_heartbeater
from ..serving.server import InferenceServer
from .planner import DevicePool, PlacementPlanner
from .spec import ModelSpec

__all__ = ["ModelManager", "PlatformMetrics", "FaultInProgressError"]

register_env("MXNET_PLATFORM_REPLAN_MS", 2000.0, float,
             "Background placement-replan period of a started "
             "ModelManager (0 disables the loop; replan() stays "
             "callable).")
register_env("MXNET_PLATFORM_DEMAND_HALFLIFE_S", 30.0, float,
             "Half-life of the per-model demand EWMA the placement "
             "planner scores against — shorter chases diurnal load "
             "faster, longer resists thrash.")
register_env("MXNET_PLATFORM_MIN_RESIDENT_S", 5.0, float,
             "Anti-thrash guard: a model faulted in more recently than "
             "this is not paged out by a replan (explicit page_out() "
             "calls are not gated).")
register_env("MXNET_PLATFORM_FAULTIN_ETA_MS", 2000.0, float,
             "Fault-in ETA estimate used for Retry-After on 503s during "
             "a model's fault-in window, until a measured fault-in "
             "latency replaces it.")
register_env("MXNET_PLATFORM_DRAIN_MS", 5000.0, float,
             "Graceful page-out drain budget: how long a preempted "
             "replica may spend flushing its batcher queue before its "
             "generate streams are handed off and memory is released.")


class FaultInProgressError(MXNetError):
    """A request arrived during its model's fault-in window — HTTP 503 +
    Retry-After (the fault-in ETA), not a terminal error: the model is
    coming up, retry shortly."""

    def __init__(self, msg, retry_after=1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class PlatformMetrics:
    """Model-labeled platform telemetry (a registry collector)."""

    def __init__(self):
        reg = self._registry = _telemetry.Registry()
        self.fault_ins = reg.labeled_counter(
            "mxtpu_platform_fault_ins_total", "model")
        self.fault_in_fails = reg.labeled_counter(
            "mxtpu_platform_fault_in_failures_total", "model")
        self.page_outs = reg.labeled_counter(
            "mxtpu_platform_page_outs_total", "model")
        self.migrations = reg.labeled_counter(
            "mxtpu_platform_migrations_total", "model")
        self.reaps = reg.labeled_counter(
            "mxtpu_platform_replica_reaps_total", "model")
        self.plans = reg.counter("mxtpu_platform_plans_total")
        self.brownouts = reg.counter("mxtpu_platform_brownouts_total")
        self.g_plan_gen = reg.gauge("mxtpu_platform_plan_generation")
        self.g_resident = reg.gauge("mxtpu_platform_resident_models")
        self.g_registered = reg.gauge("mxtpu_platform_registered_models")
        self.g_resident_bytes = reg.gauge("mxtpu_platform_resident_bytes")
        _telemetry.register_collector(self)

    def render_prometheus(self):
        return self._registry.render_prometheus()


class ModelManager:
    """Owns the model catalog, the demand signal, and the live servers.

    Parameters
    ----------
    pool : DevicePool
        The memory budget placements pack against (its
        ``devices_per_host`` defines the failure domains).
    registry : ReplicaRegistry, optional
        Shared replica live-set; created (in-process) when absent.
        Every faulted-in server registers here with model/tenant/device
        meta.
    planner : PlacementPlanner, optional
        Defaults to a fresh planner over ``pool``.

    Servers run on the constructing thread's current context (``gpu(0)``
    unless a ``with mt.cpu():`` is active) whatever thread faults them
    in, unless a spec's ``server_kwargs`` name a ``ctx``.
    """

    def __init__(self, pool: DevicePool, registry=None,
                 planner: Optional[PlacementPlanner] = None):
        self.pool = pool
        self.registry = ReplicaRegistry() if registry is None else registry
        self.planner = PlacementPlanner(pool) if planner is None else planner
        self.metrics = PlatformMetrics()
        # the default context is per thread: resolve it here, once
        self._ctx = current_context()
        self._lock = threading.RLock()
        self._specs: Dict[str, ModelSpec] = {}
        # all replica-scoped state is name -> {replica_index: value}
        self._servers: Dict[str, Dict[int, InferenceServer]] = {}
        self._beat_stops: Dict[str, Dict[int, tuple]] = {}  # (reg_name, stop)
        self._placement: Dict[str, Dict[int, int]] = {}
        self._resident_since: Dict[str, float] = {}
        self._demand: Dict[str, float] = {}
        self._demand_t: Dict[str, float] = {}
        self._fault_in_ms: Dict[str, float] = {}
        self._faulting: Dict[str, dict] = {}  # open fault-in windows
        self._replica_seq = 0
        self._plan_gen = 0
        self._health = None
        self._quotas = None
        self._halflife_s = env("MXNET_PLATFORM_DEMAND_HALFLIFE_S", 30.0,
                               float)
        self._min_resident_s = env("MXNET_PLATFORM_MIN_RESIDENT_S", 5.0,
                                   float)
        self._loop_stop = threading.Event()
        self._loop_thread = None
        self._closed = False

    # -- catalog -----------------------------------------------------------
    def register_model(self, spec: ModelSpec):
        with self._lock:
            if spec.name in self._specs:
                raise MXNetError("model %r already registered" % spec.name)
            self._specs[spec.name] = spec
            self._demand.setdefault(spec.name, 0.0)
        self.metrics.g_registered.set(len(self._specs))
        _telemetry.log_event("platform_register", model=spec.name,
                             tenant=spec.tenant, slo=spec.slo,
                             replicas=spec.replicas)
        return spec

    def spec(self, name: str) -> ModelSpec:
        with self._lock:
            spec = self._specs.get(name)
        if spec is None:
            raise MXNetError("unknown model %r (registered: %s)"
                             % (name, sorted(self._specs)))
        return spec

    def models(self):
        with self._lock:
            return sorted(self._specs)

    # -- resilience wiring -------------------------------------------------
    def attach_health(self, health):
        """Wire a :class:`~.healthplane.HealthPlane` to this manager:
        its domain transitions drive the degradation ladder, and replans
        exclude dead capacity.  Returns the health plane."""
        with self._lock:
            self._health = health
        health._on_change = self._on_domain_health
        return health

    def bind_quotas(self, quotas):
        """Give the manager the admission gate to brown out on capacity
        loss (the front door calls this with its TenantQuotas)."""
        with self._lock:
            self._quotas = quotas
        return quotas

    def plan_generation(self) -> int:
        """Monotonic plan generation — bumped on every replan and every
        health transition, stamped on all platform telemetry events."""
        with self._lock:
            return self._plan_gen

    def _bump_gen_locked(self) -> int:
        self._plan_gen += 1
        self.metrics.g_plan_gen.set(self._plan_gen)
        return self._plan_gen

    # -- demand signal -----------------------------------------------------
    def record_demand(self, name: str, n: float = 1.0):
        """Fold ``n`` requests into the model's demand EWMA (decayed by
        the configured half-life since the last observation)."""
        now = time.monotonic()
        with self._lock:
            cur = self._decayed_demand_locked(name, now)
            self._demand[name] = cur + float(n)
            self._demand_t[name] = now

    def _decayed_demand_locked(self, name, now):
        last = self._demand_t.get(name)
        cur = self._demand.get(name, 0.0)
        if last is None or self._halflife_s <= 0:
            return cur
        return cur * math.pow(0.5, (now - last) / self._halflife_s)

    def demand(self) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            return {n: self._decayed_demand_locked(n, now)
                    for n in self._specs}

    # -- actuation ---------------------------------------------------------
    def _next_replica_name(self, model):
        self._replica_seq += 1
        return "%s/r%d" % (model, self._replica_seq)

    def _fault_in_eta_s_locked(self, name) -> float:
        ms = self._fault_in_ms.get(name)
        if ms is None:
            ms = env("MXNET_PLATFORM_FAULTIN_ETA_MS", 2000.0, float)
        return max(ms / 1e3, 1e-3)

    def fault_in_window(self, name: str) -> Optional[float]:
        """Remaining fault-in ETA in seconds while ``name`` has an open
        fault-in window, else None — the front door's Retry-After for
        503s during the window."""
        with self._lock:
            win = self._faulting.get(name)
            if win is None:
                return None
            elapsed = time.monotonic() - win["t0"]
            return max(win["eta_s"] - elapsed, 0.05)

    def fault_in(self, name: str, device: Optional[int] = None,
                 replica: int = 0):
        """Materialize one replica of a model as a live, warmed server;
        returns the server.  Idempotent for already-resident replicas.
        Exactly one build runs per model at a time: concurrent callers
        wait on the fault-in window (and become the next owner if the
        build fails).  A failed build leaks nothing — the partially
        allocated server unwinds and ``resident_bytes()`` is unchanged."""
        spec = self.spec(name)
        replica = int(replica)
        while True:
            with self._lock:
                srv = self._servers.get(name, {}).get(replica)
                if srv is not None:
                    return srv
                win = self._faulting.get(name)
                if win is None:
                    win = {"t0": time.monotonic(),
                           "eta_s": self._fault_in_eta_s_locked(name),
                           "event": threading.Event()}
                    self._faulting[name] = win
                    break
            # another thread owns this model's fault-in: wait it out,
            # then re-check (its failure makes us the next owner)
            win["event"].wait(timeout=win["eta_s"] * 4 + 30.0)
        t0 = time.monotonic()
        try:
            faults.fire("platform.fault_in")
            kwargs = dict(spec.server_kwargs)
            kwargs.setdefault("ctx", self._ctx)
            if spec.generator_spec is not None:
                kwargs.setdefault("generator_spec",
                                  dict(spec.generator_spec))
            server = InferenceServer.from_checkpoint(
                spec.prefix, spec.epoch, spec.input_shapes, attach_aot=True,
                **kwargs)
        except BaseException as exc:
            with self._lock:
                self._faulting.pop(name, None)
                gen = self._plan_gen
            win["event"].set()
            self.metrics.fault_in_fails.inc(name)
            self._update_gauges()
            _telemetry.log_event("platform_fault_in_failed", model=name,
                                 replica=replica, gen=gen,
                                 error=repr(exc))
            raise
        self._observe_exec_bytes(spec, server)
        # bundle-on-first-build: a cold build writes its AOT bundle
        # immediately, not just at graceful page-out — a replica reaped
        # with its host saves nothing, and the degradation ladder's
        # re-fault onto survivors must still come back warm
        # (a build is cold when an entry missed the cache; the JAX
        # manager tests cold_bucket_runs() > 0, which warm-up keeps at 0)
        try:
            entries = server.compiled_entries()
            if any(e.cache_state == "miss" for e in entries):
                server.save_aot_bundle(spec.prefix, spec.epoch)
        except Exception:
            pass
        rep_name = None
        if device is None:
            # demand-paged arrivals carry no device: place on surviving
            # capacity, never on a host the health plane has declared
            # dead (the ladder's explicit replan may still move it)
            alive = self._health.alive_devices() if self._health else None
            dev = int(alive[0]) if alive else 0
        else:
            dev = int(device)
        with self._lock:
            reps = self._servers.setdefault(name, {})
            if replica in reps:  # raced another fault_in
                srv = reps[replica]
            else:
                rep_name = self._next_replica_name(name)
                reps[replica] = server
                self._placement.setdefault(name, {})[replica] = dev
                self._resident_since[name] = time.monotonic()
                srv = server
            self._faulting.pop(name, None)
            gen = self._plan_gen
        win["event"].set()
        if rep_name is None:
            server.stop(drain=False)
            return srv
        stop = start_heartbeater(
            self.registry, rep_name, server,
            meta={"model": name, "tenant": spec.tenant, "device": dev,
                  "replica": replica})
        with self._lock:
            self._beat_stops.setdefault(name, {})[replica] = \
                (rep_name, stop)
        dt_ms = (time.monotonic() - t0) * 1e3
        self._fault_in_ms[name] = dt_ms
        self.metrics.fault_ins.inc(name)
        self._update_gauges()
        _telemetry.log_event("platform_fault_in", model=name,
                             replica=replica, device=dev, gen=gen,
                             ms=round(dt_ms, 1),
                             cold_runs=server.cold_bucket_runs())
        return server

    def page_out(self, name: str, replica: Optional[int] = None,
                 graceful: bool = False):
        """Release the device memory of replicas of a model
        (``replica=None`` pages out every replica); the checkpoint on disk
        is what the next fault-in loads.  No-op for non-resident models.

        ``graceful=True`` is SLO-aware preemption: readiness drops and
        the replica deregisters FIRST (routers stop dispatching here),
        the batcher drains (bounded by ``MXNET_PLATFORM_DRAIN_MS``), live
        generate streams hand off to a surviving replica via the router's
        mid-stream failover, and only then is device memory released —
        transcripts stay bit-identical."""
        with self._lock:
            reps = self._servers.get(name, {})
            idxs = (sorted(reps) if replica is None
                    else [int(replica)] if int(replica) in reps else [])
            popped = []
            for i in idxs:
                popped.append((i, reps.pop(i),
                               self._beat_stops.get(name, {}).pop(i, None)))
                self._placement.get(name, {}).pop(i, None)
            if not self._servers.get(name):
                self._servers.pop(name, None)
                self._beat_stops.pop(name, None)
                self._placement.pop(name, None)
                self._resident_since.pop(name, None)
            gen = self._plan_gen
        if not popped:
            return
        faults.fire("platform.page_out")
        for i, server, beat in popped:
            self._page_out_one(name, i, server, beat, graceful, gen)
        self.metrics.page_outs.inc(name)
        self._update_gauges()

    def _page_out_one(self, name, idx, server, beat, graceful, gen):
        handed = 0
        if graceful:
            try:
                server.begin_drain()
            except Exception:
                pass
            if beat is not None:
                beat[1]()  # deregister: routers drop it on next sync
                beat = None
            try:
                server.wait_idle(
                    env("MXNET_PLATFORM_DRAIN_MS", 5000.0, float) / 1e3)
            except Exception:
                pass
        # bundle BEFORE stop: compiled_entries() is empty once the
        # predictors are released
        try:
            if server.compiled_entries():
                spec = self.spec(name)
                server.save_aot_bundle(spec.prefix, spec.epoch)
        except Exception:
            pass  # bundle refresh is best-effort; the next fault-in
            # still warms from the previous bundle (or builds)
        if beat is not None:
            beat[1]()
        if graceful:
            try:
                # live generate streams fail over mid-stream to a
                # surviving replica BEFORE the memory goes away
                handed = server.handoff_streams()
            except Exception:
                pass
            server.stop(drain=False)
        else:
            server.stop(drain=True)
        _telemetry.log_event("platform_page_out", model=name, replica=idx,
                             gen=gen, graceful=bool(graceful),
                             streams_handed_off=handed,
                             resident_bytes=server.resident_bytes())

    def migrate(self, name: str, device: int, replica: int = 0):
        """Move one replica to another device."""
        faults.fire("platform.migrate")
        with self._lock:
            resident = int(replica) in self._servers.get(name, {})
        if not resident:
            return self.fault_in(name, device, replica=replica)
        self.page_out(name, replica=replica, graceful=True)
        server = self.fault_in(name, device, replica=replica)
        self.metrics.migrations.inc(name)
        return server

    def replan(self, force: bool = False, graceful: bool = True):
        """One planner pass + actuation; returns the plan.  ``force``
        bypasses the anti-thrash guard and keeps actuating past
        individual action failures (the degradation-ladder mode)."""
        with self._lock:
            specs = dict(self._specs)
            current_replicas = {n: dict(v)
                                for n, v in self._placement.items() if v}
            current = {n: v[min(v)]
                       for n, v in current_replicas.items()}
        alive = (self._health.alive_devices()
                 if self._health is not None else None)
        plan = self.planner.plan(specs, self.demand(), current,
                                 alive_devices=alive,
                                 current_replicas=current_replicas)
        self.metrics.plans.inc()
        self._actuate(plan, force=force, graceful=graceful)
        return plan

    def _actuate(self, plan, force=False, graceful=True):
        with self._lock:
            gen = self._bump_gen_locked()
            since = dict(self._resident_since)
        _telemetry.log_event("platform_plan_actuate", gen=gen,
                             actions=len(plan.actions),
                             paged=len(plan.paged))
        now = time.monotonic()
        for act in plan.actions:
            model = act["model"]
            rep = act.get("replica", 0)
            try:
                if act["op"] == "page_out":
                    if not force and now - since.get(model, 0.0) \
                            < self._min_resident_s:
                        continue  # anti-thrash: too fresh to evict
                    self.page_out(model, replica=rep, graceful=graceful)
                elif act["op"] == "fault_in":
                    self.fault_in(model, act["device"], replica=rep)
                elif act["op"] == "migrate":
                    self.migrate(model, act["dst"], replica=rep)
            except Exception:
                if not force:
                    raise
                # ladder actuation keeps going: one failed action must
                # not strand the rest of the recovery
        return plan

    # -- degradation ladder ------------------------------------------------
    def _on_domain_health(self, domain, alive):
        """Health-plane transition callback: walk the degradation ladder
        on a domain death; replan + lift brownout on recovery."""
        with self._lock:
            gen = self._bump_gen_locked()
        _telemetry.log_event("platform_domain_transition", domain=domain,
                             alive=bool(alive), gen=gen)
        if alive:
            if self._quotas is not None and self._health is not None \
                    and not self._health.dead_domains():
                self._quotas.clear_brownout(gen=gen)
            try:
                self.replan(force=True)
            except Exception:
                pass
            return
        self._reap_domain(domain, gen)
        with self._lock:
            specs = dict(self._specs)
            current_replicas = {n: dict(v)
                                for n, v in self._placement.items() if v}
            current = {n: v[min(v)]
                       for n, v in current_replicas.items()}
        alive_devs = (self._health.alive_devices()
                      if self._health is not None else None)
        try:
            plan = self.planner.plan(specs, self.demand(), current,
                                     alive_devices=alive_devs,
                                     current_replicas=current_replicas)
        except Exception:
            return
        self.metrics.plans.inc()
        # rung 2 first: while the shuffle below runs, the door already
        # sheds the SLO classes that lost their seats — only ranks above
        # the best paged model's class stay admitted
        if self._quotas is not None:
            if plan.paged:
                ranks = [specs[n].slo_rank() for n in plan.paged
                         if n in specs]
                floor = max(0, min(ranks) - 1) if ranks else 0
                self._quotas.set_brownout(floor, gen=gen)
                self.metrics.brownouts.inc()
            elif self._health is not None \
                    and not self._health.dead_domains():
                self._quotas.clear_brownout(gen=gen)
        # rung 1 (warm re-faults onto survivors) + rung 3 (graceful
        # page-out of the lowest-score models) in one actuation
        self._actuate(plan, force=True, graceful=True)

    def _reap_domain(self, domain, gen):
        """Drop every replica placed in a dead domain: its host is gone,
        so there is no drain — stop the heartbeat thread, reap the
        registry corpse so routers converge before the TTL, release
        whatever the in-process simulation still holds."""
        dead = []
        with self._lock:
            for name in list(self._placement):
                reps = self._placement[name]
                for i in [i for i, d in reps.items()
                          if self.pool.domain_of(d) == domain]:
                    dev = reps.pop(i)
                    server = self._servers.get(name, {}).pop(i, None)
                    beat = self._beat_stops.get(name, {}).pop(i, None)
                    dead.append((name, i, dev, server, beat))
                if not self._servers.get(name):
                    self._servers.pop(name, None)
                    self._beat_stops.pop(name, None)
                    self._placement.pop(name, None)
                    self._resident_since.pop(name, None)
        for name, i, dev, server, beat in dead:
            if beat is not None:
                try:
                    beat[1](deregister=False)  # dead hosts don't leave
                except Exception:
                    pass
                try:
                    self.registry.deregister(beat[0])
                except Exception:
                    pass
            if server is not None:
                try:
                    server.stop(drain=False)
                except Exception:
                    pass
            self.metrics.reaps.inc(name)
            _telemetry.log_event("platform_replica_reap", model=name,
                                 replica=i, device=dev, domain=domain,
                                 gen=gen)
        self._update_gauges()

    def kill_replica(self, name: str, replica: int = 0) -> bool:
        """Chaos hook: simulate host death for one replica.  Its server
        dies hard (streams fail mid-flight, memory gone) and its
        heartbeats STOP without deregistering — exactly a kill -9'd
        host.  Control-plane state still lists the replica as placed:
        only the health plane's probe (registry TTL eviction) discovers
        the loss and triggers the degradation ladder."""
        replica = int(replica)
        with self._lock:
            server = self._servers.get(name, {}).get(replica)
            beat = self._beat_stops.get(name, {}).get(replica)
        if beat is not None:
            try:
                beat[1](deregister=False)
            except Exception:
                pass
            with self._lock:
                # the heartbeater is dead, but the registry NAME must
                # stay on file: the ladder's reap deregisters the corpse
                # by that name so routers converge before the TTL would
                if replica in self._beat_stops.get(name, {}):
                    self._beat_stops[name][replica] = (
                        beat[0], lambda **kw: None)
        if server is not None:
            server.stop(drain=False)
        _telemetry.log_event("platform_replica_kill", model=name,
                             replica=replica)
        return server is not None

    # -- observability -----------------------------------------------------
    def _observe_exec_bytes(self, spec, server):
        """Refine the spec's executable-footprint estimate from the live
        server's compile-cache entries (when the cache primed it): the
        bytes each CUDA graph's pool took at its capture, and its static
        input buffers.  The parameters are not in them (``param_footprint``
        counts those)."""
        try:
            total = 0
            for entry in server.compiled_entries():
                info = getattr(entry, "cost_info", None) or {}
                total += int(info.get("pool_bytes") or 0)
                total += int(info.get("static_bytes") or 0)
            if total:
                spec.observe_exec_bytes(total)
        except Exception:
            pass

    def resident_bytes(self) -> int:
        """Device bytes pinned by resident models right now — the value
        behind ``mxtpu_platform_resident_bytes``.  Falls after
        ``page_out`` (the released server reports 0)."""
        with self._lock:
            servers = [s for reps in self._servers.values()
                       for s in reps.values()]
        return sum(s.resident_bytes() for s in servers)

    def _update_gauges(self):
        with self._lock:
            n = sum(1 for reps in self._servers.values() if reps)
        self.metrics.g_resident.set(n)
        self.metrics.g_resident_bytes.set(self.resident_bytes())

    def server_for(self, name: str) -> Optional[InferenceServer]:
        """The first live replica server of a model (None when paged
        out).  Prefers a replica that is not stopped — during a host
        loss the killed replica's corpse must not shadow its surviving
        peer."""
        with self._lock:
            reps = self._servers.get(name)
            if not reps:
                return None
            for i in sorted(reps):
                if reps[i].ready_state() != "stopped":
                    return reps[i]
            return reps[min(reps)]

    def placement(self) -> Dict[str, int]:
        """Primary (lowest-index) replica's device per resident model —
        the legacy single-replica view; :meth:`replica_placement` has
        the full map."""
        with self._lock:
            return {n: v[min(v)]
                    for n, v in self._placement.items() if v}

    def replica_placement(self) -> Dict[str, Dict[int, int]]:
        with self._lock:
            return {n: dict(v) for n, v in self._placement.items() if v}

    def fault_in_latency_ms(self, name: str) -> Optional[float]:
        return self._fault_in_ms.get(name)

    def describe(self) -> dict:
        with self._lock:
            resident = sorted(n for n, v in self._servers.items() if v)
            placement = {n: v[min(v)]
                         for n, v in self._placement.items() if v}
            replica_placement = {n: dict(v)
                                 for n, v in self._placement.items() if v}
            gen = self._plan_gen
        out = {
            "models": {n: self.spec(n).describe() for n in self.models()},
            "resident": resident,
            "placement": placement,
            "replica_placement": replica_placement,
            "paged": sorted(set(self.models()) - set(resident)),
            "demand": {n: round(v, 2) for n, v in self.demand().items()},
            "resident_bytes": self.resident_bytes(),
            "plan_generation": gen,
            "pool": self.pool.describe(),
        }
        if self._health is not None:
            out["health"] = self._health.describe()
        return out

    # -- lifecycle ---------------------------------------------------------
    def start(self, replan_ms: Optional[float] = None):
        """Start the background replan loop (no-op when the period
        resolves to 0)."""
        period_ms = env("MXNET_PLATFORM_REPLAN_MS", 2000.0, float) \
            if replan_ms is None else float(replan_ms)
        if period_ms <= 0 or self._loop_thread is not None:
            return self
        period_s = period_ms / 1e3

        def loop():
            while not self._loop_stop.wait(period_s):
                try:
                    self.replan()
                except Exception:
                    pass  # one bad tick must not kill the planner

        self._loop_thread = threading.Thread(
            target=loop, name="mxtpu-platform-replan", daemon=True)
        self._loop_thread.start()
        return self

    def close(self):
        """Stop the loop and page out every resident model."""
        if self._closed:
            return
        self._closed = True
        self._loop_stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None
        for name in list(self._servers):
            try:
                self.page_out(name)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
