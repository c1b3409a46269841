"""HealthPlane — failure-domain liveness for the platform (counterpart of
``mxnet_tpu/platform/healthplane.py``).

The placement planner packs devices as if they live forever; real hosts
do not.  This module groups the :class:`~.planner.DevicePool`'s devices
into **failure domains** (host = domain, ``DevicePool.devices_per_host``
devices each) and tracks one alive/dead bit per domain from two
signals:

* **Registry heartbeats** — a dead host does not deregister, its
  heartbeats just stop.  Replicas register with a ``device`` meta label;
  a domain that *had* live replicas and now shows none (TTL-evicted from
  the :class:`~mxnet_tpu_torch.serving.registry.ReplicaRegistry`) counts a
  probe miss.
* **Injectable faults** — every probe fires one dotted op per domain
  (``platform.health.domain.<d>``); an injected error IS a probe miss
  for that domain, so chaos specs kill a host deterministically
  (``platform.health.domain.0:ioerr=1.0`` under ``MXNET_FAULTS_SEED``).

Debounce mirrors the router's probe contract: ``MXNET_PLATFORM_HEALTH_FAILS``
consecutive misses flip a domain down, ONE success flips it back up — a
slow heartbeat under load must not trigger the degradation ladder.
Every transition is a structured telemetry event and a callback into the
:class:`~.manager.ModelManager`, which reacts by reaping dead replicas,
re-planning over the surviving capacity, and walking the degradation
ladder.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import faults
from .. import telemetry as _telemetry
from ..base import env, register_env

__all__ = ["HealthPlane"]

register_env("MXNET_PLATFORM_HEALTH_FAILS", 3, int,
             "Consecutive health-probe misses before the platform marks "
             "a failure domain (host) dead; recovery takes one success.")
register_env("MXNET_PLATFORM_HEALTH_PROBE_MS", 500.0, float,
             "Background health-probe period of a started HealthPlane "
             "(0 disables the loop; probe() stays callable).")


class HealthPlane:
    """Per-failure-domain liveness over a :class:`~.planner.DevicePool`.

    Parameters
    ----------
    pool : DevicePool
        Supplies the device -> domain grouping.
    registry : ReplicaRegistry, optional
        Heartbeat source; without one only the faults hooks and explicit
        ``mark_down``/``mark_up`` drive transitions.
    probe_fails : int, optional
        Debounce threshold; default ``MXNET_PLATFORM_HEALTH_FAILS``.
    on_change : callable, optional
        ``on_change(domain, alive)`` fired (outside the lock) on every
        transition — the manager's degradation-ladder entry point.
    """

    def __init__(self, pool, registry=None,
                 probe_fails: Optional[int] = None, on_change=None):
        self.pool = pool
        self.registry = registry
        self._k = max(1, env("MXNET_PLATFORM_HEALTH_FAILS", 3, int)
                      if probe_fails is None else int(probe_fails))
        self._on_change = on_change
        self._lock = threading.Lock()
        self._alive: Dict[int, bool] = {
            d: True for d in range(pool.num_domains)}
        self._misses: Dict[int, int] = {
            d: 0 for d in range(pool.num_domains)}
        # domains that have ever shown live registry replicas: only those
        # can miss on an empty heartbeat view (a domain nothing was ever
        # placed on is not dead, just idle)
        self._expected = set()
        self._loop_stop = threading.Event()
        self._loop_thread = None

    # -- probing -----------------------------------------------------------
    def probe(self) -> List[tuple]:
        """One liveness sweep; returns the ``(domain, alive)``
        transitions it caused (empty when nothing changed)."""
        faults.fire("platform.health.probe")
        present = set()
        if self.registry is not None:
            meta = self.registry.live().get("meta", {})
            for rec in meta.values():
                dev = rec.get("device")
                if dev is not None:
                    present.add(self.pool.domain_of(int(dev)))
        transitions = []
        with self._lock:
            for dom in range(self.pool.num_domains):
                ok = True
                try:
                    faults.fire("platform.health.domain.%d" % dom)
                except Exception:
                    ok = False
                if ok and self.registry is not None:
                    if dom in present:
                        self._expected.add(dom)
                    elif dom in self._expected:
                        # had replicas, heartbeats stopped: TTL eviction
                        # emptied the domain without a deregister — the
                        # dead-host signature
                        ok = False
                if ok:
                    self._misses[dom] = 0
                    if not self._alive[dom] and \
                            (self.registry is None or dom in present):
                        # recovery needs positive evidence when a
                        # registry is attached: a reaped domain is empty
                        # AND dead until a replica heartbeats from it
                        # again (or mark_up re-admits it explicitly)
                        self._alive[dom] = True
                        transitions.append((dom, True))
                else:
                    self._misses[dom] += 1
                    if self._alive[dom] and self._misses[dom] >= self._k:
                        self._alive[dom] = False
                        self._expected.discard(dom)
                        transitions.append((dom, False))
        for dom, up in transitions:
            self._announce(dom, up)
        return transitions

    def _announce(self, dom, up):
        _telemetry.log_event("platform_domain_health", domain=dom,
                             alive=up,
                             devices=self.pool.devices_in(dom))
        if self._on_change is not None:
            try:
                self._on_change(dom, up)
            except Exception:
                pass  # a ladder failure must not kill the prober

    def mark_down(self, domain: int):
        """Explicit administrative/chaos transition (no debounce)."""
        with self._lock:
            changed = self._alive.get(domain, True)
            self._alive[domain] = False
            self._misses[domain] = self._k
            self._expected.discard(domain)
        if changed:
            self._announce(domain, False)

    def mark_up(self, domain: int):
        with self._lock:
            changed = not self._alive.get(domain, True)
            self._alive[domain] = True
            self._misses[domain] = 0
        if changed:
            self._announce(domain, True)

    # -- queries -----------------------------------------------------------
    def is_alive(self, device: int) -> bool:
        with self._lock:
            return self._alive.get(self.pool.domain_of(device), True)

    def alive_domains(self) -> List[int]:
        with self._lock:
            return sorted(d for d, ok in self._alive.items() if ok)

    def dead_domains(self) -> List[int]:
        with self._lock:
            return sorted(d for d, ok in self._alive.items() if not ok)

    def alive_devices(self) -> List[int]:
        with self._lock:
            return [d for d in range(self.pool.num_devices)
                    if self._alive.get(self.pool.domain_of(d), True)]

    def describe(self) -> dict:
        with self._lock:
            return {"domains": {d: {"alive": ok,
                                    "misses": self._misses.get(d, 0),
                                    "devices": self.pool.devices_in(d)}
                                for d, ok in sorted(self._alive.items())},
                    "probe_fails": self._k}

    # -- lifecycle ---------------------------------------------------------
    def start(self, probe_ms: Optional[float] = None):
        """Start the background probe loop (no-op when the period
        resolves to 0)."""
        period_ms = env("MXNET_PLATFORM_HEALTH_PROBE_MS", 500.0, float) \
            if probe_ms is None else float(probe_ms)
        if period_ms <= 0 or self._loop_thread is not None:
            return self
        period_s = period_ms / 1e3

        def loop():
            while not self._loop_stop.wait(period_s):
                try:
                    self.probe()
                except Exception:
                    pass  # one bad sweep must not kill the prober

        self._loop_thread = threading.Thread(
            target=loop, name="mxtpu-platform-health", daemon=True)
        self._loop_thread.start()
        return self

    def close(self):
        self._loop_stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
