"""Autoscaler — counterpart of ``mxnet_tpu/serving/autoscaler.py``: the
control loop that closes the serving feedback loop.

The Router *detects* trouble — queue pressure, per-SLO p99 vs deadline
budget, breaker-open count, shed rate.  This module is the controller: a
small loop over :meth:`Router.signals` that holds the non-draining replica
count inside a ``MIN:MAX`` band.

Control law (deliberately boring — serving controllers should be):

* **overloaded** when aggregate pressure crosses
  ``MXNET_SERVING_AUTOSCALE_OUT_PRESSURE``, any SLO class's p99 exceeds
  its deadline budget, requests were shed since the last tick, or a
  breaker is open (an open breaker is lost capacity, not just noise).
* **underloaded** when pressure is below
  ``MXNET_SERVING_AUTOSCALE_IN_PRESSURE`` and none of the overload
  signals fire.
* **hysteresis**: a direction must hold for
  ``MXNET_SERVING_AUTOSCALE_HYSTERESIS`` consecutive ticks before it
  actuates — one hot tick must not spawn a replica.
* **cooldown**: after any scale event, decisions pause for
  ``MXNET_SERVING_AUTOSCALE_COOLDOWN_MS`` so the fleet's response to
  the last action is measured before the next one (no flapping).

Scale-out asks a *provider* for a warm replica (every bucket run once
before it takes traffic — the first request on a fresh replica must run
with ``cold_bucket_runs() == 0``).  Scale-in picks the least-loaded replica
the autoscaler itself spawned, flips it to draining (``/readyz`` 503,
no new dispatch), waits for inflight under the hard
``MXNET_SERVING_DRAIN_TIMEOUT_MS`` deadline, then retires it.  Every
decision is a structured telemetry event and a fault-injectable dotted
op (``serving.autoscaler.scale_out`` / ``scale_in`` / ``drain``), and
the clock is injectable so hysteresis/cooldown are unit-testable
without a single real sleep.

Providers::

    LocalCheckpointProvider   # in-process InferenceServer per spawn
    ProcessProvider           # one OS process per spawn (python -m
                              # mxnet_tpu_torch.serving.launch); retires
                              # via SIGTERM, sharing the preemption drain
                              # path

A provider with ``self_registering=True`` (anything given a registry)
announces its replicas through the :class:`ReplicaRegistry`; replicated
routers discover them via their sync loop and the autoscaler never
touches ``add_replica`` directly — the registry stays the single source
of fleet truth.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from .. import faults
from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env
from ..context import current_context
from .registry import start_heartbeater
from .server import InferenceServer

__all__ = ["Autoscaler", "LocalCheckpointProvider", "ProcessProvider"]

register_env("MXNET_SERVING_AUTOSCALE_MIN", 1, int,
             "Autoscaler floor: never drain below this many serving "
             "replicas.")
register_env("MXNET_SERVING_AUTOSCALE_MAX", 4, int,
             "Autoscaler ceiling: never spawn above this many serving "
             "replicas.")
register_env("MXNET_SERVING_AUTOSCALE_INTERVAL_MS", 500.0, float,
             "Autoscaler control-loop tick period.")
register_env("MXNET_SERVING_AUTOSCALE_OUT_PRESSURE", 0.5, float,
             "Aggregate queue pressure (backlog/capacity) at or above "
             "which a tick votes scale-out.")
register_env("MXNET_SERVING_AUTOSCALE_IN_PRESSURE", 0.1, float,
             "Aggregate queue pressure at or below which a tick votes "
             "scale-in (only when no overload signal fires).")
register_env("MXNET_SERVING_AUTOSCALE_HYSTERESIS", 2, int,
             "Consecutive same-direction autoscaler ticks required "
             "before a scale decision actuates.")
register_env("MXNET_SERVING_AUTOSCALE_COOLDOWN_MS", 5000.0, float,
             "Pause after any scale event before the autoscaler makes "
             "another decision (anti-flap).")


class Autoscaler:
    """Pressure/SLO-driven replica-count controller over one Router.

    Parameters
    ----------
    router : Router
        Source of :meth:`~Router.signals` and (for non-registry
        providers) the actuation target.
    provider
        ``spawn() -> (name, backend)`` / ``retire(name, backend)``; see
        :class:`LocalCheckpointProvider`.  ``self_registering`` providers
        announce replicas via the registry instead of the router.
    min_replicas, max_replicas : int
        The band; defaults from ``MXNET_SERVING_AUTOSCALE_MIN/_MAX``.
    clock : callable
        Monotonic-seconds source; tests inject a fake one so hysteresis
        and cooldown are exercised without real sleeps.
    """

    def __init__(self, router, provider,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 interval_ms: Optional[float] = None,
                 out_pressure: Optional[float] = None,
                 in_pressure: Optional[float] = None,
                 hysteresis: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 drain_timeout_ms: Optional[float] = None,
                 clock=time.monotonic):
        def knob(val, name, default, typ):
            return env(name, default, typ) if val is None else typ(val)

        self._router = router
        self._provider = provider
        self._min = knob(min_replicas, "MXNET_SERVING_AUTOSCALE_MIN", 1, int)
        self._max = knob(max_replicas, "MXNET_SERVING_AUTOSCALE_MAX", 4, int)
        if not 1 <= self._min <= self._max:
            raise MXNetError("bad autoscale band %d:%d"
                             % (self._min, self._max))
        self._interval_s = knob(interval_ms,
                                "MXNET_SERVING_AUTOSCALE_INTERVAL_MS",
                                500.0, float) / 1e3
        self._out_pressure = knob(out_pressure,
                                  "MXNET_SERVING_AUTOSCALE_OUT_PRESSURE",
                                  0.5, float)
        self._in_pressure = knob(in_pressure,
                                 "MXNET_SERVING_AUTOSCALE_IN_PRESSURE",
                                 0.1, float)
        self._hyst = max(1, knob(hysteresis,
                                 "MXNET_SERVING_AUTOSCALE_HYSTERESIS",
                                 2, int))
        self._cooldown_s = knob(cooldown_ms,
                                "MXNET_SERVING_AUTOSCALE_COOLDOWN_MS",
                                5000.0, float) / 1e3
        self._drain_timeout_ms = drain_timeout_ms
        self._clock = clock
        self._over = 0
        self._under = 0
        self._last_event = None  # clock() of the last actuation
        self._last_shed = None
        self._owned = {}  # name -> backend (replicas this loop spawned)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.events = []  # decision log (tests + bench read this)
        reg = self._registry = _telemetry.Registry()
        self._c_out = reg.counter("mxtpu_autoscale_out_total",
                                  "Scale-out actuations.")
        self._c_in = reg.counter("mxtpu_autoscale_in_total",
                                 "Scale-in actuations.")
        self._c_failed = reg.counter("mxtpu_autoscale_failed_total",
                                     "Scale actuations that raised.")
        self._g_owned = reg.gauge("mxtpu_autoscale_owned_replicas",
                                  "Replicas this autoscaler spawned and "
                                  "still owns.")

    # -- signals -> decision ------------------------------------------------
    def _classify(self, sig) -> str:
        """One tick's vote: ``out`` / ``in`` / ``hold`` plus why."""
        shed = sig["shed_total"]
        shed_delta = 0 if self._last_shed is None else shed - self._last_shed
        self._last_shed = shed
        slo_hot = [s for s, v in sig["p99_ms"].items()
                   if v > sig["deadline_ms"][s]]
        reasons = []
        if sig["pressure"] >= self._out_pressure:
            reasons.append("pressure=%.2f" % sig["pressure"])
        if slo_hot:
            reasons.append("slo_p99_over_budget=%s" % ",".join(slo_hot))
        if shed_delta > 0:
            reasons.append("shed_delta=%d" % shed_delta)
        if sig["breakers_open"] > 0:
            reasons.append("breakers_open=%d" % sig["breakers_open"])
        if reasons:
            return "out", ";".join(reasons)
        if sig["pressure"] <= self._in_pressure:
            return "in", "pressure=%.2f" % sig["pressure"]
        return "hold", ""

    def tick(self) -> Optional[dict]:
        """One control-loop iteration; returns the decision event when a
        scale actuation happened, else None.  Pure function of the
        router's signals + the injected clock — the whole hysteresis /
        cooldown state machine runs through here."""
        now = self._clock()
        sig = self._router.signals()
        vote, why = self._classify(sig)
        if vote == "out":
            self._over += 1
            self._under = 0
        elif vote == "in":
            self._under += 1
            self._over = 0
        else:
            self._over = self._under = 0
        if (self._last_event is not None
                and now - self._last_event < self._cooldown_s):
            return None  # cooling down: observe, don't actuate
        active = sig["replicas"] - sig["draining"]
        if vote == "out" and self._over >= self._hyst and active < self._max:
            return self._scale_out(now, sig, why)
        if vote == "in" and self._under >= self._hyst and active > self._min:
            return self._scale_in(now, sig, why)
        return None

    # -- actuation ----------------------------------------------------------
    def _record(self, event):
        self.events.append(event)
        _telemetry.log_event("autoscale", **event)
        return event

    def _scale_out(self, now, sig, why):
        self._over = 0
        self._last_event = now
        try:
            faults.fire("serving.autoscaler.scale_out")
            name, backend = self._provider.spawn()
            if not getattr(self._provider, "self_registering", False):
                self._router.add_replica(backend, name=name)
        except Exception as exc:
            self._c_failed.inc()
            return self._record({"op": "scale_out", "ok": False,
                                 "why": why, "error": repr(exc)})
        with self._lock:
            self._owned[name] = backend
            self._g_owned.set(len(self._owned))
        self._c_out.inc()
        return self._record({"op": "scale_out", "ok": True, "replica": name,
                             "why": why, "replicas": sig["replicas"] + 1,
                             "pressure": round(sig["pressure"], 3)})

    def _pick_victim(self):
        """Least-loaded non-draining replica among the ones this loop
        spawned — the seed fleet (anything it did not spawn) is never
        retired, so the MIN band and the operator's baseline both hold."""
        with self._lock:
            owned = set(self._owned)
        cands = [d for d in self._router.describe()
                 if d["name"] in owned and not d["draining"]]
        if not cands:
            return None
        return min(cands,
                   key=lambda d: (d["inflight"] + d["queue_depth"],
                                  d["name"]))["name"]

    def _scale_in(self, now, sig, why):
        victim = self._pick_victim()
        if victim is None:
            return None  # nothing we own is retirable; keep observing
        self._under = 0
        self._last_event = now
        with self._lock:
            backend = self._owned.pop(victim)
            self._g_owned.set(len(self._owned))
        try:
            faults.fire("serving.autoscaler.scale_in")
            faults.fire("serving.autoscaler.drain")
            if getattr(self._provider, "self_registering", False):
                # deregistration is the announcement; every replicated
                # router drain-removes it through its registry sync
                self._provider.retire(victim, backend)
            else:
                self._router.remove_replica(
                    victim, drain=True,
                    drain_timeout_ms=self._drain_timeout_ms)
                self._provider.retire(victim, backend)
        except Exception as exc:
            self._c_failed.inc()
            return self._record({"op": "scale_in", "ok": False,
                                 "replica": victim, "why": why,
                                 "error": repr(exc)})
        self._c_in.inc()
        return self._record({"op": "scale_in", "ok": True, "replica": victim,
                             "why": why, "replicas": sig["replicas"] - 1,
                             "pressure": round(sig["pressure"], 3)})

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        """Run :meth:`tick` every interval in a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._interval_s):
                try:
                    self.tick()
                except Exception:
                    self._c_failed.inc()

        self._thread = threading.Thread(target=loop,
                                        name="mxtpu-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, retire_owned: bool = False):
        """Stop the loop; with ``retire_owned`` also drain-retire every
        replica this autoscaler spawned (test/bench teardown)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if retire_owned:
            with self._lock:
                owned = dict(self._owned)
                self._owned.clear()
                self._g_owned.set(0)
            for name, backend in owned.items():
                try:
                    if not getattr(self._provider, "self_registering",
                                   False):
                        self._router.remove_replica(
                            name, drain=True,
                            drain_timeout_ms=self._drain_timeout_ms)
                    self._provider.retire(name, backend)
                except Exception:
                    pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(retire_owned=True)

    def owned(self):
        with self._lock:
            return dict(self._owned)

    def metrics_text(self):
        return self._registry.render_prometheus()


class LocalCheckpointProvider:
    """Spawn warm in-process :class:`InferenceServer` replicas from one
    checkpoint prefix.

    Each spawn warms every bucket before it is handed out, so the
    scaled-out replica's first request runs with ``cold_bucket_runs() ==
    0``; with ``attach_aot`` (default) it attaches the checkpoint's AOT
    bundle before warm-up, so every bucket warms from its entry.
    Without a ``ctx`` the replicas go to the
    constructing thread's current context, resolved here: spawns run on
    the autoscaler's thread, which never sees the caller's ``with
    mt.cpu():``.  Given a
    ``registry``, each spawn registers + heartbeats there
    (``self_registering``); replicated routers pick it up via sync.
    """

    def __init__(self, prefix, epoch, input_shapes, registry=None,
                 attach_aot: bool = True, name_prefix: str = "auto",
                 meta=None, **server_kwargs):
        self._prefix = prefix
        self._epoch = int(epoch)
        self._input_shapes = dict(input_shapes)
        self._registry = registry
        self._attach_aot = bool(attach_aot)
        self._name_prefix = name_prefix
        # registration meta (e.g. {"model": ..., "tenant": ...}) so
        # model-scoped routers adopt only this provider's replicas
        self._meta = dict(meta) if meta else None
        self._server_kwargs = dict(server_kwargs)
        if self._server_kwargs.get("ctx") is None:
            self._server_kwargs["ctx"] = current_context()
        self._seq = itertools.count()
        self._beat_stops = {}

    @property
    def self_registering(self) -> bool:
        return self._registry is not None

    def spawn(self):
        name = "%s%d" % (self._name_prefix, next(self._seq))
        server = InferenceServer.from_checkpoint(
            self._prefix, self._epoch, self._input_shapes,
            attach_aot=self._attach_aot, **self._server_kwargs)
        if self._registry is not None:
            self._beat_stops[name] = start_heartbeater(
                self._registry, name, server, meta=self._meta)
        return name, server

    def retire(self, name, server):
        server.begin_drain()  # /readyz 503: no router dispatches here again
        stop_beat = self._beat_stops.pop(name, None)
        if stop_beat is not None:
            stop_beat()  # deregisters; router syncs drain-remove it
        server.stop(drain=True)


class ProcessProvider:
    """Spawn one OS process per replica: ``python -m
    mxnet_tpu_torch.serving.launch`` (the JAX package spawns ``tools/
    launch.py --serving``, which imports the JAX package; this module has
    the same arguments).  Always ``self_registering``: the child process
    registers itself (name passed via ``--name``) against the registry
    HTTP address and installs the SIGTERM preemption handler, so
    ``retire`` is just SIGTERM — autoscaler retirement and cluster
    preemption run the identical drain → deregister → exit path.  The
    child inherits this process's environment and serves on ``gpu(0)``
    unless ``MXNET_SERVING_CTX`` names another context.  Processes are
    ``subprocess.Popen`` (fork + exec), never a fork of a process whose
    CUDA is up.
    """

    self_registering = True

    def __init__(self, registry_addr: str, prefix, epoch, input_shapes,
                 name_prefix: str = "proc", extra_args=()):
        self._registry_addr = registry_addr
        self._prefix = prefix
        self._epoch = int(epoch)
        self._input_shapes = dict(input_shapes)
        self._name_prefix = name_prefix
        self._extra_args = list(extra_args)
        self._seq = itertools.count()

    def spawn(self):
        import json
        import os
        import subprocess
        import sys

        name = "%s%d" % (self._name_prefix, next(self._seq))
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving.launch",
               "--serving", "--registry", self._registry_addr,
               "--name", name,
               "--prefix", str(self._prefix), "--epoch", str(self._epoch),
               "--input-shapes",
               json.dumps({k: list(v)
                           for k, v in self._input_shapes.items()}),
               ] + self._extra_args
        # the package's own checkout first, wherever the caller runs
        child_env = dict(os.environ)
        path = child_env.get("PYTHONPATH", "")
        child_env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
        proc = subprocess.Popen(cmd, env=child_env)
        return name, proc

    def retire(self, name, proc):
        import signal as _signal

        proc.send_signal(_signal.SIGTERM)
        try:
            proc.wait(timeout=env("MXNET_SERVING_DRAIN_TIMEOUT_MS",
                                  30000.0, float) / 1e3 + 10)
        except Exception:
            proc.kill()
