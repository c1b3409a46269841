"""Router — counterpart of ``mxnet_tpu/serving/router.py``: the resilient
serving front door over N InferenceServer replicas.  A remote replica is
any server that speaks the JAX package's HTTP API, so a router of either
package fronts servers of the other.

One :class:`InferenceServer` is a single point of failure: a replica
crash or a checkpoint reload drops requests.  The router makes the
serving tier survive any single failure with zero failed client
requests, with four cooperating mechanisms:

* **Health/load-aware dispatch** — every replica (in-process
  :class:`InferenceServer` or remote ``host:port`` backend) carries a
  liveness/readiness probe, an EWMA of observed latency, and an
  in-flight/queue-depth load estimate; dispatch picks the less-loaded of
  two random ready candidates (power-of-two-choices, which avoids the
  thundering-herd of strict least-loaded while staying O(1)).
* **Failure containment** — a per-replica circuit breaker
  (closed → open on consecutive failures → half-open probe → closed on
  success) keeps traffic off a sick replica while it recovers; a failed
  call is retried on another replica (bounded, carrying its original
  idempotent request id), so one replica's death is a latency blip, not
  an error.  Optional request hedging duplicates a slow call onto a
  second replica after a p99-based delay and takes the first answer —
  the classic tail-latency cure (requests are pure, so the duplicate is
  harmless by construction).
* **Per-SLO classes** — requests declare a class (``interactive`` /
  ``batch`` by default) mapping to a deadline budget and an admission
  priority; under queue pressure the sheddable classes are rejected
  first (HTTP 429 + ``Retry-After``), protecting interactive latency.
* **Zero-downtime hot-swap** — :meth:`Router.swap` rolls a new
  checkpoint through the fleet replica by replica: load params into a
  shadow replica, warm **every** batcher bucket on it (the steady state
  runs only warmed shapes), atomically
  flip it into rotation, then drain and recycle the old one.  Capacity
  never drops below N-1 and no request ever sees a 5xx.

Every decision point is a ``mxnet_tpu_torch.faults`` dotted op
(``serving.router.dispatch``, ``serving.replica.call``,
``serving.replica.<name>.call``, ``serving.router.hedge``,
``serving.router.swap``), so chaos scenarios drive the whole path
deterministically, and everything observable exports through
``mxnet_tpu_torch.telemetry`` (RouterMetrics registry collector, breaker
transition counters, hedge wins, swap events) and the profiler's spans
(``router/dispatch[slo]``, ``router/call[replica]``,
``router/swap[replica]``).
"""
from __future__ import annotations

import itertools
import json
import random
import threading
import time
from collections import deque
from concurrent.futures import (FIRST_COMPLETED, Future, ThreadPoolExecutor,
                                TimeoutError as FutureTimeoutError, wait)
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .. import faults
from .. import profiler
from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env
from .batcher import (DeadlineExceededError, QueueFullError,
                      ServerClosedError)
from .metrics import _percentile
from .server import InferenceServer

__all__ = ["Router", "SLOClass", "RouterMetrics", "RouterError",
           "NoReplicaAvailableError", "RouterOverloadError",
           "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]

register_env("MXNET_SERVING_ROUTER_RETRIES", 2, int,
             "Max ADDITIONAL replicas a failed request is retried on "
             "before the router gives up.")
register_env("MXNET_SERVING_ROUTER_WORKERS", 16, int,
             "Router dispatcher thread-pool size (concurrent in-flight "
             "requests the router itself drives).")
register_env("MXNET_SERVING_BREAKER_THRESHOLD", 3, int,
             "Consecutive hard failures on one replica before its "
             "circuit breaker opens.")
register_env("MXNET_SERVING_BREAKER_COOLDOWN_MS", 1000.0, float,
             "How long an open breaker waits before letting one "
             "half-open probe request through.")
register_env("MXNET_SERVING_HEDGE_MS", 0.0, float,
             "Request hedging: 0 disables, >0 is a fixed delay in ms "
             "before duplicating a slow call onto a second replica, <0 "
             "derives the delay from the observed p99 latency.")
register_env("MXNET_SERVING_HEDGE_MIN_MS", 5.0, float,
             "Floor (and cold-start default) for the p99-derived hedge "
             "delay.")
register_env("MXNET_SERVING_SHED_PRESSURE", 0.75, float,
             "Queue-pressure fraction (aggregate backlog / aggregate "
             "queue capacity) beyond which sheddable SLO classes are "
             "rejected with 429 + Retry-After.")
register_env("MXNET_SERVING_PROBE_INTERVAL_MS", 200.0, float,
             "Background health-probe period for remote replicas.")
register_env("MXNET_SERVING_CALL_TIMEOUT_MS", 30000.0, float,
             "Per-replica call timeout when a request carries no "
             "deadline — a wedged replica becomes a breaker failure, "
             "not a hung client.")
register_env("MXNET_SERVING_REMOTE_CAPACITY", 256, int,
             "Assumed queue capacity of a remote replica for the "
             "pressure estimate (local replicas report their real "
             "max_queue).")
register_env("MXNET_SERVING_PROBE_FAILURES", 3, int,
             "Consecutive background-probe failures before a remote "
             "replica's cached health/readiness flips to down — one "
             "slow /healthz under load must not flap the breaker.")
register_env("MXNET_ROUTER_PROBE_FAILS", 0, int,
             "Consecutive health-probe failures before the router marks "
             "a backend dead (recovery still takes one success); 0 "
             "defers to MXNET_SERVING_PROBE_FAILURES (default 3).")
register_env("MXNET_SERVING_REGISTRY_SYNC_MS", 500.0, float,
             "Period at which a registry-attached router re-syncs its "
             "replica set against the shared live set.")
register_env("MXNET_GEN_TTFT_MS", 0.0, float,
             "Time-to-first-token budget (ms) of the default 'generate' "
             "SLO class; 0 means no budget.  Doubles as the admission "
             "deadline the router passes to the engine's pending queue.")
register_env("MXNET_GEN_ITL_MS", 0.0, float,
             "Inter-token-latency budget (ms) of the default 'generate' "
             "SLO class; 0 means no budget.  Gaps beyond it count in "
             "mxtpu_router_itl_violations_total.")

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

_EWMA_ALPHA = 0.2


class RouterError(MXNetError):
    """Base class for router-level request failures."""


class NoReplicaAvailableError(RouterError):
    """Every routable replica was tried (or none was routable) and the
    request still failed — the HTTP 503 case."""


class RouterOverloadError(RouterError):
    """Admission control shed this request under queue pressure — the
    HTTP 429 + Retry-After case.  Sheddable classes go first."""

    def __init__(self, msg, retry_after=1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class SLOClass:
    """One service-level class: a default deadline budget plus an
    admission priority.  Higher ``priority`` numbers shed first;
    ``sheddable`` classes are rejected under queue pressure before any
    non-sheddable request is."""

    __slots__ = ("name", "deadline_ms", "priority", "sheddable",
                 "ttft_ms", "itl_ms")

    def __init__(self, name: str, deadline_ms: Optional[float] = None,
                 priority: int = 0, sheddable: bool = False,
                 ttft_ms: Optional[float] = None,
                 itl_ms: Optional[float] = None):
        self.name = name
        self.deadline_ms = deadline_ms
        self.priority = int(priority)
        self.sheddable = bool(sheddable)
        # streaming-generation budgets: a whole-request deadline is the
        # wrong unit for an open-ended token stream, so the generate
        # class budgets time-to-first-token and inter-token latency
        self.ttft_ms = ttft_ms
        self.itl_ms = itl_ms

    def __repr__(self):
        return ("SLOClass(%r, deadline_ms=%r, priority=%d, sheddable=%s, "
                "ttft_ms=%r, itl_ms=%r)"
                % (self.name, self.deadline_ms, self.priority,
                   self.sheddable, self.ttft_ms, self.itl_ms))


def default_slo_classes() -> Dict[str, SLOClass]:
    return {
        "interactive": SLOClass("interactive", priority=0, sheddable=False),
        "batch": SLOClass("batch", priority=1, sheddable=True),
        "generate": SLOClass(
            "generate", priority=0, sheddable=False,
            ttft_ms=env("MXNET_GEN_TTFT_MS", 0.0, float) or None,
            itl_ms=env("MXNET_GEN_ITL_MS", 0.0, float) or None),
    }


class _Request:
    __slots__ = ("rid", "slo", "inputs", "deadline", "t0")

    def __init__(self, rid, slo, inputs, deadline_ms):
        self.rid = rid
        self.slo = slo
        self.inputs = inputs
        self.t0 = time.monotonic()
        self.deadline = (self.t0 + deadline_ms / 1e3
                         if deadline_ms is not None else None)

    def remaining_ms(self) -> Optional[float]:
        """Deadline budget left, or raises when it is already spent —
        retries and hedges all charge against ONE budget."""
        if self.deadline is None:
            return None
        rem = (self.deadline - time.monotonic()) * 1e3
        if rem <= 0:
            raise DeadlineExceededError(
                "request %s exhausted its deadline budget" % self.rid)
        return rem


class RouterMetrics:
    """Registry-backed counters for one Router (a telemetry collector,
    like :class:`ServingMetrics`): per-SLO request/latency accounting,
    breaker transitions, failovers, hedges, sheds, swaps."""

    _LAT_SAMPLES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        reg = self._registry = _telemetry.Registry()
        self._req = reg.labeled_counter("mxtpu_router_requests_total", "slo")
        self._done = reg.labeled_counter(
            "mxtpu_router_requests_completed", "slo")
        self._failed = reg.labeled_counter(
            "mxtpu_router_requests_failed", "slo")
        self._shed = reg.labeled_counter("mxtpu_router_requests_shed", "slo")
        self._expired = reg.labeled_counter(
            "mxtpu_router_requests_expired", "slo")
        self._retries = reg.counter("mxtpu_router_retries_total")
        self._streams = reg.labeled_counter(
            "mxtpu_router_streams_total", "slo")
        self._stream_resumes = reg.counter(
            "mxtpu_router_stream_resumes_total")
        self._itl_violations = reg.counter(
            "mxtpu_router_itl_violations_total")
        self._hedges = reg.counter("mxtpu_router_hedges_total")
        self._hedge_wins = reg.counter("mxtpu_router_hedge_wins_total")
        self._swaps = reg.counter("mxtpu_router_swaps_total")
        self._breaker = reg.labeled_counter(
            "mxtpu_router_breaker_transitions_total", "state")
        self._rep_failures = reg.labeled_counter(
            "mxtpu_router_replica_failures_total", "replica")
        self._g_replicas = reg.gauge("mxtpu_router_replicas")
        self._g_ready = reg.gauge("mxtpu_router_replicas_ready")
        self._g_pressure = reg.gauge("mxtpu_router_pressure_pct")
        self._lat = {}  # slo -> deque of latency ms
        _telemetry.register_collector(self)

    # -- update hooks ------------------------------------------------------
    def on_submit(self, slo):
        self._req.inc(slo)

    def on_complete(self, slo, latency_ms):
        self._done.inc(slo)
        with self._lock:
            self._lat.setdefault(
                slo, deque(maxlen=self._LAT_SAMPLES)).append(latency_ms)

    def on_fail(self, slo):
        self._failed.inc(slo)

    def on_shed(self, slo):
        self._shed.inc(slo)

    def on_expire(self, slo):
        self._expired.inc(slo)

    def on_retry(self):
        self._retries.inc()

    def on_stream(self, slo):
        self._streams.inc(slo)

    def on_stream_resume(self):
        self._stream_resumes.inc()

    def on_itl_violation(self):
        self._itl_violations.inc()

    def on_hedge(self):
        self._hedges.inc()

    def on_hedge_win(self):
        self._hedge_wins.inc()

    def on_swap(self):
        self._swaps.inc()

    def on_breaker(self, state):
        self._breaker.inc(state)

    def on_replica_failure(self, name):
        self._rep_failures.inc(name)

    def set_topology(self, total, ready, pressure):
        self._g_replicas.set(total)
        self._g_ready.set(ready)
        self._g_pressure.set(int(pressure * 100))

    # -- export ------------------------------------------------------------
    def latency_quantile(self, q, slo=None):
        """Latency quantile in ms over completed requests (one class, or
        pooled); None until any request completed."""
        with self._lock:
            if slo is None:
                vals = [v for d in self._lat.values() for v in d]
            else:
                vals = list(self._lat.get(slo, ()))
        if not vals:
            return None
        return _percentile(sorted(vals), q)

    def snapshot(self):
        out = {
            "requests": self._req.snapshot(),
            "completed": self._done.snapshot(),
            "failed": self._failed.snapshot(),
            "shed": self._shed.snapshot(),
            "expired": self._expired.snapshot(),
            "retries": self._retries.value,
            "streams": self._streams.snapshot(),
            "stream_resumes": self._stream_resumes.value,
            "itl_violations": self._itl_violations.value,
            "hedges": self._hedges.value,
            "hedge_wins": self._hedge_wins.value,
            "swaps": self._swaps.value,
            "breaker_transitions": self._breaker.snapshot(),
            "replica_failures": self._rep_failures.snapshot(),
            "replicas": self._g_replicas.value,
            "replicas_ready": self._g_ready.value,
        }
        with self._lock:
            slos = list(self._lat)
        for slo in slos:
            out["latency_ms_p50_%s" % slo] = self.latency_quantile(.50, slo)
            out["latency_ms_p99_%s" % slo] = self.latency_quantile(.99, slo)
        return out

    def render_text(self):
        text = self._registry.render_prometheus()
        lines = [text] if text else []
        with self._lock:
            slos = list(self._lat)
        for slo in sorted(slos):
            for q, v in (("0.5", self.latency_quantile(.50, slo)),
                         ("0.99", self.latency_quantile(.99, slo))):
                if v is not None:
                    lines.append(
                        'mxtpu_router_latency_ms{slo="%s",quantile="%s"} '
                        '%.3f\n' % (slo, q, v))
        return "".join(lines)

    def render_prometheus(self):
        """Collector hook for ``telemetry.render_prometheus()``."""
        return self.render_text()


class _Replica:
    """Shared replica state machine: circuit breaker + load estimate.

    Breaker contract: CLOSED admits everything; ``threshold`` consecutive
    hard failures OPEN it; after ``cooldown`` the next pick transitions to
    HALF_OPEN and admits exactly one probe request — success re-CLOSEs,
    failure re-OPENs with a fresh cooldown.  Deadline expiries and
    queue-full rejections are *load* signals, not faults: they never
    advance the failure count.
    """

    kind = "base"

    def __init__(self, name, router):
        self.name = name
        self._router = router
        self._lock = threading.Lock()
        self.state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.inflight = 0
        self.ewma_ms = 0.0
        self.calls = 0
        # scale-in / hot-removal: a draining replica finishes its
        # in-flight work but never receives a new dispatch
        self.draining = False

    # -- breaker -----------------------------------------------------------
    def _transition(self, state):
        self.state = state
        self._router.metrics.on_breaker(state)
        _telemetry.log_event("router_breaker", replica=self.name,
                             state=state)

    def routable(self, now) -> bool:
        if self.draining:
            return False
        with self._lock:
            if self.state == BREAKER_OPEN and \
                    now - self._opened_at >= self._router.breaker_cooldown_s:
                self._transition(BREAKER_HALF_OPEN)
                self._probe_inflight = False
            if self.state == BREAKER_OPEN:
                return False
            if self.state == BREAKER_HALF_OPEN and self._probe_inflight:
                return False  # one probe at a time
        return self.ready()

    def try_reserve(self) -> bool:
        """Claim the right to dispatch one request here.  CLOSED admits
        everything; HALF_OPEN atomically admits exactly ONE probe —
        ``routable`` alone cannot enforce that, because two dispatcher
        threads may both read half-open+idle before either begins its
        call (the classic check-then-act race).  The reservation is
        released by ``end_call`` (any outcome) or ``release``."""
        with self._lock:
            if self.state == BREAKER_OPEN:
                return False
            if self.state == BREAKER_HALF_OPEN:
                if self._probe_inflight:
                    return False
                self._probe_inflight = True
            return True

    def release(self):
        """Undo a ``try_reserve`` that never became a call."""
        with self._lock:
            if self.state == BREAKER_HALF_OPEN:
                self._probe_inflight = False

    def begin_call(self):
        with self._lock:
            self.inflight += 1
            self.calls += 1
            if self.state == BREAKER_HALF_OPEN:
                self._probe_inflight = True

    def end_call(self, ok: Optional[bool], latency_ms: float):
        """``ok=None`` is the neutral outcome (deadline/queue-full):
        load bookkeeping only, breaker untouched."""
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            if ok is None:
                if self.state == BREAKER_HALF_OPEN:
                    self._probe_inflight = False
                return
            if ok:
                self._failures = 0
                self.ewma_ms = (latency_ms if self.ewma_ms == 0.0 else
                                _EWMA_ALPHA * latency_ms +
                                (1 - _EWMA_ALPHA) * self.ewma_ms)
                if self.state != BREAKER_CLOSED:
                    self._probe_inflight = False
                    self._transition(BREAKER_CLOSED)
            else:
                self._failures += 1
                if self.state == BREAKER_HALF_OPEN or \
                        self._failures >= self._router.breaker_threshold:
                    if self.state != BREAKER_OPEN:
                        self._transition(BREAKER_OPEN)
                    self._opened_at = time.monotonic()
                    self._probe_inflight = False
        if ok is False:
            self._router.metrics.on_replica_failure(self.name)

    # -- load --------------------------------------------------------------
    def score(self) -> float:
        """Lower routes first: EWMA latency scaled by outstanding work."""
        return (self.ewma_ms or 1.0) * (1.0 + self.inflight
                                        + self.queue_depth())

    def describe(self) -> dict:
        return {"name": self.name, "kind": self.kind, "state": self.state,
                "ready": self.ready(), "inflight": self.inflight,
                "ewma_ms": round(self.ewma_ms, 3), "calls": self.calls,
                "queue_depth": self.queue_depth(),
                "draining": self.draining}

    # -- backend interface -------------------------------------------------
    def ready(self) -> bool:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def queue_depth(self) -> int:
        return 0

    def capacity(self) -> int:
        return env("MXNET_SERVING_REMOTE_CAPACITY", 256, int)

    def call(self, inputs, deadline_ms, request_id, slo):
        raise NotImplementedError

    def supports_generate(self) -> bool:
        return False

    def generate_stream(self, prompt, max_new_tokens, deadline_ms,
                        request_id, slo):
        """Iterator of generated token ids; raising mid-iteration is the
        resume-on-another-replica signal."""
        raise NotImplementedError


class _LocalReplica(_Replica):
    """An in-process :class:`InferenceServer` behind the router."""

    kind = "local"

    def __init__(self, name, server: InferenceServer, router):
        super().__init__(name, router)
        self.server = server

    def ready(self):
        return self.server.ready()

    def alive(self):
        return not self.server._stopped

    def queue_depth(self):
        try:
            return self.server.queue_depth()
        except Exception:
            return 0

    def capacity(self):
        return self.server._batcher.max_queue

    def call(self, inputs, deadline_ms, request_id, slo):
        fut = self.server.submit(deadline_ms=deadline_ms, **inputs)
        timeout_ms = deadline_ms if deadline_ms is not None else \
            env("MXNET_SERVING_CALL_TIMEOUT_MS", 30000.0, float)
        try:
            # slack past the deadline: the server's own expiry wins the
            # race and surfaces as DeadlineExceededError, not a timeout
            return fut.result(timeout=timeout_ms / 1e3 + 5.0)
        except FutureTimeoutError:
            raise RouterError(
                "replica %s timed out after %.0fms (request %s)"
                % (self.name, timeout_ms, request_id))

    def supports_generate(self):
        return self.server._generator is not None

    def generate_stream(self, prompt, max_new_tokens, deadline_ms,
                        request_id, slo):
        stream = self.server.submit_generate(
            prompt, max_new_tokens, deadline_ms=deadline_ms)
        return iter(stream)


class _RemoteReplica(_Replica):
    """A remote ``host:port`` InferenceServer HTTP backend."""

    kind = "remote"

    def __init__(self, name, addr: str, router):
        super().__init__(name, router)
        self.addr = addr
        self._base = "http://%s" % addr
        self._probe_ready = None  # cached by the background probe thread
        self._probe_alive = None
        # debounce: one slow /healthz under load must not flap the
        # replica out of rotation — K consecutive failures flip it down,
        # one success flips it straight back up
        self._probe_k = max(1, env("MXNET_ROUTER_PROBE_FAILS", 0, int)
                            or env("MXNET_SERVING_PROBE_FAILURES", 3, int))
        self._alive_misses = 0
        self._ready_misses = 0

    def _get(self, path, timeout=2.0):
        import urllib.request

        with urllib.request.urlopen(self._base + path,
                                    timeout=timeout) as resp:
            return resp.status

    def _probe(self):
        """Refresh the cached liveness/readiness (background thread).
        Success is believed immediately; failure only after
        ``MXNET_SERVING_PROBE_FAILURES`` consecutive misses — except
        while the cache is still unset (first contact), where a miss
        counts at once so a never-up backend is not routed to."""
        faults.fire("serving.replica.probe")
        try:
            ok = self._get("/healthz") == 200
        except Exception:
            ok = False
        if ok:
            self._alive_misses = 0
            self._probe_alive = True
        else:
            self._alive_misses += 1
            if self._probe_alive is None or \
                    self._alive_misses >= self._probe_k:
                self._probe_alive = False
        try:
            ok = self._get("/readyz") == 200
        except Exception:
            ok = False
        if ok:
            self._ready_misses = 0
            self._probe_ready = True
        else:
            self._ready_misses += 1
            if self._probe_ready is None or \
                    self._ready_misses >= self._probe_k:
                self._probe_ready = False

    def ready(self):
        if self._probe_ready is None:
            try:
                self._probe()
            except Exception:
                return False
        return bool(self._probe_ready)

    def alive(self):
        if self._probe_alive is None:
            self.ready()
        return bool(self._probe_alive)

    def queue_depth(self):
        return 0  # remote backlog is not visible; inflight covers it

    def call(self, inputs, deadline_ms, request_id, slo):
        import urllib.error
        import urllib.request

        body = json.dumps({"inputs": {
            k: np.asarray(v).tolist() for k, v in inputs.items()}}).encode()
        headers = {"Content-Type": "application/json",
                   "X-Request-Id": request_id, "X-SLO-Class": slo}
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = "%.3f" % deadline_ms
        timeout_ms = deadline_ms if deadline_ms is not None else \
            env("MXNET_SERVING_CALL_TIMEOUT_MS", 30000.0, float)
        req = urllib.request.Request(self._base + "/predict", data=body,
                                     headers=headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_ms / 1e3 + 5.0) as resp:
                outs = json.loads(resp.read())["outputs"]
                return [np.asarray(o, np.float32) for o in outs]
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:200]
            exc.close()
            if exc.code == 504:
                raise DeadlineExceededError(detail)
            if exc.code in (429, 503):
                raise QueueFullError("replica %s rejected: %s"
                                     % (self.name, detail))
            raise RouterError("replica %s HTTP %d: %s"
                              % (self.name, exc.code, detail))

    def supports_generate(self):
        # not probeable cheaply: assume yes; a generator-less backend
        # answers 404 which surfaces as RouterError -> failover
        return True

    def generate_stream(self, prompt, max_new_tokens, deadline_ms,
                        request_id, slo):
        import urllib.error
        import urllib.request

        payload = {"prompt": [int(t) for t in prompt]}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        headers = {"Content-Type": "application/json",
                   "X-Request-Id": request_id, "X-SLO-Class": slo}
        timeout_ms = env("MXNET_SERVING_CALL_TIMEOUT_MS", 30000.0, float)
        req = urllib.request.Request(
            self._base + "/generate", data=json.dumps(payload).encode(),
            headers=headers)
        try:
            resp = urllib.request.urlopen(req, timeout=timeout_ms / 1e3)
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:200]
            exc.close()
            if exc.code == 429 or exc.code == 503:
                raise QueueFullError("replica %s rejected generate: %s"
                                     % (self.name, detail))
            if exc.code == 504:
                raise DeadlineExceededError(detail)
            raise RouterError("replica %s HTTP %d: %s"
                              % (self.name, exc.code, detail))

        def _iter():
            # NDJSON lines, one token each, until the done/error line;
            # connection close without one means the replica died
            with resp:
                done = False
                for line in resp:
                    obj = json.loads(line)
                    if "error" in obj:
                        raise RouterError("replica %s stream failed: %s"
                                          % (self.name, obj["error"]))
                    if obj.get("done"):
                        done = True
                        break
                    yield int(obj["token"])
                if not done:
                    raise RouterError(
                        "replica %s stream closed without done marker"
                        % self.name)
        return _iter()

    def swap(self, prefix, epoch, timeout=600.0):
        """Remote in-place hot-swap via ``POST /swap`` (the server warms
        every bucket on the new params before its atomic flip)."""
        import urllib.request

        body = json.dumps({"prefix": prefix, "epoch": int(epoch)}).encode()
        req = urllib.request.Request(
            self._base + "/swap", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())


class Router:
    """Health-aware front door over N serving replicas.

    Parameters
    ----------
    backends : sequence of InferenceServer | "host:port" str
        The replica set: in-process servers and/or remote HTTP backends
        (an :class:`InferenceServer` exposed via ``serve_http``).  Mixed
        sets are fine.
    slo_classes : dict name -> SLOClass, optional
        Defaults to ``interactive`` (never shed) + ``batch`` (sheddable).
    retries, breaker_threshold, breaker_cooldown_ms, hedge_ms,
    shed_pressure, workers
        Override the corresponding ``MXNET_SERVING_*`` env defaults.
    seed : int
        Seeds the power-of-two-choices RNG, so a chaos run's dispatch
        sequence is reproducible.
    registry : ReplicaRegistry | RegistryClient, optional
        A shared replica live-set (``serving.registry``).  The router
        syncs its replica set against it in the background
        (``MXNET_SERVING_REGISTRY_SYNC_MS``): members it has never seen
        are added, members that left or were evicted are drained and
        removed.  N routers attached to one registry converge on the
        same fleet — the front door stops being a single point of
        failure.  With a registry, ``backends`` may be empty.
    model : str, optional
        Restrict registry discovery to members whose registration meta
        carries this ``model`` label (members without one count as
        ``"default"``).  N model-scoped routers can then share one
        registry — the multi-model platform's per-model live view.
    """

    def __init__(self, backends: Sequence[Union[InferenceServer, str]] = (),
                 slo_classes: Optional[Dict[str, SLOClass]] = None,
                 retries: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 shed_pressure: Optional[float] = None,
                 workers: Optional[int] = None, seed: int = 0,
                 registry=None, registry_sync_ms: Optional[float] = None,
                 model: Optional[str] = None):
        if not backends and registry is None:
            raise ValueError("need at least one backend replica "
                             "(or a registry to discover them from)")
        self.metrics = RouterMetrics()
        self.retries = env("MXNET_SERVING_ROUTER_RETRIES", 2, int) \
            if retries is None else int(retries)
        self.breaker_threshold = \
            env("MXNET_SERVING_BREAKER_THRESHOLD", 3, int) \
            if breaker_threshold is None else int(breaker_threshold)
        self.breaker_cooldown_s = (
            env("MXNET_SERVING_BREAKER_COOLDOWN_MS", 1000.0, float)
            if breaker_cooldown_ms is None else float(breaker_cooldown_ms)
        ) / 1e3
        self.hedge_ms = env("MXNET_SERVING_HEDGE_MS", 0.0, float) \
            if hedge_ms is None else float(hedge_ms)
        self.shed_pressure = env("MXNET_SERVING_SHED_PRESSURE", 0.75, float) \
            if shed_pressure is None else float(shed_pressure)
        n_workers = env("MXNET_SERVING_ROUTER_WORKERS", 16, int) \
            if workers is None else int(workers)
        self.slo_classes = dict(slo_classes) if slo_classes is not None \
            else default_slo_classes()

        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()  # one rolling swap at a time
        self._replicas: List[_Replica] = []
        for i, b in enumerate(backends):
            name = "r%d" % i
            if isinstance(b, str):
                self._replicas.append(_RemoteReplica(name, b, self))
            else:
                self._replicas.append(_LocalReplica(name, b, self))
        self._name_seq = itertools.count(len(self._replicas))
        # servers the router itself created (swap shadows): it owns their
        # lifecycle; caller-provided backends stay the caller's
        self._owned: List[InferenceServer] = []
        self._closed = False
        self._rng = random.Random(seed)
        self._rid = itertools.count()
        self._pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="mxtpu-router")
        self._call_pool = ThreadPoolExecutor(
            max_workers=2 * n_workers + 2,
            thread_name_prefix="mxtpu-router-call")
        self._httpd = None
        self._http_thread = None
        self._probe_stop = threading.Event()
        self._probe_thread = None
        if any(isinstance(r, _RemoteReplica) for r in self._replicas):
            self._ensure_probe_thread()
        # registry-driven replica discovery (router replication): names
        # under registry management are synced against the shared live
        # set; constructor-passed backends stay the caller's.
        self._registry = registry
        # per-model registry view: with model=<name> only registry
        # members whose meta carries that model label are adopted
        # (absent label == "default"), so N model-scoped routers share
        # ONE registry instead of one registry per model.
        self._model = model
        self._registry_names: set = set()
        self._registry_gen = -1
        self._registry_stop = threading.Event()
        self._registry_thread = None
        if registry is not None:
            self._registry_sync_s = (
                env("MXNET_SERVING_REGISTRY_SYNC_MS", 500.0, float)
                if registry_sync_ms is None else float(registry_sync_ms)
            ) / 1e3
            self._sync_registry()  # first sync before taking traffic
            self._registry_thread = threading.Thread(
                target=self._registry_loop, name="mxtpu-router-regsync",
                daemon=True)
            self._registry_thread.start()

    def _ensure_probe_thread(self):
        if self._probe_thread is None:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="mxtpu-router-probe",
                daemon=True)
            self._probe_thread.start()

    # -- topology ----------------------------------------------------------
    def replicas(self) -> List[_Replica]:
        with self._lock:
            return list(self._replicas)

    def describe(self) -> List[dict]:
        return [r.describe() for r in self.replicas()]

    def pressure(self) -> float:
        """Aggregate backlog / aggregate queue capacity across replicas —
        the admission-control load signal sheddable classes are gated on
        (and the autoscaler's primary scale signal).  Draining replicas
        contribute their backlog but no capacity: retiring a replica
        must RAISE measured pressure, not mask it."""
        cap = 0
        load = 0
        for r in self.replicas():
            if not r.draining:
                cap += r.capacity()
            load += (r.queue_depth() if isinstance(r, _LocalReplica)
                     else r.inflight)
        return (load / cap) if cap else 1.0

    # -- dynamic topology (autoscaler + registry sync) ---------------------
    def add_replica(self, backend, name: Optional[str] = None) -> str:
        """Put a new backend into rotation; returns its replica name.
        The autoscaler's scale-out actuation and the registry sync both
        land here."""
        if self._closed:
            raise ServerClosedError("router is closed")
        with self._lock:
            if name is None:
                name = "r%d" % next(self._name_seq)
            if any(r.name == name for r in self._replicas):
                raise MXNetError("replica name %r already in rotation"
                                 % name)
            if isinstance(backend, str):
                rep = _RemoteReplica(name, backend, self)
            else:
                rep = _LocalReplica(name, backend, self)
            self._replicas.append(rep)
        if isinstance(rep, _RemoteReplica):
            self._ensure_probe_thread()
        _telemetry.log_event("router_topology", op="add", replica=name,
                             replica_kind=rep.kind)
        self._update_topology_metrics()
        return name

    def remove_replica(self, name: str, drain: bool = True,
                       drain_timeout_ms: Optional[float] = None,
                       wait: bool = True):
        """Take one replica out of rotation.  It is flipped to draining
        first (no new dispatch; requests in flight finish), then dropped
        from the set once idle or when the drain deadline
        (``MXNET_SERVING_DRAIN_TIMEOUT_MS``) expires — a wedged replica
        must not hang retirement forever.  With ``wait=False`` the
        drain-then-drop runs in a background thread (the registry sync
        path, which must stay responsive).  Returns the removed
        replica's backend (or None for ``wait=False`` / unknown
        names)."""
        with self._lock:
            rep = next((r for r in self._replicas if r.name == name), None)
            if rep is None:
                return None
            rep.draining = True
        _telemetry.log_event("router_topology", op="drain", replica=name)

        def _finish():
            if drain:
                deadline = time.monotonic() + (
                    env("MXNET_SERVING_DRAIN_TIMEOUT_MS", 30000.0, float)
                    if drain_timeout_ms is None else float(drain_timeout_ms)
                ) / 1e3
                while time.monotonic() < deadline:
                    if rep.inflight == 0 and rep.queue_depth() == 0:
                        break
                    time.sleep(0.01)
            with self._lock:
                if rep in self._replicas:
                    self._replicas.remove(rep)
            _telemetry.log_event("router_topology", op="remove",
                                 replica=name, replica_kind=rep.kind)
            self._update_topology_metrics()
            return (rep.server if isinstance(rep, _LocalReplica)
                    else rep.addr)

        if wait:
            return _finish()
        threading.Thread(target=_finish, name="mxtpu-router-drain-%s" % name,
                         daemon=True).start()
        return None

    def _sync_registry(self):
        """One reconciliation pass against the shared registry: add
        members this router has never seen, drain-and-remove the ones
        that deregistered or were evicted.  Gen-gated, so the steady
        state costs one integer fetch."""
        try:
            live = self._registry.live()
        except Exception:
            return  # registry blip: keep serving the last-known fleet
        if live["gen"] == self._registry_gen:
            return
        self._registry_gen = live["gen"]
        metas = live.get("meta") or {}
        members = live["replicas"]
        if self._model is not None:
            members = {
                name: backend for name, backend in members.items()
                if ((metas.get(name) or {}).get("model") or "default")
                == self._model}
        current = {r.name for r in self.replicas()}
        for name, backend in members.items():
            if name not in current:
                try:
                    self.add_replica(backend, name=name)
                except MXNetError:
                    pass  # raced another sync pass
                self._registry_names.add(name)
        for name in sorted(self._registry_names - set(members)):
            self._registry_names.discard(name)
            self.remove_replica(name, wait=False)

    def sync_registry(self):
        """Force one registry reconciliation pass right now (the
        background loop runs every MXNET_SERVING_REGISTRY_SYNC_MS).  The
        platform front door calls this after a fault-in so the first
        request sees the fresh replica instead of a 500ms-stale view."""
        self._sync_registry()

    def _registry_loop(self):
        while not self._registry_stop.wait(self._registry_sync_s):
            self._sync_registry()

    def signals(self) -> dict:
        """The autoscaler's input: one consistent snapshot of the
        pressure/SLO/breaker/shed signals this router already exports as
        telemetry."""
        reps = self.replicas()
        now = time.monotonic()
        snap = self.metrics.snapshot()
        p99 = {}
        budget = {}
        for slo, cls in self.slo_classes.items():
            # streaming classes budget TTFT instead of a whole-request
            # deadline; their latency samples ARE TTFT observations
            bud = cls.deadline_ms if cls.deadline_ms is not None \
                else cls.ttft_ms
            if bud is not None:
                v = self.metrics.latency_quantile(0.99, slo)
                if v is not None:
                    p99[slo] = v
                    budget[slo] = bud
        return {
            "pressure": self.pressure(),
            "replicas": len(reps),
            "ready": sum(1 for r in reps if r.routable(now)),
            "draining": sum(1 for r in reps if r.draining),
            "breakers_open": sum(1 for r in reps
                                 if r.state != BREAKER_CLOSED),
            "shed_total": sum(snap["shed"].values()),
            "expired_total": sum(snap["expired"].values()),
            "stream_resumes": snap["stream_resumes"],
            "p99_ms": p99,
            "deadline_ms": budget,
        }

    def _update_topology_metrics(self, pressure=None):
        reps = self.replicas()
        now = time.monotonic()
        self.metrics.set_topology(
            len(reps), sum(1 for r in reps if r.routable(now)),
            self.pressure() if pressure is None else pressure)

    def _probe_loop(self):
        interval = env("MXNET_SERVING_PROBE_INTERVAL_MS", 200.0, float) / 1e3
        while not self._probe_stop.wait(interval):
            for r in self.replicas():
                if isinstance(r, _RemoteReplica):
                    try:
                        r._probe()
                    except Exception:
                        pass
            self._update_topology_metrics()

    # -- request path ------------------------------------------------------
    def submit(self, slo: str = "interactive",
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None, **inputs) -> Future:
        """Admit one request and return a Future for its per-item output
        list.  Raises :class:`RouterOverloadError` synchronously when
        admission control sheds this SLO class, ``ServerClosedError``
        after :meth:`close`; the future raises
        :class:`NoReplicaAvailableError` when every routable replica was
        exhausted or ``DeadlineExceededError`` past the budget."""
        if self._closed:
            raise ServerClosedError("router is closed")
        cls = self.slo_classes.get(slo)
        if cls is None:
            raise MXNetError("unknown SLO class %r (one of %s)"
                             % (slo, sorted(self.slo_classes)))
        pressure = self.pressure()
        if cls.sheddable and pressure >= self.shed_pressure:
            self.metrics.on_shed(slo)
            _telemetry.log_event("router_shed", slo=slo,
                                 pressure=round(pressure, 3))
            raise RouterOverloadError(
                "shedding %r traffic at %.0f%% queue pressure"
                % (slo, pressure * 100))
        if deadline_ms is None:
            deadline_ms = cls.deadline_ms
        rid = request_id if request_id is not None \
            else "req-%d" % next(self._rid)
        self.metrics.on_submit(slo)
        req = _Request(rid, slo, inputs, deadline_ms)
        return self._pool.submit(self._dispatch, req)

    def predict(self, slo: str = "interactive",
                deadline_ms: Optional[float] = None,
                **inputs) -> List[np.ndarray]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(slo=slo, deadline_ms=deadline_ms,
                           **inputs).result()

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 slo: str = "generate",
                 deadline_ms: Optional[float] = None,
                 request_id: Optional[str] = None):
        """Stream generated tokens through the fleet: returns an
        iterator of token ids, resumable across replica failures.

        The stream dispatches to a generate-capable replica
        (power-of-two-choices, breakers respected); if the replica dies
        MID-STREAM the router resumes on another one by re-submitting
        ``prompt + tokens emitted so far`` (greedy decode is
        deterministic, so the client-visible stream continues seamlessly
        with zero duplicated or dropped tokens —
        ``mxtpu_router_stream_resumes_total`` counts the seams).  Hedging
        is not applied to streams: a duplicated stream would decode the
        same tokens twice for no tail-latency win on an open-ended
        response; failover covers the slow-replica case instead.

        ``deadline_ms`` (default: the class ``ttft_ms``) bounds
        ADMISSION — time queued before the first token — not the whole
        stream; inter-token gaps beyond the class ``itl_ms`` budget
        count in ``mxtpu_router_itl_violations_total``.  Raises
        :class:`RouterOverloadError` synchronously when the class is
        shed; the iterator raises :class:`NoReplicaAvailableError` when
        every capable replica failed."""
        if self._closed:
            raise ServerClosedError("router is closed")
        cls = self.slo_classes.get(slo)
        if cls is None:
            raise MXNetError("unknown SLO class %r (one of %s)"
                             % (slo, sorted(self.slo_classes)))
        pressure = self.pressure()
        if cls.sheddable and pressure >= self.shed_pressure:
            self.metrics.on_shed(slo)
            _telemetry.log_event("router_shed", slo=slo,
                                 pressure=round(pressure, 3))
            raise RouterOverloadError(
                "shedding %r traffic at %.0f%% queue pressure"
                % (slo, pressure * 100))
        if max_new_tokens is None:
            max_new_tokens = env("MXNET_GEN_MAX_NEW_TOKENS", 64, int)
        rid = request_id if request_id is not None \
            else "gen-%d" % next(self._rid)
        self.metrics.on_submit(slo)
        self.metrics.on_stream(slo)
        return self._generate_iter(cls, rid, prompt, int(max_new_tokens),
                                   deadline_ms)

    def _generate_iter(self, cls, rid, prompt, max_new, deadline_ms):
        t0 = time.monotonic()
        cur = [int(t) for t in prompt]
        remaining = max_new
        emitted = 0
        failures = 0
        last_exc = None
        ttft_budget = deadline_ms if deadline_ms is not None \
            else cls.ttft_ms
        itl_budget = cls.itl_ms
        while remaining > 0:
            faults.fire("serving.router.dispatch")
            tried = set()
            rep = None
            while True:
                cand = self._pick(tried)
                if cand is None:
                    break
                tried.add(cand.name)
                if cand.supports_generate():
                    rep = cand
                    break
                cand.release()
            if rep is None:
                self.metrics.on_fail(cls.name)
                raise NoReplicaAvailableError(
                    "generate %s: no generate-capable replica (tried %s):"
                    " %r" % (rid, sorted(tried) or "none", last_exc)) \
                    from last_exc
            rep.begin_call()
            ok = None
            t_call = time.monotonic()
            made_progress = False
            try:
                faults.fire("serving.replica.call")
                faults.fire("serving.replica.%s.call" % rep.name)
                stream = rep.generate_stream(
                    cur, remaining,
                    ttft_budget if emitted == 0 else None, rid, cls.name)
                t_prev = time.monotonic()
                for tok in stream:
                    now = time.monotonic()
                    if emitted == 0:
                        # TTFT is the stream's per-SLO latency sample
                        self.metrics.on_complete(cls.name,
                                                 (now - t0) * 1e3)
                    elif itl_budget and (now - t_prev) * 1e3 > itl_budget:
                        self.metrics.on_itl_violation()
                    t_prev = now
                    tok = int(tok)
                    cur.append(tok)
                    emitted += 1
                    remaining -= 1
                    made_progress = True
                    failures = 0
                    yield tok
                    if remaining <= 0:
                        break
                if remaining > 0 and not made_progress:
                    raise RouterError(
                        "replica %s returned an empty stream" % rep.name)
                ok = True
            except DeadlineExceededError:
                ok = None  # admission budget died, not the replica
                self.metrics.on_expire(cls.name)
                raise
            except QueueFullError as exc:
                ok = None  # load signal, breaker-neutral
                last_exc = exc
                failures += 1
            except GeneratorExit:
                ok = None  # consumer abandoned the stream
                raise
            except BaseException as exc:
                ok = False
                last_exc = exc
                failures += 1
            finally:
                rep.end_call(ok, (time.monotonic() - t_call) * 1e3)
            if ok:
                return  # budget reached or EOS: clean end of stream
            if failures > self.retries:
                self.metrics.on_fail(cls.name)
                raise NoReplicaAvailableError(
                    "generate %s failed after %d attempts: %r"
                    % (rid, failures, last_exc)) from last_exc
            # resume on another replica: re-submit prompt + emitted
            # tokens (deterministic greedy decode -> seamless stream)
            if made_progress or emitted:
                self.metrics.on_stream_resume()
            else:
                self.metrics.on_retry()
            _telemetry.log_event("router_stream_resume", rid=rid,
                                 replica=rep.name, emitted=emitted,
                                 error=repr(last_exc))

    def _pick(self, tried, now=None) -> Optional[_Replica]:
        """Power-of-two-choices over routable replicas not yet tried for
        this request: sample two, take the lower load score.  The chosen
        replica is atomically reserved (``try_reserve``) so a half-open
        breaker admits exactly ONE probe even when many dispatcher
        threads race the pick."""
        now = time.monotonic() if now is None else now
        cands = [r for r in self.replicas()
                 if r.name not in tried and r.routable(now)]
        while cands:
            if len(cands) == 1:
                choice = cands[0]
            else:
                with self._lock:
                    a, b = self._rng.sample(cands, 2)
                choice = a if a.score() <= b.score() else b
            if choice.try_reserve():
                return choice
            cands.remove(choice)  # lost the probe-slot race; next best
        return None

    def _call_replica(self, rep: _Replica, req: _Request):
        rep.begin_call()
        t0 = time.monotonic()
        ok = None
        try:
            faults.fire("serving.replica.call")
            faults.fire("serving.replica.%s.call" % rep.name)
            with profiler.Frame("router/call[%s]" % rep.name,
                                category="serving"):
                out = rep.call(req.inputs, req.remaining_ms(), req.rid,
                               req.slo)
            ok = True
            return out
        except DeadlineExceededError:
            raise  # neutral: the budget died, not the replica
        except QueueFullError:
            raise  # neutral: load signal, score/pressure already carry it
        except BaseException:
            ok = False
            raise
        finally:
            rep.end_call(ok, (time.monotonic() - t0) * 1e3)

    def _hedge_delay_s(self) -> Optional[float]:
        if self.hedge_ms == 0:
            return None
        if self.hedge_ms > 0:
            return self.hedge_ms / 1e3
        p99 = self.metrics.latency_quantile(0.99)
        floor = env("MXNET_SERVING_HEDGE_MIN_MS", 5.0, float)
        return max(p99 if p99 is not None else floor, floor) / 1e3

    def _call_hedged(self, rep: _Replica, req: _Request, tried):
        """One attempt, optionally hedged: duplicate onto a second
        replica when the primary is slower than the hedge delay and take
        whichever answers first (same idempotent request id)."""
        delay = self._hedge_delay_s()
        if delay is None:
            return self._call_replica(rep, req)
        primary = self._call_pool.submit(self._call_replica, rep, req)
        try:
            return primary.result(timeout=delay)
        except FutureTimeoutError:
            pass
        except Exception:
            raise
        backup_rep = self._pick(tried)
        if backup_rep is None:
            return primary.result()
        tried.add(backup_rep.name)
        self.metrics.on_hedge()
        faults.fire("serving.router.hedge")
        _telemetry.log_event("router_hedge", rid=req.rid,
                             primary=rep.name, backup=backup_rep.name)
        backup = self._call_pool.submit(self._call_replica, backup_rep, req)
        pending = {primary, backup}
        last_exc = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                exc = f.exception()
                if exc is None:
                    if f is backup:
                        self.metrics.on_hedge_win()
                    return f.result()
                last_exc = exc
        raise last_exc

    def _dispatch(self, req: _Request):
        with profiler.Frame("router/dispatch[%s]" % req.slo,
                            category="serving"):
            return self._dispatch_attempts(req)

    def _dispatch_attempts(self, req: _Request):
        last_exc = None
        tried = set()
        for attempt in range(self.retries + 1):
            faults.fire("serving.router.dispatch")
            rep = self._pick(tried)
            if rep is None:
                break
            tried.add(rep.name)
            if attempt:
                self.metrics.on_retry()
                _telemetry.log_event(
                    "router_failover", rid=req.rid, to=rep.name,
                    attempt=attempt, error=repr(last_exc))
            try:
                out = self._call_hedged(rep, req, tried)
                self.metrics.on_complete(
                    req.slo, (time.monotonic() - req.t0) * 1e3)
                return out
            except DeadlineExceededError:
                self.metrics.on_expire(req.slo)
                raise
            except RouterOverloadError:
                raise
            except Exception as exc:
                last_exc = exc
                continue
        self.metrics.on_fail(req.slo)
        raise NoReplicaAvailableError(
            "request %s failed on every routable replica (tried %s): %r"
            % (req.rid, sorted(tried) or "none", last_exc)) from last_exc

    # -- hot swap ----------------------------------------------------------
    def swap(self, prefix, epoch) -> int:
        """Zero-downtime checkpoint hot-swap, replica by replica.

        For each local replica: build a shadow :class:`InferenceServer`
        from the checkpoint with the replica's own config, warm every
        bucket on it (constructor warmup: the steady state runs only
        warmed shapes), atomically flip it into rotation, then drain and
        stop the old server.  Requests in flight on the old replica
        finish during the drain; a request that races the flip gets a
        ``ServerClosedError`` from the draining server and is
        transparently retried on another replica — zero failed client
        requests.  Remote replicas swap in place via ``POST /swap``
        (warm-then-flip happens server-side).  Capacity never drops
        below N-1 replicas.  Returns the number of replicas swapped."""
        with self._swap_lock:
            return self._swap_locked(prefix, epoch)

    def _swap_locked(self, prefix, epoch) -> int:
        swapped = 0
        for rep in self.replicas():
            faults.fire("serving.router.swap")
            with profiler.Frame("router/swap[%s]" % rep.name,
                                category="serving"):
                if isinstance(rep, _RemoteReplica):
                    rep.swap(prefix, epoch)
                else:
                    old_srv = rep.server
                    cfg = old_srv.swap_config()
                    shadow = InferenceServer.from_checkpoint(
                        prefix, epoch, cfg.pop("input_shapes"),
                        warmup=True, start=True, **cfg)
                    new_rep = _LocalReplica(rep.name, shadow, self)
                    with self._lock:
                        self._owned.append(shadow)
                        idx = self._replicas.index(rep)
                        self._replicas[idx] = new_rep
                    # drain: in-flight work finishes, the old server then
                    # rejects with ServerClosedError -> router retries
                    old_srv.stop(drain=True)
                    if old_srv in self._owned:
                        self._owned.remove(old_srv)
            swapped += 1
            self.metrics.on_swap()
            _telemetry.log_event("router_swap", replica=rep.name,
                                 prefix=prefix, epoch=int(epoch),
                                 replica_kind=rep.kind)
        self._update_topology_metrics()
        return swapped

    def cold_bucket_runs(self) -> int:
        """Aggregate never-warmed-bucket flush count over the local
        replicas currently in rotation (0: the steady state ran only
        warmed shapes)."""
        return sum(r.server.cold_bucket_runs() for r in self.replicas()
                   if isinstance(r, _LocalReplica))

    # -- lifecycle ---------------------------------------------------------
    def close(self, stop_backends: bool = False):
        """Stop dispatching.  Router-owned servers (swap shadows) are
        always drained and stopped; caller-provided backends only with
        ``stop_backends``.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._probe_stop.set()
        self._registry_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
        if self._registry_thread is not None:
            self._registry_thread.join(timeout=5)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._http_thread is not None:
                self._http_thread.join(timeout=5)
                self._http_thread = None
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._call_pool.shutdown(wait=True, cancel_futures=True)
        to_stop = list(self._owned)
        if stop_backends:
            to_stop += [r.server for r in self.replicas()
                        if isinstance(r, _LocalReplica)]
        for srv in to_stop:
            try:
                srv.stop(drain=True)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- HTTP front end ----------------------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Stdlib HTTP front door in a daemon thread; returns the bound
        ``(host, port)``.

        * ``POST /predict`` — like the InferenceServer endpoint, plus
          ``X-SLO-Class`` / ``X-Request-Id`` / ``X-Deadline-Ms`` headers
          (body fields ``slo`` / ``request_id`` / ``deadline_ms`` win).
          429 + ``Retry-After`` when the class was shed, 503 when no
          replica could serve, 504 past deadline.
        * ``POST /generate`` — ``{"prompt": [ids], "max_new_tokens":
          opt, "deadline_ms": opt, "slo": opt}`` → NDJSON token stream
          (one flushed ``{"token": t}`` line per token, final
          ``{"done": true}``), resumable across replica failures
          (:meth:`generate`); 429 when shed, 503 when no capable
          replica.
        * ``POST /swap`` — ``{"prefix":..., "epoch":N}`` rolls the
          zero-downtime hot-swap across all replicas.
        * ``GET /metrics`` — router Prometheus text.
        * ``GET /healthz`` — router liveness (200 until ``close``).
        * ``GET /readyz`` — 200 when ≥1 replica is routable, else 503.
        * ``GET /replicas`` — JSON state of every replica (breaker state,
          EWMA latency, in-flight, readiness).
        """
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep pytest/console output clean
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

            def do_GET(self):
                if self.path == "/metrics":
                    self._reply(200, router.metrics.render_text(),
                                ctype="text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    if router._closed:
                        self._reply(503, json.dumps({"status": "closed"}))
                    else:
                        self._reply(200, "ok", ctype="text/plain")
                elif self.path == "/readyz":
                    now = time.monotonic()
                    n = sum(1 for r in router.replicas() if r.routable(now))
                    if n and not router._closed:
                        self._reply(200, "ready", ctype="text/plain")
                    else:
                        self._reply(503, json.dumps(
                            {"status": "no_ready_replicas"}))
                elif self.path == "/replicas":
                    self._reply(200, json.dumps(router.describe()))
                else:
                    self._reply(404, json.dumps({"error": "not found"}))

            def _generate(self, req):
                slo = req.get("slo") or \
                    self.headers.get("X-SLO-Class") or "generate"
                deadline_ms = req.get("deadline_ms")
                if deadline_ms is None:
                    hdr = self.headers.get("X-Deadline-Ms")
                    if hdr:
                        deadline_ms = float(hdr)
                try:
                    it = router.generate(
                        req.get("prompt", []), req.get("max_new_tokens"),
                        slo=slo, deadline_ms=deadline_ms,
                        request_id=req.get("request_id") or
                        self.headers.get("X-Request-Id"))
                except RouterOverloadError as exc:
                    self._reply(429, json.dumps({"error": str(exc)}),
                                headers=(("Retry-After",
                                          "%g" % exc.retry_after),))
                    return
                except (ServerClosedError, MXNetError) as exc:
                    self._reply(503, json.dumps({"error": str(exc)}))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Accel-Buffering", "no")
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
                    it.close()  # client went away: stop the stream
                except BaseException as exc:
                    try:
                        self.wfile.write((json.dumps(
                            {"error": repr(exc)}) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/generate":
                        self._generate(req)
                        return
                    if self.path == "/swap":
                        swapped = router.swap(req["prefix"],
                                              int(req["epoch"]))
                        self._reply(200, json.dumps({"swapped": swapped}))
                        return
                    if self.path != "/predict":
                        self._reply(404, json.dumps({"error": "not found"}))
                        return
                    slo = req.get("slo") or \
                        self.headers.get("X-SLO-Class") or "interactive"
                    deadline_ms = req.get("deadline_ms")
                    if deadline_ms is None:
                        hdr = self.headers.get("X-Deadline-Ms")
                        if hdr:
                            deadline_ms = float(hdr)
                    rid = req.get("request_id") or \
                        self.headers.get("X-Request-Id")
                    fut = router.submit(slo=slo, deadline_ms=deadline_ms,
                                        request_id=rid,
                                        **req.get("inputs", {}))
                    outs = fut.result()
                    self._reply(200, json.dumps(
                        {"outputs": [np.asarray(o).tolist()
                                     for o in outs]}))
                except RouterOverloadError as exc:
                    self._reply(429, json.dumps({"error": str(exc)}),
                                headers=(("Retry-After",
                                          "%g" % exc.retry_after),))
                except DeadlineExceededError as exc:
                    self._reply(504, json.dumps({"error": str(exc)}))
                except (NoReplicaAvailableError, ServerClosedError,
                        QueueFullError) as exc:
                    self._reply(503, json.dumps({"error": str(exc)}))
                except (MXNetError, ValueError, TypeError, KeyError,
                        OSError, json.JSONDecodeError) as exc:
                    self._reply(400, json.dumps({"error": repr(exc)}))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-router-http",
            daemon=True)
        self._http_thread.start()
        return self._httpd.server_address
