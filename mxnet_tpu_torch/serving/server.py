"""InferenceServer — counterpart of ``mxnet_tpu/serving/server.py``: the
threaded serving front end over the micro-batcher.

``submit()`` gives a ``concurrent.futures.Future`` per request (the
in-process RPC surface); ``serve_http()`` optionally exposes the same
thing as a small stdlib HTTP endpoint (JSON in/out, ``/metrics`` in
Prometheus text format) so a converted checkpoint becomes a network
service with zero extra dependencies.  Admission control is a bounded
queue: beyond ``max_queue`` pending requests, ``submit`` raises
:class:`QueueFullError` (HTTP 503) instead of letting latency grow
without bound — callers retry with backoff, which is the backpressure
contract.

The compile-once tier: with ``MXNET_COMPILE_CACHE_DIR`` set (or a bundle
attached) every bucket primes through the compile cache at warm-up (on
the card, a CUDA graph per bucket); ``compiled_entries()`` lists them,
``save_aot_bundle`` writes ``prefix-NNNN.aot/`` with the warm-up recipe,
and ``from_checkpoint(attach_aot=True)`` attaches one this package wrote
(a JAX-written or other-topology bundle raises ``MXNetError``;
``attach_aot=False`` serves the checkpoint alone).  Buckets default to the
``serving_buckets`` autotune site's winner when the autotuner is on, else
``pow2_buckets``.

The preemption handler leaves a flight-recorder postmortem before it
exits.  Kept difference from the JAX package: ``ctx=None`` resolves to the
constructing thread's current context once, in the constructor, because
the default context is per thread and the worker, HTTP and router threads
never see a ``with mt.cpu():`` the caller entered.
"""
from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..base import MXNetError, env, register_env
from ..context import cpu as mt_cpu, current_context
from .batcher import (BucketedPredictor, DeadlineExceededError, MicroBatcher,
                      QueueFullError, ServerClosedError, pow2_buckets)
from .metrics import ServingMetrics

__all__ = ["InferenceServer", "install_preemption_handler"]

register_env("MXNET_SERVING_MAX_WAIT_US", 2000, int,
             "Default micro-batch flush deadline for InferenceServer.")
register_env("MXNET_SERVING_MAX_QUEUE", 256, int,
             "Default admission-control queue bound for InferenceServer.")
register_env("MXNET_SERVING_DRAIN_TIMEOUT_MS", 30000.0, float,
             "Hard deadline for a draining InferenceServer stop: past it, "
             "still-pending requests are force-cancelled with "
             "DrainTimeoutError instead of letting a wedged batch worker "
             "hang retirement forever.")


def _autotune_buckets(max_batch):
    """Tuned micro-batch bucket ladder for ``max_batch``, or None (the
    JAX package's site and objective).

    Analytic objective: expected relative padding waste under uniform
    1..max_batch batch demand, plus a per-bucket penalty — every bucket
    is one more executor to build, warm, and keep resident."""
    try:
        from .. import autotune
    except Exception:
        return None
    if not autotune.enabled():
        return None
    mb = int(max_batch)

    def score(cand):
        buckets = sorted(int(b) for b in cand["buckets"])
        waste = 0.0
        for n in range(1, mb + 1):
            b = next((b for b in buckets if b >= n), buckets[-1])
            waste += (b - n) / float(b)
        return waste / mb + 0.03 * len(buckets)

    try:
        cfg = autotune.get_or_tune(
            "serving_buckets", {"max_batch": mb},
            candidates=autotune.spaces.serving_buckets(mb),
            score_fn=score, default=None)
    except Exception:
        return None
    return list(cfg["buckets"]) if cfg else None


class InferenceServer:
    """Dynamic-batching inference service over a (symbol, params) checkpoint.

    Parameters
    ----------
    symbol, params, dtype
        As for :class:`mxnet_tpu_torch.Predictor`.
    input_shapes : dict
        ``{input_name: shape}`` INCLUDING the leading batch axis; the
        leading dim of the first input is the default ``max_batch_size``
        and per-request inputs carry the remaining dims.
    ctx : Context | list of Context, optional
        One replica (bucket-predictor family + worker thread) is built
        per context, all pulling from one shared queue.  None is the
        constructing thread's current context (``gpu(0)`` unless a ``with
        mt.cpu():`` is active), fixed here for every thread the server
        runs.
    buckets : sequence of int, optional
        Allowed padded batch sizes; default the ``serving_buckets``
        autotune site's winner when the autotuner is on, else
        ``pow2_buckets(max_batch)``.
    max_wait_us : int
        Flush deadline: a queued request never waits longer than this for
        its batch to fill.
    max_queue : int
        Admission bound; ``submit`` beyond it raises ``QueueFullError``.
    warmup : bool
        Run every bucket once before accepting traffic (default True).
    """

    def __init__(self, symbol, params, input_shapes: Dict[str, Sequence[int]],
                 ctx=None, buckets: Optional[Sequence[int]] = None,
                 max_wait_us: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 dtype=np.float32, warmup: bool = True, start: bool = True,
                 generator_spec: Optional[Dict] = None):
        shapes = {k: tuple(v) for k, v in input_shapes.items()}
        batch_dims = {s[0] for s in shapes.values() if len(s) >= 1}
        if len(batch_dims) != 1:
            raise MXNetError(
                "all serving inputs must share one leading batch dim, got %s"
                % shapes)
        max_batch = batch_dims.pop()
        if buckets is None:
            tuned = _autotune_buckets(max_batch)
            buckets = (tuned if tuned is not None
                       else pow2_buckets(max_batch))
        self._item_shapes = {k: s[1:] for k, s in shapes.items()}
        self._input_shapes = shapes
        self._dtype = np.dtype(dtype)
        ctxs = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        # the default context is per thread: resolve it here, once
        ctxs = [current_context() if c is None else c for c in ctxs]
        self._ctxs = list(ctxs)
        # release-relevant state BEFORE any device allocation, so a
        # mid-construction failure can unwind whatever was built
        self._replicas = []
        self._batcher = None
        self._generator = None
        self._generator_spec = None
        self._model_params = params
        self._released_cold_runs = 0
        self._httpd = None
        self._http_thread = None
        # the HTTP handler's JSON decode/encode time on /predict
        self._json_ms = {"decode": 0.0, "encode": 0.0, "n": 0}
        self._json_lock = threading.Lock()
        # lifecycle for the liveness/readiness split: readiness is gated
        # on started + warmed + not draining/stopped, liveness (healthz)
        # keeps its worker-thread semantics untouched
        self._started = False
        self._draining = False
        self._stopped = False
        self._swap_lock = threading.Lock()
        try:
            self._replicas = [
                BucketedPredictor(symbol, params, self._item_shapes,
                                  buckets, ctx=c, dtype=dtype)
                for c in ctxs]
            self.buckets = self._replicas[0].buckets
            self.metrics = ServingMetrics()
            self._batcher = MicroBatcher(
                self._replicas, self.metrics,
                max_wait_us=env("MXNET_SERVING_MAX_WAIT_US", 2000, int)
                if max_wait_us is None else max_wait_us,
                max_queue=env("MXNET_SERVING_MAX_QUEUE", 256, int)
                if max_queue is None else max_queue)
            # snapshots that must survive a post-stop release (swap_config
            # and the router's capacity estimate read these, possibly on a
            # server whose predictors were already dropped by page-out)
            self._max_wait_us = self._batcher.max_wait_us
            self._max_queue = self._batcher.max_queue
            # generative sidecar: a DecodeEngine sharing this checkpoint's
            # params, driving POST /generate token streaming
            if generator_spec is not None:
                from ..generation import DecodeEngine

                self.attach_generator(DecodeEngine(
                    params, warmup=warmup, start=start, ctx=self._ctxs[0],
                    dtype=dtype, **generator_spec))
            # warmup=False is an explicit opt-out: the
            # server counts as warmed-for-readiness the moment it starts
            self._warmed = not warmup
            if warmup:
                self.warmup()
            if start:
                self.start()
        except BaseException:
            self._abort_partial_build()
            raise

    def _abort_partial_build(self):
        """Unwind a construction that failed midway (a torn AOT bundle, a
        fault-injected warmup IOError): stop whatever threads already run
        and drop every device-memory reference, so the failed attempt pins
        nothing — ``resident_bytes()`` of the owner returns to its
        pre-attempt value instead of leaking a half-built replica through
        a live DecodeEngine loop thread."""
        self._stopped = True
        self._draining = True
        gen = self._generator
        if gen is not None:
            try:
                gen.stop(drain=False, timeout=5.0)
            except Exception:
                pass
        batcher = self._batcher
        if batcher is not None:
            try:
                batcher.stop(drain=False, timeout=5.0)
                batcher.release()
            except Exception:
                pass
        self._replicas = []
        self._generator = None
        self._model_params = None

    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_shapes, attach_aot=True,
                        **kwargs):
        """Serve ``save_checkpoint`` files directly (the file pair
        ``Predictor.from_checkpoint`` consumes).

        When an AOT bundle (``prefix-NNNN.aot/``, written by
        :meth:`save_aot_bundle`) sits beside the params and
        ``attach_aot`` is True it is attached as a read-only
        compile-cache overlay BEFORE warm-up, so every bucket warms from
        its entry: no nvcc, no NVRTC, no tuning.  A bundle written by the
        JAX package or for a different device topology raises
        :class:`MXNetError` (pass ``attach_aot=False`` to serve without
        it).  With ``attach_aot`` the chaos seam
        ``checkpoint.aot.attach`` fires first.  A bundle whose warm-up
        manifest records a generator spec restores the
        :class:`~mxnet_tpu_torch.generation.DecodeEngine` too (pass an
        explicit ``generator_spec`` to override)."""
        if attach_aot:
            from ..checkpoint import attach_aot_bundle

            manifest = attach_aot_bundle(prefix, epoch)
            gen_spec = ((manifest or {}).get("warmup") or {}) \
                .get("generator")
            if gen_spec and "generator_spec" not in kwargs:
                kwargs["generator_spec"] = gen_spec
        return cls("%s-symbol.json" % prefix,
                   "%s-%04d.params" % (prefix, epoch),
                   input_shapes, **kwargs)

    def attach_generator(self, engine):
        """Attach a :class:`~mxnet_tpu_torch.generation.DecodeEngine` (usually
        built by the ``generator_spec`` ctor kwarg) so this server answers
        ``POST /generate`` with streamed tokens.  Its spec rides along in
        :meth:`swap_config`, and :meth:`swap` rebuilds it on the new
        params."""
        self._generator = engine
        self._generator_spec = engine.spec()
        return self

    def submit_generate(self, prompt, max_new_tokens=None,
                        deadline_ms=None):
        """Queue one generation request; returns its
        :class:`~mxnet_tpu_torch.generation.GenStream` (iterate for tokens).
        Raises ``QueueFullError`` on admission rejection (HTTP 429) and
        :class:`MXNetError` when no generator is attached."""
        if self._generator is None:
            raise MXNetError(
                "no generator attached — construct InferenceServer with "
                "generator_spec= or call attach_generator()")
        if self._stopped:
            raise ServerClosedError("server is stopped")
        return self._generator.submit(prompt, max_new_tokens,
                                      deadline_ms=deadline_ms)

    def compiled_entries(self):
        """Primed compile-cache wrappers across every replica and bucket,
        plus the attached generator's prefill, decode, draft, verify and
        catch-up executors (empty unless ``MXNET_COMPILE_CACHE_DIR`` is set
        or a bundle is attached)."""
        out = []
        for rep in self._replicas:
            out.extend(rep.compiled_entries())
        if self._generator is not None:
            out.extend(self._generator.compiled_entries())
        return out

    def save_aot_bundle(self, prefix, epoch):
        """Write this server's compiled entries as an AOT bundle beside
        the checkpoint (``prefix-NNNN.aot/``) with a warm-up manifest, so
        the next replica restored from this prefix warms from it.
        Requires the compile cache to be on (the buckets must have primed
        through it)."""
        from ..checkpoint import save_aot_bundle as _save

        entries = self.compiled_entries()
        if not entries:
            raise MXNetError(
                "no cached executables to bundle — set "
                "MXNET_COMPILE_CACHE_DIR before building the server so "
                "its buckets prime through the compile cache")
        warmup = {
            "input_shapes": {k: list(v)
                             for k, v in self._input_shapes.items()},
            "buckets": list(self.buckets),
            "dtype": self._dtype.name,
        }
        if self._generator_spec is not None:
            gen_spec = dict(self._generator_spec)
            draft = gen_spec.get("draft")
            if draft and not isinstance(draft.get("params"), str):
                # the warm-up manifest is JSON: in-memory draft weights
                # travel as a sibling .params file, path-referenced
                from .. import ndarray as nd

                draft = dict(draft)
                dpath = "%s-%04d.draft.params" % (prefix, int(epoch))
                nd.save(dpath, {k: v if isinstance(v, nd.NDArray)
                                else nd.array(np.asarray(v), mt_cpu())
                                for k, v in draft["params"].items()})
                draft["params"] = dpath
                gen_spec["draft"] = draft
            warmup["generator"] = gen_spec
        return _save(prefix, epoch, entries, warmup=warmup)

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self._batcher.start()
        self._started = True
        return self

    def warmup(self):
        """Run every bucket once on every replica.  The server is not
        :meth:`ready` until this completes (callers deferring warmup past
        construction get the ``/readyz`` 503-while-warming window)."""
        from .. import faults

        # chaos seam: serving.server.warmup:ioerr=1 fails the warmup after
        # the predictors (and a generator) are device-resident — the
        # partial-allocation path _abort_partial_build must unwind
        faults.fire("serving.server.warmup")
        self._warmed = False
        for rep in self._replicas:
            rep.warmup()
        self._warmed = True
        return self

    def begin_drain(self):
        """Flip to draining WITHOUT stopping: ``ready()`` goes False (so
        ``/readyz`` answers 503 and a router stops dispatching here) while
        in-flight and queued work keeps completing.  The scale-in /
        preemption first step — quiesce arrivals, then :meth:`stop`."""
        self._draining = True
        return self

    def stop(self, drain: bool = True, timeout_ms: Optional[float] = None):
        """Stop the service.  With ``drain`` (default) queued requests are
        flushed before the workers exit — bounded by ``timeout_ms``
        (default ``MXNET_SERVING_DRAIN_TIMEOUT_MS``): past the deadline
        remaining futures are force-cancelled with
        :class:`~mxnet_tpu_torch.serving.batcher.DrainTimeoutError` so a wedged
        worker can never hang retirement.  Without ``drain`` they fail
        fast with :class:`ServerClosedError`.  Idempotent: a second
        ``stop`` (any ``drain`` value) is a no-op rather than re-failing
        futures or re-joining dead workers."""
        if self._stopped:
            return
        self._stopped = True
        self._draining = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._http_thread is not None:
                self._http_thread.join(timeout=5)
                self._http_thread = None
        if timeout_ms is None:
            timeout_ms = env("MXNET_SERVING_DRAIN_TIMEOUT_MS", 30000.0,
                             float)
        if self._generator is not None:
            self._generator.stop(drain=drain, timeout=timeout_ms / 1e3)
        self._batcher.stop(drain=drain, timeout=timeout_ms / 1e3)
        # a stopped server must not pin device memory: snapshot the cold-
        # run counter while the predictors are alive, then drop every
        # reference to them (bucket executors, parameter arrays, the
        # generator's KV pool) — the batcher's worker threads have exited,
        # so nothing touches them again
        self._released_cold_runs = self.cold_bucket_runs()
        self._batcher.release()
        self._replicas = []
        self._generator = None
        self._model_params = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- request path -----------------------------------------------------
    def _coerce(self, name, value):
        shape = self._item_shapes.get(name)
        if shape is None:
            raise MXNetError("unknown input %r (expected %s)"
                             % (name, sorted(self._item_shapes)))
        arr = np.asarray(value, dtype=self._dtype)
        if arr.shape == (1,) + shape:  # callers may keep a unit batch axis
            arr = arr[0]
        if arr.shape != shape:
            raise MXNetError("input %r has shape %s, expected %s"
                             % (name, arr.shape, shape))
        return arr

    def submit(self, deadline_ms: Optional[float] = None, **inputs) -> Future:
        """Enqueue one request; returns a Future resolving to the per-item
        output list (batch axis stripped).  Raises ``QueueFullError`` when
        admission control rejects, ``ServerClosedError`` after ``stop``;
        the future raises ``DeadlineExceededError`` if ``deadline_ms``
        elapses while the request is still queued."""
        if self._stopped:
            raise ServerClosedError("server is stopped")
        missing = set(self._item_shapes) - set(inputs)
        if missing:
            raise MXNetError("missing inputs %s" % sorted(missing))
        coerced = {k: self._coerce(k, v) for k, v in inputs.items()}
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        future = Future()
        self._batcher.put(coerced, future, deadline)
        return future

    def predict(self, deadline_ms: Optional[float] = None,
                **inputs) -> List[np.ndarray]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(deadline_ms=deadline_ms, **inputs).result()

    def queue_depth(self):
        return self._batcher.queue_depth()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the batcher queue is empty and no dequeued batch
        is still executing — the graceful page-out drain barrier (call
        :meth:`begin_drain` first so no new work arrives).  False on
        timeout."""
        if self._batcher is None:
            return True
        return self._batcher.wait_idle(timeout)

    def handoff_streams(self) -> int:
        """Fail every queued and active generate stream with
        :class:`ServerClosedError` so a router-level consumer re-homes
        them on a surviving replica (greedy decode resumes bit-identical
        from prompt + emitted tokens).  Returns the stream count; 0
        without a generator."""
        if self._generator is None:
            return 0
        return self._generator.handoff()

    def health(self):
        """``("ok", [])`` when every replica worker is alive, else
        ``("degraded", [detail, ...])`` listing the dead workers."""
        dead = self._batcher.dead_workers()
        return ("degraded" if dead else "ok", dead)

    def ready(self) -> bool:
        """Readiness (distinct from liveness): True only when the server
        is started, warmed (or warmup was explicitly opted out), not
        draining/stopped, and at least one replica worker survives.  A
        router must never dispatch to a warming or draining replica —
        that is this predicate, surfaced over HTTP as ``/readyz``."""
        if not self._started or self._draining or self._stopped \
                or not self._warmed:
            return False
        return len(self._batcher.dead_workers()) < len(self._replicas)

    def ready_state(self) -> str:
        """Why-not-ready detail for ``/readyz``: one of ``ready`` /
        ``starting`` / ``warming`` / ``draining`` / ``stopped`` /
        ``dead``."""
        if self._stopped:
            return "stopped"
        if self._draining:
            return "draining"
        if not self._warmed:
            return "warming"
        if not self._started:
            return "starting"
        if len(self._batcher.dead_workers()) >= len(self._replicas):
            return "dead"
        return "ready"

    def swap(self, prefix, epoch):
        """In-place zero-downtime checkpoint hot-swap.

        Builds a fresh shadow :class:`BucketedPredictor` family per
        context from ``prefix-symbol.json`` / ``prefix-NNNN.params``,
        warms **every** bucket on it (so the post-swap steady state runs
        only warmed shapes), then atomically flips the batcher onto the
        new predictors.  The batch in flight finishes on the old weights;
        the very next flush runs the new ones.  The server keeps
        accepting and serving requests throughout — readiness never
        drops.  Serialized: concurrent ``swap`` calls queue up.  Runs on
        the server's own contexts whatever thread calls it (an HTTP
        handler on ``POST /swap``)."""
        from .. import faults

        faults.fire("serving.server.swap")
        symbol = "%s-symbol.json" % prefix
        params = "%s-%04d.params" % (prefix, epoch)
        with self._swap_lock:
            shadows = [
                BucketedPredictor(symbol, params, self._item_shapes,
                                  self.buckets, ctx=c, dtype=self._dtype)
                for c in self._ctxs]
            for rep in shadows:
                rep.warmup()
            shadow_gen = None
            if self._generator is not None:
                from ..generation import DecodeEngine

                # warm a shadow engine on the new params before the flip;
                # in-flight streams finish on the old engine as it drains
                shadow_gen = DecodeEngine(
                    params, ctx=self._ctxs[0], dtype=self._dtype,
                    warmup=True, start=True, **self._generator_spec)
            self._batcher.swap_replicas(shadows)
            self._replicas = shadows
            if shadow_gen is not None:
                old_gen, self._generator = self._generator, shadow_gen
                threading.Thread(
                    target=old_gen.stop, kwargs={"drain": True},
                    name="mxtpu-gen-swap-drain", daemon=True).start()
        from .. import telemetry as _tm

        _tm.log_event("serving_swap", prefix=prefix, epoch=int(epoch),
                      buckets=list(self.buckets))
        return self

    def swap_config(self) -> Dict:
        """Constructor kwargs (minus the model) a router needs to build a
        shadow server of this one — same shapes, buckets, batching knobs,
        contexts, and dtype."""
        cfg = {
            "input_shapes": dict(self._input_shapes),
            "buckets": tuple(self.buckets),
            "max_wait_us": self._max_wait_us,
            "max_queue": self._max_queue,
            "ctx": list(self._ctxs),
            "dtype": self._dtype,
        }
        if self._generator_spec is not None:
            cfg["generator_spec"] = dict(self._generator_spec)
        return cfg

    def cold_bucket_runs(self) -> int:
        """Post-warmup flushes that hit a never-warmed bucket, summed
        over replicas (and the generator's cold decode runs).  The count
        survives :meth:`stop`, which releases the predictors."""
        n = self._released_cold_runs \
            + sum(rep.cold_runs for rep in self._replicas)
        if self._generator is not None:
            n += self._generator.cold_decode_runs()
        return n

    def resident_bytes(self) -> int:
        """Estimated bytes of device-resident model state this server
        pins: every replica's bound parameter/aux arrays (buckets share
        one copy per context through ``Predictor.reshape``).  0 once
        :meth:`stop` has released the predictors."""
        from ..sharding.placement import param_bytes

        arrays = []
        for rep in self._replicas:
            base = rep._preds[rep.buckets[-1]]
            arrays.extend(base._exec.arg_dict.values())
            arrays.extend(base._exec.aux_dict.values())
        if not arrays:
            return 0
        return param_bytes(arrays)[1]

    def metrics_text(self):
        return self.metrics.render_text()

    def http_json_ms(self) -> Dict[str, float]:
        """Mean ms per ``POST /predict`` the HTTP handler spent decoding
        the request's JSON and encoding the answer's (0 before any)."""
        with self._json_lock:
            n = max(1, self._json_ms["n"])
            return {"decode": self._json_ms["decode"] / n,
                    "encode": self._json_ms["encode"] / n,
                    "requests": self._json_ms["n"]}

    # -- HTTP front end ---------------------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start the stdlib HTTP endpoint in a daemon thread; returns the
        bound ``(host, port)``.

        * ``POST /predict`` — body ``{"inputs": {name: nested list},
          "deadline_ms": optional}`` → ``{"outputs": [...]}``; 503 when
          the queue is full (retry with backoff), 504 past deadline.  An
          ``X-Deadline-Ms`` request header sets the deadline too (the
          body field wins when both are present).
        * ``POST /generate`` — body ``{"prompt": [token ids],
          "max_new_tokens": optional, "deadline_ms": optional}`` →
          newline-delimited JSON token stream (``application/x-ndjson``),
          one ``{"token": t}`` line flushed per decoded token and a final
          ``{"done": true, ...}`` line; the connection closes to delimit
          the stream.  429 when generation admission rejects (retry with
          backoff), 404 when no generator is attached.
        * ``POST /swap`` — body ``{"prefix": ..., "epoch": N}``: in-place
          warm checkpoint hot-swap (every bucket run once on the new
          params before the atomic flip; serving never pauses).
        * ``GET /metrics`` — Prometheus text.
        * ``GET /healthz`` — liveness: 200 ``ok`` when every replica
          worker thread is alive; 503 with a JSON
          ``{"status": "degraded", "dead_workers": [...]}`` body when one
          has died (the server limps on through surviving replicas, but
          the orchestrator should recycle it).
        * ``GET /readyz`` — readiness: 200 ``ready`` only when the server
          should receive traffic; 503 ``{"status": "warming" | "draining"
          | ...}`` while warming up, draining, or stopped, so a router
          never routes to a warming/draining replica.  Liveness semantics
          on ``/healthz`` are unchanged.
        """
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep pytest/console output clean
                pass

            def _reply(self, code, body, ctype="application/json"):
                data = body if isinstance(body, bytes) else body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/metrics":
                    self._reply(200, server.metrics_text(),
                                ctype="text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    status, dead = server.health()
                    if status == "ok":
                        self._reply(200, "ok", ctype="text/plain")
                    else:
                        self._reply(503, json.dumps(
                            {"status": "degraded", "dead_workers": dead}))
                elif self.path == "/readyz":
                    if server.ready():
                        self._reply(200, "ready", ctype="text/plain")
                    else:
                        self._reply(503, json.dumps(
                            {"status": server.ready_state()}))
                else:
                    self._reply(404, json.dumps({"error": "not found"}))

            def _generate(self, req):
                """Stream tokens as NDJSON lines, flushed one per decode
                step; HTTP/1.0-style connection close delimits the
                stream (no Content-Length)."""
                deadline_ms = req.get("deadline_ms")
                if deadline_ms is None:
                    hdr = self.headers.get("X-Deadline-Ms")
                    if hdr:
                        deadline_ms = float(hdr)
                try:
                    stream = server.submit_generate(
                        req.get("prompt", []),
                        req.get("max_new_tokens"),
                        deadline_ms=deadline_ms)
                except QueueFullError as exc:
                    self._reply(429, json.dumps({"error": str(exc)}))
                    return
                except ServerClosedError as exc:
                    self._reply(503, json.dumps({"error": str(exc)}))
                    return
                except (MXNetError, ValueError, TypeError) as exc:
                    code = 404 if "no generator attached" in str(exc) \
                        else 400
                    self._reply(code, json.dumps({"error": repr(exc)}))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("X-Accel-Buffering", "no")
                self.end_headers()
                self.close_connection = True
                try:
                    for tok in stream:
                        self.wfile.write(
                            (json.dumps({"token": int(tok)}) + "\n")
                            .encode())
                        self.wfile.flush()
                    self.wfile.write((json.dumps(
                        {"done": True, "n": len(stream.tokens),
                         "ttft_ms": stream.ttft_ms}) + "\n").encode())
                    self.wfile.flush()
                except BrokenPipeError:
                    pass  # client went away mid-stream
                except BaseException as exc:
                    # 200 already sent: signal failure in-band so the
                    # router can resume the stream on another replica
                    try:
                        self.wfile.write((json.dumps(
                            {"error": repr(exc)}) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    raw = self.rfile.read(n)
                    t0 = time.perf_counter()
                    req = json.loads(raw or b"{}")
                    t_decode = time.perf_counter() - t0
                    if self.path == "/generate":
                        self._generate(req)
                        return
                    if self.path == "/swap":
                        server.swap(req["prefix"], int(req["epoch"]))
                        self._reply(200, json.dumps(
                            {"swapped": True, "epoch": int(req["epoch"])}))
                        return
                    if self.path != "/predict":
                        self._reply(404, json.dumps({"error": "not found"}))
                        return
                    deadline_ms = req.get("deadline_ms")
                    if deadline_ms is None:
                        hdr = self.headers.get("X-Deadline-Ms")
                        if hdr:
                            deadline_ms = float(hdr)
                    fut = server.submit(deadline_ms=deadline_ms,
                                        **req.get("inputs", {}))
                    outs = fut.result()
                    t0 = time.perf_counter()
                    body = json.dumps(
                        {"outputs": [np.asarray(o).tolist() for o in outs]})
                    t_encode = time.perf_counter() - t0
                    with server._json_lock:
                        server._json_ms["decode"] += t_decode * 1e3
                        server._json_ms["encode"] += t_encode * 1e3
                        server._json_ms["n"] += 1
                    self._reply(200, body)
                except QueueFullError as exc:
                    self._reply(503, json.dumps({"error": str(exc)}))
                except DeadlineExceededError as exc:
                    self._reply(504, json.dumps({"error": str(exc)}))
                except ServerClosedError as exc:
                    self._reply(503, json.dumps({"error": str(exc)}))
                except (MXNetError, ValueError, TypeError, KeyError,
                        OSError, json.JSONDecodeError) as exc:
                    self._reply(400, json.dumps({"error": repr(exc)}))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxtpu-serving-http",
            daemon=True)
        self._http_thread.start()
        return self._httpd.server_address


def install_preemption_handler(server, deregister=None, sig=None,
                               drain_timeout_ms=None, exit_process=True):
    """Install the serving preemption path on ``sig`` (default SIGTERM),
    mirroring the training workers' handler (kvstore.py): flip the
    replica to draining (``/readyz`` 503 so routers stop dispatching),
    run ``deregister`` if given (drop out of the replica registry so
    replicated routers converge before the process dies), drain bounded
    by ``MXNET_SERVING_DRAIN_TIMEOUT_MS``, and exit 0 — autoscaler
    retirement and cluster preemption share this one path, and a clean
    preemption must not look like a crash to the launcher.  Returns the
    handler (tests invoke it directly); the signal itself is only hooked
    from the main thread (``signal.signal`` constraint — elsewhere the
    handler comes back uninstalled)."""
    import logging
    import os
    import signal as _signal

    if sig is None:
        sig = _signal.SIGTERM
    fired = threading.Event()

    def handler(signum=None, frame=None):
        if fired.is_set():
            return
        fired.set()
        logging.info("serving preemption signal: draining, deregistering")
        try:
            server.begin_drain()
        except Exception as e:
            logging.warning("preemption begin_drain failed: %s", e)
        if deregister is not None:
            try:
                deregister()
            except Exception as e:
                logging.warning("preemption deregister failed: %s", e)
        try:
            server.stop(drain=True, timeout_ms=drain_timeout_ms)
        except Exception as e:
            logging.warning("preemption drain/stop failed: %s", e)
        try:
            # flight recorder: the postmortem is the only record of this
            # replica's final state once we _exit (no atexit hooks run)
            from .. import telemetry as _tm

            _tm.flight_recorder.dump("preemption-sigterm-serving")
        except Exception:
            pass
        if exit_process:
            os._exit(0)

    if threading.current_thread() is threading.main_thread():
        try:
            _signal.signal(sig, handler)
        except (ValueError, OSError):
            pass
    return handler
