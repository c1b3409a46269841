"""DecodeEngine — iteration-level continuous batching over paged KV;
counterpart of ``mxnet_tpu/generation/engine.py``.

Autoregressive serving has two phases with opposite shapes: *prefill*
(one big parallel pass over the prompt) and *decode* (one token per
sequence per step).  Iteration-level ("continuous") batching re-forms the
batch EVERY decode step — new sequences are admitted into free lanes the
moment prefill finishes, finished ones retire immediately — so short
requests never wait for long ones (Orca / vLLM).

Two token-path optimizations ride on top of the paged pool:

* **Cross-request prefix caching** (``prefix_cache_pages`` /
  ``MXNET_GEN_PREFIX_CACHE_PAGES``): admission resolves the prompt
  against :class:`~.kv_pool.PagedKVPool`'s content-hash prefix index.  A
  cached prompt skips prefill and walks its known suffix through the
  windowed catch-up executor (``models.transformer.
  get_transformer_lm_catchup``), so TTFT is one engine iteration.  Pages
  are refcounted and copy-on-write (``ensure_writable`` before any write
  into a possibly shared page), and every complete page a sequence
  materializes is re-published (``register_prefix``), which also makes a
  preempted sequence's re-admission a prefix hit.

* **Speculative decoding** (``draft=``): a draft model proposes K tokens
  per iteration (its own paged pool and decode executors), then ONE
  windowed target pass — the catch-up graph at width K+1 — scores all
  K+1 slots.  Greedy acceptance keeps every token whose draft matched the
  target argmax, so transcripts match non-speculative greedy.  K is the
  explicit ``draft["k"]``, else ``MXNET_GEN_DRAFT_K``, resolved at
  construction and carried in :meth:`DecodeEngine.spec`.

Shapes are bucketed: prefill runs through one :class:`~mxnet_tpu_torch.
serving.batcher.BucketedPredictor` per prompt-length bucket, decode
through one fixed-lane executor per lane-count bucket
(``models.transformer.get_transformer_lm_decode``), so warmup runs every
shape the steady state will run (``cold_decode_runs() == 0``).

What stays on the device.  The JAX engine keeps its pool in host numpy
arrays and copies every plane in and out of every decode step.  Here the
pool lives on the engine's device: every decode, catch-up and verify
executor binds the pool's planes in place (:meth:`PagedKVPool.bind_args`,
one shared handle per plane) and the engine adopts the executor's output
planes as the pool's (:meth:`PagedKVPool.adopt`), so a step copies each
plane once on the device and none over the bus; prefill K/V go from the
executor's outputs straight into the pool.  Only the logits rows the
engine takes ``argmax`` of come to the host, where ``np.argmax`` breaks
ties to the first index, as in the JAX engine.  Every executor binds one
copy of the weights, moved to the engine's context once.  The loop
thread runs under ``torch.no_grad()``, and every tensor names its device.

Backpressure: admission is a bounded pending queue (reject =
:class:`~mxnet_tpu_torch.serving.batcher.QueueFullError`) plus KV-pool
capacity; a mid-decode pool exhaustion preempts the youngest lane (its
pages are freed — though complete ones stay in the prefix index — and the
sequence re-queues for re-admission of prompt+generated; greedy decode is
deterministic, so the stream continues seamlessly).

Compile-once: every executor carries the JAX engine's ``_cache_kind``
(``gen-prefill``, ``gen-step``, ``gen-draft-prefill``, ``gen-draft-step``,
``gen-verify``, ``gen-catchup``) and, with the compile cache on, primes
through it at warm-up; ``compiled_entries`` lists them for an AOT bundle.
On the card the prefill buckets are CUDA graphs in one memory pool the
engine's executors share.  The lane buckets run eagerly: a step adopts
its output planes as the pool's, and a graph reads the planes it was
captured on, so it would copy every plane back on each step and keep a
second set per bucket (ROADMAP.md S.7).  Unset knobs consult the
``decode_engine`` (lane buckets, page size) and ``draft_k`` autotune
sites before the env defaults, as in the JAX engine, and ``stop`` feeds
the observed acceptance back to ``draft_k``.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults
from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env
from ..serving.batcher import (BucketedPredictor, DeadlineExceededError,
                               QueueFullError, ServerClosedError,
                               pow2_buckets)
from .kv_pool import KVPoolExhaustedError, PagedKVPool

__all__ = ["DecodeEngine", "GenStream"]


register_env("MXNET_GEN_PAGE_SIZE", 16, int,
             "KV-pool page size (tokens per page) for DecodeEngine.")
register_env("MXNET_GEN_NUM_PAGES", 128, int,
             "KV-pool page count (page 0 is reserved scratch) for "
             "DecodeEngine.")
register_env("MXNET_GEN_MAX_LANES", 8, int,
             "Largest decode lane-count bucket (max sequences advancing "
             "per decode step).")
register_env("MXNET_GEN_MAX_NEW_TOKENS", 64, int,
             "Default generation budget when a request does not say.")
register_env("MXNET_GEN_PENDING_QUEUE", 256, int,
             "Bounded admission queue for DecodeEngine.submit; beyond it "
             "submissions raise QueueFullError (HTTP 429).")
register_env("MXNET_GEN_PREFIX_CACHE_PAGES", 0, int,
             "Max refcount-0 KV pages the cross-request prefix index may "
             "retain (LRU-evicted); 0 disables prefix caching.")
register_env("MXNET_GEN_DRAFT_K", 4, int,
             "Speculative draft length (tokens proposed per iteration) "
             "when a draft model is configured and no explicit K is "
             "given.")

_DONE = object()  # GenStream queue sentinel


def _autotune_engine_config(num_layers, num_heads, head_dim, max_seq_len,
                            dtype, max_lanes):
    """Tuned {lane_buckets, page_size} for this model geometry, or None
    (the JAX engine's site and objective).

    The objective is analytic and deterministic: expected padded-lane
    waste under uniform live-lane demand, KV fragmentation of a half page
    per sequence, a per-bucket build-cost term (every lane bucket is one
    more decode executor to build and keep warm) and a page-table-length
    term penalizing tiny pages."""
    try:
        from .. import autotune
    except Exception:
        return None
    if not autotune.enabled():
        return None
    key = {"num_layers": int(num_layers), "num_heads": int(num_heads),
           "head_dim": int(head_dim), "max_seq_len": int(max_seq_len),
           "max_lanes": int(max_lanes), "dtype": str(np.dtype(dtype))}

    def score(cand):
        buckets = sorted(int(b) for b in cand["lane_buckets"])
        page = int(cand["page_size"])
        waste = 0.0
        for n in range(1, max_lanes + 1):
            b = next((b for b in buckets if b >= n), buckets[-1])
            waste += (b - n) / float(b)
        waste /= max_lanes
        frag = (page - 1) / 2.0 / max(1.0, max_seq_len / 2.0)
        return (waste + frag + 0.02 * len(buckets)
                + 0.0005 * (max_seq_len / float(page)))

    return autotune.get_or_tune(
        "decode_engine", key,
        candidates=autotune.spaces.decode_engine(max_lanes, max_seq_len),
        score_fn=score, default=None)


def _autotune_draft_k(num_layers, hidden, draft_layers, draft_hidden,
                      acceptance):
    """Tuned {k: draft length} for a (target, draft) geometry pair, or
    None (the JAX engine's site and objective).  Lower is better: the
    expected cost per accepted token.  One iteration costs ``(k+1)``
    target-token-FLOPs for the fused verify pass plus ``rho*k`` for the
    draft rounds (``rho`` = draft/target per-token FLOP ratio, dominated by
    ``layers*hidden^2``), and yields ``sum(a^i, i=0..k)`` expected tokens
    under per-token acceptance probability ``a``."""
    try:
        from .. import autotune
    except Exception:
        return None
    if not autotune.enabled():
        return None
    acceptance = min(0.99, max(0.0, float(acceptance)))
    key = {"num_layers": int(num_layers), "hidden": int(hidden),
           "draft_layers": int(draft_layers),
           "draft_hidden": int(draft_hidden),
           "acceptance": round(acceptance, 1)}
    rho = ((int(draft_layers) * float(draft_hidden) ** 2)
           / (int(num_layers) * float(hidden) ** 2))

    def score(cand):
        k = int(cand["k"])
        expected = sum(acceptance ** i for i in range(k + 1))
        return ((k + 1) + rho * k) / expected

    return autotune.get_or_tune(
        "draft_k", key, candidates=autotune.spaces.draft_k(),
        score_fn=score, default=None)


class GenStream:
    """One request's streaming handle: iterate tokens as they decode.

    ``for tok in stream`` yields generated token ids incrementally;
    :meth:`result` blocks for the full list.  ``ttft_ms`` / ``itl_ms``
    expose this request's observed first-token latency and inter-token
    gaps once available.  Token-path introspection: ``prefill_tokens``
    (prompt positions actually prefilled, across re-admissions),
    ``cached_prefix_tokens`` (positions served from the prefix cache),
    ``ttft_iters`` (engine iterations before the first token — 0 when
    prefill itself emitted it, 1 for a fully-cached prompt),
    ``draft_proposed`` / ``draft_accepted`` / ``accept_rate`` (per-
    stream speculative acceptance EWMA)."""

    def __init__(self, prompt, max_new_tokens):
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.ttft_ms: Optional[float] = None
        self.itl_ms: List[float] = []
        self.prefill_tokens = 0
        self.cached_prefix_tokens = 0
        self.ttft_iters: Optional[int] = None
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.accept_rate: Optional[float] = None
        self._t0 = time.monotonic()
        self._t_last = None
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None

    # -- engine side ------------------------------------------------------
    def _emit(self, token: int) -> float:
        """Record one generated token; returns the gap (ms) it observed
        (TTFT for the first token, ITL after)."""
        now = time.monotonic()
        if self._t_last is None:
            gap = (now - self._t0) * 1e3
            self.ttft_ms = gap
        else:
            gap = (now - self._t_last) * 1e3
            self.itl_ms.append(gap)
        self._t_last = now
        self.tokens.append(int(token))
        self._q.put(int(token))
        return gap

    def _finish(self, exc: Optional[BaseException] = None):
        if self._done.is_set():
            return
        self._exc = exc
        self._done.set()
        self._q.put(_DONE)

    # -- consumer side ----------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("generation still running")
        if self._exc is not None:
            raise self._exc
        return list(self.tokens)


class _Seq:
    """Engine-internal live-sequence state (one decode lane's occupant).

    ``next_pos`` is the feed cursor: the position whose token goes into
    the NEXT decode/verify slot (every position below it has final K/V
    materialized in the pool).  Steady state keeps ``next_pos ==
    len(tokens) - 1``; a cached-prefix admission starts it at the hit
    length, a partial hit or a re-admitted preemptee walks the known
    suffix forward one slot per step without emitting.  ``draft_pos``
    is the same cursor for the draft model's pool; ``limit`` is
    ``len(prompt) + max_new`` — no position at or beyond it is ever
    fed, so pool allocations never outgrow the admission-time check."""

    __slots__ = ("sid", "stream", "tokens", "gen_count", "max_new",
                 "deadline", "eos_id", "admitted_at", "next_pos",
                 "draft_pos", "iters", "limit")

    def __init__(self, sid, stream, deadline, eos_id):
        self.sid = sid
        self.stream = stream
        self.tokens = list(stream.prompt)  # prompt + generated so far
        self.gen_count = len(stream.tokens)
        self.max_new = stream.max_new_tokens
        self.deadline = deadline  # absolute monotonic seconds or None
        self.eos_id = eos_id
        self.admitted_at = 0.0
        self.next_pos = 0
        self.draft_pos = 0
        self.iters = 0
        self.limit = len(stream.prompt) + self.max_new


class _GenMetrics:
    """Telemetry collector for one engine: token throughput, TTFT/ITL
    histograms, admission/retire/preempt counters, lane occupancy, and
    the speculative-decoding draft economy."""

    def __init__(self):
        reg = self._registry = _telemetry.Registry()
        self.tokens = reg.counter("mxtpu_gen_tokens_total")
        self.admitted = reg.counter("mxtpu_gen_sequences_admitted_total")
        self.retired = reg.counter("mxtpu_gen_sequences_retired_total")
        self.preempted = reg.counter("mxtpu_gen_sequences_preempted_total")
        self.expired = reg.counter("mxtpu_gen_sequences_expired_total")
        self.rejected = reg.counter("mxtpu_gen_sequences_rejected_total")
        self.failed = reg.counter("mxtpu_gen_sequences_failed_total")
        self.steps = reg.counter("mxtpu_gen_decode_steps_total")
        self.cold_steps = reg.counter("mxtpu_gen_decode_cold_steps_total")
        self.cached_admissions = reg.counter(
            "mxtpu_gen_prefix_cached_admissions_total")
        self.draft_proposed = reg.counter("mxtpu_gen_draft_proposed_total")
        self.draft_accepted = reg.counter("mxtpu_gen_draft_accepted_total")
        self.spec_fallbacks = reg.counter("mxtpu_gen_spec_fallbacks_total")
        # 0.5ms .. ~16s exponential buckets
        self.ttft = reg.histogram("mxtpu_gen_ttft_ms")
        self.itl = reg.histogram("mxtpu_gen_itl_ms")
        self.g_active = reg.gauge("mxtpu_gen_active_lanes")
        self.g_pending = reg.gauge("mxtpu_gen_pending_requests")
        self.g_accept = reg.gauge("mxtpu_gen_draft_accept_rate")
        _telemetry.register_collector(self)

    def render_prometheus(self):
        return self._registry.render_prometheus()


class DecodeEngine:
    """Continuous-batching generation over a decoder-only LM checkpoint.

    Parameters
    ----------
    params : dict | str
        ``{name: array}`` (``arg:`` prefixes allowed) or a ``.params``
        path — the ``get_transformer_lm`` training checkpoint; it is
        moved to ``ctx`` once and every executor binds that one copy.
    vocab_size, num_layers, num_heads, hidden, max_seq_len
        Model geometry (must match the checkpoint).
    lane_buckets : sequence of int, optional
        Decode lane-count buckets (default ``pow2_buckets(
        MXNET_GEN_MAX_LANES)``); one executor per bucket.
    page_size, num_pages : int, optional
        KV-pool geometry (``MXNET_GEN_PAGE_SIZE`` / ``_NUM_PAGES``).
    prefill_len_buckets, prefill_batch_buckets
        Prompt-length and prefill-batch shape quantization; one
        :class:`BucketedPredictor` per length bucket.
    eos_id : int, optional
        Token id that ends a sequence early.
    prefix_cache_pages : int, optional
        Cross-request prefix-cache retention bound (refcount-0 pages
        the index may keep); default ``MXNET_GEN_PREFIX_CACHE_PAGES``,
        0 disables caching entirely (legacy semantics).
    draft : dict, optional
        Speculative-decoding draft model: ``{"params": path-or-dict,
        "num_layers": int, "num_heads": int, "hidden": int,
        "k": int or None, "acceptance_hint": float}``.  ``k`` None
        takes ``MXNET_GEN_DRAFT_K``; the RESOLVED value is stored back
        into :meth:`spec`.
    ctx : Context, optional
        Where the weights, the pools and every executor live (default
        ``gpu(0)``).
    """

    def __init__(self, params, vocab_size, num_layers=4, num_heads=8,
                 hidden=512, max_seq_len=128,
                 lane_buckets: Optional[Sequence[int]] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_len_buckets: Optional[Sequence[int]] = None,
                 prefill_batch_buckets: Sequence[int] = (1, 2, 4),
                 eos_id: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 prefix_cache_pages: Optional[int] = None,
                 draft: Optional[Dict] = None,
                 ctx=None, dtype=np.float32, warmup: bool = True,
                 start: bool = True):
        from .. import ndarray as nd
        from ..context import gpu
        from ..models.transformer import (get_transformer_lm_catchup,
                                          get_transformer_lm_decode,
                                          get_transformer_lm_prefill)
        from ..name import NameManager
        from ..predictor import Predictor

        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.hidden = int(hidden)
        self.max_seq_len = int(max_seq_len)
        self.head_dim = self.hidden // self.num_heads
        self.eos_id = eos_id
        self._ctx = ctx if ctx is not None else gpu(0)
        self._dtype = np.dtype(dtype)
        # unset knobs consult the autotuner before the env defaults:
        # explicit constructor args always pin, tuned winners beat the
        # built-in defaults, env vars remain the no-autotune fallback
        tuned = None
        if page_size is None or lane_buckets is None:
            tuned = _autotune_engine_config(
                self.num_layers, self.num_heads, self.head_dim,
                self.max_seq_len, self._dtype,
                max_lanes=(max(int(b) for b in lane_buckets)
                           if lane_buckets is not None
                           else env("MXNET_GEN_MAX_LANES", 8, int)))
        if page_size is None and tuned:
            page_size = tuned.get("page_size")
        if lane_buckets is None and tuned:
            lane_buckets = tuned.get("lane_buckets")
        self.page_size = int(env("MXNET_GEN_PAGE_SIZE", 16, int)
                             if page_size is None else page_size)
        self.num_pages = int(env("MXNET_GEN_NUM_PAGES", 128, int)
                             if num_pages is None else num_pages)
        self.max_pages = -(-self.max_seq_len // self.page_size)
        self.lane_buckets = tuple(sorted(set(
            int(b) for b in (lane_buckets if lane_buckets is not None
                             else pow2_buckets(
                                 env("MXNET_GEN_MAX_LANES", 8, int))))))
        self.max_lanes = self.lane_buckets[-1]
        if prefill_len_buckets is None:
            prefill_len_buckets = [b for b in pow2_buckets(self.max_seq_len)
                                   if b >= min(8, self.max_seq_len)]
        self.prefill_len_buckets = tuple(sorted(set(
            int(b) for b in prefill_len_buckets)))
        self.prefill_batch_buckets = tuple(sorted(set(
            int(b) for b in prefill_batch_buckets)))
        self.max_pending = int(env("MXNET_GEN_PENDING_QUEUE", 256, int)
                               if max_pending is None else max_pending)
        self.default_max_new = env("MXNET_GEN_MAX_NEW_TOKENS", 64, int)
        self.prefix_cache_pages = max(0, int(
            env("MXNET_GEN_PREFIX_CACHE_PAGES", 0, int)
            if prefix_cache_pages is None else prefix_cache_pages))

        # one copy of the weights on the engine's context: the Predictor
        # shares an NDArray already there, so every executor (and every
        # reshape) binds these same tensors; a draft value that IS a
        # target value is the same copy too
        moved: Dict[int, object] = {}

        def to_ctx(arrays):
            if isinstance(arrays, str):
                arrays = nd.load(arrays)
            out = {}
            for name, value in arrays.items():
                if id(value) not in moved:
                    moved[id(value)] = (
                        value.as_in_context(self._ctx)
                        if isinstance(value, nd.NDArray)
                        else nd.array(value, self._ctx))
                out[name] = moved[id(value)]
            return out

        # -- speculative draft config (resolve K once, here) --------------
        self._draft: Optional[Dict] = None
        self._draft_params = None
        self._verify_width = 1
        self._params = to_ctx(params)
        if draft:
            d = dict(draft)
            d_layers = int(d.get("num_layers", max(1, self.num_layers // 2)))
            d_heads = int(d.get("num_heads", self.num_heads))
            d_hidden = int(d.get("hidden", self.hidden))
            hint = float(d.get("acceptance_hint", 0.8))
            k = d.get("k")
            if k is None:
                tuned_k = _autotune_draft_k(self.num_layers, self.hidden,
                                            d_layers, d_hidden, hint)
                k = (tuned_k.get("k") if tuned_k
                     else env("MXNET_GEN_DRAFT_K", 4, int))
            k = max(1, min(int(k), self.max_seq_len - 1))
            dparams = d.get("params")
            self._draft = {"params": dparams, "num_layers": d_layers,
                           "num_heads": d_heads, "hidden": d_hidden,
                           "k": k, "acceptance_hint": hint}
            if dparams is None:
                raise MXNetError("draft spec needs 'params'")
            self._draft_params = to_ctx(dparams)
            self._verify_width = k + 1
        self._accept_ewma: Optional[float] = None

        self.pool = PagedKVPool(self.num_pages, self.page_size,
                                self.num_layers, self.num_heads,
                                self.head_dim, dtype=self._dtype,
                                prefix_cache_pages=self.prefix_cache_pages,
                                ctx=self._ctx)
        self.metrics = _GenMetrics()

        # one CUDA graph memory pool for every executor of the engine
        # (the compile cache's prefill graphs; only the loop thread
        # replays them)
        from ..compile_cache import GraphPool

        self._graph_pool = GraphPool()

        def mark(pred, kind):
            pred._exec._cache_kind = kind
            pred._exec._graph_pool = self._graph_pool

        # Symbols build under a fresh NameManager so auto-generated op
        # names are independent of process construction history.
        def prefill_rigs(params, n_layers, n_heads, n_hidden, kind):
            rigs = {}
            for L in self.prefill_len_buckets:
                with NameManager():
                    symbol = get_transformer_lm_prefill(
                        self.vocab_size, n_layers, n_heads, n_hidden,
                        seq_len=L, max_seq_len=self.max_seq_len)
                rigs[L] = BucketedPredictor(
                    symbol, params, {"data": (L,)},
                    self.prefill_batch_buckets, ctx=self._ctx, dtype=dtype)
                for pred in rigs[L]._preds.values():
                    mark(pred, kind)
            return rigs

        def lane_rigs(builder, params, n_layers, n_heads, n_hidden, pool,
                      kind, width=None):
            """One fixed-lane executor per lane bucket over ``pool``'s
            planes (bound as shared params, never as copied inputs) and
            the shared weights (``reshape`` passes both through)."""
            kw = {} if width is None else {"width": width}
            with NameManager():
                symbol = builder(
                    self.vocab_size, n_layers, n_heads, n_hidden,
                    max_seq_len=self.max_seq_len, lanes=self.max_lanes,
                    num_pages=self.num_pages, page_size=self.page_size,
                    max_pages=self.max_pages, **kw)

            def shapes(b):
                lane = (b,) if width is None else (b, width)
                return {"data": lane, "positions": lane,
                        "page_table": (b, self.max_pages)}
            bound = dict(params)
            bound.update(pool.bind_args())
            base = Predictor(symbol, bound, shapes(self.max_lanes),
                             ctx=self._ctx, dtype=dtype)
            rigs = {self.max_lanes: base}
            for b in self.lane_buckets[:-1]:
                rigs[b] = base.reshape(shapes(b))
            for pred in rigs.values():
                mark(pred, kind)
            return rigs

        # prefill: one BucketedPredictor per prompt-length bucket
        self._prefill: Dict[int, BucketedPredictor] = prefill_rigs(
            self._params, self.num_layers, self.num_heads, self.hidden,
            "gen-prefill")
        # decode: one fixed-lane Predictor per lane bucket
        self._decode: Dict[int, Predictor] = lane_rigs(
            get_transformer_lm_decode, self._params, self.num_layers,
            self.num_heads, self.hidden, self.pool, "gen-step")

        # -- speculative rig: draft pool + prefill + decode, target verify
        self._draft_pool: Optional[PagedKVPool] = None
        self._draft_prefill: Dict[int, BucketedPredictor] = {}
        self._draft_decode: Dict[int, "Predictor"] = {}
        self._verify: Dict[int, "Predictor"] = {}
        if self._draft is not None:
            dl = self._draft["num_layers"]
            dh = self._draft["num_heads"]
            dhid = self._draft["hidden"]
            self._draft_pool = PagedKVPool(self.num_pages, self.page_size,
                                           dl, dh, dhid // dh,
                                           dtype=self._dtype, ctx=self._ctx)
            self._draft_prefill = prefill_rigs(self._draft_params, dl, dh,
                                               dhid, "gen-draft-prefill")
            self._draft_decode = lane_rigs(
                get_transformer_lm_decode, self._draft_params, dl, dh, dhid,
                self._draft_pool, "gen-draft-step")
            # verification is teacher forcing too — the draft's K
            # proposals are known before the call — so the verify rig
            # uses the same windowed single-pass graph as catch-up
            self._verify = lane_rigs(
                get_transformer_lm_catchup, self._params, self.num_layers,
                self.num_heads, self.hidden, self.pool, "gen-verify",
                width=self._verify_width)

        # -- prefix-cache catch-up rig: a windowed teacher-forcing
        # executor that re-walks the KNOWN suffix of a partial prefix
        # hit (or a re-admitted preemptee) ``catchup_width`` slots per
        # forward instead of one per decode iteration
        self._catchup: Dict[int, "Predictor"] = {}
        self._catchup_width = 0
        if self.prefix_cache_pages:
            cw = max(2, min(32, self.max_seq_len - 1))
            self._catchup_width = cw
            self._catchup = lane_rigs(
                get_transformer_lm_catchup, self._params, self.num_layers,
                self.num_heads, self.hidden, self.pool, "gen-catchup",
                width=cw)

        # cold-shape bookkeeping: lane buckets warmup ran, post-warmup
        # steps that hit a novel (never-warmed) bucket
        self.warmed_lane_buckets = set()
        self._warned_lane_buckets = set()
        self.decode_cold_runs = 0

        self._cv = threading.Condition()
        self._pending: deque = deque()  # _Seq, FIFO (preempted go front)
        self._active: List[_Seq] = []
        self._sid = 0
        self._closed = False
        self._drain = True
        self._loop_thread = threading.Thread(
            target=self._loop, name="mxtpu-gen-engine", daemon=True)
        self._started = False
        if warmup:
            self.warmup()
        if start:
            self.start()

    # -- construction helpers ---------------------------------------------
    def spec(self) -> Dict:
        """Model/engine geometry needed to rebuild this engine against a
        new checkpoint (hot-swap, AOT warmup manifests, shadow replicas).
        The draft block carries the RESOLVED speculative K — a replica
        rebuilt from a bundle speculates with zero re-tuning."""
        out = {
            "vocab_size": self.vocab_size, "num_layers": self.num_layers,
            "num_heads": self.num_heads, "hidden": self.hidden,
            "max_seq_len": self.max_seq_len,
            "lane_buckets": list(self.lane_buckets),
            "page_size": self.page_size, "num_pages": self.num_pages,
            "prefill_len_buckets": list(self.prefill_len_buckets),
            "prefill_batch_buckets": list(self.prefill_batch_buckets),
            "eos_id": self.eos_id, "max_pending": self.max_pending,
            "prefix_cache_pages": self.prefix_cache_pages,
        }
        if self._draft is not None:
            out["draft"] = dict(self._draft)
        return out

    @classmethod
    def from_checkpoint(cls, prefix, epoch, **spec):
        """Build from ``save_checkpoint`` files; ``spec`` as for the
        constructor (see :meth:`spec`)."""
        return cls("%s-%04d.params" % (prefix, int(epoch)), **spec)

    def warmup(self):
        """Run every prefill (length x batch) bucket and every
        decode/draft/verify/catch-up lane bucket once, so the steady
        state runs only shapes that ran before (``cold_decode_runs() ==
        0``).  The lane executors read the pool's own planes with
        all-zero tables, and their output planes are dropped: the pool
        is unchanged."""
        with torch.no_grad():
            for bp in self._prefill.values():
                bp.warmup()
            for bp in self._draft_prefill.values():
                bp.warmup()
            for b in self.lane_buckets:
                rigs = [(self._decode[b], (b,))]
                if self._draft is not None:
                    rigs.append((self._draft_decode[b], (b,)))
                    rigs.append((self._verify[b], (b, self._verify_width)))
                if self._catchup:
                    rigs.append((self._catchup[b], (b, self._catchup_width)))
                for pred, dshape in rigs:
                    zeros = np.zeros(dshape, self._dtype)
                    outs = self._forward_lanes(
                        pred, zeros, zeros,
                        np.zeros((b, self.max_pages), self._dtype))
                    outs[0].cpu()  # wait until it ran
                self.warmed_lane_buckets.add(b)
        return self

    def _lane_preds(self):
        return (list(self._decode.values())
                + list(self._draft_decode.values())
                + list(self._verify.values())
                + list(self._catchup.values()))

    def compiled_entries(self):
        """Primed compile-cache wrappers across the prefill, decode,
        draft, verify and catch-up executors (kinds ``gen-prefill`` /
        ``gen-step`` / ``gen-draft-prefill`` / ``gen-draft-step`` /
        ``gen-verify`` / ``gen-catchup``; empty with the cache off) — the
        input to ``checkpoint.save_aot_bundle``, so a replica restored
        from the bundle serves its first generate request with no cold
        build."""
        from ..compile_cache import entries_of

        out = []
        for bp in list(self._prefill.values()) + \
                list(self._draft_prefill.values()):
            out.extend(bp.compiled_entries())
        for pred in self._lane_preds():
            out.extend(entries_of(pred._exec))
        return out

    def cold_decode_runs(self) -> int:
        """Post-warmup decode steps that hit a never-warmed lane bucket
        plus prefill runs on a never-warmed (length, batch) bucket — 0 is
        the "steady state runs only warmed shapes" check."""
        return (self.decode_cold_runs
                + sum(bp.cold_runs for bp in self._prefill.values())
                + sum(bp.cold_runs
                      for bp in self._draft_prefill.values()))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            self._loop_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop the engine.  With ``drain`` (default) queued and active
        sequences finish first (bounded by ``timeout`` seconds), without
        it they fail fast with :class:`ServerClosedError`."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._drain = drain
            if not drain:
                self._fail_all_locked(ServerClosedError(
                    "engine stopped before completion"))
            self._cv.notify_all()
        if self._started:
            self._loop_thread.join(timeout)
        with self._cv:
            # drain deadline expired with work outstanding (or fail-fast
            # stop racing the loop): cancel whatever is left
            self._fail_all_locked(ServerClosedError("engine stopped"))
        # observed-acceptance feedback: when the measured EWMA drifts a
        # decile from the configured hint, pre-record the draft_k winner
        # for the observed rate so the NEXT construction (same geometry,
        # honest hint) resolves without tuning from the stale prior
        if self._draft is not None and self._accept_ewma is not None:
            if abs(self._accept_ewma
                   - self._draft["acceptance_hint"]) >= 0.1:
                try:
                    _autotune_draft_k(
                        self.num_layers, self.hidden,
                        self._draft["num_layers"], self._draft["hidden"],
                        self._accept_ewma)
                except Exception:
                    pass
        # a stopped engine hands its CUDA graphs' memory back (the loop
        # thread has exited, so nothing replays them again)
        if not self._loop_thread.is_alive():
            for bp in list(self._prefill.values()) + \
                    list(self._draft_prefill.values()):
                bp.release()
            for pred in self._lane_preds():
                pred._exec.release_cache()

    def handoff(self) -> int:
        """Preempt every queued and active stream WITHOUT stopping the
        engine: each fails with :class:`ServerClosedError`, which a
        router-level consumer treats as a replica failure and re-submits
        (prompt + emitted tokens) on a surviving replica — greedy decode
        makes the resumed transcript bit-identical.  The graceful
        page-out handoff: call this before the owning server releases
        its device memory.  Returns the number of streams handed off."""
        with self._cv:
            n = len(self._pending) + len(self._active)
            self._fail_all_locked(ServerClosedError(
                "replica preempted: stream handed off"))
            self._cv.notify_all()
        if n:
            _telemetry.log_event("gen_handoff", streams=n)
        return n

    def _fail_all_locked(self, exc):
        n = 0
        for seq in list(self._pending) + list(self._active):
            self.pool.free(seq.sid)
            if self._draft_pool is not None:
                self._draft_pool.free(seq.sid)
            seq.stream._finish(exc)
            n += 1
        self._pending.clear()
        del self._active[:]
        if n:
            self.metrics.failed.inc(n)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)

    # -- request path ------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> GenStream:
        """Queue one prompt for generation; returns its
        :class:`GenStream`.  Raises :class:`QueueFullError` when the
        pending queue is at capacity (HTTP 429 — retry with backoff) and
        :class:`MXNetError` for prompts that can never fit."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("empty prompt")
        max_new = int(self.default_max_new if max_new_tokens is None
                      else max_new_tokens)
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        total = len(prompt) + max_new
        if total > self.max_seq_len:
            raise MXNetError(
                "prompt (%d) + max_new_tokens (%d) exceeds max_seq_len %d"
                % (len(prompt), max_new, self.max_seq_len))
        if self.pool.pages_for(total) > self.pool.capacity:
            raise MXNetError(
                "request needs %d KV pages but the pool only has %d — it "
                "can never be admitted" %
                (self.pool.pages_for(total), self.pool.capacity))
        stream = GenStream(prompt, max_new)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        with self._cv:
            if self._closed:
                raise ServerClosedError("engine is stopped")
            if len(self._pending) >= self.max_pending:
                self.metrics.rejected.inc()
                raise QueueFullError(
                    "generation queue full (%d pending); retry with "
                    "backoff" % len(self._pending))
            self._pending.append(_Seq(self._sid, stream, deadline,
                                      self.eos_id))
            self._sid += 1
            self.metrics.g_pending.set(len(self._pending))
            self._cv.notify_all()
        return stream

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 timeout: Optional[float] = 300.0) -> List[int]:
        """Blocking convenience wrapper: the full generated token list."""
        return self.submit(prompt, max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout)

    def pending_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def active_lanes(self) -> int:
        with self._cv:
            return len(self._active)

    def snapshot(self) -> dict:
        with self._cv:
            snap = {"pending": len(self._pending),
                    "active": len(self._active),
                    "tokens_total": self.metrics.tokens.value,
                    "cold_decode_runs": self.cold_decode_runs(),
                    "prefix_cache_pages": self.prefix_cache_pages,
                    "kv": self.pool.snapshot()}
            if self._draft is not None:
                snap["draft"] = {
                    "k": self._draft["k"],
                    "proposed": self.metrics.draft_proposed.value,
                    "accepted": self.metrics.draft_accepted.value,
                    "accept_rate_ewma": self._accept_ewma,
                    "fallbacks": self.metrics.spec_fallbacks.value,
                    "kv": self._draft_pool.snapshot(),
                }
            return snap

    # -- engine loop -------------------------------------------------------
    def _loop(self):
        # grad mode is per thread: the caller's no_grad does not reach
        # this one
        with torch.no_grad():
            self._loop_body()

    def _loop_body(self):
        while True:
            with self._cv:
                while not self._pending and not self._active \
                        and not self._closed:
                    self._cv.wait(0.05)
                if self._closed and not self._active and \
                        (not self._pending or not self._drain):
                    for seq in self._pending:
                        seq.stream._finish(ServerClosedError(
                            "engine stopped before execution"))
                    self._pending.clear()
                    return
            try:
                self._admit()
                if self._active:
                    self._decode_step()
            except BaseException as exc:  # fault-injected or real: contain
                logging.warning("generation engine step failed: %r", exc)
                with self._cv:
                    self._fail_all_locked(exc)
                _telemetry.log_event("gen_engine_error", error=repr(exc))

    def _prefill_bucket_for(self, n: int) -> int:
        for L in self.prefill_len_buckets:
            if L >= n:
                return L
        raise MXNetError("prompt of %d exceeds largest prefill bucket %d"
                         % (n, self.prefill_len_buckets[-1]))

    def _admit(self):
        """Move pending sequences into free decode lanes: allocate KV
        pages (resolving the prompt against the prefix index), run
        bucketed prefill for the cache misses, stream each prefilled
        sequence's first token.  Cached sequences go straight to decode
        lanes — zero prefill steps."""
        batch: List[_Seq] = []
        now = time.monotonic()
        avail = self.pool.reclaimable_pages()
        d_avail = (self._draft_pool.free_pages()
                   if self._draft_pool is not None else None)
        with self._cv:
            while self._pending and \
                    len(self._active) + len(batch) < self.max_lanes:
                seq = self._pending[0]
                if seq.deadline is not None and now > seq.deadline:
                    self._pending.popleft()
                    self.metrics.expired.inc()
                    seq.stream._finish(DeadlineExceededError(
                        "request waited past its TTFT deadline"))
                    continue
                need = self.pool.pages_for(len(seq.tokens))
                if need > avail or (d_avail is not None and need > d_avail):
                    break  # wait for active lanes to retire/free pages
                avail -= need
                if d_avail is not None:
                    d_avail -= need
                self._pending.popleft()
                batch.append(seq)
            self.metrics.g_pending.set(len(self._pending))
        if not batch:
            return
        faults.fire("generation.engine.admit")
        # group by prompt-length bucket, chunk to the prefill batch cap
        by_bucket: Dict[int, List[_Seq]] = {}
        for seq in batch:
            by_bucket.setdefault(
                self._prefill_bucket_for(len(seq.tokens)), []).append(seq)
        for L, seqs in sorted(by_bucket.items()):
            bp = self._prefill[L]
            cap = bp.max_batch_size
            for ofs in range(0, len(seqs), cap):
                self._prefill_group(L, seqs[ofs:ofs + cap])

    def _prefill_group(self, L: int, seqs: List[_Seq]):
        admitted: List[_Seq] = []
        for seq in seqs:
            try:
                _, cached = self.pool.alloc_prefix(
                    seq.sid, len(seq.tokens),
                    tokens=(seq.tokens if self.prefix_cache_pages
                            else None))
            except KVPoolExhaustedError:
                # admission raced a concurrent consumer: wait a round
                with self._cv:
                    self._pending.appendleft(seq)
                continue
            if self._draft_pool is not None:
                try:
                    self._draft_pool.alloc(seq.sid, len(seq.tokens))
                except KVPoolExhaustedError:
                    self.pool.free(seq.sid)
                    with self._cv:
                        self._pending.appendleft(seq)
                    continue
            seq.next_pos = cached  # 0 on a miss: full prefill below
            if cached:
                seq.stream.cached_prefix_tokens += cached
                self.metrics.cached_admissions.inc()
            admitted.append(seq)
        if not admitted:
            return
        # the draft holds no prefix cache: prefill EVERY admitted
        # sequence through the draft model so proposals can start from
        # the first decode iteration
        if self._draft is not None:
            self._prefill_into(self._draft_prefill[L], L, admitted,
                               self._draft_pool)
            for seq in admitted:
                seq.draft_pos = len(seq.tokens)
        misses = [s for s in admitted if s.next_pos == 0]
        if misses:
            rows = self._prefill_into(self._prefill[L], L, misses,
                                      self.pool)
            for seq, row in zip(misses, rows):
                n = len(seq.tokens)
                seq.stream.prefill_tokens += n
                seq.next_pos = n
                if self.prefix_cache_pages:
                    self.pool.register_prefix(seq.sid, seq.tokens[:n])
                self._emit(seq, int(np.argmax(row)))
        if self.prefix_cache_pages:
            self._catchup_group([s for s in admitted if s not in misses])
        for seq in admitted:
            seq.admitted_at = time.monotonic()
        with self._cv:
            self._active.extend(s for s in admitted
                                if not s.stream.done)
            self.metrics.admitted.inc(len(admitted))
            self.metrics.g_active.set(len(self._active))

    def _prefill_into(self, bp, L: int, seqs: List[_Seq], pool):
        """One padded prefill batch of ``seqs`` through ``bp``: every
        layer's K/V go from the executor's outputs straight into
        ``pool`` on the device; returns each sequence's logits row at its
        last prompt position, the only rows brought to the host."""
        items = []
        for seq in seqs:
            buf = np.zeros((L,), self._dtype)
            buf[:len(seq.tokens)] = seq.tokens
            items.append({"data": buf})
        _, outs = bp.forward_padded(items, copy=False)
        outs = [o._data for o in outs]
        for i, seq in enumerate(seqs):
            n = len(seq.tokens)
            for layer in range(pool.num_layers):
                pool.write_prefill(seq.sid, layer, outs[1 + 2 * layer][i],
                                   outs[2 + 2 * layer][i], n)
        last = torch.as_tensor([len(seq.tokens) - 1 for seq in seqs],
                               device=outs[0].device)
        rows = outs[0][torch.arange(len(seqs), device=last.device), last]
        return rows.float().cpu().numpy()

    def _catchup_group(self, seqs: List[_Seq]):
        """Batch-walk the KNOWN suffix of prefix hits through the
        windowed catch-up executor — ``catchup_width`` positions
        per forward instead of one per decode iteration — feeding
        THROUGH the final prompt position and emitting the first
        generated token from the last slot's logits.  A cached
        admission therefore reaches its first token inside admission,
        in ``ceil(suffix / catchup_width)`` forwards, with no separate
        decode step: TTFT stays one engine iteration regardless of how
        far short of the prompt the index's page-granular match fell."""
        pending = [s for s in seqs
                   if 0 < s.next_pos < len(s.tokens)]
        if not pending or not self._catchup:
            return
        W = self._catchup_width
        while pending:
            b = self._lane_bucket_for(len(pending))
            self._note_lane_bucket(b)
            pred = self._catchup[b]
            data = np.zeros((b, W), self._dtype)
            # pads park in the scratch page's last slot (zero table row)
            positions = np.full((b, W), self.max_seq_len - 1,
                                dtype=self._dtype)
            table = np.zeros((b, self.max_pages), self._dtype)
            spans = []
            for i, seq in enumerate(pending):
                # the cursor's page can still be prefix-indexed/shared
                self.pool.ensure_writable(seq.sid, seq.next_pos)
                span = min(W, len(seq.tokens) - seq.next_pos)
                data[i, :span] = seq.tokens[seq.next_pos:
                                            seq.next_pos + span]
                positions[i, :span] = np.arange(seq.next_pos,
                                                seq.next_pos + span)
                table[i] = self.pool.page_table_row(seq.sid,
                                                    self.max_pages)
                spans.append(span)
            logits = self._run_lanes(pred, self.pool, data, positions,
                                     table).reshape(b, W, -1)
            # only each lane's last fed slot is read: those rows to host
            last = torch.as_tensor([span - 1 for span in spans],
                                   device=logits.device)
            logits = logits[torch.arange(len(spans), device=last.device),
                            last].float().cpu().numpy()
            nxt = []
            for i, (seq, span) in enumerate(zip(pending, spans)):
                seq.iters += 1
                seq.next_pos += span
                self.pool.register_prefix(seq.sid,
                                          seq.tokens[:seq.next_pos])
                if seq.next_pos >= len(seq.tokens):
                    # crossed into generation: the last fed slot's
                    # logits seed the stream's first token
                    self._emit(seq, int(np.argmax(logits[i])))
                else:
                    nxt.append(seq)
            pending = nxt

    def _emit(self, seq: _Seq, tok: int):
        """Stream one generated token; retires the sequence when it hit
        its budget or EOS.  Returns True when the sequence retired."""
        first = not seq.stream.tokens
        gap = seq.stream._emit(tok)
        if first:
            seq.stream.ttft_iters = seq.iters
        seq.tokens.append(tok)
        seq.gen_count += 1
        self.metrics.tokens.inc()
        (self.metrics.ttft if first else self.metrics.itl).observe(gap)
        if seq.gen_count >= seq.max_new or \
                (seq.eos_id is not None and tok == seq.eos_id):
            self._retire(seq)
            return True
        return False

    def _retire(self, seq: _Seq):
        faults.fire("generation.engine.retire")
        if self.prefix_cache_pages:
            # publish the finished transcript's complete pages before
            # releasing them: a refcount-0 indexed page is retained as
            # cache, so the next request sharing this prefix hits
            self.pool.register_prefix(seq.sid, seq.tokens[:seq.next_pos])
        self.pool.free(seq.sid)
        if self._draft_pool is not None:
            self._draft_pool.free(seq.sid)
        seq.stream._finish(None)
        self.metrics.retired.inc()

    def _preempt_one(self, exclude: Optional[_Seq] = None) -> bool:
        """Free the youngest active lane's pages and push the sequence
        back to the FRONT of the pending queue for re-admission of
        prompt + generated-so-far (greedy decode is deterministic, so
        its stream continues without a hiccup).  Its complete pages are
        published to the prefix index first, so with caching enabled
        the re-admission is a prefix HIT instead of a full re-prefill."""
        with self._cv:
            victims = [s for s in self._active if s is not exclude]
            if not victims:
                victims = [s for s in self._active]
            if not victims:
                return False
            victim = max(victims, key=lambda s: s.admitted_at)
            self._active.remove(victim)
            self._pending.appendleft(victim)
            self.metrics.g_active.set(len(self._active))
            self.metrics.g_pending.set(len(self._pending))
        if self.prefix_cache_pages:
            self.pool.register_prefix(victim.sid,
                                      victim.tokens[:victim.next_pos])
        self.pool.free(victim.sid)
        if self._draft_pool is not None:
            self._draft_pool.free(victim.sid)
        victim.next_pos = 0
        victim.draft_pos = 0
        self.metrics.preempted.inc()
        _telemetry.log_event("gen_preempt", sid=victim.sid,
                             tokens=len(victim.tokens))
        return True

    def _lane_bucket_for(self, n: int) -> int:
        for b in self.lane_buckets:
            if b >= n:
                return b
        raise MXNetError("%d active lanes exceed largest bucket %d"
                         % (n, self.lane_buckets[-1]))

    def _note_lane_bucket(self, b: int):
        if b in self.warmed_lane_buckets:
            return
        self.decode_cold_runs += 1
        self.metrics.cold_steps.inc()
        self.warmed_lane_buckets.add(b)
        if b not in self._warned_lane_buckets:
            self._warned_lane_buckets.add(b)
            logging.warning(
                "generation: decode step hit never-warmed lane bucket "
                "%d post-warmup (a shape warmup never ran, on the "
                "serving path) — add it to lane_buckets/warmup", b)
            _telemetry.log_event("gen_decode_cold_bucket", lanes=b)

    def _decode_step(self):
        """One continuous-batching iteration: grow every lane's KV
        allocation for the positions about to be written (pool
        exhaustion preempts the youngest other lane), copy-on-write any
        shared page under the feed cursor, then advance every lane —
        one token via the decode executor, or up to K+1 via the
        draft/verify speculative pass."""
        faults.fire("generation.engine.step")
        width = self._verify_width
        for seq in list(self._active):
            # an earlier lane's extend may have preempted this one already
            while seq in self._active:
                try:
                    tgt = min(seq.next_pos + width, seq.limit,
                              self.max_seq_len)
                    self.pool.extend(seq.sid, tgt)
                    if self.prefix_cache_pages:
                        # the page under the cursor may be shared (cached
                        # admission) or still prefix-indexed: split it
                        # before this iteration writes K/V there
                        self.pool.ensure_writable(seq.sid, seq.next_pos)
                    if self._draft_pool is not None:
                        self._draft_pool.extend(seq.sid, tgt)
                    break
                except KVPoolExhaustedError:
                    if not self._preempt_one(exclude=seq):
                        raise
        active = list(self._active)
        if not active:
            return
        if self._draft is not None:
            self._spec_step(active)
        else:
            self._plain_step(active)

    @staticmethod
    def _forward_lanes(pred, data, positions, table):
        """One forward of a lane-bucket executor over the planes it binds
        in place; returns its outputs (tensors on the device) and keeps
        no reference to them."""
        pred.set_input("data", data)
        pred.set_input("positions", positions)
        pred.set_input("page_table", table)
        pred._exec.forward(is_train=False)
        outs = [o._data for o in pred.get_outputs()]
        pred._exec._output_arrays = []
        return outs

    def _run_lanes(self, pred, pool, data, positions, table):
        """Run one lane-bucket executor over ``pool``'s planes and adopt
        its output planes as the pool's; returns the logits, on the
        device."""
        outs = self._forward_lanes(pred, data, positions, table)
        pool.adopt(outs[len(outs) - 2 * pool.num_layers:])
        return outs[0]

    def _plain_step(self, active: List[_Seq]):
        """Advance every active lane one position through the decode
        executor: feed ``tokens[next_pos]`` at ``next_pos``, emit the
        argmax only when the cursor crosses into generation (a lane
        re-walking a known suffix — partial cache hit, re-admitted
        preemptee — just materializes K/V silently)."""
        b = self._lane_bucket_for(len(active))
        self._note_lane_bucket(b)
        pred = self._decode[b]
        data = np.zeros((b,), self._dtype)
        positions = np.zeros((b,), self._dtype)
        table = np.zeros((b, self.max_pages), self._dtype)
        for i, seq in enumerate(active):
            data[i] = seq.tokens[seq.next_pos]
            positions[i] = seq.next_pos  # slot the new K/V lands in
            table[i] = self.pool.page_table_row(seq.sid, self.max_pages)
        logits = self._run_lanes(pred, self.pool, data, positions,
                                 table).float().cpu().numpy()
        self.metrics.steps.inc()
        retired = []
        for i, seq in enumerate(active):
            seq.iters += 1
            seq.next_pos += 1
            if self.prefix_cache_pages:
                self.pool.register_prefix(seq.sid,
                                          seq.tokens[:seq.next_pos])
            if seq.next_pos >= len(seq.tokens):
                if self._emit(seq, int(np.argmax(logits[i]))):
                    retired.append(seq)
        self._drop_retired(retired)

    def _spec_step(self, active: List[_Seq]):
        """One speculative iteration: draft K proposals per steady lane,
        then ONE windowed target verify pass scores feed slots
        ``[tokens[next_pos], d_1 .. d_K]`` at positions ``next_pos ..
        next_pos+K`` (teacher forcing — every feed token is known before
        the call, so the graph is the same single causal pass as
        catch-up, not K+1 chained decode blocks).  Greedy acceptance
        walks the slots in order, keeping every emitted argmax whose
        following draft feed matches — the emitted tokens are the
        TARGET's own argmaxes over the same paged K/V a plain decode
        would read, and the spec-parity tests assert transcript equality
        against non-speculative greedy for every K.  A fault at
        ``generation.draft.verify`` degrades THIS iteration to a plain
        single-token step instead of failing any stream."""
        width = self._verify_width
        b = self._lane_bucket_for(len(active))
        self._note_lane_bucket(b)
        try:
            faults.fire("generation.draft.verify")
        except Exception:
            self.metrics.spec_fallbacks.inc()
            self._plain_step(active)
            return
        proposals = self._draft_propose(active, b)
        vpred = self._verify[b]
        data = np.zeros((b, width), self._dtype)
        # pad slots park at (token 0, position max_seq_len-1): with a
        # zero page-table row beyond the lane's allocation the write
        # lands in scratch page 0, and no live position ever attends it
        positions = np.full((b, width), self.max_seq_len - 1, self._dtype)
        table = np.zeros((b, self.max_pages), self._dtype)
        lane_width: Dict[object, int] = {}
        for i, seq in enumerate(active):
            table[i] = self.pool.page_table_row(seq.sid, self.max_pages)
            drafts = proposals.get(seq.sid, [])
            lw = 0
            for w in range(width):
                p = seq.next_pos + w
                if p >= min(seq.limit, self.max_seq_len):
                    break
                if p < len(seq.tokens):
                    tok = seq.tokens[p]
                else:
                    j = w - (len(seq.tokens) - seq.next_pos)
                    if j < 0 or j >= len(drafts):
                        break
                    tok = drafts[j]
                data[i, w] = tok
                positions[i, w] = p
                lw += 1
            lane_width[seq.sid] = lw
        logits = self._run_lanes(vpred, self.pool, data, positions,
                                 table).reshape(b, width, -1)
        logits = logits.float().cpu().numpy()
        self.metrics.steps.inc()
        retired = []
        for i, seq in enumerate(active):
            seq.iters += 1
            lw = lane_width[seq.sid]
            n_drafted = max(0, lw - (len(seq.tokens) - seq.next_pos))
            start = seq.next_pos
            emits = 0
            for w in range(lw):
                g = int(np.argmax(logits[i, w]))
                seq.next_pos = start + w + 1
                if seq.next_pos < len(seq.tokens):
                    continue  # known-suffix slot: K/V only, no emission
                emits += 1
                if self._emit(seq, g):
                    retired.append(seq)
                    break
                if w + 1 < lw and int(data[i, w + 1]) != g:
                    break  # draft diverged: discard the rest
            if self.prefix_cache_pages:
                self.pool.register_prefix(seq.sid,
                                          seq.tokens[:seq.next_pos])
            # the draft fed positions start .. start + len(drafts) - 1
            # (its proposal rounds); below next_pos it holds accepted K/V,
            # above it rejected junk, and where every proposal was
            # accepted the last accepted token was never fed.  The cursor
            # stops at what the draft fed, so the next sync round feeds
            # the rest (the JAX engine sets it to next_pos and leaves that
            # slot stale: ROADMAP.md C.9)
            seq.draft_pos = min(seq.next_pos,
                                start + len(proposals.get(seq.sid, [])))
            if n_drafted:
                accepted = max(0, emits - 1)
                self.metrics.draft_proposed.inc(n_drafted)
                self.metrics.draft_accepted.inc(accepted)
                rate = accepted / float(n_drafted)
                st = seq.stream
                st.draft_proposed += n_drafted
                st.draft_accepted += accepted
                st.accept_rate = (rate if st.accept_rate is None
                                  else 0.8 * st.accept_rate + 0.2 * rate)
                self._accept_ewma = (rate if self._accept_ewma is None
                                     else 0.8 * self._accept_ewma
                                     + 0.2 * rate)
                self.metrics.g_accept.set(self._accept_ewma)
        self._drop_retired(retired)

    def _draft_propose(self, active: List[_Seq], b: int) -> Dict:
        """Run the draft model: first catch its pool up to each lane's
        feed cursor (re-feeding accepted tokens its last rejected run
        clobbered), then K batched rounds of chained greedy proposals
        for every steady lane.  Returns {sid: [d_1 .. d_K]}."""
        k = self._verify_width - 1
        pred = self._draft_decode[b]
        rows = {s.sid: self._draft_pool.page_table_row(s.sid,
                                                       self.max_pages)
                for s in active}
        while True:
            lag = [s for s in active if s.draft_pos < s.next_pos]
            if not lag:
                break
            data = np.zeros((b,), self._dtype)
            positions = np.full((b,), self.max_seq_len - 1, self._dtype)
            table = np.zeros((b, self.max_pages), self._dtype)
            for i, seq in enumerate(active):
                if seq.draft_pos < seq.next_pos:
                    data[i] = seq.tokens[seq.draft_pos]
                    positions[i] = seq.draft_pos
                    table[i] = rows[seq.sid]
            self._run_lanes(pred, self._draft_pool, data, positions, table)
            for seq in lag:
                seq.draft_pos += 1
        proposals: Dict[object, List[int]] = {}
        feed: Dict[object, int] = {}
        for seq in active:
            if seq.next_pos == len(seq.tokens) - 1:
                proposals[seq.sid] = []
                feed[seq.sid] = seq.tokens[seq.next_pos]
        if not proposals:
            return proposals
        for r in range(k):
            data = np.zeros((b,), self._dtype)
            positions = np.full((b,), self.max_seq_len - 1, self._dtype)
            table = np.zeros((b, self.max_pages), self._dtype)
            live = []
            for i, seq in enumerate(active):
                if seq.sid not in proposals:
                    continue
                p = seq.next_pos + r
                if p >= min(seq.limit, self.max_seq_len) - 1:
                    continue  # no use drafting past the hard stop
                data[i] = feed[seq.sid]
                positions[i] = p
                table[i] = rows[seq.sid]
                live.append((i, seq))
            if not live:
                break
            logits = self._run_lanes(pred, self._draft_pool, data,
                                     positions, table).float().cpu().numpy()
            for i, seq in live:
                d = int(np.argmax(logits[i]))
                proposals[seq.sid].append(d)
                feed[seq.sid] = d
        return proposals

    def _drop_retired(self, retired: List[_Seq]):
        if not retired:
            return
        with self._cv:
            for seq in retired:
                if seq in self._active:
                    self._active.remove(seq)
            self.metrics.g_active.set(len(self._active))
            self._cv.notify_all()
