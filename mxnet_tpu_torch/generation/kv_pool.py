"""Paged KV-cache pool — counterpart of ``mxnet_tpu/generation/kv_pool.py``:
fixed-size pages, per-sequence page tables, refcounted copy-on-write
sharing, and a cross-request prefix cache.

KV storage is a shared pool of fixed-size pages (the vLLM PagedAttention
layout): a sequence owns ``ceil(len / page_size)`` pages, listed in order
in its page table, so live memory tracks live tokens and the pool admits
as many sequences as actually fit.

Page 0 is reserved as scratch: inactive decode lanes point their
page-table rows at it so their masked-out writes land harmlessly
(``ops/paged.py``).  Allocation is O(1) off a free list; exhaustion raises
:class:`KVPoolExhaustedError` — the engine's admission backpressure and
preemption signal, never a deadlock.

Prefix caching (cross-request): every COMPLETE page a sequence fills is
content-addressed by a page-granular rolling hash over the token ids it
holds (each page's digest chains over every preceding token, so two
sequences share page ``j`` only when their first ``(j+1)*page_size``
tokens are identical).  Pages carry refcounts: :meth:`alloc_prefix`
resolves the longest indexed prefix of a new prompt and takes references
on the hit pages instead of recomputing them; :meth:`free` decrements,
and a page whose refcount reaches 0 while still indexed is RETAINED as
reusable cache rather than returned to the free list — a bounded LRU
(``MXNET_GEN_PREFIX_CACHE_PAGES``) that evicts only refcount-0 pages.  A
lane about to write into a shared page copies it first
(:meth:`ensure_writable` — copy-on-write).

Where the JAX package keeps the planes in host numpy arrays, here each
layer's K and V plane is a torch tensor on the pool's device (``ctx``,
default ``gpu(0)``): prefill K/V are scattered into it and copy-on-write
copies pages inside it, on the device, and the engine's executors read the
planes in place through :meth:`bind_args` and hand their new planes back
through :meth:`adopt`.  The bookkeeping (free list, refcounts, index,
watermarks, telemetry, fault points) is the JAX package's, line for line.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import Context, gpu
from ..ops.param import torch_dtype

__all__ = ["PagedKVPool", "KVPoolExhaustedError"]


class KVPoolExhaustedError(MXNetError):
    """No free pages — backpressure: callers queue, shed, or preempt."""


def _page_digest(prev: bytes, chunk) -> bytes:
    """Rolling content hash for one page worth of token ids: chains the
    previous page's digest so a digest identifies the ENTIRE prefix up
    to and including this page, not just its own tokens."""
    h = hashlib.sha1(prev)
    h.update(np.asarray(chunk, np.int64).tobytes())
    return h.digest()


class PagedKVPool:
    """Paged K/V storage on a device for ``num_layers`` attention layers.

    Parameters
    ----------
    num_pages : int
        Total pool pages INCLUDING the reserved scratch page 0, so
        ``num_pages - 1`` are allocatable.
    page_size : int
        Tokens per page.
    num_layers, num_heads, head_dim : int
        K/V geometry; each layer holds one ``(num_pages, page_size,
        num_heads, head_dim)`` K array and one V array.
    prefix_cache_pages : int, optional
        Upper bound on refcount-0 pages the prefix index retains after
        their last owner frees them (0, the default, disables prefix
        caching entirely — legacy alloc/free semantics).
    ctx : Context, optional
        Where the planes live (default ``gpu(0)``).
    """

    def __init__(self, num_pages, page_size, num_layers, num_heads,
                 head_dim, dtype=np.float32, prefix_cache_pages: int = 0,
                 ctx: Optional[Context] = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_layers = int(num_layers)
        self.prefix_cache_pages = max(0, int(prefix_cache_pages))
        self._dtype = np.dtype(dtype)
        self.ctx = ctx if ctx is not None else gpu(0)
        self.device = self.ctx.torch_device()
        shape = (self.num_pages, self.page_size, int(num_heads),
                 int(head_dim))
        tdt = torch_dtype(self._dtype)
        self.k_pools = [torch.zeros(shape, dtype=tdt, device=self.device)
                        for _ in range(self.num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=tdt, device=self.device)
                        for _ in range(self.num_layers)]
        self._handles: Optional[Dict[str, object]] = None
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lengths: Dict[object, int] = {}
        # -- sharing / prefix-cache state ---------------------------------
        self._ref: Dict[int, int] = {}          # page -> refcount (live)
        self._index: "OrderedDict[bytes, int]" = OrderedDict()  # LRU->MRU
        self._page_key: Dict[int, bytes] = {}   # indexed page -> digest
        self._cached = 0                        # indexed pages at ref 0
        self._chain: Dict[object, Tuple[int, bytes]] = {}  # seq -> (pages
        #                                     registered, digest so far)
        self.peak_pages = 0
        reg = self._registry = _telemetry.Registry()
        self._g_live = reg.gauge("mxtpu_gen_kv_pages_live")
        self._g_peak = reg.gauge("mxtpu_gen_kv_pages_peak")
        self._g_occ = reg.gauge("mxtpu_gen_kv_pool_occupancy_pct")
        # ratio gauge over the ALLOCATABLE pages (num_pages - 1): hits
        # exactly 1.0 at a full pool, unlike pre-fix math that could
        # never reach it when derived from the raw num_pages
        self._g_occ_ratio = reg.gauge("mxtpu_gen_kv_occupancy")
        self._g_shared = reg.gauge("mxtpu_gen_pages_shared")
        self._g_cached = reg.gauge("mxtpu_gen_prefix_cached_pages")
        self._c_allocs = reg.counter("mxtpu_gen_kv_page_allocs_total")
        self._c_frees = reg.counter("mxtpu_gen_kv_page_frees_total")
        self._c_hits = reg.counter("mxtpu_gen_prefix_hits_total")
        self._c_misses = reg.counter("mxtpu_gen_prefix_misses_total")
        self._c_evict = reg.counter("mxtpu_gen_prefix_evictions_total")
        self._c_cow = reg.counter("mxtpu_gen_kv_cow_copies_total")
        self._c_hit_tokens = reg.counter("mxtpu_gen_prefix_hit_tokens_total")
        _telemetry.register_collector(self)

    # -- accounting -------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (scratch page excluded)."""
        return self.num_pages - 1

    def live_pages(self) -> int:
        with self._lock:
            return self._live_locked()

    def _live_locked(self) -> int:
        """Pages owned by at least one live sequence — excludes scratch
        page 0, the free list, AND retained (refcount-0) cache pages."""
        return self.capacity - len(self._free) - self._cached

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def reclaimable_pages(self) -> int:
        """Pages an allocation can obtain: the free list plus retained
        refcount-0 cache pages (evicted on demand)."""
        with self._lock:
            return len(self._free) + self._cached

    def cached_pages(self) -> int:
        with self._lock:
            return self._cached

    def shared_pages(self) -> int:
        """Pages referenced by more than one live sequence."""
        with self._lock:
            return sum(1 for r in self._ref.values() if r > 1)

    def total_refcount(self) -> int:
        """Sum of live refcounts — 0 after every sequence closed means
        no leaked shared pages (the chaos-run invariant)."""
        with self._lock:
            return sum(self._ref.values())

    def occupancy(self) -> float:
        return self.live_pages() / float(self.capacity)

    def pages_for(self, num_tokens: int) -> int:
        return -(-int(num_tokens) // self.page_size)  # ceil div

    def seq_length(self, seq_id) -> int:
        with self._lock:
            return self._lengths[seq_id]

    def live_sequences(self) -> int:
        with self._lock:
            return len(self._tables)

    def _refresh_gauges_locked(self):
        live = self._live_locked()
        if live > self.peak_pages:
            self.peak_pages = live
        self._g_live.set(live)
        self._g_peak.set(self.peak_pages)
        self._g_occ.set(int(round(100.0 * live / self.capacity)))
        self._g_occ_ratio.set(round(live / float(self.capacity), 4))
        self._g_shared.set(sum(1 for r in self._ref.values() if r > 1))
        self._g_cached.set(self._cached)

    # -- prefix-index internals (all called with the lock held) ----------
    def _evict_one_locked(self) -> bool:
        """Drop the least-recently-used refcount-0 indexed page back to
        the free list.  Returns False when nothing is evictable."""
        for key, page in self._index.items():
            if self._ref.get(page, 0) == 0:
                del self._index[key]
                del self._page_key[page]
                self._cached -= 1
                self._free.append(page)
                self._c_evict.inc()
                return True
        return False

    def _reserve_locked(self, need: int):
        """Ensure ``need`` pages are on the free list, evicting retained
        cache pages LRU-first; raises when the pool genuinely cannot."""
        while len(self._free) < need:
            if not self._evict_one_locked():
                raise KVPoolExhaustedError(
                    "KV pool exhausted: need %d pages, %d free (capacity "
                    "%d); retry, shed, or preempt" %
                    (need, len(self._free), self.capacity))

    def _enforce_cache_bound_locked(self):
        while self._cached > self.prefix_cache_pages:
            if not self._evict_one_locked():
                break

    def _release_page_locked(self, page: int):
        """Drop one reference; a refcount-0 page is retained when still
        indexed (and retention is enabled), else returned to the free
        list."""
        r = self._ref.get(page, 0) - 1
        if r > 0:
            self._ref[page] = r
            return
        self._ref.pop(page, None)
        key = self._page_key.get(page)
        if key is not None and self.prefix_cache_pages > 0:
            self._cached += 1
        else:
            if key is not None:
                del self._index[key]
                del self._page_key[page]
            self._free.append(page)

    def _match_prefix_locked(self, tokens) -> Tuple[List[int], List[bytes]]:
        """Longest run of indexed pages covering ``tokens``' complete
        page chunks; returns (pages, their chained digests)."""
        ps = self.page_size
        pages: List[int] = []
        digests: List[bytes] = []
        key = b""
        for start in range(0, (len(tokens) // ps) * ps, ps):
            key = _page_digest(key, tokens[start:start + ps])
            page = self._index.get(key)
            if page is None:
                break
            pages.append(page)
            digests.append(key)
        return pages, digests

    # -- alloc / extend / free -------------------------------------------
    def can_fit(self, num_tokens: int) -> bool:
        with self._lock:
            return (self.pages_for(num_tokens)
                    <= len(self._free) + self._cached)

    def alloc(self, seq_id, num_tokens: int) -> List[int]:
        """Claim pages for a new sequence of ``num_tokens`` tokens;
        returns its page list.  Raises :class:`KVPoolExhaustedError`
        without allocating anything when the pool cannot fit it."""
        pages, _ = self.alloc_prefix(seq_id, num_tokens, tokens=None)
        return pages

    def alloc_prefix(self, seq_id, num_tokens: int,
                     tokens=None) -> Tuple[List[int], int]:
        """Claim pages for a new sequence, resolving ``tokens`` (the
        prompt) against the prefix index first.  Returns ``(pages,
        cached_tokens)`` where the first ``cached_tokens`` positions'
        K/V are already materialized in shared pages — the caller skips
        prefill for them and feeds only the remainder.

        The hit policy is conservative: a match is only taken when the
        cached run covers at least as many tokens as the leftover
        suffix, so a near-miss never trades one big prefill for a long
        dribble of per-token catch-up steps.  ``cached_tokens`` is
        capped at ``num_tokens - 1`` — the final prompt position must
        always be (re)fed so its logits exist to produce the first
        generated token; when the cache covers it too, the write lands
        in a shared page and copy-on-write splits it.

        A fault injected at ``generation.prefix.lookup`` degrades the
        lookup to a miss (full prefill) instead of failing the stream.
        """
        faults.fire("generation.kv.alloc")
        lookup_ok = True
        if tokens is not None and self.prefix_cache_pages > 0:
            try:
                faults.fire("generation.prefix.lookup")
            except Exception:
                lookup_ok = False
        need_total = max(1, self.pages_for(num_tokens))
        with self._lock:
            if seq_id in self._tables:
                raise MXNetError("sequence %r already allocated" % (seq_id,))
            taken: List[int] = []
            digests: List[bytes] = []
            cached_tokens = 0
            if tokens is not None and self.prefix_cache_pages > 0 \
                    and lookup_ok:
                hit_pages, hit_digests = self._match_prefix_locked(tokens)
                usable = min(len(hit_pages) * self.page_size,
                             int(num_tokens) - 1)
                if usable >= 1 and (int(num_tokens) - usable) <= usable:
                    cached_tokens = usable
                    n_pages = self.pages_for(usable)
                    taken = hit_pages[:n_pages]
                    digests = hit_digests[:n_pages]
            if tokens is not None and self.prefix_cache_pages > 0:
                if cached_tokens:
                    self._c_hits.inc()
                    self._c_hit_tokens.inc(cached_tokens)
                else:
                    self._c_misses.inc()
            fresh_need = need_total - len(taken)
            self._reserve_locked(fresh_need)
            for page, key in zip(taken, digests):
                r = self._ref.get(page, 0)
                if r == 0:
                    self._cached -= 1
                self._ref[page] = r + 1
                self._index.move_to_end(key)
            fresh = [self._free.pop() for _ in range(fresh_need)]
            for page in fresh:
                self._ref[page] = 1
            pages = taken + fresh
            self._tables[seq_id] = pages
            self._lengths[seq_id] = int(num_tokens)
            self._chain[seq_id] = (len(taken),
                                   digests[-1] if digests else b"")
            self._c_allocs.inc(fresh_need)
            self._refresh_gauges_locked()
            return list(pages), cached_tokens

    def extend(self, seq_id, new_length: int) -> List[int]:
        """Grow a sequence to ``new_length`` tokens, claiming new pages
        when it crosses a page boundary.  Raises
        :class:`KVPoolExhaustedError` (state unchanged) when the pool is
        out — the engine preempts a sequence to make room."""
        with self._lock:
            pages = self._tables.get(seq_id)
            if pages is None:
                raise MXNetError("unknown sequence %r" % (seq_id,))
            need = self.pages_for(new_length) - len(pages)
            if need > 0:
                self._reserve_locked(need)
            for _ in range(max(0, need)):
                page = self._free.pop()
                self._ref[page] = 1
                pages.append(page)
            if need > 0:
                self._c_allocs.inc(need)
            self._lengths[seq_id] = max(self._lengths[seq_id],
                                        int(new_length))
            self._refresh_gauges_locked()
            return list(pages)

    def free(self, seq_id):
        """Release a sequence's references (idempotent).  Unshared pages
        return to the free list; pages other sequences still reference
        merely decrement; refcount-0 pages the prefix index still names
        are retained as cache, LRU-bounded by ``prefix_cache_pages``."""
        with self._lock:
            pages = self._tables.pop(seq_id, None)
            self._lengths.pop(seq_id, None)
            self._chain.pop(seq_id, None)
            if pages:
                # reversed keeps the legacy free-list LIFO order: a
                # follow-up alloc reuses the pages lowest-id-first
                for page in reversed(pages):
                    self._release_page_locked(page)
                self._c_frees.inc(len(pages))
                self._enforce_cache_bound_locked()
                self._refresh_gauges_locked()

    # -- copy-on-write ----------------------------------------------------
    def is_shared(self, seq_id, position: int) -> bool:
        """True when the page holding ``position`` must not be written
        by this sequence (another reference or the index still reads
        it)."""
        with self._lock:
            pages = self._tables.get(seq_id)
            if pages is None:
                raise MXNetError("unknown sequence %r" % (seq_id,))
            idx = int(position) // self.page_size
            if idx >= len(pages):
                return False
            page = pages[idx]
            return self._ref.get(page, 0) > 1 or page in self._page_key

    def ensure_writable(self, seq_id, position: int) -> bool:
        """Copy-on-write: when the page holding ``position`` is shared
        (refcount > 1) or still prefix-indexed, copy its K/V into a
        fresh private page and repoint this sequence's table entry, so
        the upcoming write can never mutate data another stream or the
        cache reads.  Returns True when a copy happened.  Raises
        :class:`KVPoolExhaustedError` when no page can be claimed."""
        with self._lock:
            pages = self._tables.get(seq_id)
            if pages is None:
                raise MXNetError("unknown sequence %r" % (seq_id,))
            idx = int(position) // self.page_size
            if idx >= len(pages):
                return False  # beyond allocation: write hits scratch
            page = pages[idx]
            if self._ref.get(page, 0) <= 1 and page not in self._page_key:
                return False
            self._reserve_locked(1)
            fresh = self._free.pop()
            self._ref[fresh] = 1
            with torch.no_grad():
                for layer in range(self.num_layers):
                    self.k_pools[layer][fresh] = self.k_pools[layer][page]
                    self.v_pools[layer][fresh] = self.v_pools[layer][page]
            pages[idx] = fresh
            self._release_page_locked(page)
            # the chain state survives a COW: digests are content-based
            # (over token ids), and the index keeps naming the ORIGINAL
            # page, whose bytes this sequence can no longer touch
            self._c_cow.inc()
            self._c_allocs.inc()
            self._enforce_cache_bound_locked()
            self._refresh_gauges_locked()
            return True

    # -- prefix registration ----------------------------------------------
    def register_prefix(self, seq_id, tokens) -> int:
        """Publish this sequence's newly COMPLETE pages (every position
        written and final) into the prefix index under their rolling
        content digests.  ``tokens`` must cover exactly the positions
        whose K/V is materialized and valid.  Incremental and
        idempotent; returns the number of pages newly indexed."""
        if self.prefix_cache_pages <= 0:
            return 0
        ps = self.page_size
        with self._lock:
            pages = self._tables.get(seq_id)
            if pages is None:
                return 0
            n_reg, key = self._chain.get(seq_id, (0, b""))
            complete = min(len(tokens) // ps, len(pages))
            added = 0
            for j in range(n_reg, complete):
                key = _page_digest(key, tokens[j * ps:(j + 1) * ps])
                page = pages[j]
                if key not in self._index and page not in self._page_key:
                    self._index[key] = page
                    self._page_key[page] = key
                    added += 1
            self._chain[seq_id] = (complete, key)
            if added:
                self._refresh_gauges_locked()
            return added

    # -- page-table / data plumbing for the decode step ------------------
    def page_table_row(self, seq_id, max_pages: int) -> np.ndarray:
        """The sequence's page list padded to ``max_pages`` with the
        scratch page 0 (the decode step's per-lane page-table row)."""
        with self._lock:
            pages = self._tables.get(seq_id)
            if pages is None:
                raise MXNetError("unknown sequence %r" % (seq_id,))
            if len(pages) > max_pages:
                raise MXNetError(
                    "sequence %r spans %d pages > max_pages %d"
                    % (seq_id, len(pages), max_pages))
            row = np.zeros((max_pages,), np.float32)
            row[:len(pages)] = pages
            return row

    def write_prefill(self, seq_id, layer, k, v, length: int):
        """Scatter a prefill pass's K/V (``(seq_len, heads, head_dim)``,
        only the first ``length`` rows real) into the sequence's pages: a
        tensor on the pool's device (the engine's path, one scatter on the
        device) or a host array."""
        length = int(length)
        ps = self.page_size
        with self._lock:
            pages = np.asarray(self._tables[seq_id], np.int64)
        t = np.arange(length)
        slots = torch.as_tensor(pages[t // ps] * ps + t % ps,
                                device=self.device)
        kp, vp = self.k_pools[layer], self.v_pools[layer]
        flat = (-1,) + tuple(kp.shape[2:])
        with torch.no_grad():
            kp.view(flat)[slots] = self._rows(k, length, kp.dtype)
            vp.view(flat)[slots] = self._rows(v, length, vp.dtype)

    def _rows(self, x, length, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x[:length].to(self.device, dtype)

    # -- the planes as executor arguments ----------------------------------
    def bind_args(self) -> Dict[str, object]:
        """``{"layer%d_k_pool": NDArray, "layer%d_v_pool": NDArray}`` over
        the planes, one handle per plane for the pool's life: executors
        that bind these (as shared parameters) read the current planes in
        place, with no copy."""
        if self._handles is None:
            from ..ndarray import NDArray

            self._handles = {}
            for i in range(self.num_layers):
                self._handles["layer%d_k_pool" % i] = NDArray(
                    self.k_pools[i], self.ctx)
                self._handles["layer%d_v_pool" % i] = NDArray(
                    self.v_pools[i], self.ctx)
        return self._handles

    def adopt(self, planes):
        """Make ``planes`` (``[k0, v0, k1, v1, ...]``, tensors on the
        pool's device, the pool outputs of a paged-attention forward)
        the pool's planes; the bound handles follow."""
        for i in range(self.num_layers):
            self.k_pools[i] = planes[2 * i]
            self.v_pools[i] = planes[2 * i + 1]
            if self._handles is not None:
                self._handles["layer%d_k_pool" % i]._set(planes[2 * i])
                self._handles["layer%d_v_pool" % i]._set(planes[2 * i + 1])

    def snapshot(self) -> dict:
        with self._lock:
            live = self._live_locked()
            return {"capacity": self.capacity, "live_pages": live,
                    "peak_pages": self.peak_pages,
                    "sequences": len(self._tables),
                    "occupancy": live / float(self.capacity),
                    "shared_pages": sum(1 for r in self._ref.values()
                                        if r > 1),
                    "cached_pages": self._cached,
                    "prefix_index_size": len(self._index),
                    "prefix_hits": self._c_hits.value,
                    "prefix_misses": self._c_misses.value,
                    "prefix_evictions": self._c_evict.value,
                    "cow_copies": self._c_cow.value,
                    "total_refcount": sum(self._ref.values())}

    def render_prometheus(self):
        """Collector hook for ``telemetry.render_prometheus()``."""
        return self._registry.render_prometheus()
