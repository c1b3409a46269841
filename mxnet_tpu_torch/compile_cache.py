"""Compile-once: content-keyed plan entries, CUDA graphs and AOT bundles;
counterpart of ``mxnet_tpu/compile_cache.py``.

The JAX package serializes XLA executables.  The port runs eager torch, so
what a "compiled" program is here has two halves:

* **in process, a CUDA graph.**  The kinds of ``GRAPH_KINDS``
  (``"fwd"`` with ``is_train=False``, every serving bucket, and the
  generation engine's ``gen-prefill`` and ``gen-draft-prefill``
  executors) are captured at their signature's first prime, on the
  executor's bound tensors, and replayed after that.  The buckets of one
  replica share one graph memory pool (``GraphPool``).  Before a replay
  every argument whose tensor is not the one captured is copied into the
  captured buffer: a training step rebinds its aux states
  (``Executor._store_aux``), and an evaluation between steps replays the
  inference graph on them.  A graph's outputs are its own buffers: they
  hold until the next call of the same executor, as an MXNet executor's
  ``outputs`` do.  The launch counts the kernel wrappers made while the
  graph was captured are added on every replay (``kernels.LAUNCHES``
  counts on the host).  The engine's lane
  kinds (``gen-step``, ``gen-draft-step``, ``gen-verify``,
  ``gen-catchup``) and the training kinds (``"fwdbwd"``, ``"fused"``)
  are entries too, but run eagerly: no graph.  A lane step's output
  planes become the KV pool's (``PagedKVPool.adopt``), so a graph of it
  would copy every plane back into its captured buffers on each step and
  keep a second set of planes per lane bucket.  A capture that raises is
  recorded as ``cache_state == "bypass"`` and counted
  (``stats()["bypass"]``); the executor then runs eagerly.

* **on disk, what a new process reuses without building anything.**  An
  entry (``EntryStore``: ``MAGIC | u64 meta_len | meta json | payload``,
  CRC32 sidecar, written by ``filesystem.atomic_write``) holds the plan's
  fingerprint and warm-up recipe, the names of the nvcc libraries
  (``kernels._lib_path``) and NVRTC cubins (by source hash) its first run
  loaded, the visible tuning entries and the cost info (the graph pool's
  and the static inputs' device bytes).  The library and cubin bytes are
  entries of their own in the same store (kinds ``"lib"`` and
  ``"cubin"``, each with its sha256), written beside the first entry that
  loads them.  On a hit a missing library is written into ``_build/``
  after its hash is checked (no nvcc), a cubin is registered with
  ``cuda_rtc`` (no NVRTC), the tuning winners are visible (no tuning),
  and the graph is captured at warm-up (``meta["capture_ms"]``: capturing
  is not compiling).

Keying is as in the JAX package (``CachedFunction._key_parts``): graph
fingerprint, compute dtype, ``cast_exclude``, remat, ``group2ctx``, the
signature, the autotune fingerprint and the shard mesh and specs, plus the
executor's device type.  The environment envelope is ``{"schema",
"framework": "torch", "torch", "cuda", "platform", "device_kind",
"device_count", "process_count"}``: an entry written under another is a
miss with a ``compile_cache_invalidate`` event, never a crash, and so is
a JAX-written ``.mxc`` entry (same magic and suffix, another envelope).
``attach_bundle`` refuses a bundle whose ``framework`` or topology differs
(a JAX-written bundle raises ``MXNetError`` even on the CPU, where the
topology keys could match).

Enable with ``MXNET_COMPILE_CACHE_DIR=/path`` (empty default = off: with
no bundle attached ``maybe_cached`` returns its callable untouched and the
executor runs exactly as before).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .artifact_store import EntryStore, digest_of
from .base import MXNetError, env, register_env

__all__ = [
    "enabled", "cache_dir", "env_fingerprint", "stats", "reset_stats",
    "maybe_cached", "CachedFunction", "attach_bundle", "detach_bundles",
    "save_bundle", "read_manifest", "ls_entries", "verify_entry", "prune",
    "entry_meta", "MANIFEST_NAME", "ENTRY_SUFFIX",
]

register_env("MXNET_COMPILE_CACHE_DIR", "", str,
             "Directory for the persistent framework-level compilation "
             "cache (content-fingerprint keyed plan entries, the nvcc "
             "libraries and NVRTC cubins they load). Empty disables the "
             "cache entirely.")
register_env("MXNET_COMPILE_CACHE_MAX_MB", 2048, int,
             "Size budget for the compile-cache directory; after a store "
             "the oldest entries (by mtime) are pruned until under "
             "budget. <= 0 disables pruning.")
register_env("MXNET_COMPILE_CACHE_STRICT", 0, int,
             "1 makes cache load/store failures raise instead of "
             "degrading to a plain build (debugging aid; production "
             "keeps 0: a broken cache must never break the job).")
register_env("MXNET_COMPILE_CACHE_MIN_MS", 0.0, float,
             "Only builds that took at least this many ms are stored (0 "
             "stores everything).")

_MAGIC = b"MXTPUCC1"
_SCHEMA = 1
ENTRY_SUFFIX = ".mxc"
MANIFEST_NAME = "manifest.json"
#: the kinds captured as CUDA graphs: the inference executors whose
#: inputs are written in place (the engine's lane kinds adopt their output
#: planes, and run eagerly)
GRAPH_KINDS = frozenset(("fwd", "gen-prefill", "gen-draft-prefill"))
_BLOB_KINDS = ("lib", "cubin")

# on-disk grammar + admin shared with the autotune TuningDB
_STORE = EntryStore(_MAGIC, ENTRY_SUFFIX, "compile-cache", "compile_cache")

_lock = threading.Lock()
# process-wide loaded entries: a hot-swap shadow replica in the same
# process inherits the outgoing replica's entries without touching the
# disk.  digest -> (meta, payload dict); no graph is held here
_mem: Dict[str, Tuple[dict, dict]] = {}
# read-only overlay directories (attached AOT bundles), searched after
# the primary cache dir
_bundles: List[str] = []
_env_fp_cache: Optional[dict] = None


def enabled() -> bool:
    return bool(env("MXNET_COMPILE_CACHE_DIR", "", str))


def active() -> bool:
    """True when entries may come out of (or go into) the cache: the
    on-disk cache is enabled or an AOT bundle overlay is attached."""
    return enabled() or bool(_bundles)


def cache_dir() -> str:
    return env("MXNET_COMPILE_CACHE_DIR", "", str)


def _strict() -> bool:
    return bool(env("MXNET_COMPILE_CACHE_STRICT", 0, int))


# ---------------------------------------------------------------------------
# telemetry instruments (global registry; they fire once per prime, never
# per call)
# ---------------------------------------------------------------------------

_instruments = None
_INSTRUMENT_NAMES = (
    "mxtpu_compile_cache_hits_total", "mxtpu_compile_cache_misses_total",
    "mxtpu_compile_cache_stores_total", "mxtpu_compile_cache_errors_total",
    "mxtpu_compile_cache_bypass_total", "mxtpu_compile_ms",
    "mxtpu_compile_cache_deserialize_ms", "mxtpu_compile_cache_capture_ms",
    "mxtpu_compile_cache_first_run_ms")


def _metrics():
    global _instruments
    if _instruments is None:
        from . import telemetry as tm

        reg = tm.registry()
        _instruments = {
            "hits": reg.counter(
                "mxtpu_compile_cache_hits_total",
                "Plan builds satisfied by a cache entry (no nvcc, no "
                "NVRTC, no tuning)."),
            "misses": reg.counter(
                "mxtpu_compile_cache_misses_total",
                "Plan builds that found no entry and ran cold."),
            "stores": reg.counter(
                "mxtpu_compile_cache_stores_total",
                "Cache entries written."),
            "errors": reg.counter(
                "mxtpu_compile_cache_errors_total",
                "Cache load/store failures degraded to a plain build "
                "(corrupt entry, torn write, injected fault)."),
            "bypass": reg.counter(
                "mxtpu_compile_cache_bypass_total",
                "Primes that run eagerly outside the cache (a key that "
                "could not be formed, a CUDA graph capture that raised)."),
            "compile_ms": reg.histogram(
                "mxtpu_compile_ms",
                "Cold first-run time per cache-miss plan build (ms), the "
                "kernels' nvcc and NVRTC builds included.",
                start=1.0, factor=4.0, count=12),
            "deserialize_ms": reg.histogram(
                "mxtpu_compile_cache_deserialize_ms",
                "Entry load and library/cubin restore time per cache hit "
                "(ms).", start=0.25, factor=4.0, count=12),
            "capture_ms": reg.histogram(
                "mxtpu_compile_cache_capture_ms",
                "CUDA graph capture time per prime (ms): not compiling.",
                start=0.25, factor=4.0, count=12),
            "first_run_ms": reg.histogram(
                "mxtpu_compile_cache_first_run_ms",
                "The first, eager run of every prime, hit or miss (ms): "
                "the warm-up before a capture.",
                start=0.25, factor=4.0, count=12),
        }
    return _instruments


def _log_event(kind, **fields):
    try:
        from . import telemetry as tm

        tm.log_event(kind, **fields)
    except Exception:
        pass


def stats() -> dict:
    """Compact counters for capture records."""
    m = _metrics()
    return {
        "dir": cache_dir() or None,
        "hits": m["hits"].value,
        "misses": m["misses"].value,
        "stores": m["stores"].value,
        "errors": m["errors"].value,
        "bypass": m["bypass"].value,
        "compile_ms": round(m["compile_ms"].sum, 3),
        "deserialize_ms": round(m["deserialize_ms"].sum, 3),
        "capture_ms": round(m["capture_ms"].sum, 3),
        "first_run_ms": round(m["first_run_ms"].sum, 3),
    }


def reset_stats() -> None:
    """Test hook: zero the instruments (they are dropped from the global
    registry and made anew), drop the in-memory entries and detach every
    bundle."""
    global _instruments
    from . import telemetry as tm

    reg = tm.registry()
    with _lock:
        _instruments = None
        with reg._lock:
            for name in _INSTRUMENT_NAMES:
                reg._instruments.pop(name, None)
        _mem.clear()
        del _bundles[:]


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------

def env_fingerprint() -> dict:
    """The compatibility envelope an entry is only valid inside: the
    framework, torch and CUDA versions, the platform, the card's name and
    count, the process count.  Recorded in every entry and checked at
    load: any mismatch invalidates (a miss, never a crash)."""
    global _env_fp_cache
    if _env_fp_cache is None:
        import torch

        cuda = torch.cuda.is_available()
        processes = 1
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                processes = dist.get_world_size()
        except Exception:
            pass
        _env_fp_cache = {
            "schema": _SCHEMA,
            "framework": "torch",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "platform": "gpu" if cuda else "cpu",
            "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "process_count": processes,
        }
    return dict(_env_fp_cache)


def _tensors_sig(named) -> list:
    return [[k, list(t.shape), str(t.dtype).replace("torch.", "")]
            for k, t in named]


def _signature(executor, args) -> dict:
    """The batch-signature half of the key: (name, shape, dtype) of every
    bound argument and aux state, in bind order."""
    if args and isinstance(args[0], dict):
        arg_t = args[0]
        aux_t = args[1] if len(args) > 1 else {}
    else:
        arg_t = {k: v._data for k, v in executor.arg_dict.items()}
        aux_t = {k: v._data for k, v in executor.aux_dict.items()}
    return {"args": _tensors_sig(_pieces(arg_t)),
            "aux": _tensors_sig(_pieces(aux_t))}


def _pieces(named):
    """(name, tensor) of every tensor in ``named``; a ShardedTensor's
    pieces are named by their coordinate."""
    out = []
    for k, v in named.items():
        shards = getattr(v, "shards", None)
        if shards is not None:
            out.extend(("%s@%s" % (k, c), t) for c, t in sorted(
                shards.items(), key=lambda kv: repr(kv[0])))
        else:
            out.append((k, v))
    return out


_digest = digest_of


def _sha256(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# entry file format: MAGIC | u64 meta_len | meta json | payload, with a
# CRC32 sidecar — the shared artifact_store grammar
# ---------------------------------------------------------------------------

def _entry_path(d: str, digest: str) -> str:
    return _STORE.entry_path(d, digest)


def entry_meta(path: str) -> dict:
    """Parse just the json header of an entry."""
    return _STORE.entry_meta(path)


def _write_entry(d: str, digest: str, meta: dict, payload_bytes: bytes,
                 op: str = "compile_cache.store") -> str:
    return _STORE.write_entry(d, digest, meta, payload_bytes, op=op)


def _read_payload(path: str) -> Tuple[dict, bytes]:
    return _STORE.read_payload(path)


def _env_compatible(meta: dict) -> bool:
    return meta.get("env") == env_fingerprint()


def _read_dirs() -> List[str]:
    d = cache_dir()
    out = [d] if d else []
    with _lock:
        out.extend(_bundles)
    return out


def _read_entry(digest: str, what: str):
    """-> (meta, payload bytes, path) of the first readable,
    env-compatible entry ``digest`` in the cache dir or a bundle, or None.
    Every failure mode (CRC mismatch, torn header, injected fault)
    degrades to None with a structured event; a stale env is a miss with
    a ``compile_cache_invalidate`` event."""
    from . import faults
    from .filesystem import verify_crc_sidecar

    for d in _read_dirs():
        path = _entry_path(d, digest)
        if not os.path.exists(path):
            continue
        try:
            faults.fire("compile_cache.load")
            if verify_crc_sidecar(path) is False:
                raise MXNetError("CRC mismatch")
            meta, payload = _read_payload(path)
            if not _env_compatible(meta):
                _log_event("compile_cache_invalidate", path=path,
                           entry_env=meta.get("env"),
                           current_env=env_fingerprint())
                continue  # stale-version entry: a miss, not an error
            if what in _BLOB_KINDS:
                if meta.get("kind") != what or \
                        _sha256(payload) != meta.get("sha256"):
                    raise MXNetError("%s entry's bytes do not match its "
                                     "sha256" % what)
            else:
                payload = json.loads(payload.decode())
            return meta, payload, path
        except Exception as exc:
            _metrics()["errors"].inc()
            _log_event("compile_cache_corrupt", path=path,
                       error=repr(exc)[:300])
            if _strict():
                raise
            continue
    return None


# ---------------------------------------------------------------------------
# libraries and cubins: content-keyed blobs in the same store
# ---------------------------------------------------------------------------

def _blob_digest(kind: str, name: str) -> str:
    return digest_of({"schema": _SCHEMA, "blob": kind, "name": name})


def _store_blob(kind: str, name: str, data: bytes) -> Optional[str]:
    """Write blob ``name`` into the cache dir unless it is there already;
    the path, or None (cache off, or a store failure, counted)."""
    d = cache_dir()
    if not d:
        return None
    digest = _blob_digest(kind, name)
    path = _entry_path(d, digest)
    if os.path.exists(path):
        return path
    meta = {"digest": digest, "kind": kind, "name": name,
            "sha256": _sha256(data), "bytes": len(data),
            "env": env_fingerprint(), "created": round(time.time(), 3)}
    try:
        _write_entry(d, digest, meta, data)
        _metrics()["stores"].inc()
        _log_event("compile_cache_store", digest=digest, path=path,
                   blob=kind, name=name, bytes=len(data))
        return path
    except Exception as exc:
        _metrics()["errors"].inc()
        _log_event("compile_cache_store_failed", digest=digest,
                   error=repr(exc)[:300])
        if _strict():
            raise
        return None


def load_blob(kind: str, name: str) -> Optional[bytes]:
    """Blob ``name`` of ``kind`` ("lib" or "cubin") from the cache dir or
    an attached bundle, its sha256 checked; None when there is none."""
    if not active():
        return None
    got = _read_entry(_blob_digest(kind, name), kind)
    return None if got is None else got[1]


def store_library(path: str) -> Optional[str]:
    """Keep the bytes of the nvcc library at ``path`` (a file of
    ``kernels._BUILD``, named by its sources' hash) in the cache dir."""
    if not enabled() or not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    return _store_blob("lib", os.path.basename(path), data)


def restore_library(path: str) -> bool:
    """Write the nvcc library ``path`` from the cache (its name is the
    hash of its sources, its bytes checked against the entry's sha256);
    True when it is there now without nvcc."""
    if os.path.exists(path):
        return True
    data = load_blob("lib", os.path.basename(path))
    if data is None:
        return False
    from .filesystem import atomic_write

    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_write(path, lambda f: f.write(data), op="compile_cache.restore")
    _log_event("compile_cache_library_restored", path=path,
               bytes=len(data))
    return True


def store_cubin(key: str, cubin: bytes) -> Optional[str]:
    """Keep an NVRTC cubin (``key``: its source hash) in the cache dir."""
    if not enabled():
        return None
    return _store_blob("cubin", key, cubin)


def _ensure_blobs(payload: dict) -> None:
    """Write the blobs a plan entry names into the cache dir from this
    process (the library files, the cubins it holds)."""
    from . import cuda_rtc, kernels

    for libname in payload.get("libs", {}).values():
        store_library(os.path.join(kernels._BUILD, libname))
    for key in payload.get("cubins", []):
        cubin = cuda_rtc.cubin(key)
        if cubin is not None:
            store_cubin(key, cubin)


def _restore_blobs(payload: dict) -> None:
    """On a hit: each library the entry names into ``_build/`` (no nvcc)
    and each cubin into ``cuda_rtc`` (no NVRTC)."""
    from . import cuda_rtc, kernels

    for libname in payload.get("libs", {}).values():
        restore_library(os.path.join(kernels._BUILD, libname))
    for key in payload.get("cubins", []):
        if cuda_rtc.cubin(key) is None:
            data = load_blob("cubin", key)
            if data is not None:
                cuda_rtc.register_cubin(key, data)


# ---------------------------------------------------------------------------
# load / store of plan entries
# ---------------------------------------------------------------------------

def _load(digest: str):
    """-> (meta, payload) or None (a miss)."""
    with _lock:
        hit = _mem.get(digest)
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    got = _read_entry(digest, "plan")
    if got is None:
        return None
    meta, payload, path = got
    try:
        _restore_blobs(payload)
    except Exception as exc:
        _metrics()["errors"].inc()
        _log_event("compile_cache_corrupt", path=path, error=repr(exc)[:300])
        if _strict():
            raise
    ms = (time.perf_counter() - t0) * 1e3
    _metrics()["deserialize_ms"].observe(ms)
    with _lock:
        _mem[digest] = (meta, payload)
    _log_event("compile_cache_hit", digest=digest, path=path,
               deserialize_ms=round(ms, 3))
    return meta, payload


def _store(digest: str, meta: dict, payload: dict,
           compile_ms: float) -> Optional[str]:
    d = cache_dir()
    if not d:
        return None
    min_ms = env("MXNET_COMPILE_CACHE_MIN_MS", 0.0, float)
    if compile_ms < min_ms:
        return None
    try:
        blob = json.dumps(payload, sort_keys=True, default=str).encode()
        path = _write_entry(d, digest, meta, blob)
        _metrics()["stores"].inc()
        _log_event("compile_cache_store", digest=digest, path=path,
                   bytes=len(blob), compile_ms=round(compile_ms, 1))
        _ensure_blobs(payload)
        budget = env("MXNET_COMPILE_CACHE_MAX_MB", 2048, int)
        if budget > 0:
            prune(d, budget)
        return path
    except Exception as exc:
        _metrics()["errors"].inc()
        _log_event("compile_cache_store_failed", digest=digest,
                   error=repr(exc)[:300])
        if _strict():
            raise
        return None


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

class GraphPool:
    """One CUDA graph memory pool, shared by the graphs of one replica's
    buckets (made at the first capture)."""

    __slots__ = ("handle",)

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            import torch

            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


class _Graph:
    """A captured call: the graph, the tensors it was captured on and the
    outputs it writes; ``replay`` copies any argument whose tensor is not
    the captured one into it, replays, and adds the launches the kernel
    wrappers made during the capture."""

    def __init__(self, graph, buffers, outputs, launches):
        self.graph = graph
        self.buffers = buffers  # the call's tensors at the capture
        self.outputs = outputs
        self.launches = launches

    def replay(self, leaves):
        from . import kernels

        for t, buf in zip(leaves, self.buffers):
            if t is not buf and (t.data_ptr() != buf.data_ptr()
                                 or t.stride() != buf.stride()):
                buf.copy_(t)
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.count(name, n)
        return self.outputs


def _leaves(obj, out):
    """Every tensor of a nested call argument, in a fixed order."""
    import torch

    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif getattr(obj, "shards", None) is not None:  # a ShardedTensor
        for c in sorted(obj.shards, key=repr):
            out.append(obj.shards[c])
    elif isinstance(obj, dict):
        for k in obj:
            _leaves(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out)
    return out


def _nbytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        key = (t.data_ptr(), t.numel())
        if key not in seen:
            seen.add(key)
            n += t.numel() * t.element_size()
    return n


# ---------------------------------------------------------------------------
# the executor-facing wrapper
# ---------------------------------------------------------------------------

class CachedFunction:
    """Lazy cache-aware stand-in for an executor's call.

    The first call under each argument signature fingerprints the
    executor and its arguments, consults the cache (memory, then the
    cache dir, then attached bundles), and runs the call once eagerly:
    on a miss that run is the cold build (it may run nvcc and NVRTC) and
    the entry is stored; on a hit the entry's libraries and cubins were
    restored first, so it builds nothing.  An inference kind on a CUDA
    executor is then captured as a CUDA graph and replayed from the next
    call on; a NEW signature re-primes.  Any cache malfunction falls back
    to the wrapped callable, which behaves exactly as if the cache never
    existed.
    """

    __slots__ = ("_fn", "_kind", "_static_key", "_executor", "_by_sig",
                 "records", "digest", "meta", "cost_info", "cache_state")

    def __init__(self, fn, kind: str, static_key, executor):
        self._fn = fn
        self._kind = kind
        self._static_key = static_key
        self._executor = executor
        self._by_sig: Dict[Any, Any] = {}
        # one record per primed signature (bundle export reads these):
        # {"digest", "meta", "payload", "graph"}
        self.records: List[dict] = []
        self.digest = None
        self.meta = None
        self.cost_info = None
        self.cache_state = None  # "hit" | "miss" | "bypass"

    @staticmethod
    def _quick_sig(args):
        """Hashable per-call signature (the dispatch key): shape and dtype
        of every tensor of the call's arguments."""
        return tuple((tuple(t.shape), t.dtype, t.device)
                     for t in _leaves(args, []))

    def __call__(self, *args, **kwargs):
        sig = self._quick_sig(args)
        run = self._by_sig.get(sig)
        if run is None:
            return self._prime(sig, args, kwargs)
        if isinstance(run, _Graph):
            return run.replay(_leaves(args, []))
        return run(*args, **kwargs)

    def _key_parts(self, args) -> dict:
        ex = self._executor
        parts = {
            "schema": _SCHEMA,
            "kind": self._kind,
            "static": repr(self._static_key),
            "graph": ex._plan.fingerprint(),
            "compute_dtype": str(ex._compute_dtype),
            "cast_exclude": sorted(ex._cast_exclude),
            # the remat the executor fixed for this step key (the fused
            # step's autotune winner), off for a key that has none
            "remat": int(ex._remat.get(self._static_key, False)),
            "group2ctx": sorted(
                (g, str(c)) for g, c in ex._group2ctx.items()),
            "sig": _signature(ex, args),
            "device": ex._ctx.device_type,
        }
        # tuned and untuned entries must never collide: when the
        # autotuner is active its DB-state fingerprint joins the key
        try:
            from . import autotune as _at

            at_fp = _at.cache_fingerprint()
        except Exception:
            at_fp = None
        if at_fp is not None:
            parts["autotune"] = at_fp
        if ex._shard_mesh is not None:
            from .sharding.mesh import mesh_fingerprint

            parts["shard"] = {
                "mesh": repr(mesh_fingerprint(ex._shard_mesh)),
                "specs": sorted((k, str(v))
                                for k, v in ex._shard_specs.items()),
            }
        return parts

    def _register(self, sig, run, state, digest=None, meta=None,
                  payload=None, parts=None):
        self._by_sig[sig] = run
        self.cache_state = state
        self.digest = digest
        self.meta = meta
        self.cost_info = (meta or {}).get("cost") or None
        if digest is not None:
            self.records.append({"digest": digest, "meta": meta,
                                 "payload": payload, "parts": parts,
                                 "graph": isinstance(run, _Graph)})

    def _graphable(self, args) -> bool:
        ex = self._executor
        if self._kind not in GRAPH_KINDS or ex._plan.stochastic:
            return False
        if ex._dp is not None or ex._placement:
            return False
        leaves = _leaves(args, [])
        return bool(leaves) and all(t.is_cuda for t in leaves) and \
            len({t.device for t in leaves}) == 1

    def _prime(self, sig, args, kwargs):
        from . import kernels

        digest = None
        try:
            parts = self._key_parts(args)
            digest = _digest(parts)
            hit = _load(digest)
        except Exception as exc:
            if _strict():
                raise
            _metrics()["errors"].inc()
            _log_event("compile_cache_key_failed", kind=self._kind,
                       error=repr(exc)[:300])
            hit = None
            if digest is None:
                # can't even fingerprint: bypass the cache entirely
                _metrics()["bypass"].inc()
                self._register(sig, self._fn, "bypass")
                return self._fn(*args, **kwargs)
        if hit is not None:
            _metrics()["hits"].inc()
        else:
            _metrics()["misses"].inc()
        # the first run: the cold build on a miss, a warm run on a hit
        # (it loads what the entry restored), and the warm-up before a
        # capture either way
        leaves = _leaves(args, [])
        cuda = any(t.is_cuda for t in leaves)
        with kernels.recording() as used:
            t0 = time.perf_counter()
            out = self._fn(*args, **kwargs)
            if cuda:
                import torch

                torch.cuda.synchronize()
            run_ms = (time.perf_counter() - t0) * 1e3
        _metrics()["first_run_ms"].observe(run_ms)
        state = "hit" if hit is not None else "miss"
        run, cost, capture_ms = self._fn, None, None
        if self._graphable(args):
            try:
                run, cost, capture_ms = self._capture(args, kwargs)
            except Exception as exc:
                state = "bypass"
                _metrics()["bypass"].inc()
                _log_event("compile_cache_capture_failed", kind=self._kind,
                           digest=digest, error=repr(exc)[:300])
                run = self._fn
        if hit is not None:
            meta, payload = hit
            meta = dict(meta)
        else:
            # a tuning site the run consulted (in record mode) may have
            # changed the winner set, and with it the key: the entry is
            # stored under the key a process holding those winners forms
            parts2 = self._key_parts(args)
            if parts2 != parts:
                parts, digest = parts2, _digest(parts2)
            _metrics()["compile_ms"].observe(run_ms)
            payload = self._payload(parts, used)
            meta = self._build_meta(digest, run_ms, cost)
            with _lock:
                _mem[digest] = (meta, payload)
            _store(digest, meta, payload, run_ms)
            meta = dict(meta)
        if cost is not None:
            meta["cost"] = cost
        meta["capture_ms"] = capture_ms
        self._register(sig, run, state, digest, meta, payload, parts)
        return out

    def _payload(self, parts, used) -> dict:
        from . import autotune as _at
        from . import kernels

        try:
            tuning = _at.db().all_digests() if _at.enabled() else []
        except Exception:
            tuning = []
        return {"plan": parts["graph"], "kind": self._kind,
                "warmup": {"sig": parts["sig"], "device": parts["device"]},
                "libs": {s: os.path.basename(kernels._lib_path(s))
                         for s in sorted(used["libs"])},
                "cubins": sorted(used["cubins"]),
                "launches": dict(used["launches"]),
                "autotune": tuning}

    def _capture(self, args, kwargs):
        """Capture the call as a CUDA graph in this replica's pool; ->
        (_Graph, cost, capture ms).  Its launches are taken back off
        ``kernels.LAUNCHES`` (nothing ran) and added on every replay."""
        import torch

        from . import kernels

        ex = self._executor
        leaves = _leaves(args, [])
        device = leaves[0].device
        pool = getattr(ex, "_graph_pool", None)
        if pool is None:
            pool = ex._graph_pool = GraphPool()
        torch.cuda.synchronize(device)
        # as a capture does on entering: what is left reserved is in use,
        # so the growth over the capture is the graph pool's alone
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with kernels.recording() as seen:
            with torch.cuda.graph(graph, pool=pool.get(),
                                  capture_error_mode="thread_local"):
                outputs = self._fn(*args, **kwargs)
        kernels.uncount(seen["launches"])
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        _metrics()["capture_ms"].observe(ms)
        inputs = getattr(ex, "_cache_inputs", ())
        static_bytes = _nbytes([v._data for k, v in ex.arg_dict.items()
                                if k in inputs and
                                getattr(v._data, "is_cuda", False)])
        cost = {"pool_bytes": max(0, torch.cuda.memory_reserved(device)
                                  - before),
                "static_bytes": static_bytes,
                "output_bytes": _nbytes(_leaves(outputs, []))}
        g = _Graph(graph, leaves, outputs, dict(seen["launches"]))
        return g, cost, round(ms, 3)

    def _build_meta(self, digest, compile_ms, cost) -> dict:
        ex = self._executor
        mesh_axes = None
        if ex._shard_mesh is not None:
            mesh = ex._shard_mesh
            mesh_axes = {str(n): int(mesh.shape[n]) for n in mesh.axis_names}
        return {
            "digest": digest,
            "kind": self._kind,
            "env": env_fingerprint(),
            "mesh_axes": mesh_axes,
            "created": round(time.time(), 3),
            "compile_ms": round(compile_ms, 3),
            "cost": cost,
        }


def maybe_cached(fn, kind: str, static_key, executor):
    """Executor hook: wrap a callable in a :class:`CachedFunction` when
    the cache is enabled or a bundle is attached, else return it
    untouched (the default: no behavior change)."""
    if not enabled() and not _bundles:
        return fn
    return CachedFunction(fn, kind, static_key, executor)


# ---------------------------------------------------------------------------
# AOT bundles — a read-only cache overlay saved beside a checkpoint
# ---------------------------------------------------------------------------

def _blob_source(kind: str, name: str) -> Optional[bytes]:
    """A blob's bytes from the store, else from this process."""
    data = load_blob(kind, name)
    if data is not None:
        return data
    from . import cuda_rtc, kernels

    if kind == "cubin":
        return cuda_rtc.cubin(name)
    path = os.path.join(kernels._BUILD, name)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    return None


def _tuning_state():
    """(cache fingerprint, visible winner digests) of the autotuner now,
    or None while it is off."""
    try:
        from . import autotune as _at

        fp = _at.cache_fingerprint()
        return None if fp is None else (fp, _at.db().all_digests())
    except Exception:
        return None


def _rekeyed(rec, tuning):
    """(digest, meta) of a primed record under the tuning DB's state now.
    A site tuned after the record was primed re-keys it (the winner set
    joins the key): a bundle's entries and the winners it carries agree,
    so a replica that attaches it forms the same keys."""
    meta = dict(rec["meta"] or {})
    parts = rec.get("parts")
    if parts is None:
        return rec["digest"], meta
    parts = dict(parts)
    parts.pop("autotune", None)
    if tuning is not None:
        parts["autotune"] = tuning[0]
    digest = _digest(parts)
    meta["digest"] = digest
    return digest, meta


def save_bundle(path: str, entries, warmup: Optional[dict] = None) -> str:
    """Write an AOT bundle: one entry per primed plan in ``entries``
    (:class:`CachedFunction` wrappers, typically every bucket of a serving
    replica), the library and cubin entries they name, and
    ``manifest.json`` recording the warm-up recipe and the environment."""
    os.makedirs(path, exist_ok=True)
    from .filesystem import atomic_write

    manifest = {
        "schema": _SCHEMA,
        "env": env_fingerprint(),
        "created": round(time.time(), 3),
        "warmup": warmup or {},
        "entries": [],
        "blobs": [],
    }
    seen, blobs = set(), set()
    tuning = _tuning_state()
    for wrapper in entries:
        for rec in getattr(wrapper, "records", []) or []:
            digest, meta = _rekeyed(rec, tuning)
            payload = dict(rec.get("payload") or {})
            if digest in seen:
                continue
            if tuning is not None:
                payload["autotune"] = tuning[1]
            disk = {k: v for k, v in meta.items() if k != "capture_ms"}
            _write_entry(path, digest, disk, json.dumps(
                payload, sort_keys=True, default=str).encode())
            seen.add(digest)
            manifest["entries"].append({
                "digest": digest,
                "kind": meta.get("kind"),
                "mesh_axes": meta.get("mesh_axes"),
                "cost": meta.get("cost"),
                "graph": bool(rec.get("graph")),
            })
            blobs.update(("lib", n) for n in payload.get("libs", {}).values())
            blobs.update(("cubin", n) for n in payload.get("cubins", []))
    for kind, name in sorted(blobs):
        data = _blob_source(kind, name)
        if data is None:
            continue
        digest = _blob_digest(kind, name)
        _write_entry(path, digest, {
            "digest": digest, "kind": kind, "name": name,
            "sha256": _sha256(data), "bytes": len(data),
            "env": env_fingerprint(), "created": round(time.time(), 3)},
            data)
        manifest["blobs"].append({"digest": digest, "kind": kind,
                                  "name": name, "bytes": len(data)})
    # the tuning DB rides along: a restored replica is tuned by
    # construction (best-effort: a bundle without tuning entries is
    # still a valid bundle)
    try:
        from . import autotune as _at

        n = _at.export_to_bundle(path)
        if n:
            manifest["autotune_entries"] = n
    except Exception:
        pass
    atomic_write(os.path.join(path, MANIFEST_NAME),
                 lambda f: f.write(json.dumps(manifest, indent=1,
                                              default=str).encode()),
                 checksum=True, op="compile_cache.store")
    _log_event("compile_cache_bundle_saved", path=path,
               entries=len(manifest["entries"]))
    return path


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        return json.load(f)


def attach_bundle(path: str, mesh=None) -> dict:
    """Attach an AOT bundle directory as a read-only cache overlay.

    Refuses LOUDLY (raises :class:`MXNetError`) when the bundle was
    written by another framework (the JAX package's) or for another
    device topology or, when ``mesh`` is given, other mesh axes.  A stale
    torch or CUDA version is a softer failure: the bundle attaches but
    every entry invalidates at load (a plain build) with an event."""
    manifest = read_manifest(path)
    cur = env_fingerprint()
    ent_env = manifest.get("env") or {}
    for k in ("framework", "platform", "device_kind", "device_count",
              "process_count"):
        if ent_env.get(k) != cur.get(k):
            raise MXNetError(
                "AOT bundle %s was built for %s=%r but this process has "
                "%r — refusing the mismatched restore (rebuild the bundle "
                "on this topology or serve without it)"
                % (path, k, ent_env.get(k), cur.get(k)))
    if mesh is not None:
        want = {str(n): int(mesh.shape[n]) for n in mesh.axis_names}
        for e in manifest.get("entries", []):
            axes = e.get("mesh_axes")
            if axes and axes != want:
                raise MXNetError(
                    "AOT bundle entry %s records mesh axes %s but the "
                    "target mesh is %s — refusing the mismatched restore"
                    % (e.get("digest"), axes, want))
    with _lock:
        if path not in _bundles:
            _bundles.append(path)
    try:
        from . import autotune as _at

        _at.attach_bundle_overlay(path)
    except Exception:
        pass
    _log_event("compile_cache_bundle_attached", path=path,
               entries=len(manifest.get("entries", [])))
    return manifest


def detach_bundles() -> None:
    with _lock:
        del _bundles[:]


# ---------------------------------------------------------------------------
# admin: ls / verify / prune  (python -m mxnet_tpu_torch.tools.
# compile_cache_admin)
# ---------------------------------------------------------------------------

def ls_entries(d: str) -> List[dict]:
    """[{digest, path, bytes, mtime, kind, compile_ms, env_ok}] for every
    entry in ``d`` (unreadable headers report kind='corrupt')."""
    return _STORE.ls_entries(
        d, meta_fields=lambda meta: {"kind": meta.get("kind"),
                                     "compile_ms": meta.get("compile_ms"),
                                     "env_ok": _env_compatible(meta)})


def _check_payload(meta, payload):
    if meta.get("kind") in _BLOB_KINDS:
        if _sha256(payload) != meta.get("sha256"):
            raise MXNetError("bytes do not match the entry's sha256")
    else:
        json.loads(payload.decode())


def verify_entry(path: str) -> Tuple[bool, str]:
    """(ok, detail): CRC sidecar + header + payload check (a plan's JSON,
    a blob's sha256) — everything short of using the entry."""
    ok, detail = _STORE.verify_entry(path, payload_check=_check_payload,
                                     env_ok=_env_compatible)
    if detail == "ok (stale env: invalidates on load)":
        detail = "ok (stale env: rebuilds on load)"
    return ok, detail


def prune(d: str, budget_mb: int) -> List[str]:
    """Delete oldest-mtime entries (and their sidecars) until the
    directory is under ``budget_mb``.  Returns the removed paths."""
    removed = _STORE.prune(d, budget_mb)
    if removed:
        _log_event("compile_cache_pruned", dir=d, removed=len(removed))
    return removed


def entries_of(executor) -> List[CachedFunction]:
    """The primed :class:`CachedFunction` wrappers of one executor."""
    return [fn for fn in getattr(executor, "_jit_cache", {}).values()
            if isinstance(fn, CachedFunction) and fn.records]
