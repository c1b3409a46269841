"""Persistent autotuner — search knobs once per (model, topology), pay
the tuning cost once per fleet; counterpart of ``mxnet_tpu/autotune/``.

Following the TVM autotuning loop (arXiv 1802.04799):

* each tunable site declares its search space in :mod:`.spaces` (the
  JAX package's lists): ``serving_buckets`` (``serving/server.py``),
  ``decode_engine`` and ``draft_k`` (``generation/engine.py``),
  ``flash_attention`` (``ops/attention.py``: the port's kernels pick
  their own tiles, so its winner sizes nothing; the key is kept so that
  bundles carry its entry) and ``fused_step`` (``executor.py``: remat
  off or on; donation has no torch counterpart);
* the :class:`.Tuner` scores candidates with a closed-form ``score_fn``
  or by the roofline over the cost model of the candidate's program
  (``build_fn``, ``hlo_analysis``: the eager plan counted on meta
  tensors, where the JAX package reads XLA's cost analysis), refining
  the top-K by CUDA-event timing (``measure_fn``) where a card is
  present;
* winners persist in the :class:`.TuningDB` — the same atomic
  CRC-checked entry format, env-envelope invalidation, and admin
  surface as the compile cache (shared :mod:`..artifact_store`
  helpers) — so a whole fleet inherits one host's tuning;
* the chosen config joins the compile-cache key (tuned and untuned
  executables never collide) and AOT bundles carry the tuning entries,
  so a restored replica is tuned-by-construction.

Modes (``MXNET_AUTOTUNE``): empty/``off`` — sites use their built-in
defaults, zero overhead; ``1``/``on`` — sites consult the DB (lookup
only; a miss is the default config); ``record`` — a DB miss runs the
tuning loop and persists the winner.
"""
from __future__ import annotations

import threading
from typing import Optional

from ..base import env, register_env

from .db import TuningDB  # noqa: F401  (re-export)
from .tuner import Tuner  # noqa: F401  (re-export)
from . import spaces  # noqa: F401  (re-export)

__all__ = ["TuningDB", "Tuner", "spaces", "mode", "enabled", "db",
           "db_dir", "get_or_tune", "lookup", "stats", "reset_for_tests",
           "cache_fingerprint", "export_to_bundle",
           "attach_bundle_overlay"]

register_env("MXNET_AUTOTUNE", "", str,
             "Autotuner mode: empty/off = sites use built-in defaults; "
             "1/on = consult the tuning DB at lowering time (lookup "
             "only); record = tune on a DB miss and persist the winner.")
register_env("MXNET_AUTOTUNE_DIR", "", str,
             "Directory for the persistent tuning DB. Empty derives "
             "<MXNET_COMPILE_CACHE_DIR>/autotune when the compile cache "
             "is enabled, else the DB is in-memory only.")
register_env("MXNET_AUTOTUNE_TOPK", 3, int,
             "How many proxy-ranked candidates the Tuner re-scores by "
             "real timed execution when measurement is available.")
register_env("MXNET_AUTOTUNE_MEASURE", 0, int,
             "1 forces timed top-K refinement even without CUDA (where "
             "CUDA is, it is automatic); 0 trusts the analytic score "
             "off the card.")
register_env("MXNET_AUTOTUNE_STRICT", 0, int,
             "1 makes tuning-DB load/store failures raise instead of "
             "degrading to the built-in default config (debugging aid).")

_lock = threading.Lock()
_db_cache: Optional[TuningDB] = None
_fp_cache = None  # (generation, mode) -> digest memo for cache_fingerprint
_instruments = None


def mode() -> str:
    """'off' | 'on' | 'record'."""
    v = env("MXNET_AUTOTUNE", "", str).strip().lower()
    if v in ("", "0", "off"):
        return "off"
    if v == "record":
        return "record"
    return "on"


def enabled() -> bool:
    return mode() != "off"


def db_dir() -> str:
    d = env("MXNET_AUTOTUNE_DIR", "", str)
    if d:
        return d
    cc = env("MXNET_COMPILE_CACHE_DIR", "", str)
    if cc:
        import os

        return os.path.join(cc, "autotune")
    return ""


def db() -> TuningDB:
    """Process-wide DB singleton (rebuilt when the dir env changes)."""
    global _db_cache
    with _lock:
        d = db_dir()
        if _db_cache is None or _db_cache._dir != d:
            overlays = _db_cache._overlays if _db_cache is not None else []
            _db_cache = TuningDB(d, overlays=overlays)
        return _db_cache


# -- telemetry instruments --------------------------------------------------

def _metrics():
    global _instruments
    if _instruments is None:
        from .. import telemetry as tm

        reg = tm.registry()
        _instruments = {
            "hits": reg.counter(
                "mxtpu_autotune_hits_total",
                "Tunable-site lookups satisfied by a tuning-DB winner."),
            "misses": reg.counter(
                "mxtpu_autotune_misses_total",
                "Tunable-site lookups that fell back to the built-in "
                "default (no DB entry for this key)."),
            "stores": reg.counter(
                "mxtpu_autotune_stores_total",
                "Tuning winners written to the DB."),
            "errors": reg.counter(
                "mxtpu_autotune_errors_total",
                "Tuning-DB load/store failures degraded to the default "
                "config (corrupt entry, torn write, injected fault)."),
            "tuning_ms": reg.histogram(
                "mxtpu_autotune_tuning_ms",
                "Wall time per tuning-loop run (ms).",
                start=1.0, factor=4.0, count=12),
        }
    return _instruments


def _log_event(kind, **fields):
    try:
        from .. import telemetry as tm

        tm.log_event(kind, **fields)
    except Exception:
        pass


def stats() -> dict:
    """Compact counters for BENCH / capture records."""
    m = _metrics()
    return {
        "mode": mode(),
        "dir": db_dir() or None,
        "hits": m["hits"].value,
        "misses": m["misses"].value,
        "stores": m["stores"].value,
        "errors": m["errors"].value,
        "tuning_ms": round(m["tuning_ms"].sum, 3),
    }


def reset_for_tests() -> None:
    """Drop the DB singleton, fingerprint memo, and instruments (they
    are dropped from the global registry and made anew, at zero)."""
    global _db_cache, _fp_cache, _instruments
    from .. import telemetry as tm

    reg = tm.registry()
    with _lock:
        _db_cache = None
        _fp_cache = None
        _instruments = None
        with reg._lock:
            for name in ("mxtpu_autotune_hits_total",
                         "mxtpu_autotune_misses_total",
                         "mxtpu_autotune_stores_total",
                         "mxtpu_autotune_errors_total",
                         "mxtpu_autotune_tuning_ms"):
                reg._instruments.pop(name, None)


# -- the site-facing API ----------------------------------------------------

def lookup(site: str, key: dict) -> Optional[dict]:
    """Winner config for (site, key), or None.  Off mode: always None
    without touching the DB (zero overhead on the default path)."""
    if mode() == "off":
        return None
    ent = db().get(site, key)
    return ent["config"] if ent else None


def get_or_tune(site: str, key: dict, candidates=None, build_fn=None,
                score_fn=None, measure_fn=None,
                default: Optional[dict] = None) -> Optional[dict]:
    """The one call every tunable site makes at lowering time.

    off: ``default``.  on: DB winner or ``default``.  record: DB winner,
    else run the tuning loop over ``candidates``, persist, and return
    the fresh winner (``default`` when every candidate fails)."""
    m = mode()
    if m == "off":
        return default
    ent = db().get(site, key)
    if ent is not None:
        return ent["config"]
    if m != "record" or not candidates:
        return default
    return Tuner(db()).tune(site, key, candidates, build_fn=build_fn,
                            score_fn=score_fn, measure_fn=measure_fn,
                            default=default)


def cache_fingerprint() -> Optional[str]:
    """Compile-cache key material: None when off (key unchanged — old
    entries stay valid), else a digest over the full visible winner
    set.  Conservative by design: ANY winner change
    re-keys every executable, so tuned and untuned programs can never
    collide under one digest."""
    global _fp_cache
    if mode() == "off":
        return None
    d = db()
    tag = (d.generation, d._dir)
    with _lock:
        if _fp_cache is not None and _fp_cache[0] == tag:
            return _fp_cache[1]
    from ..artifact_store import digest_of

    # deliberately NOT keyed on record-vs-on: both modes see the same
    # winner set, so executables compiled while recording deserialize
    # unchanged on the lookup-mode fleet
    fp = digest_of({"entries": d.all_digests()})
    with _lock:
        _fp_cache = (tag, fp)
    return fp


# -- AOT bundle integration (compile_cache.save_bundle/attach_bundle) ------

def export_to_bundle(bundle_path: str) -> int:
    """Copy every visible tuning entry into ``<bundle>/autotune`` so the
    bundle restores a replica tuned-by-construction.  Returns the entry
    count (0 when there is nothing to carry)."""
    import os

    d = db()
    if not d.all_digests():
        return 0
    return d.export_entries(os.path.join(bundle_path, "autotune"))


def attach_bundle_overlay(bundle_path: str) -> bool:
    """Attach ``<bundle>/autotune`` as a read-only DB overlay (no-op
    when the bundle carries no tuning entries)."""
    import os

    sub = os.path.join(bundle_path, "autotune")
    if not os.path.isdir(sub):
        return False
    db().add_overlay(sub)
    global _fp_cache
    with _lock:
        _fp_cache = None
    _log_event("autotune_bundle_attached", path=sub)
    return True
