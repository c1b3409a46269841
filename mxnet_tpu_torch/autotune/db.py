"""TuningDB — the persistent winner store.

Each entry is one tuned site: ``(site, key, device kind, topology) →
best config``, written in the shared :mod:`mxnet_tpu_torch.artifact_store`
grammar (same atomic CRC-checked file format, env-envelope
invalidation, and admin surface as the compile cache — one store
implementation, two artifact families); counterpart of
``mxnet_tpu/autotune/db.py``.  The payload is plain JSON (config +
provenance), so a DB is inspectable with ``strings``; the env envelope
(``compile_cache.env_fingerprint``, torch terms) invalidates an entry of
another framework or version.

Lookup order: in-process memo, the primary DB dir
(``MXNET_AUTOTUNE_DIR``), then read-only overlays (attached AOT
bundles).  Every failure mode — missing file, CRC mismatch, torn
header, injected ``autotune.load`` fault — degrades to a miss (the
caller falls back to the built-in default config), never a crash.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from ..artifact_store import EntryStore, digest_of
from ..base import MXNetError, env

_MAGIC = b"MXTPUAT1"
_SCHEMA = 1
ENTRY_SUFFIX = ".mxt"

_STORE = EntryStore(_MAGIC, ENTRY_SUFFIX, "autotune", "autotune")


def _strict() -> bool:
    return bool(env("MXNET_AUTOTUNE_STRICT", 0, int))


def topology_fingerprint() -> dict:
    """The key half of the envelope: the axes along which a different
    machine needs a different winner (the platform, the card's name and
    count, the process count, in torch terms) — a subset of
    :func:`compile_cache.env_fingerprint`, which is ALSO recorded whole in
    every entry as the invalidation envelope."""
    from ..compile_cache import env_fingerprint

    fp = env_fingerprint()
    return {k: fp[k] for k in ("platform", "device_kind", "device_count",
                               "process_count")}


class TuningDB:
    """Winner store over one writable dir plus read-only overlays."""

    def __init__(self, d: str = "", overlays: Optional[List[str]] = None):
        self._dir = d or ""
        self._overlays: List[str] = list(overlays or [])
        self._mem = {}  # digest -> {"config", "meta"}
        # bumped on every put/overlay change; cache_fingerprint() memoizes
        # against it so the compile-cache key only re-hashes on change
        self.generation = 0

    # -- keying -----------------------------------------------------------
    @staticmethod
    def digest(site: str, key: dict) -> str:
        parts = {"schema": _SCHEMA, "site": site, "key": key,
                 "topology": topology_fingerprint()}
        return digest_of(parts)

    def read_dirs(self) -> List[str]:
        out = [self._dir] if self._dir else []
        out.extend(self._overlays)
        return out

    def add_overlay(self, d: str) -> None:
        if d not in self._overlays:
            self._overlays.append(d)
            self.generation += 1

    # -- load / store -----------------------------------------------------
    def get(self, site: str, key: dict) -> Optional[dict]:
        """-> {"config", "meta"} or None (a miss — caller uses the
        built-in default).  Counts hits/misses; corruption degrades."""
        from . import _metrics

        digest = self.digest(site, key)
        ent = self._mem.get(digest)
        if ent is None:
            ent = self._load(digest)
        if ent is None:
            _metrics()["misses"].inc()
            return None
        _metrics()["hits"].inc()
        return ent

    def _load(self, digest: str) -> Optional[dict]:
        from . import _log_event, _metrics
        from .. import faults
        from ..compile_cache import env_fingerprint
        from ..filesystem import verify_crc_sidecar

        for d in self.read_dirs():
            path = _STORE.entry_path(d, digest)
            if not os.path.exists(path):
                continue
            try:
                faults.fire("autotune.load")
                if verify_crc_sidecar(path) is False:
                    raise MXNetError("CRC mismatch")
                meta, payload = _STORE.read_payload(path)
                if meta.get("env") != env_fingerprint():
                    _log_event("autotune_invalidate", path=path,
                               entry_env=meta.get("env"),
                               current_env=env_fingerprint())
                    continue  # stale-version entry: a miss, not an error
                body = json.loads(payload.decode())
                ent = {"config": body["config"], "meta": meta}
                self._mem[digest] = ent
                return ent
            except Exception as exc:
                _metrics()["errors"].inc()
                _log_event("autotune_corrupt", path=path,
                           error=repr(exc)[:300])
                if _strict():
                    raise
                continue
        return None

    def put(self, site: str, key: dict, config: dict,
            provenance: Optional[dict] = None) -> str:
        from . import _log_event, _metrics
        from ..compile_cache import env_fingerprint

        digest = self.digest(site, key)
        provenance = provenance or {}
        meta = {
            "digest": digest,
            "site": site,
            "key": key,
            "env": env_fingerprint(),
            "created": round(time.time(), 3),
            "objective": provenance.get("objective"),
            "score": provenance.get("score"),
            "measured_ms": provenance.get("measured_ms"),
            "tuning_ms": provenance.get("tuning_ms"),
        }
        self._mem[digest] = {"config": config, "meta": meta}
        self.generation += 1
        if self._dir:
            payload = json.dumps({"config": config,
                                  "provenance": provenance},
                                 sort_keys=True, default=str).encode()
            try:
                path = _STORE.write_entry(self._dir, digest, meta, payload)
                _metrics()["stores"].inc()
                _log_event("autotune_store", digest=digest, site=site,
                           path=path, config=config)
            except Exception as exc:
                _metrics()["errors"].inc()
                _log_event("autotune_store_failed", digest=digest,
                           site=site, error=repr(exc)[:300])
                if _strict():
                    raise
        return digest

    def all_digests(self) -> List[str]:
        """Every winner visible to this DB (memo + dirs + overlays) —
        the compile-cache key material: a different winner set is a
        different set of programs."""
        seen = set(self._mem)
        for d in self.read_dirs():
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if name.endswith(ENTRY_SUFFIX):
                    seen.add(name[:-len(ENTRY_SUFFIX)])
        return sorted(seen)

    def export_entries(self, dest: str) -> int:
        """Copy every visible winner into ``dest`` (AOT bundle carry).
        In-memory-only winners are materialized as fresh entries."""
        n = 0
        os.makedirs(dest, exist_ok=True)
        exported = set()
        for d in self.read_dirs():
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if not name.endswith(ENTRY_SUFFIX) or name in exported:
                    continue
                src = os.path.join(d, name)
                try:
                    meta, payload = _STORE.read_payload(src)
                    _STORE.write_entry(dest, name[:-len(ENTRY_SUFFIX)],
                                       meta, payload)
                    exported.add(name)
                    n += 1
                except Exception:
                    continue
        for digest, ent in sorted(self._mem.items()):
            if digest + ENTRY_SUFFIX in exported:
                continue
            body = {"config": ent["config"], "provenance": {}}
            try:
                _STORE.write_entry(dest, digest, ent["meta"],
                                   json.dumps(body, sort_keys=True,
                                              default=str).encode())
                n += 1
            except Exception:
                continue
        return n


# -- admin surface (python -m mxnet_tpu_torch.tools.autotune_admin) ------

def _env_compatible(meta: dict) -> bool:
    from ..compile_cache import env_fingerprint

    return meta.get("env") == env_fingerprint()


def ls_entries(d: str) -> List[dict]:
    """[{digest, path, bytes, mtime, site, objective, score, env_ok}]."""
    return _STORE.ls_entries(
        d, meta_fields=lambda meta: {"site": meta.get("site"),
                                     "objective": meta.get("objective"),
                                     "score": meta.get("score"),
                                     "env_ok": _env_compatible(meta)})


def verify_entry(path: str):
    """(ok, detail): CRC sidecar + header + payload-JSON check."""
    def _check(meta, payload):
        body = json.loads(payload.decode())
        if "config" not in body:
            raise MXNetError("entry has no config")

    return _STORE.verify_entry(path, payload_check=_check,
                               env_ok=_env_compatible)


def prune(d: str, budget_mb: int) -> List[str]:
    from . import _log_event

    removed = _STORE.prune(d, budget_mb)
    if removed:
        _log_event("autotune_pruned", dir=d, removed=len(removed))
    return removed


def show_winner(path: str) -> dict:
    """Full entry (meta + config + provenance) for one entry file."""
    meta, payload = _STORE.read_payload(path)
    body = json.loads(payload.decode())
    return {"meta": meta, "config": body.get("config"),
            "provenance": body.get("provenance")}
