"""Shared atomic entry-store helpers for content-addressed artifact
caches; counterpart of ``mxnet_tpu/artifact_store.py``, with the same
grammar and the same digests, so each package reads the other's headers.

One on-disk grammar for every persistent artifact family the framework
keeps beside a job (compiled-plan entries, libraries and cubins in
``compile_cache``, tuning winners in ``autotune``):

    MAGIC | u64 meta_len | meta json | payload bytes

written atomically (tmp+fsync+rename, the checkpoint discipline) with a
CRC32 sidecar, read back with CRC + header verification, and
listed/verified/pruned by one admin implementation.  Each family
parameterizes an :class:`EntryStore` with its own magic, filename
suffix, and fault-injection op prefix — the families share THIS code
instead of copy-pasting the format.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, List, Optional, Tuple

from .base import MXNetError

__all__ = ["EntryStore", "digest_of"]


def digest_of(parts: dict) -> str:
    """Canonical content fingerprint: sha256 over the sorted-key JSON of
    ``parts``, truncated to 32 hex chars (the entry filename stem)."""
    blob = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


class EntryStore:
    """Format + admin surface for one artifact family.

    Parameters
    ----------
    magic : bytes
        File magic; a mismatch is a loud "not a <label> entry" error.
    suffix : str
        Entry filename suffix (e.g. ``".mxc"``).
    label : str
        Human name used in error messages.
    op_prefix : str
        Dotted-op prefix for the ``faults`` layer: stores fire
        ``<op_prefix>.store`` through ``filesystem.atomic_write``.
    """

    def __init__(self, magic: bytes, suffix: str, label: str,
                 op_prefix: str):
        self.magic = magic
        self.suffix = suffix
        self.label = label
        self.op_prefix = op_prefix

    # -- paths / headers --------------------------------------------------
    def entry_path(self, d: str, digest: str) -> str:
        return os.path.join(d, digest + self.suffix)

    def entry_meta(self, path: str) -> dict:
        """Parse just the json header of an entry (payload untouched)."""
        with open(path, "rb") as f:
            magic = f.read(len(self.magic))
            if magic != self.magic:
                raise MXNetError("%s is not a %s entry"
                                 % (path, self.label))
            mlen = int.from_bytes(f.read(8), "little")
            if mlen <= 0 or mlen > (1 << 24):
                raise MXNetError("%s has an implausible meta header" % path)
            return json.loads(f.read(mlen).decode())

    # -- write / read -----------------------------------------------------
    def write_entry(self, d: str, digest: str, meta: dict,
                    payload_bytes: bytes, op: Optional[str] = None) -> str:
        from .filesystem import atomic_write

        os.makedirs(d, exist_ok=True)
        meta_blob = json.dumps(meta, sort_keys=True, default=str).encode()
        path = self.entry_path(d, digest)

        def writer(f):
            f.write(self.magic)
            f.write(len(meta_blob).to_bytes(8, "little"))
            f.write(meta_blob)
            f.write(payload_bytes)

        # atomic_write fires the fault layer under the family's dotted op
        # and lands the CRC sidecar after the data — identical discipline
        # to checkpoints
        atomic_write(path, writer, checksum=True,
                     op=op or (self.op_prefix + ".store"))
        return path

    def read_payload(self, path: str) -> Tuple[dict, bytes]:
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:len(self.magic)] != self.magic:
            raise MXNetError("%s is not a %s entry" % (path, self.label))
        off = len(self.magic)
        mlen = int.from_bytes(blob[off:off + 8], "little")
        off += 8
        if mlen <= 0 or off + mlen > len(blob):
            raise MXNetError("%s has a torn meta header" % path)
        meta = json.loads(blob[off:off + mlen].decode())
        return meta, blob[off + mlen:]

    # -- admin: ls / verify / prune --------------------------------------
    def ls_entries(self, d: str,
                   meta_fields: Optional[Callable[[dict], dict]] = None
                   ) -> List[dict]:
        """[{digest, path, bytes, mtime, **meta_fields(meta)}] for every
        entry in ``d`` (unreadable headers report kind='corrupt')."""
        out = []
        if not os.path.isdir(d):
            return out
        for name in sorted(os.listdir(d)):
            if not name.endswith(self.suffix):
                continue
            path = os.path.join(d, name)
            st = os.stat(path)
            rec = {"digest": name[:-len(self.suffix)], "path": path,
                   "bytes": st.st_size, "mtime": st.st_mtime}
            try:
                meta = self.entry_meta(path)
                rec.update(meta_fields(meta) if meta_fields else meta)
            except Exception as exc:
                rec.update(kind="corrupt", error=repr(exc)[:120])
            out.append(rec)
        return out

    def verify_entry(self, path: str,
                     payload_check: Optional[Callable] = None,
                     env_ok: Optional[Callable[[dict], bool]] = None
                     ) -> Tuple[bool, str]:
        """(ok, detail): CRC sidecar + header + payload check —
        everything short of actually using the entry.  ``payload_check``
        (meta, payload) may raise to flag an unreadable payload;
        ``env_ok(meta)`` False downgrades the detail (still ok: a
        stale-env entry invalidates at load, it is not corrupt)."""
        from .filesystem import verify_crc_sidecar

        crc = verify_crc_sidecar(path)
        if crc is False:
            return False, "crc mismatch"
        try:
            meta, payload = self.read_payload(path)
            if payload_check is not None:
                payload_check(meta, payload)
        except Exception as exc:
            return False, "unreadable: %r" % (exc,)
        if env_ok is not None and not env_ok(meta):
            return True, "ok (stale env: invalidates on load)"
        return True, "ok"

    def prune(self, d: str, budget_mb: int) -> List[str]:
        """Delete oldest-mtime entries (and their sidecars) until the
        directory is under ``budget_mb``.  Returns the removed paths."""
        entries = self.ls_entries(d)
        total = sum(e["bytes"] for e in entries)
        budget = budget_mb * (1 << 20)
        removed = []
        for e in sorted(entries, key=lambda e: e["mtime"]):
            if total <= budget:
                break
            for p in (e["path"], e["path"] + ".crc32"):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            removed.append(e["path"])
            total -= e["bytes"]
        return removed
