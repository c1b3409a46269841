"""URI-scheme filesystem registry for the data-IO layer — counterpart of
``mxnet_tpu/filesystem.py``, with the same functions and messages.

Plain paths and ``file://`` read the local filesystem; ``hdfs://`` and
``s3://`` (the reference's build-time ``USE_HDFS``/``USE_S3``,
``make/config.mk:136-144``) are gated: they raise with instructions until
the user registers an opener backed by whatever client their environment
provides (fsspec, boto3, pyarrow.fs, a FUSE mount, ...).

    import mxnet_tpu_torch as mt
    mt.filesystem.register_scheme("s3", my_s3_opener)
    it = mt.io.ImageRecordIter(path_imgrec="s3://bucket/train.rec", ...)

An opener is ``fn(uri, mode) -> file-like`` (binary modes get bytes;
``mode`` is the ``open()``-style string).  ``MXRecordIO``,
``MXIndexedRecordIO`` and the record iterators open through ``open_uri``.

``atomic_write`` and the CRC32 sidecars are the crash-consistency pieces
that checkpoint writers sit on.  ``atomic_write`` fires the
fault-injection layer (``faults``) at the site named by ``op``, as the JAX
package's does.
"""
from __future__ import annotations

import os
import zlib
from typing import Callable, Dict, Optional

_SCHEMES: Dict[str, Callable] = {}

# schemes the reference ships build-gated support for; named in the
# error message so migrating users know the knob moved from compile
# time to run time
_KNOWN_REMOTE = ("hdfs", "s3")


def scheme_of(uri: str) -> str:
    """The URI's scheme, '' for plain local paths. A Windows drive
    letter ('C:/...') is not a scheme."""
    head, sep, _ = uri.partition("://")
    if not sep or len(head) <= 1:
        return ""
    return head.lower()


def local_path(uri: str):
    """The local filesystem path for ''/file:// URIs, else None. The ONE
    place local-vs-remote resolution lives — callers that need an
    existence check use this rather than re-deriving the rule."""
    scheme = scheme_of(uri)
    if scheme == "":
        return uri
    if scheme == "file":
        return uri[7:]
    return None


def register_scheme(scheme: str, opener: Callable) -> None:
    """Register ``opener(uri, mode) -> file-like`` for ``scheme``.
    Re-registering replaces (last wins); ``None`` unregisters."""
    scheme = scheme.lower().rstrip(":")
    if scheme in ("", "file") or len(scheme) == 1:
        # '' / 'file' are built-in local; single letters are treated as
        # Windows drive prefixes by scheme_of — an opener registered
        # under any of these would never be dispatched
        raise ValueError(
            "scheme %r cannot be registered: ''/file are built-in local "
            "and single-letter schemes collide with drive letters"
            % scheme)
    if opener is None:
        _SCHEMES.pop(scheme, None)
    else:
        _SCHEMES[scheme] = opener


def open_uri(uri: str, mode: str = "rb"):
    """Open ``uri`` through the scheme registry (local files built in)."""
    lp = local_path(uri)
    if lp is not None:
        return open(lp, mode)
    scheme = scheme_of(uri)
    opener = _SCHEMES.get(scheme)
    if opener is None:
        hint = (" (the reference gates %s:// behind USE_%s at build "
                "time, make/config.mk:136-144; here it is a runtime "
                "hook)" % (scheme, scheme.upper())
                if scheme in _KNOWN_REMOTE else "")
        raise IOError(
            "no filesystem registered for scheme %r (uri %r). Register "
            "one backed by your environment's client, e.g.\n"
            "    mx.filesystem.register_scheme(%r, "
            "lambda uri, mode: fsspec.open(uri, mode).open())%s"
            % (scheme, uri, scheme, hint))
    return opener(uri, mode)


# ---------------------------------------------------------------------------
# Durable local writes — the crash-consistency primitives the checkpoint
# and kvstore-snapshot writers sit on (docs/how_to/fault_tolerance.md).
# The reference writes .params with a bare fopen/fwrite
# (ndarray.cc:633-714): a crash mid-save leaves a torn file that LOOKS
# like the newest checkpoint.  Here every durable artifact goes through
# tmp + fsync + os.replace (readers only ever see old-complete or
# new-complete bytes) and carries a CRC32 sidecar so silent corruption
# (torn writes from OTHER writers, bit rot, partial copies) is detected
# at discovery time instead of mid-restore.
# ---------------------------------------------------------------------------

_CRC_SUFFIX = ".crc32"
_CRC_CHUNK = 1 << 20


def file_crc32(path: str) -> int:
    """Streaming CRC32 of a file's bytes (constant memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def crc_sidecar_path(path: str) -> str:
    return path + _CRC_SUFFIX


def write_crc_sidecar(path: str) -> str:
    """Record ``crc32 size`` of ``path`` in an (atomically written)
    sidecar; returns the sidecar path."""
    line = "%08x %d\n" % (file_crc32(path), os.path.getsize(path))
    side = crc_sidecar_path(path)
    atomic_write(side, lambda f: f.write(line.encode("ascii")),
                 checksum=False, op="crc.sidecar")
    return side


def verify_crc_sidecar(path: str) -> Optional[bool]:
    """True/False when a sidecar exists and the file matches/mismatches;
    None when there is no sidecar to judge by (pre-sidecar artifact)."""
    side = crc_sidecar_path(path)
    if not os.path.exists(side):
        return None
    try:
        with open(side, "r") as f:
            crc_s, size_s = f.read().split()
        if not os.path.exists(path):
            return False
        if os.path.getsize(path) != int(size_s):
            return False
        return file_crc32(path) == int(crc_s, 16)
    except (OSError, ValueError):
        return False


def atomic_write(path: str, writer: Callable, checksum: bool = False,
                 op: str = "file.write") -> str:
    """Crash-safe replace of ``path``: ``writer(f)`` fills a same-dir temp
    file, which is fsync'd and ``os.replace``'d over the target — readers
    never observe a partial file.  With ``checksum`` a CRC32 sidecar is
    written after the data lands.  ``op`` names this site to the fault
    layer, as in the JAX package: an active plan's ``partial`` rule tears
    the TEMP file and raises (power loss mid-write); the target is
    untouched."""
    from . import faults

    faults.fire(op)
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            writer(f)
            frac = faults.partial_fraction(op)
            if frac is not None:
                # torn write: keep a prefix, make it durable, then die the
                # way a crashed writer would (before the replace)
                f.flush()
                f.truncate(max(0, int(f.tell() * frac)))
                f.flush()
                os.fsync(f.fileno())
                raise faults.InjectedIOError(
                    "injected torn write at %s (%s)" % (op, path))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # fsync the directory so the rename itself survives power loss
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # platform without dir fsync: best effort
    except faults.InjectedIOError:
        raise  # leave the torn temp behind, as a real crash would
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if checksum:
        write_crc_sidecar(path)
    return path
