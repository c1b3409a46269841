"""Build, load and count the hand-written CUDA kernels.

Each source in ``csrc/`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/``, named by a
hash of the source and of the headers beside it (``*.cuh``), at first use.
The library is loaded with ``ctypes``; pointers and the stream are passed
as integers.  Nothing here runs at import: a machine without ``nvcc`` or a
card imports the package, and only a launch on a CUDA tensor needs the
build.

``LAUNCHES`` counts, per kernel, the launches its wrapper made.  A wrapper
adds one per kernel launched (K3 at head-dim width 256 is two, as
its C entry reports) right after a call that returned no error, and
nowhere else, so a caller can show which kernels a run went through.  Kernels compiled at run
time by ``rtc.MXRtc`` count under ``rtc:<name>``, added at their first
launch.

``recording()`` collects, on the calling thread, the launches counted,
the libraries loaded and the NVRTC cubins used while it is open (what a
compile-cache entry names, and what a CUDA graph capture takes back off
``LAUNCHES`` with ``uncount``).  With the compile cache on, a library
missing from ``_build/`` is first looked for there (its bytes checked
against their sha256, no nvcc), and a library nvcc built is kept there.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

from .base import MXNetError, env

__all__ = ["SOURCES", "LAUNCHES", "build_all", "library", "count",
           "reset_launches", "recording", "uncount"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

#: kernel name -> source file under csrc/ (one library per source file);
#: ``flash_fwd_splitp`` is K1's split-P variant, behind the splash op
SOURCES = {"flash_fwd": "flash_fwd.cu",
           "flash_fwd_splitp": "flash_fwd.cu",
           "flash_bwd_dq": "flash_bwd.cu",
           "flash_bwd_dkv": "flash_bwd.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
#: the compiler's report (registers, shared memory, spills) per built source
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: wrappers launch from several threads (``parallel``'s shards)
_COUNT_LOCK = threading.Lock()


#: the open ``recording()`` records of each thread
_RECORDING = threading.local()


def _records():
    return getattr(_RECORDING, "stack", ())


def count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n
    for rec in _records():
        rec["launches"][name] = rec["launches"].get(name, 0) + n


def uncount(launches: Dict[str, int]) -> None:
    """Take counts back off ``LAUNCHES`` (launches recorded into a CUDA
    graph during its capture: nothing ran)."""
    with _COUNT_LOCK:
        for name, n in launches.items():
            LAUNCHES[name] = LAUNCHES.get(name, 0) - n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def note(what: str, key: str) -> None:
    """Record that ``key`` (a source under ``csrc/`` for "libs", a cubin
    key for "cubins") was used, in every open ``recording()``."""
    for rec in _records():
        rec[what].add(key)


@contextlib.contextmanager
def recording():
    """``{"launches": {name: n}, "libs": {source}, "cubins": {key}}``
    of what this thread launched and loaded while the block ran."""
    rec = {"launches": {}, "libs": set(), "cubins": set()}
    stack = list(_records())
    _RECORDING.stack = stack + [rec]
    try:
        yield rec
    finally:
        _RECORDING.stack = stack


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(env("CUDA_HOME"), "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found on PATH or under CUDA_HOME (%s); "
                         "the CUDA kernels cannot be built" % path)
    return path


def _lib_path(source: str) -> str:
    """The library built from ``source``, named by a hash of the source,
    every header under ``csrc/`` (a source may include any of them) and
    the flags, so that an edit to any of them builds anew."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(_BUILD, "lib%s-%s.so" % (stem, digest.hexdigest()[:16]))


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile the sources of every named kernel (default: all) whose
    library is missing, one ``nvcc`` per source, all started together.
    Returns the seconds it took; raises with the compiler's output if any
    build fails."""
    names = list(SOURCES if names is None else names)
    sources = sorted({SOURCES[n] for n in names})
    todo = [s for s in sources if not os.path.exists(_lib_path(s))]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, os.path.join(_CSRC, n)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append("%s (exit %d):\n%s" % (n, proc.returncode, log))
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise MXNetError("CUDA kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library holding kernel ``name``, built first if needed."""
    source = SOURCES[name]
    lib = _LIBS.get(source)
    if lib is None:
        from . import compile_cache

        path = _lib_path(source)
        if compile_cache.active() and not os.path.exists(path):
            compile_cache.restore_library(path)
        if build_all([name]) and compile_cache.enabled():
            compile_cache.store_library(path)
        lib = ctypes.CDLL(path)
        _LIBS[source] = lib
    if _records():
        note("libs", source)
    return lib
