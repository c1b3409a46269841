"""NVRTC and libcuda (CUDA's ``cu*`` API) through ``ctypes``: compile CUDA
C at run time for Hopper and launch it on PyTorch's stream.
``rtc.MXRtc`` is the user-facing side; this module only compiles, loads
and launches.

- ``compile_cubin(source, name)``: NVRTC compiles ``source`` for
  ``sm_90a`` (``-std=c++17``, ``-I$CUDA_HOME/include``, where NVRTC finds
  ``cuda_bf16.h`` and ``cuda_fp16.h``) into a cubin; a failure raises
  ``MXNetError`` carrying NVRTC's log.
- ``function(source, name, device)``: the kernel loaded into the device's
  primary context (``cuModuleLoadData``), compiled and loaded once per
  (source, device) and cached.  Cubins are held by ``source_key`` (a hash
  of the name, the source and the options); with the compile cache on, a
  cubin not compiled in this process is first looked for there (no
  NVRTC), and a cubin NVRTC compiled is kept there.  ``COMPILES`` counts
  NVRTC compilations.
- ``LaunchPlan(func, device, n_args)``: ``cuLaunchKernel`` of one
  kernel on one device, many times, on a given stream.  It exists for a
  caller that pushes the same kernel over and over (an update loop pushes
  it once per parameter array, every step), so that a launch costs the
  host as little as it can: everything that does not change from one
  launch to the next is looked up or allocated once.

Two things libcuda asks of the caller, handled here:

- the device's primary context (the one PyTorch's runtime uses) must be
  current on the calling thread.  A kernel may be launched from a thread
  that never called libcuda, such as autograd's device thread
  running a backward, so every load makes it current
  (``cuDevicePrimaryCtxRetain`` once per device, ``cuCtxSetCurrent``), and
  every launch asks ``cuCtxGetCurrent`` and sets it only when another is
  current;
- ``cuLaunchKernel`` reads its arguments through ``kernelParams``, an
  array of pointers to the argument values, and copies the values before
  it returns.  A plan allocates that array and the values' block once and
  overwrites the values per launch, holding a lock from the fill to the
  return, so that two threads launching one plan never fill one block at
  once.

Nothing here runs at import: the libraries are loaded at the first
compile or launch, so a machine without CUDA imports the package.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import struct
import threading
from typing import Dict, List, Sequence, Tuple

from .base import MXNetError, env

__all__ = ["NVRTC_OPTIONS", "nvrtc_version", "nvrtc_search", "compile_cubin",
           "function", "LaunchPlan", "error_string", "source_key", "cubin",
           "register_cubin", "COMPILES"]

#: NVRTC options besides the include path: Hopper with its arch-specific
#: features (``wgmma``, ``setmaxnreg``), C++17
NVRTC_OPTIONS = ("--gpu-architecture=sm_90a", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: cubins by ``source_key``
_CUBINS: Dict[str, bytes] = {}
#: NVRTC compilations this process ran (``{"n": count}``)
COMPILES = {"n": 0}
_FUNCS: Dict[Tuple[str, str, int], Tuple[ctypes.c_void_p, ctypes.c_void_p]] = {}
_PRIMARY: Dict[int, ctypes.c_void_p] = {}


def nvrtc_search() -> Tuple[List[str], List[str]]:
    """(directories searched, library names tried in order) for libnvrtc:
    the versioned files under ``$CUDA_HOME/lib64`` first, then the names the
    dynamic loader resolves on its own path."""
    home = env("CUDA_HOME")
    dirs = [os.path.join(home, "lib64"),
            os.path.join(home, "targets", "x86_64-linux", "lib")]
    files = [f for d in dirs
             for f in sorted(glob.glob(os.path.join(d, "libnvrtc.so*")))]
    return dirs, files + ["libnvrtc.so", "libnvrtc.so.13", "libnvrtc.so.12",
                          "libnvrtc.so.11.2"]


def _load(what: str, names: Sequence[str], dirs: Sequence[str]) -> ctypes.CDLL:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise MXNetError("%s not found: looked in %s (CUDA_HOME/lib64) and on the "
                     "dynamic loader's path (LD_LIBRARY_PATH, ld.so.cache) "
                     "for %s" % (what, ", ".join(dirs) or "no directory",
                                 ", ".join(os.path.basename(n) for n in names)))


def _nvrtc() -> ctypes.CDLL:
    lib = _LIBS.get("nvrtc")
    if lib is None:
        dirs, names = nvrtc_search()
        lib = _load("libnvrtc (NVRTC, CUDA's run-time compiler)", names, dirs)
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        ptr = ctypes.POINTER
        for fn, args in (
                ("nvrtcVersion", [ptr(i), ptr(i)]),
                ("nvrtcCreateProgram", [ptr(p), ctypes.c_char_p,
                                        ctypes.c_char_p, i, p, p]),
                ("nvrtcCompileProgram", [p, i, ptr(ctypes.c_char_p)]),
                ("nvrtcGetProgramLogSize", [p, ptr(sz)]),
                ("nvrtcGetProgramLog", [p, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", [p, ptr(sz)]),
                ("nvrtcGetCUBIN", [p, ctypes.c_char_p]),
                ("nvrtcDestroyProgram", [ptr(p)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
        lib.nvrtcGetErrorString.argtypes = [i]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        _LIBS["nvrtc"] = lib
    return lib


def _libcuda() -> ctypes.CDLL:
    lib = _LIBS.get("cuda")
    if lib is None:
        lib = _load("libcuda", ["libcuda.so.1", "libcuda.so"], [])
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        ptr = ctypes.POINTER
        for fn, args in (
                ("cuInit", [u]),
                ("cuDeviceGet", [ptr(i), i]),
                ("cuDevicePrimaryCtxRetain", [ptr(p), i]),
                ("cuCtxSetCurrent", [p]),
                ("cuCtxGetCurrent", [ptr(p)]),
                ("cuModuleLoadData", [ptr(p), ctypes.c_char_p]),
                ("cuModuleGetFunction", [ptr(p), p, ctypes.c_char_p]),
                ("cuLaunchKernel", [p, u, u, u, u, u, u, u, p, ptr(p), ptr(p)]),
                ("cuGetErrorString", [i, ptr(ctypes.c_char_p)])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i
        _check_cu(lib, lib.cuInit(0), "cuInit")
        _LIBS["cuda"] = lib
    return lib


def _check_nvrtc(lib, res: int, what: str) -> None:
    if res != 0:
        raise MXNetError("%s failed: %s" % (
            what, lib.nvrtcGetErrorString(res).decode()))


def _error_string(lib, res: int) -> str:
    msg = ctypes.c_char_p()
    lib.cuGetErrorString(res, ctypes.byref(msg))
    return "%s (CUresult %d)" % ((msg.value or b"unknown error").decode(), res)


def error_string(res: int) -> str:
    """libcuda's description of CUresult ``res``."""
    return _error_string(_libcuda(), res)


def _check_cu(lib, res: int, what: str) -> None:
    if res != 0:
        raise MXNetError("%s failed: %s" % (what, _error_string(lib, res)))


def nvrtc_version() -> Tuple[int, int]:
    """(major, minor) of the NVRTC that compiles the kernels."""
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def nvrtc_options() -> List[str]:
    return list(NVRTC_OPTIONS) + ["-I" + os.path.join(env("CUDA_HOME"),
                                                       "include")]


def compile_cubin(source: str, name: str) -> bytes:
    """Compile ``source`` with NVRTC for sm_90a; the cubin, or
    ``MXNetError`` with NVRTC's log."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), (name + ".cu").encode(), 0,
        None, None), "nvrtcCreateProgram")
    try:
        opts = [o.encode() for o in nvrtc_options()]
        res = lib.nvrtcCompileProgram(prog, len(opts),
                                      (ctypes.c_char_p * len(opts))(*opts))
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(max(size.value, 1))
        lib.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise MXNetError("rtc kernel %r failed to compile (%s, options %s):"
                             "\n%s" % (name, lib.nvrtcGetErrorString(res)
                                       .decode(), " ".join(nvrtc_options()),
                                       log.value.decode(errors="replace")))
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def source_key(source: str, name: str) -> str:
    """The hash a cubin is held by: kernel name, source and NVRTC options
    (the include path left out: it names this machine's CUDA_HOME)."""
    blob = "\0".join([name, source] + list(NVRTC_OPTIONS)).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def cubin(key: str):
    """The cubin held for ``key`` in this process, or None."""
    return _CUBINS.get(key)


def register_cubin(key: str, data: bytes) -> None:
    """Hold ``data`` as the cubin of ``key`` (from a compile-cache entry):
    ``function`` then loads it without NVRTC."""
    with _LOCK:
        _CUBINS.setdefault(key, bytes(data))


def _primary(lib, device: int) -> ctypes.c_void_p:
    """``device``'s primary context, retained at the first request."""
    ctx = _PRIMARY.get(device)
    if ctx is None:
        dev = ctypes.c_int()
        _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), device),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _PRIMARY[device] = ctx
    return ctx


def function(source: str, name: str, device: int) -> ctypes.c_void_p:
    """Kernel ``name`` of ``source`` loaded on CUDA device ``device``:
    compiled at the first request for the source, loaded at the first for
    the device, cached after."""
    from . import compile_cache, kernels

    key = (source, name, device)
    ckey = source_key(source, name)
    kernels.note("cubins", ckey)
    with _LOCK:
        hit = _FUNCS.get(key)
        if hit is None:
            cubin = _CUBINS.get(ckey)
            if cubin is None and compile_cache.active():
                cubin = compile_cache.load_blob("cubin", ckey)
            if cubin is None:
                cubin = compile_cubin(source, name)
                COMPILES["n"] += 1
                compile_cache.store_cubin(ckey, cubin)
            _CUBINS[ckey] = cubin
            lib = _libcuda()
            _check_cu(lib, lib.cuCtxSetCurrent(_primary(lib, device)),
                      "cuCtxSetCurrent")
            module, func = ctypes.c_void_p(), ctypes.c_void_p()
            _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(module), cubin),
                      "cuModuleLoadData")
            _check_cu(lib, lib.cuModuleGetFunction(
                ctypes.byref(func), module, name.encode()),
                "cuModuleGetFunction")
            hit = _FUNCS[key] = (module, func)
    return hit[1]


class LaunchPlan:
    """Launches of ``func`` (loaded on CUDA device ``device``) with
    ``n_args`` pointer arguments.  Built once per kernel and device; a
    launch then makes no lookup and allocates nothing on the host.

    Thread safety: one lock per plan around the fill of the values and
    ``cuLaunchKernel``, which copies them before it returns; a thread that
    waits for the lock waits for one launch's enqueue."""

    def __init__(self, func: ctypes.c_void_p, device: int, n_args: int):
        self.func = func
        self.device = device
        self._lib = _libcuda()
        self._ctx = _primary(self._lib, device)
        self._current = ctypes.c_void_p()
        self._current_ptr = ctypes.pointer(self._current)
        # kernelParams[i] -> values[i]; the values are overwritten per
        # launch, in argument order, as native 64-bit words
        self._values = (ctypes.c_void_p * n_args)()
        base = ctypes.addressof(self._values)
        size = ctypes.sizeof(ctypes.c_void_p)
        self._params = (ctypes.c_void_p * n_args)(
            *[base + i * size for i in range(n_args)])
        self._fill = struct.Struct("@%dP" % n_args).pack_into
        self._lock = threading.Lock()

    def launch(self, pointers: Sequence[int], grid: Sequence[int],
               block: Sequence[int], stream: int) -> int:
        """Launch with one device pointer per argument on ``stream`` (a
        ``cudaStream_t`` as an int); the CUresult."""
        lib = self._lib
        with self._lock:
            res = lib.cuCtxGetCurrent(self._current_ptr)
            if res != 0:
                return res
            if self._current.value != self._ctx.value:
                res = lib.cuCtxSetCurrent(self._ctx)
                if res != 0:
                    return res
            self._fill(self._values, 0, *pointers)
            return lib.cuLaunchKernel(self.func, grid[0], grid[1], grid[2],
                                      block[0], block[1], block[2], 0,
                                      stream, self._params, None)
