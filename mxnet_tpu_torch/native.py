"""ctypes loader of the native IO library and the JPEG codecs —
counterpart of ``mxnet_tpu/native.py``.

The reference's IO hot path is C++ (src/io/, dmlc-core RecordIO +
ThreadedIter).  The port builds the repository's unchanged sources with
``g++ -O2 -std=c++17 -fPIC -Wall -pthread -shared`` at first use, into
``_build/`` beside this file, each library named by a hash of its sources
and flags (built to a temporary path, then renamed), and never loads the
JAX package's ``libmxtpu.so``:

* the reader, ``src/recordio.cc``: ``NativeRecordReader``,
  ``NativeRecordWriter``, ``NativePrefetchReader`` (``rio_abi_version() ==
  2``);
* the JPEG decoder, in this order of preference:
  ``libjpeg``, ``src/imgdecode.cc`` built with ``-ljpeg`` (the JAX
  package's decoder), where libjpeg's headers are installed; else
  ``nvjpeg``, ``csrc/nvjpeg_codec.cu`` built by ``nvcc`` with ``-lnvjpeg``
  where a card and the CUDA toolkit are: the same C ABI
  (``mxtpu_decode_jpeg_batch_alloc``/``mxtpu_free_many``, RGB HWC uint8 on
  the host) and an encoder (``encode_jpeg``).

The two sources are two libraries because a machine may have the reader's
compiler but not libjpeg's headers.  As in the JAX package, where a
library cannot be built or ``MXNET_USE_NATIVE=0``, callers fall back to the
pure-Python reader and to PIL; ``native_status()`` says which libraries
loaded and, for one that did not, the build's own error text.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from .base import env

__all__ = ["get_lib", "have_native", "native_status", "decoder_route",
           "capi_lib_path",
           "nvjpeg_lib", "NativeRecordReader", "NativeRecordWriter",
           "NativePrefetchReader", "decode_jpeg_batch", "encode_jpeg"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_PKG_DIR, "_build")
_SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "src")
_CSRC = os.path.join(_PKG_DIR, "csrc")

GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_LOCK = threading.Lock()
_LIBS = {}    # library name -> ctypes.CDLL, or None when it is unavailable
_ERRORS = {}  # library name -> why it is unavailable


def _lib_path(stem, sources, flags, deps=()):
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in list(sources) + list(deps):
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(_BUILD, "lib%s-%s.so" % (stem, digest.hexdigest()[:16]))


def _compile(stem, cmd_head, sources, libs, deps=()):
    """Build ``sources`` into ``_build/lib<stem>-<hash>.so`` unless it is
    there (the hash also covers the headers ``deps``); the path, or raise
    OSError with the compiler's output."""
    missing = [s for s in list(sources) + list(deps)
               if not os.path.exists(s)]
    if missing:
        raise OSError("source missing: %s" % ", ".join(missing))
    out = _lib_path(stem, sources, cmd_head + libs, deps)
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = "%s.build.%d.%d" % (out, os.getpid(), threading.get_ident())
    try:
        proc = subprocess.run(cmd_head + ["-o", tmp] + sources + libs,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise OSError("%s (exit %d):\n%s" % (" ".join(cmd_head),
                                                 proc.returncode,
                                                 proc.stdout.strip()))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind_reader(lib):
    i64, u8p, vp, cp = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                        ctypes.c_void_p, ctypes.c_char_p)
    u8pp = ctypes.POINTER(u8p)
    lib.rio_reader_open.restype = vp
    lib.rio_reader_open.argtypes = [cp]
    lib.rio_read.restype = i64
    lib.rio_read.argtypes = [vp, u8pp, ctypes.POINTER(i64)]
    lib.rio_read_at.restype = i64
    lib.rio_read_at.argtypes = [vp, i64, u8pp]
    lib.rio_reader_reset.argtypes = [vp]
    lib.rio_reader_close.argtypes = [vp]
    lib.rio_writer_open.restype = vp
    lib.rio_writer_open.argtypes = [cp]
    lib.rio_write.restype = i64
    lib.rio_write.argtypes = [vp, u8p, i64]
    lib.rio_writer_close.argtypes = [vp]
    lib.rio_prefetch_open.restype = vp
    lib.rio_prefetch_open.argtypes = [cp, ctypes.c_int]
    lib.rio_prefetch_next.restype = i64
    lib.rio_prefetch_next.argtypes = [vp, u8pp]
    lib.rio_prefetch_close.argtypes = [vp]
    lib.rio_free.argtypes = [u8p]
    lib.rio_abi_version.restype = i64
    if lib.rio_abi_version() != 2:
        raise OSError("rio_abi_version() is %d, not 2"
                      % lib.rio_abi_version())
    return lib


def _bind_decoder(lib):
    ci, szp = ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u8pp, cip = ctypes.POINTER(u8p), ctypes.POINTER(ci)
    lib.mxtpu_decode_jpeg_batch_alloc.restype = ci
    lib.mxtpu_decode_jpeg_batch_alloc.argtypes = [u8pp, szp, ci, u8pp, cip,
                                                  cip, ci]
    lib.mxtpu_free_many.argtypes = [u8pp, ci]
    return lib


def _bind_nvjpeg(lib):
    _bind_decoder(lib)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ci = ctypes.c_int
    lib.mxtt_nvjpeg_encode.restype = ci
    lib.mxtt_nvjpeg_encode.argtypes = [u8p, ci, ci, ci, ctypes.POINTER(u8p),
                                       ctypes.POINTER(ctypes.c_size_t)]
    lib.mxtt_nvjpeg_error.restype = ctypes.c_char_p
    lib.mxtt_nvjpeg_error.argtypes = []
    return lib


def _build_reader():
    return _bind_reader(ctypes.CDLL(_compile(
        "rio", ["g++"] + GXX_FLAGS, [os.path.join(_SRC_DIR, "recordio.cc")],
        [])))


def _build_libjpeg():
    return _bind_decoder(ctypes.CDLL(_compile(
        "imgdecode", ["g++"] + GXX_FLAGS,
        [os.path.join(_SRC_DIR, "imgdecode.cc")], ["-ljpeg"])))


def _build_nvjpeg():
    import torch

    from .kernels import _nvcc

    if not torch.cuda.is_available():
        raise OSError("no CUDA device")
    lib_dir = os.path.join(env("CUDA_HOME"), "lib64")
    head = [_nvcc(), "-O2", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
            "-Xlinker", "-rpath=" + lib_dir]
    return _bind_nvjpeg(ctypes.CDLL(_compile(
        "nvjpeg_codec", head, [os.path.join(_CSRC, "nvjpeg_codec.cu")],
        ["-lnvjpeg"])))


def capi_lib_path() -> str:
    """The port's C ABI library, ``_build/libmxtpu_torch_capi-<hash>.so``,
    built at first use with g++ from ``src/c_api.cc`` and
    ``src/c_predict_api.cc`` as they are and ``csrc/capi_common.cc`` (the
    port's copy of ``src/capi_common.cc``, which drives
    ``mxnet_tpu_torch.capi_shim``), against this interpreter's headers and
    libpython; ``-Bsymbolic`` keeps its calls inside itself beside the
    JAX package's library in one process.  Raises OSError with the
    compiler's output where it does not build (no fallback)."""
    import sysconfig

    inc = os.path.join(os.path.dirname(_SRC_DIR), "include")
    libdir = sysconfig.get_config_var("LIBDIR")
    head = ["g++"] + GXX_FLAGS + [
        "-I", _SRC_DIR, "-I", inc, "-I", sysconfig.get_paths()["include"],
        "-Wl,-Bsymbolic", "-L", libdir, "-Wl,-rpath," + libdir]
    deps = [os.path.join(_SRC_DIR, "capi_common.h"),
            os.path.join(inc, "mxtpu", "c_api.h"),
            os.path.join(inc, "mxtpu", "c_predict_api.h")]
    with _LOCK:
        return _compile(
            "mxtpu_torch_capi", head,
            [os.path.join(_SRC_DIR, "c_predict_api.cc"),
             os.path.join(_SRC_DIR, "c_api.cc"),
             os.path.join(_CSRC, "capi_common.cc")],
            ["-lpython" + sysconfig.get_config_var("LDVERSION")], deps)


_BUILDERS = {"reader": _build_reader, "libjpeg": _build_libjpeg,
             "nvjpeg": _build_nvjpeg}


def _library(name):
    """Library ``name`` (built and loaded once per process), or None."""
    if name in _LIBS:
        return _LIBS[name]
    with _LOCK:
        if name not in _LIBS:
            if not env("MXNET_USE_NATIVE", True, bool):
                _ERRORS[name] = "disabled by MXNET_USE_NATIVE=0"
                _LIBS[name] = None
            else:
                try:
                    _LIBS[name] = _BUILDERS[name]()
                except (OSError, AttributeError) as exc:
                    _ERRORS[name] = str(exc)
                    _LIBS[name] = None
        return _LIBS[name]


def get_lib():
    """The loaded reader library, or None (pure-Python fallback)."""
    return _library("reader")


def have_native() -> bool:
    return get_lib() is not None


def nvjpeg_lib():
    """The nvJPEG codec library, or None (no card, toolkit or nvJPEG)."""
    return _library("nvjpeg")


def decoder_route():
    """``"libjpeg"`` or ``"nvjpeg"``: the codec ``decode_jpeg_batch`` uses;
    None when neither loads (the iterators then decode with PIL)."""
    if _library("libjpeg") is not None:
        return "libjpeg"
    if nvjpeg_lib() is not None:
        return "nvjpeg"
    return None


def native_status() -> dict:
    """Per library, ``"loaded"`` or the reason it is not (the build's own
    error text), and the decoder route."""
    route = decoder_route()
    status = {"reader": "loaded" if get_lib() is not None
              else _ERRORS.get("reader"),
              "libjpeg": "loaded" if _library("libjpeg") is not None
              else _ERRORS.get("libjpeg")}
    if route != "libjpeg":
        status["nvjpeg"] = "loaded" if route == "nvjpeg" \
            else _ERRORS.get("nvjpeg")
    status["decoder"] = route
    return status


def _take(lib, ptr, length) -> bytes:
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.rio_free(ptr)


class _Handle:
    """A native handle closed by ``close`` or when garbage-collected."""

    _close_fn = None

    def __init__(self, opener, path, *args):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable: %s"
                               % _ERRORS.get("reader"))
        self._lib = lib
        self._h = getattr(lib, opener)(path.encode(), *args)
        if not self._h:
            raise IOError("cannot open %s" % path)

    def close(self):
        if self._h:
            getattr(self._lib, self._close_fn)(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: globals may be gone
            pass


class NativeRecordReader(_Handle):
    """Sequential/offset reader (same framing as recordio.MXRecordIO)."""

    _close_fn = "rio_reader_close"

    def __init__(self, path):
        super().__init__("rio_reader_open", path)

    def _result(self, n, buf):
        if n < 0:
            raise IOError("corrupt RecordIO stream")
        if n == 0 and not buf:
            return None
        return _take(self._lib, buf, n)

    def read(self):
        if not self._h:
            raise IOError("reader is closed")
        buf = ctypes.POINTER(ctypes.c_uint8)()
        off = ctypes.c_int64()
        n = self._lib.rio_read(self._h, ctypes.byref(buf), ctypes.byref(off))
        return self._result(n, buf)

    def read_at(self, pos):
        if not self._h:
            raise IOError("reader is closed")
        buf = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.rio_read_at(self._h, pos, ctypes.byref(buf))
        return self._result(n, buf)

    def reset(self):
        self._lib.rio_reader_reset(self._h)


class NativeRecordWriter(_Handle):
    _close_fn = "rio_writer_close"

    def __init__(self, path):
        super().__init__("rio_writer_open", path)

    def write(self, buf: bytes) -> int:
        arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
        off = self._lib.rio_write(self._h, arr, len(buf))
        if off < 0:
            raise IOError("RecordIO write failed")
        return off


class NativePrefetchReader(_Handle):
    """Background-thread readahead (dmlc::ThreadedIter parity,
    reference src/io/iter_prefetcher.h:28-129)."""

    _close_fn = "rio_prefetch_close"

    def __init__(self, path, capacity=16):
        super().__init__("rio_prefetch_open", path, capacity)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise IOError("prefetch reader is closed")
        buf = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.rio_prefetch_next(self._h, ctypes.byref(buf))
        if n < 0:
            raise IOError("corrupt RecordIO stream")
        if n == 0 and not buf:
            raise StopIteration
        return _take(self._lib, buf, n)


def decode_jpeg_batch(bufs, nthreads=4):
    """Decode a list of JPEG byte strings on a C++ thread pool in one
    foreign call (GIL-free; the reference's OMP decode,
    iter_image_recordio.cc:140-160), by the codec ``decoder_route()`` names.

    Returns a list of HWC uint8 RGB numpy arrays; entries that are not
    decodable JPEGs come back as None (the caller falls back to PIL), and
    so does every entry when no codec loads."""
    import numpy as np

    route = decoder_route()
    if route is None:
        return [None] * len(bufs)
    lib = _library(route)
    n = len(bufs)
    if n == 0:
        return []
    u8p = ctypes.POINTER(ctypes.c_uint8)
    # bytes objects are only read by the C side: cast without copying
    in_ptrs = (u8p * n)(*[ctypes.cast(ctypes.c_char_p(b), u8p) for b in bufs])
    in_lens = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
    out_ptrs = (u8p * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    lib.mxtpu_decode_jpeg_batch_alloc(in_ptrs, in_lens, n, out_ptrs, ws, hs,
                                      nthreads)
    outs = [None] * n
    try:
        for i in range(n):
            if out_ptrs[i]:
                view = np.ctypeslib.as_array(out_ptrs[i],
                                             shape=(hs[i], ws[i], 3))
                outs[i] = view.copy()  # own the memory before C frees it
    finally:
        lib.mxtpu_free_many(out_ptrs, n)
    return outs


def encode_jpeg(arr, quality=95) -> bytes:
    """An HWC uint8 RGB image as JPEG bytes (4:2:0, ``quality``) by nvJPEG
    on the card."""
    import numpy as np

    lib = nvjpeg_lib()
    if lib is None:
        raise RuntimeError("nvJPEG codec unavailable: %s"
                           % _ERRORS.get("nvjpeg"))
    img = np.ascontiguousarray(arr, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_jpeg takes an HWC RGB image, got shape %s"
                         % (img.shape,))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    length = ctypes.c_size_t()
    rc = lib.mxtt_nvjpeg_encode(img.ctypes.data_as(u8p), img.shape[1],
                                img.shape[0], int(quality),
                                ctypes.byref(out), ctypes.byref(length))
    if rc != 0:
        raise RuntimeError("nvJPEG encode failed: %s"
                           % lib.mxtt_nvjpeg_error().decode())
    ptrs = (u8p * 1)(out)
    try:
        return ctypes.string_at(out, length.value)
    finally:
        lib.mxtpu_free_many(ptrs, 1)
