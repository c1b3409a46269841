"""NDArray — the imperative n-dim array over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py`` for the serving slice: the array
type, ``array``/``zeros``/``empty``, and ``save``/``load`` in the
reference's binary ``.params`` container, bit for bit
(src/ndarray/ndarray.cc:633-714: magic 0x112, TShape uint32s, Context two
int32s, mshadow type flag, raw buffer; dmlc vector<string> keys).  A file
written by either package loads in the other, and re-saving a loaded file
reproduces its bytes.

Arrays live on their context's ``torch.device``; creation functions default
to the current context, which is ``gpu(0)`` unless the caller enters
another.  ``a[:] = x`` writes into the existing tensor in place, so holders
of the NDArray (executors, predictors) see the update.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from .base import MXNetError, mx_real_t
from .context import Context, cpu, gpu, current_context

__all__ = ["NDArray", "array", "zeros", "empty", "load", "save"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise MXNetError("unsupported dtype %s" % name)
    return _TORCH_DTYPES[name]


def _default_ctx(ctx) -> Context:
    return ctx if ctx is not None else current_context()


class NDArray:
    """n-dim array on a device context (reference: include/mxnet/ndarray.h)."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data: torch.Tensor, ctx: Context):
        self._data = data
        self._ctx = ctx

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype of the elements; ``"bfloat16"`` for bf16 arrays,
        which numpy cannot represent."""
        name = _DTYPE_NAMES[self._data.dtype]
        return name if name == "bfloat16" else np.dtype(name)

    @property
    def size(self):
        return self._data.numel()

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    def asnumpy(self) -> np.ndarray:
        """Host copy.  bfloat16 arrays come back widened to float32."""
        x = self._data.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self._ctx:
            return self
        return NDArray(self._data.to(context.torch_device()), context)

    def copy(self) -> "NDArray":
        return NDArray(self._data.clone(), self._ctx)

    def _set(self, data: torch.Tensor) -> None:
        """Rebind the array to ``data`` (no copy): how executors and
        optimizers hand back new buffers to the holders of this array."""
        self._data = data

    def __getitem__(self, key) -> "NDArray":
        """A view of the selected rows (basic indexing)."""
        return NDArray(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        with torch.no_grad():
            self._data[key] = value.to(self._data.device, self._data.dtype)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self._ctx)


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """Copy ``source_array`` (NDArray, numpy array, or nested lists) to
    ``ctx``.  As in the reference, python lists and float64 default to
    float32 and int64 to int32."""
    is_nd = isinstance(source_array, NDArray)
    if is_nd:
        src = source_array._data
    else:
        host = np.asarray(source_array)
        if host.dtype.kind == "V":  # ml_dtypes bfloat16 from the JAX package
            host = host.astype(np.float32)
            dtype = dtype or "bfloat16"
        src = torch.tensor(host)  # a copy: never aliases the caller's memory
    if dtype is None:
        carries_dtype = is_nd or isinstance(source_array,
                                            (np.ndarray, np.generic))
        if not carries_dtype or src.dtype == torch.float64:
            dtype = mx_real_t
        elif src.dtype == torch.int64:
            dtype = np.int32
        else:
            dtype = src.dtype
    ctx = _default_ctx(ctx)
    data = src.to(device=ctx.torch_device(), dtype=_torch_dtype(dtype),
                  copy=is_nd)
    return NDArray(data, ctx)


def zeros(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    if isinstance(shape, int):
        shape = (shape,)
    ctx = _default_ctx(ctx)
    return NDArray(torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def empty(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    """An array whose contents are unspecified (zero-filled here, as in
    the JAX package)."""
    return zeros(shape, ctx, dtype)


# ---------------------------------------------------------------------------
# Save / load — reference .params binary format, bit-for-bit
# ---------------------------------------------------------------------------

_MAGIC = 0x112
# mshadow type flags (mshadow/base.h enum order).  bfloat16 has no flag in
# the reference enum: bf16 arrays are widened to float32 and saved as flag 0.
_TYPE_FLAG = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
              "int32": 4, "int8": 5, "int64": 6}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}


def _save_one(f, arr: NDArray):
    shape = arr.shape
    f.write(struct.pack("<I", len(shape)))
    if shape:
        f.write(struct.pack("<%dI" % len(shape), *shape))
    if len(shape) == 0:
        return
    f.write(struct.pack("<ii", arr.context.device_typeid,
                        arr.context.device_id))
    host = arr.asnumpy()
    dtype_name = host.dtype.name
    if dtype_name not in _TYPE_FLAG:
        host = host.astype(np.float32)
        dtype_name = "float32"
    f.write(struct.pack("<i", _TYPE_FLAG[dtype_name]))
    f.write(host.tobytes())


def _load_one(f, ctx) -> NDArray:
    (ndim,) = struct.unpack("<I", f.read(4))
    shape = struct.unpack("<%dI" % ndim, f.read(4 * ndim)) if ndim else ()
    if ndim == 0:
        return NDArray(torch.zeros(()), cpu())
    dev_type, dev_id = struct.unpack("<ii", f.read(8))
    (type_flag,) = struct.unpack("<i", f.read(4))
    if type_flag == 7:
        # earlier versions of the JAX package wrote bf16 with invented flag
        # 7 and a float32-widened payload
        dtype_name = "float32"
    elif type_flag not in _FLAG_TYPE:
        # guessing an element size would desynchronize the stream
        raise MXNetError("unknown mshadow type flag %d in .params file"
                         % type_flag)
    else:
        dtype_name = _FLAG_TYPE[type_flag]
    np_dtype = np.dtype(dtype_name)
    count = int(np.prod(shape))
    host = np.frombuffer(f.read(count * np_dtype.itemsize),
                         dtype=np_dtype).reshape(shape)
    if ctx is None:
        # the context the header records; a TPU id of the JAX package (4)
        # maps to the card, cpu_pinned to the CPU
        ctx = cpu(dev_id) if dev_type in (1, 3) else gpu(dev_id)
    return array(host, ctx, dtype=np_dtype)


def save(fname: str, data) -> None:
    """Save an NDArray, a list or a ``{name: NDArray}`` dict in the
    reference's .params container format."""
    if isinstance(data, NDArray):
        data = [data]
    names: List[str] = []
    if isinstance(data, dict):
        names = list(data)
        arrays = [data[k] for k in names]
    else:
        arrays = list(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            _save_one(f, arr)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            nb = n.encode("utf-8")
            f.write(struct.pack("<Q", len(nb)))
            f.write(nb)


def load(fname: str, ctx: Optional[Context] = None):
    """Load a .params container; a dict if names are present, else a list.
    Arrays go to ``ctx``, or by default to the context each array's header
    records (the reference's NDArray::Load)."""
    with open(fname, "rb") as f:
        magic, _res = struct.unpack("<QQ", f.read(16))
        if magic != _MAGIC:
            raise MXNetError("Invalid NDArray file format (magic %#x)" % magic)
        (n,) = struct.unpack("<Q", f.read(8))
        arrays = [_load_one(f, ctx) for _ in range(n)]
        (nk,) = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(nk):
            (ln,) = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode("utf-8"))
    if names:
        return dict(zip(names, arrays))
    return arrays


# the fused optimizer updates, called as nd.<name>(weight, grad, ..., out=)
from .ops.optimizer_ops import (adam_update, rmsprop_update,  # noqa: E402
                                rmspropalex_update, sgd_mom_update,
                                sgd_update)
