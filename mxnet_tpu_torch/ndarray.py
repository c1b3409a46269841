"""NDArray — the imperative n-dim array over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py``: the array type with its
arithmetic, comparison and shape methods; the creation functions; the
``mx.nd.<op>`` surface, one function per registered op, generated from the
op registry at import and refreshed when an op is registered later
(``register_kernel_op``, ``operator.register``'s ``Custom``); and
``save``/``load`` in the reference's binary ``.params`` container, bit for
bit (src/ndarray/ndarray.cc:633-714: magic 0x112, TShape uint32s, Context
two int32s, mshadow type flag, raw buffer; dmlc vector<string> keys).  A
file written by either package loads in the other, and re-saving a loaded
file reproduces its bytes.

Arrays live on their context's ``torch.device``; creation functions default
to the current context, which is ``gpu(0)`` unless the caller enters
another.  An op runs on the context of its first NDArray input, else on its
``ctx`` attr, else on the current context.  ``a[:] = x``, ``a += b`` and
``out=`` write into the existing tensor in place, so holders of the NDArray
(executors, predictors) see the update; ``reshape``, ``T``, ``slice`` and
basic indexing are views of the parent's storage, as in the reference.
An op's result never aliases its inputs.  Under the NaiveEngine
(``MXNET_ENGINE_TYPE=NaiveEngine``) every op runs to its end on the device
before the call returns, and an error names the op.
"""
from __future__ import annotations

import builtins as _builtins
import struct
from typing import List, Optional

import numpy as np
import torch

from .base import MXNetError, mx_real_t, naive_engine
from .context import Context, cpu, gpu, current_context
from .ops import OpContext, registered_ops
from .ops.param import TORCH_DTYPES, torch_dtype
from .parallel.mesh import ShardedTensor
from . import random as _random

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "moveaxis", "onehot_encode", "waitall", "load",
           "save", "imdecode"]

_DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


# Hook installed by comm_engine: called with the NDArray before a host read
# so an in-flight async kvstore pull into it lands first (the reference
# engine's WaitToRead contract, threaded_engine.h).
_async_read_guard = None


def _dense(x):
    """A tensor: an array stored as pieces on a mesh (a ShardedTensor,
    ``sharding.place``) gathered whole onto its first context."""
    return x.full() if isinstance(x, ShardedTensor) else x


def _default_ctx(ctx) -> Context:
    return ctx if ctx is not None else current_context()


def _context_of(device: torch.device) -> Context:
    """The Context naming a torch device."""
    return gpu(device.index or 0) if device.type == "cuda" else cpu()


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

    @property
    def ndim(self):
        return self._data.dim()

    def wait_to_read(self):
        """Block until a pending async kvstore pull into this array landed
        (the engine's WaitToRead contract, comm_engine.py)."""
        g = _async_read_guard
        if g is not None:
            g(self)

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy (never a view of a CPU array's storage, as in the
        reference).  bfloat16 arrays come back widened to float32."""
        self.wait_to_read()
        x = _dense(self._data).detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return np.array(x.cpu().numpy())

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def astype(self, dtype) -> "NDArray":
        """A copy converted to ``dtype``."""
        return NDArray(self._data.to(torch_dtype(dtype), copy=True),
                       self._ctx)

    def copyto(self, other) -> "NDArray":
        """Copy into an array (in place, converting to its dtype) or to a
        context (a new array there)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError("shape mismatch in copyto")
            other[:] = self
            return other
        ctx = Context(other)
        return NDArray(_dense(self._data).to(ctx.torch_device(), copy=True),
                       ctx)

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self._ctx and not isinstance(self._data,
                                                   ShardedTensor):
            return self
        return NDArray(_dense(self._data).to(context.torch_device()),
                       context)

    def copy(self) -> "NDArray":
        return NDArray(_dense(self._data).clone(), self._ctx)

    def _set(self, data: torch.Tensor) -> None:
        """Rebind the array to ``data`` (no copy): how executors and
        optimizers hand back new buffers to the holders of this array."""
        self._data = data

    # -- shape (views of the parent's storage, reference ndarray.h:286-352)
    def reshape(self, shape) -> "NDArray":
        """A view with MXNet's reshape codes (0 copy, -1 infer, -2 rest,
        -3 merge, -4 split)."""
        from .ops.matrix import _reshape_target

        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(_reshape_target(self.shape, shape)),
                       self._ctx)

    def broadcast_to(self, shape) -> "NDArray":
        """Broadcast along extent-1 axes to ``shape``; a shorter current
        shape is left-padded with 1s, and 0 in the target keeps the input's
        extent (the ``broadcast_to`` op's convention: this calls it)."""
        shape = tuple(int(d) for d in shape)
        cur = self
        if len(self.shape) < len(shape):
            cur = self.reshape((1,) * (len(shape) - len(self.shape))
                               + self.shape)
        if len(cur.shape) != len(shape):
            raise ValueError("cannot broadcast %s to lower-rank %s"
                             % (self.shape, shape))
        if any(c != t and c != 1 and t != 0
               for c, t in zip(cur.shape, shape)):
            raise ValueError("cannot broadcast %s to %s (only extent-1 axes "
                             "broadcast)" % (self.shape, shape))
        return _invoke("broadcast_to", (cur,), {"shape": shape})

    @property
    def T(self) -> "NDArray":
        """The axes reversed (a view)."""
        return NDArray(self._data.permute(*reversed(range(self.ndim))),
                       self._ctx)

    def slice(self, start, stop) -> "NDArray":
        """Rows ``start:stop`` of axis 0, a view of this array's storage
        (the reference's Slice)."""
        return NDArray(self._data[start:stop], self._ctx)

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __getitem__(self, key) -> "NDArray":
        """A view of the selected elements (basic indexing); an NDArray
        key gathers rows (a copy)."""
        if isinstance(key, NDArray):
            key = key._data.to(torch.int64)
        return NDArray(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(self._data, ShardedTensor):
            self._set_pieces(key, value)
            return
        if isinstance(value, ShardedTensor):
            value = value.full()
        elif not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        if isinstance(key, NDArray):
            key = key._data.to(torch.int64)
        with torch.no_grad():
            self._data[key] = value.to(self._data.device, self._data.dtype)

    def _set_pieces(self, key, value):
        """``a[:] = value`` into an array stored as pieces on a mesh: each
        piece takes its block of ``value``, in place; pieces of the same
        layout are copied one to one, never gathered."""
        from .sharding.placement import _block

        x = self._data
        if not (isinstance(key, _builtins.slice) and
                key == _builtins.slice(None)):
            raise MXNetError("an array stored as pieces on a mesh is "
                             "written whole (a[:] = value)")
        with torch.no_grad():
            if isinstance(value, ShardedTensor) and \
                    value.same_layout(x.mesh, x.spec):
                for c, p in x.shards.items():
                    p.copy_(value.shards[c])
                return
            if isinstance(value, ShardedTensor):
                value = value.full()
            elif not isinstance(value, torch.Tensor):
                value = torch.tensor(np.asarray(value))
            value = value.broadcast_to(tuple(x.shape))
            for c, p in x.shards.items():
                p.copy_(_block(value, x.spec, x.mesh, c))

    # -- arithmetic (reference python/mxnet/ndarray.py operators) ----------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _invoke(op, (a, b), {})
        if np.isscalar(other):
            return _invoke(scalar_op, (self,), {"scalar": float(other)})
        raise TypeError("unsupported operand type %s" % type(other))

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_rpower_scalar",
                            reverse=True)

    def __neg__(self):
        return _invoke("negative", (self,), {})

    def __abs__(self):
        return _invoke("abs", (self,), {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def _inplace(self, out: "NDArray") -> "NDArray":
        """``a op= b``: written into this array's tensor when the shape
        holds, else rebound (a broadcast that grows the array)."""
        if out.shape == self.shape:
            with torch.no_grad():
                self._data.copy_(out._data)
        else:
            self._set(out._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self._ctx)

    # -- pickling: the JAX package's state dict (host data, context), so a
    # pickled optimizer state (a server snapshot) restores onto the
    # context it was taken on; bfloat16 data travels widened to float32
    # and says so under "dtype".  An array stored as pieces keeps them
    # (the pieces pickle as tensors on their devices).
    def __getstate__(self):
        state = {"ctx_type": self._ctx.device_type,
                 "ctx_id": self._ctx.device_id, "writable": True}
        if isinstance(self._data, ShardedTensor):
            state["pieces"] = self._data
            return state
        state["data"] = self.asnumpy()
        if self._data.dtype == torch.bfloat16:
            state["dtype"] = "bfloat16"
        return state

    def __setstate__(self, state):
        self._ctx = Context(state["ctx_type"], state["ctx_id"])
        if "pieces" in state:
            self._data = state["pieces"]
            return
        self._data = torch.from_numpy(np.array(state["data"])).to(
            device=self._ctx.torch_device(),
            dtype=torch_dtype(state.get("dtype", state["data"].dtype)))


# ---------------------------------------------------------------------------
# Imperative invoke — the analogue of MXImperativeInvoke
# (reference src/c_api/c_api_ndarray.cc:323)
# ---------------------------------------------------------------------------


def _is_tensor_arg(v) -> bool:
    """True for array kwargs (NDArray, numpy array, torch tensor); numpy
    scalars are attrs."""
    return isinstance(v, (NDArray, np.ndarray, torch.Tensor))


def _as_tensor(x, device) -> torch.Tensor:
    """A non-NDArray input on ``device``: python lists and scalars default
    to float32, as ``array`` does."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return array(x, _context_of(device))._data
    return torch.tensor(np.asarray(x, dtype=mx_real_t), device=device)


def _parse_ctx(value) -> Context:
    if isinstance(value, Context):
        return value
    dev_type, _, dev_id = str(value).partition("(")
    return Context(dev_type, int(dev_id.rstrip(")")) if dev_id else 0)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device == b.device and \
        a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _nd_context(x) -> Context:
    """The context of an NDArray or of a torch tensor's device."""
    return x.context if isinstance(x, NDArray) else _context_of(x.device)


def _invoke(op_name: str, args, kwargs):
    """Run registered op ``op_name`` on NDArrays: positional inputs, array
    kwargs by input name, every other kwarg an attr; ``out=`` receives the
    result in place; updated aux states are written back to their arrays.
    The op runs on the context of its first NDArray input (or torch
    tensor's device), else its ``ctx`` attr, else ``out``'s, else the
    current context.  Torch tensors are accepted as inputs, aux states and
    ``out``, and written in place like NDArrays."""
    op = registered_ops()[op_name]
    kwargs = dict(kwargs)
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    nd_kwargs = {k: v for k, v in kwargs.items() if _is_tensor_arg(v)}
    attrs = {k: v for k, v in kwargs.items() if k not in nd_kwargs}
    pos_inputs = [a for a in args if a is not None]
    if op.key_var_num_args and op.key_var_num_args not in attrs:
        attrs[op.key_var_num_args] = len(pos_inputs)
    parsed = op.parse_attrs(attrs)
    names = op.input_names(parsed) + op.aux_names(parsed)
    inputs = list(pos_inputs)
    if nd_kwargs:
        slot = dict(zip(names, inputs))
        slot.update(nd_kwargs)
        inputs = [slot[n] for n in names if n in slot]
    ctx = next((_nd_context(a) for a in inputs
                if isinstance(a, (NDArray, torch.Tensor))), None)
    if ctx is None and parsed.get("ctx"):
        ctx = _parse_ctx(parsed["ctx"])
    if ctx is None and out is not None:  # a source op writes where out is
        ctx = _nd_context(out[0] if isinstance(out, (list, tuple)) else out)
    if ctx is None:
        ctx = current_context()
    device = ctx.torch_device()
    tensors = [a._data if isinstance(a, NDArray) else _as_tensor(a, device)
               for a in inputs]
    n_aux = len(op.aux_names(parsed))
    main_in = tensors[:len(tensors) - n_aux]
    aux_in = tuple(tensors[len(tensors) - n_aux:])
    gen = _random.generator(device) if op.stochastic else None
    naive = naive_engine()
    try:
        with torch.no_grad():
            outs, aux_updates = op.apply(OpContext(False, gen, device),
                                         parsed, main_in, aux_in)
        if naive and device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception as exc:
        if not naive:
            raise
        # the NaiveEngine: the op runs to its end on the device before the
        # call returns, and an error, its own or the device queue's, names
        # the op
        raise MXNetError("op %s: %s: %s" % (op_name, type(exc).__name__,
                                            exc)) from exc
    for holder, new in zip(inputs[len(inputs) - n_aux:], aux_updates):
        if isinstance(holder, NDArray) and new is not holder._data:
            holder._set(new)
        elif isinstance(holder, torch.Tensor) and new is not holder:
            holder.copy_(new)
    # a result that is a view of an input (identity, Reshape, BlockGrad)
    # becomes a copy: an op's output never aliases its inputs
    outs = [o.clone() if any(_shares_storage(o, t) for t in tensors) else o
            for o in outs]
    results = [NDArray(o, ctx) for o in outs]
    if out is not None:
        for dst, src in zip(out if isinstance(out, (list, tuple)) else [out],
                            results):
            if isinstance(dst, torch.Tensor):
                with torch.no_grad():
                    dst.copy_(src._data)
            elif dst.shape == src.shape:
                with torch.no_grad():
                    dst._data.copy_(src._data)
            else:
                dst._set(src._data.to(dst._data.dtype))
        return out
    return results[0] if len(results) == 1 else results


def _make_imperative(op_name: str, op):
    def fn(*args, **kwargs):
        return _invoke(op_name, args, kwargs)

    fn.__name__ = op_name
    fn.__doc__ = op.doc or "Imperative function of op %s" % op_name
    return fn


# the module's own functions, which no generated op function replaces
_OWN_NAMES = frozenset(__all__)


def _init_ops():
    """One function per registered op, ``nd.<op>(*arrays, **attrs)``.
    The generated names shadow builtins (``sum``, ``max``, ``abs``,
    ``round``) at this module's scope: code here must not call those."""
    g = globals()
    for name, op in registered_ops().items():
        if name in _OWN_NAMES:
            continue
        g[name] = _make_imperative(name, op)
        if not name.startswith("_") and name not in __all__:
            __all__.append(name)


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
        # a copy: never aliases the caller's memory (a view with negative
        # strides, e.g. a flipped image, is made contiguous first)
        src = torch.tensor(np.ascontiguousarray(host))
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
    data = src.to(device=ctx.torch_device(), dtype=torch_dtype(dtype),
                  copy=is_nd)
    return NDArray(data, ctx)


def zeros(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    if isinstance(shape, int):
        shape = (shape,)
    ctx = _default_ctx(ctx)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def empty(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    """An array whose contents are unspecified (zero-filled here, as in
    the JAX package)."""
    return zeros(shape, ctx, dtype)


def ones(shape, ctx=None, dtype=mx_real_t) -> NDArray:
    return full(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype=mx_real_t) -> NDArray:
    if isinstance(shape, int):
        shape = (shape,)
    ctx = _default_ctx(ctx)
    return NDArray(torch.full(tuple(shape), val, dtype=torch_dtype(dtype),
                              device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=mx_real_t) -> NDArray:
    """Evenly spaced values in [start, stop), each repeated ``repeat``
    times (computed in float64 as numpy does, then converted)."""
    vals = np.arange(start, stop, step) if stop is not None \
        else np.arange(start)
    if repeat > 1:
        vals = np.repeat(vals, repeat)
    return array(vals, ctx, dtype=dtype)


def moveaxis(tensor: NDArray, source, destination) -> NDArray:
    return NDArray(torch.movedim(tensor._data, source, destination).clone(),
                   tensor.context)


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    if not arrays:
        raise MXNetError("concatenate: arrays must not be empty")
    return NDArray(torch.cat([a._data for a in arrays], dim=axis),
                   arrays[0].context)


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """One-hot rows of ``indices`` written into ``out`` (its shape and
    dtype)."""
    return _invoke("_onehot_encode", (indices, out), {"out": out})


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None):
    """Decode a JPEG/PNG buffer through the registered ``_imdecode`` op
    (reference python/mxnet/ndarray.py imdecode): CHW float32, an optional
    crop box and CHW mean subtracted.  Bytes land on the current context
    (the card unless the caller asks for the CPU), an NDArray's decode on
    its own context, and with ``out`` on ``out``'s; ``out`` (4-D: slice
    ``index``) receives the result."""
    if isinstance(str_img, NDArray):
        buf = str_img
    else:
        data = str_img if isinstance(str_img, (bytes, bytearray)) \
            else bytes(str_img)
        buf = array(np.frombuffer(data, dtype=np.uint8),
                    None if out is None else out.context, dtype=np.uint8)
    mean_arr = mean if mean is not None else array(
        np.zeros((0,), np.float32), buf.context)
    x0, y0, x1, y1 = clip_rect if clip_rect else (0, 0, 0, 0)
    res = _invoke("_imdecode", (mean_arr, buf),
                  {"index": index, "x0": x0, "y0": y0, "x1": x1, "y1": y1,
                   "c": channels, "size": 0})
    if out is not None:
        # reference Imdecode writes into slice ``index`` of a 4-D batch
        # buffer (ndarray.cc: ret->Slice(index, index+1)); a 3-D out is
        # filled whole
        if out.ndim == 4:
            out[index:index + 1] = res.reshape((1,) + res.shape)
        else:
            out[:] = res
        return out
    return res


def waitall() -> None:
    """Block until every pending device operation is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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


def _save_stream(f, data) -> None:
    """Write a .params container to a binary file object."""
    if isinstance(data, NDArray):
        data = [data]
    names: List[str] = []
    if isinstance(data, dict):
        names = list(data)
        arrays = [data[k] for k in names]
    else:
        arrays = list(data)
    f.write(struct.pack("<QQ", _MAGIC, 0))
    f.write(struct.pack("<Q", len(arrays)))
    for arr in arrays:
        _save_one(f, arr)
    f.write(struct.pack("<Q", len(names)))
    for n in names:
        nb = n.encode("utf-8")
        f.write(struct.pack("<Q", len(nb)))
        f.write(nb)


def save(fname: str, data, checksum: bool = False,
         op: str = "params.write") -> None:
    """Save an NDArray, a list or a ``{name: NDArray}`` dict in the
    reference's .params container format.

    The file is written atomically (``filesystem.atomic_write``: a temp
    file, fsync, ``os.replace``), so a crash mid-save never leaves a torn
    file in its place; ``checksum`` adds the CRC32 sidecar
    (``fname.crc32``) checkpoint discovery checks.  ``op`` names the write
    site, as in the JAX package."""
    from .filesystem import atomic_write

    atomic_write(fname, lambda f: _save_stream(f, data), checksum=checksum,
                 op=op)


def load(fname: str, ctx: Optional[Context] = None):
    """Load a .params container; a dict if names are present, else a list.
    Arrays go to ``ctx``, or by default to the context each array's header
    records (the reference's NDArray::Load)."""
    with open(fname, "rb") as f:
        return _load_stream(f, ctx)


def _load_stream(f, ctx: Optional[Context] = None):
    """Read a .params container from a binary file object."""
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


_init_ops()
