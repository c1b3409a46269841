"""Custom-operator subsystem — user-defined ops in Python.

Counterpart of ``mxnet_tpu/operator.py`` (reference
python/mxnet/operator.py:19-576, src/operator/custom/custom.cc):
``CustomOp``, ``CustomOpProp``, ``register``, ``get_prop_class``, the
``Custom`` op, the legacy ``PythonOp``/``NumpyOp``/``NDArrayOp`` and the
``_Native``/``_NDArray`` stubs.

The port runs the graph eagerly, so the JAX package's ``pure_callback``
bridge has no counterpart: ``forward`` is called directly with NDArrays
that wrap the op's tensors on their device (no host round trip unless the
user calls ``asnumpy``), and ``backward`` runs inside a
``torch.autograd.Function``.  The backward honours ``need_top_grad`` and
``declare_backward_dependency`` — only the arrays the prop declares are
kept for it; the others reach ``backward`` as zeros — and ``req``: "write"
for each input that takes a gradient, "null" for the rest; ``assign`` also
takes "inplace" and "add".  Aux states go to ``forward`` and ``backward``
as arrays the op may update in place; the forward's updates are the op's
new aux states.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_class",
           "PythonOp", "NDArrayOp", "NumpyOp"]


class CustomOp(object):
    """Base class for user operators: implement ``forward`` and
    ``backward``; write results with ``assign`` to honour the request.

    One operator instance may serve several executors with the same input
    shapes: keep no per-batch state on ``self`` between ``forward`` and
    ``backward``; recompute from the arrays passed in."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` (NDArray, numpy array or scalar) into ``dst`` per
        request type (reference python/mxnet/operator.py:433-440)."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            from .ndarray import NDArray

            val = src._data if isinstance(src, NDArray) else \
                torch.as_tensor(np.asarray(src))
            with torch.no_grad():
                dst._data.add_(val.to(dst._data.device, dst._data.dtype))
        else:
            raise MXNetError("unknown request type %r" % (req,))


class CustomOpProp(object):
    """Metadata of a custom op: arguments, outputs, aux states, shapes,
    types, and the operator it creates.

    ``need_top_grad``: True when the op needs the gradient from the layer
    above; False for a loss layer, its own gradient source (reference
    python/mxnet/operator.py:442-453)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError()


_prop_registry: Dict[str, type] = {}
_registry_lock = threading.Lock()


def register(reg_name):
    """Decorator: register a ``CustomOpProp`` subclass under ``reg_name``,
    so ``mx.sym.Custom(..., op_type=reg_name)`` and ``mx.nd.Custom`` find
    it (reference python/mxnet/operator.py:576)."""

    def do_register(prop_cls):
        with _registry_lock:
            _prop_registry[reg_name] = prop_cls
            # a re-registration must not keep serving the old class's props
            for key in [k for k in _prop_cache if k[0] == reg_name]:
                del _prop_cache[key]
        return prop_cls

    return do_register


def get_prop_class(reg_name: str) -> type:
    try:
        return _prop_registry[reg_name]
    except KeyError:
        raise KeyError(
            "Custom op type %r is not registered; call "
            "mx.operator.register(%r) on a CustomOpProp subclass first"
            % (reg_name, reg_name))


# ---------------------------------------------------------------------------
# The Custom op
# ---------------------------------------------------------------------------

_RESERVED_ATTRS = ("ctx", "name", "op_type")


class _LRU(dict):
    """Bounded cache: bucketing workloads create one entry per shape."""

    def __init__(self, maxsize=256):
        super(_LRU, self).__init__()
        self._maxsize = maxsize

    def __setitem__(self, key, value):
        if key not in self and len(self) >= self._maxsize:
            del self[next(iter(self))]
        super(_LRU, self).__setitem__(key, value)


_prop_cache: Dict[Any, CustomOpProp] = {}
_op_cache: Dict[Any, CustomOp] = _LRU()
# caches key on this serial, not id(prop): after a re-registration a freed
# prop's address may be reused
_prop_serial = itertools.count()


def _get_prop(attrs: Dict[str, Any]) -> CustomOpProp:
    op_type = attrs["op_type"]
    kwargs = {k: v for k, v in attrs.items()
              if k not in _RESERVED_ATTRS and not k.startswith("__")}
    key = (op_type, tuple(sorted(kwargs.items())))
    prop = _prop_cache.get(key)
    if prop is None:
        prop = get_prop_class(op_type)(**kwargs)
        prop._mx_prop_serial = next(_prop_serial)
        _prop_cache[key] = prop
    return prop


def _normalize_shapes(prop, in_shapes):
    """prop.infer_shape, taking the 2-tuple (no aux) form too."""
    res = prop.infer_shape([list(s) for s in in_shapes])
    ishapes, oshapes = res[0], res[1]
    ashapes = res[2] if len(res) > 2 else []
    return ([tuple(s) for s in ishapes], [tuple(s) for s in oshapes],
            [tuple(s) for s in ashapes])


def _np_dtype(t: torch.Tensor):
    from .ndarray import _DTYPE_NAMES

    name = _DTYPE_NAMES[t.dtype]
    return name if name == "bfloat16" else np.dtype(name)


def _operator(prop, main):
    """The CustomOp instance for these input shapes and dtypes (cached),
    created for the inputs' context."""
    from .ndarray import _context_of

    shapes = [tuple(t.shape) for t in main]
    dtypes = [_np_dtype(t) for t in main]
    key = (prop._mx_prop_serial, tuple(shapes), tuple(map(str, dtypes)),
           main[0].device if main else None)
    op = _op_cache.get(key)
    if op is None:
        ctx = _context_of(main[0].device) if main else None
        op = _op_cache[key] = prop.create_operator(
            ctx, [list(s) for s in shapes], dtypes)
    return op


def _out_spec(prop, main):
    """(out_shapes, out torch dtypes) of the op for these inputs."""
    from .ops.param import torch_dtype

    _, oshapes, _ = _normalize_shapes(prop, [t.shape for t in main])
    try:
        odts = prop.infer_type([_np_dtype(t) for t in main])[1]
    except NotImplementedError:
        odts = [_np_dtype(main[0])] * len(oshapes)
    return oshapes, [torch_dtype(d) for d in odts]


def _wrap(tensors):
    from .ndarray import NDArray, _context_of

    return [NDArray(t, _context_of(t.device)) for t in tensors]


class _CustomFn(torch.autograd.Function):
    """The user's forward, and its backward as the op's gradient.
    ``tensors`` are the main inputs, then the aux states."""

    @staticmethod
    def forward(ctx, prop, is_train, n_main, *tensors):
        main, aux = tensors[:n_main], tensors[n_main:]
        op = _operator(prop, main)
        oshapes, odts = _out_spec(prop, main)
        out_t = [torch.zeros(s, dtype=d, device=main[0].device)
                 for s, d in zip(oshapes, odts)]
        aux_t = [a.clone() for a in aux]
        op.forward(bool(is_train), ["write"] * len(out_t), _wrap(main),
                   _wrap(out_t), _wrap(aux_t))
        n_out = len(out_t)
        # ids as the reference numbers them: out_grad, in_data, out_data
        deps = set(prop.declare_backward_dependency(
            list(range(n_out)), list(range(n_out, n_out + n_main)),
            list(range(n_out + n_main, 2 * n_out + n_main))))
        ctx.op, ctx.n_main, ctx.n_out = op, n_main, n_out
        ctx.device = main[0].device
        ctx.keep = [i in deps for i in range(2 * n_out + n_main)]
        ctx.shapes = [(tuple(t.shape), t.dtype) for t in list(main) + out_t]
        ctx.save_for_backward(*(t for i, t in enumerate(list(main) + out_t)
                                if ctx.keep[n_out + i]), *aux_t)
        ctx.mark_non_differentiable(*aux_t)
        return tuple(out_t) + tuple(aux_t)

    @staticmethod
    def backward(ctx, *cts):
        n_main, n_out = ctx.n_main, ctx.n_out

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=ctx.device)

        saved = iter(ctx.saved_tensors)
        arrays = [next(saved) if ctx.keep[n_out + i] else zeros(*sd)
                  for i, sd in enumerate(ctx.shapes)]
        aux = list(saved)
        main, outs = arrays[:n_main], arrays[n_main:]
        out_grad = [c if c is not None and ctx.keep[i]
                    else zeros(*ctx.shapes[n_main + i])
                    for i, c in enumerate(cts[:n_out])]
        in_grad = [torch.zeros_like(t) for t in main]
        req = ["write" if ctx.needs_input_grad[3 + i] else "null"
               for i in range(n_main)]
        ctx.op.backward(req, _wrap(out_grad), _wrap(main), _wrap(outs),
                        _wrap(in_grad), _wrap([a.clone() for a in aux]))
        grads = [g if r != "null" else None for g, r in zip(in_grad, req)]
        return (None, None, None) + tuple(grads) + (None,) * len(aux)


def _custom_kernel(opctx, attrs, *tensors):
    """Registry function of the ``Custom`` op: the outputs, then the new
    aux states."""
    prop = _get_prop(attrs)
    return _CustomFn.apply(prop, opctx.is_train,
                           len(prop.list_arguments()), *tensors)


def _custom_infer_shape(attrs, in_shapes):
    if any(s is None for s in in_shapes):
        raise ValueError("Custom op needs all input shapes")
    return _normalize_shapes(_get_prop(attrs), in_shapes)


def _register_legacy_callback_stubs():
    """``_Native``/``_NDArray`` nodes carry C function pointers of the
    process that wrote them (reference python/mxnet/operator.py:19-226):
    graphs holding them load and introspect, and running one raises with
    the way to re-create it."""
    from .ops.registry import register as reg_op

    def _make(name):
        @reg_op(name, inputs=("data",), allow_extra_attrs=True,
                hint=name.strip("_").lower())
        def _stub(opctx, attrs, *arrays):
            raise MXNetError(
                "%s carries process-local callback pointers and cannot "
                "execute from a serialized graph; re-create the op with "
                "PythonOp/NDArrayOp.get_symbol or mx.operator.register "
                "(Custom)" % name)

    _make("_Native")
    _make("_NDArray")


def _register_custom_op():
    from .ops.param import Param
    from .ops.registry import register as reg_op

    reg_op(
        "Custom",
        inputs=lambda attrs: list(_get_prop(attrs).list_arguments()),
        num_outputs=lambda attrs: len(_get_prop(attrs).list_outputs()),
        aux=lambda attrs: list(_get_prop(attrs).list_auxiliary_states()),
        params={"op_type": Param(str, required=True,
                                 doc="registered CustomOpProp name")},
        allow_extra_attrs=True,
        infer_shape=_custom_infer_shape,
        output_names=lambda attrs: list(_get_prop(attrs).list_outputs()),
        hint="custom",
    )(_custom_kernel)


# ---------------------------------------------------------------------------
# Legacy PythonOp / NDArrayOp (reference ``_Native`` / ``_NDArray`` ops)
# ---------------------------------------------------------------------------


class PythonOp(object):
    """Legacy numpy-callback op (reference python/mxnet/operator.py:19-120,
    op ``_Native``): ``get_symbol`` registers an adapter prop and returns a
    Custom symbol."""

    _legacy_counter = [0]

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = bool(need_top_grad)

    def forward(self, in_data, out_data):
        out_data[0][:] = in_data[0]

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        return CustomOpProp.declare_backward_dependency(
            self, out_grad, in_data, out_data)

    def _legacy_op(self):
        """The CustomOp running this op's numpy forward and backward."""
        legacy = self

        class _LegacyOp(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                ins = [a.asnumpy() for a in in_data]
                outs = [a.asnumpy() for a in out_data]
                legacy.forward(in_data=ins, out_data=outs)
                for dst, src in zip(out_data, outs):
                    self.assign(dst, "write", src)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                igs = [a.asnumpy() for a in in_grad]
                legacy.backward(out_grad=[a.asnumpy() for a in out_grad],
                                in_data=[a.asnumpy() for a in in_data],
                                out_data=[a.asnumpy() for a in out_data],
                                in_grad=igs)
                for dst, r, src in zip(in_grad, req, igs):
                    self.assign(dst, r, src)

        return _LegacyOp()

    def _adapter_prop(self):
        legacy = self

        class _LegacyProp(CustomOpProp):
            def __init__(self):
                super(_LegacyProp, self).__init__(
                    need_top_grad=legacy.need_top_grad())

            def list_arguments(self):
                return legacy.list_arguments()

            def list_outputs(self):
                return legacy.list_outputs()

            def infer_shape(self, in_shape):
                res = legacy.infer_shape(in_shape)
                return res if len(res) == 3 else (res[0], res[1], [])

            def declare_backward_dependency(self, out_grad, in_data,
                                            out_data):
                return legacy.declare_backward_dependency(
                    out_grad, in_data, out_data)

            def create_operator(self, ctx, in_shapes, in_dtypes):
                return legacy._legacy_op()

        return _LegacyProp

    def get_symbol(self, *args, **kwargs):
        from . import symbol

        PythonOp._legacy_counter[0] += 1
        reg_name = "_legacy_python_op_%d" % PythonOp._legacy_counter[0]
        register(reg_name)(self._adapter_prop())
        kwargs["op_type"] = reg_name
        return symbol.Custom(*args, **kwargs)


class NDArrayOp(PythonOp):
    """Legacy NDArray-callback op (reference python/mxnet/operator.py:
    122-226, op ``_NDArray``): forward and backward receive NDArrays."""

    def _legacy_op(self):
        legacy = self

        class _LegacyOp(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                legacy.forward(in_data=in_data, out_data=out_data)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                legacy.backward(out_grad=out_grad, in_data=in_data,
                                out_data=out_data, in_grad=in_grad)

        return _LegacyOp()


#: reference alias — the numpy-based op
NumpyOp = PythonOp

_register_legacy_callback_stubs()
_register_custom_op()

# the generated surfaces were made before Custom existed
from .ops.kernel_op import refresh_surfaces  # noqa: E402

refresh_surfaces()
