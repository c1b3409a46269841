"""Python-side backing of the C ABI (``src/c_predict_api.cc`` and
``src/c_api.cc``) for the port; counterpart of ``mxnet_tpu/capi_shim.py``,
with its handle registries, argument types and error strings.

The port's C library, ``libmxtpu_torch_capi`` (``native.capi_lib_path``:
the two sources above as they are, and ``csrc/capi_common.cc``, which
imports this module), embeds (or joins) a CPython interpreter and drives
this shim with primitive types only — strings, bytes, ints — so the C side
stays a thin marshalling layer.  Handles are integers into a registry,
mirroring the reference's opaque ``PredictorHandle`` over C++ objects
(reference src/c_predict_api.cc:41-280).  ``dev_type`` 2 is ``gpu(dev_id)``
and 1 is ``cpu()``.
"""
from __future__ import annotations

import threading

import numpy as np

class _HandleRegistry:
    """Integer-handle table — the opaque-handle pattern all C-ABI objects
    share (predictors, NDArrays)."""

    def __init__(self):
        self._items = {}
        self._next = 1
        self._lock = threading.Lock()

    def put(self, obj):
        with self._lock:
            hid = self._next
            self._next += 1
            self._items[hid] = obj
        return hid

    def get(self, hid, kind):
        obj = self._items.get(hid)
        if obj is None:
            raise KeyError("invalid %s handle %d" % (kind, hid))
        return obj

    def pop(self, hid):
        with self._lock:
            self._items.pop(hid, None)

    def replace(self, hid, obj):
        with self._lock:
            if hid not in self._items:
                raise KeyError("invalid handle %d" % hid)
            self._items[hid] = obj


_predictors = _HandleRegistry()


def _ctx_from_dev(dev_type, dev_id=0):
    """Reference dev_type codes (include/mxnet/base.h): 1=cpu, 2=gpu."""
    from . import context as ctx_mod

    return ctx_mod.gpu(dev_id) if dev_type == 2 else ctx_mod.cpu()


def create(symbol_json, params_bytes, input_keys, input_shapes, dev_type):
    """-> integer handle.  ``params_bytes``: a .params file image;
    ``input_shapes``: list of tuples aligned with ``input_keys``."""
    import io as _io

    from . import Predictor
    from .context import cpu
    from .ndarray import _load_stream

    # staged on the host, then copied to the predictor's context
    params = _load_stream(_io.BytesIO(params_bytes), cpu()) \
        if params_bytes else {}
    if not isinstance(params, dict):
        from .base import MXNetError

        raise MXNetError(
            "params blob has no names (list container); save checkpoints "
            "as a name->array dict")
    ctx = _ctx_from_dev(dev_type)
    shapes = {k: tuple(int(d) for d in s)
              for k, s in zip(input_keys, input_shapes)}
    pred = Predictor(symbol_json, params, shapes, ctx=ctx)
    return _predictors.put(pred)


def _get(hid):
    return _predictors.get(hid, "predictor")


def set_input(hid, key, data_bytes, shape):
    """``shape`` is the flat element count from the C caller (MXPredSetInput
    passes data as a flat float buffer); reshape to the bound input."""
    pred = _get(hid)
    want = pred._input_shapes[key]
    arr = np.frombuffer(data_bytes, np.float32).reshape(want)
    pred.set_input(key, arr)


def forward(hid):
    pred = _get(hid)
    pred._exec.forward(is_train=False)


def num_outputs(hid):
    return len(_get(hid).get_outputs())


def get_output_shape(hid, index):
    return tuple(int(d) for d in _get(hid).get_output(index).shape)


def get_output(hid, index):
    out = _get(hid).get_output(index).asnumpy().astype(np.float32)
    return out.tobytes()


def reshape(hid, input_keys, input_shapes):
    """New handle bound to new shapes, sharing weights (MXPredReshape)."""
    pred = _get(hid)
    new = pred.reshape({k: tuple(int(d) for d in s)
                        for k, s in zip(input_keys, input_shapes)})
    return _predictors.put(new)


def free(hid):
    _predictors.pop(hid)


# ---------------------------------------------------------------------------
# Core NDArray / op C API backing (src/c_api.cc — the reference's
# c_api.cc NDArray CRUD + MXImperativeInvoke + MXListAllOpNames subset).
# Same integer-handle registry pattern as the predictor above.
# ---------------------------------------------------------------------------

_ndarrays = _HandleRegistry()


def _nd_put(arr):
    return _ndarrays.put(arr)


def _nd_get(hid):
    return _ndarrays.get(hid, "NDArray")


def nd_create(shape, dev_type, dev_id, dtype_flag):
    from . import ndarray as nd
    from .ndarray import _FLAG_TYPE

    return _nd_put(nd.zeros(tuple(int(d) for d in shape),
                            ctx=_ctx_from_dev(dev_type, dev_id),
                            dtype=_FLAG_TYPE[dtype_flag]))


def nd_free(hid):
    _ndarrays.pop(hid)


def nd_shape(hid):
    return tuple(int(d) for d in _nd_get(hid).shape)


def nd_dtype(hid):
    from .ndarray import _TYPE_FLAG

    return _TYPE_FLAG[str(np.dtype(_nd_get(hid).dtype))]


def nd_copy_from(hid, data_bytes):
    arr = _nd_get(hid)
    src = np.frombuffer(data_bytes, dtype=arr.dtype).reshape(arr.shape)
    arr[:] = src


def nd_copy_to(hid):
    return _nd_get(hid).asnumpy().tobytes()


def nd_wait_all():
    from . import ndarray as nd

    nd.waitall()


def nd_save(fname, hids, keys):
    from . import ndarray as nd

    arrs = [_nd_get(h) for h in hids]
    nd.save(fname, dict(zip(keys, arrs)) if keys else arrs)


def nd_load(fname):
    """-> (handles, names); names empty for list containers."""
    from . import ndarray as nd

    data = nd.load(fname)
    if isinstance(data, dict):
        names = list(data.keys())
        return [_nd_put(data[k]) for k in names], names
    return [_nd_put(a) for a in data], []


def list_op_names():
    from .ops import registered_ops

    return sorted(registered_ops())


def op_input_names(op_name):
    """Declared input order for one op (MXTPUListOpInputs — the
    reference exposes this via MXSymbolGetAtomicSymbolInfo's arg
    descriptions)."""
    from .ops.registry import get_op

    return list(get_op(op_name).input_names({}))


def nd_invoke(op_name, in_hids, keys, vals):
    """MXImperativeInvoke: attrs arrive as strings; the op's declarative
    Param specs parse them (the reference's attr_parser contract)."""
    from .ndarray import NDArray, _invoke

    inputs = [_nd_get(h) for h in in_hids]
    kwargs = dict(zip(keys, vals))
    res = _invoke(op_name, tuple(inputs), kwargs)
    outs = res if isinstance(res, (list, tuple)) else [res]
    for o in outs:
        if not isinstance(o, NDArray):  # _invoke's contract; keep loud
            raise TypeError("op %s returned a non-NDArray output" % op_name)
    return [_nd_put(o) for o in outs]


# ---------------------------------------------------------------------------
# Symbol / Executor C API backing (src/c_api.cc — the reference's
# c_api_symbolic.cc:54-545 + c_api_executor.cc:11-157 surfaces).  A C
# consumer can now build a graph from JSON, infer shapes, bind NDArrays,
# and run forward/backward with no Python-side setup.
# ---------------------------------------------------------------------------

_symbols = _HandleRegistry()
_executors = _HandleRegistry()

# reference OpReqType codes (include/mxnet/op_attr_types.h): kNullOp=0,
# kWriteTo=1, kWriteInplace=2, kAddTo=3
_GRAD_REQ_CODE = {0: "null", 1: "write", 2: "write", 3: "add"}


def sym_from_json(json_str):
    from . import symbol

    return _symbols.put(symbol.load_json(json_str))


def sym_from_file(fname):
    from . import symbol

    return _symbols.put(symbol.load(fname))


def _sym_get(hid):
    obj = _symbols.get(hid, "Symbol")
    if isinstance(obj, _PendingAtomic):
        raise ValueError(
            "symbol handle %d is an uncomposed atomic symbol (%s); call "
            "MXTPUSymbolCompose to wire its inputs first" % (hid, obj.op))
    return obj


def sym_tojson(hid):
    return _sym_get(hid).tojson()


def sym_list_arguments(hid):
    return list(_sym_get(hid).list_arguments())


def sym_list_outputs(hid):
    return list(_sym_get(hid).list_outputs())


def sym_list_aux(hid):
    return list(_sym_get(hid).list_auxiliary_states())


def sym_free(hid):
    _symbols.pop(hid)


def sym_infer_shape(hid, keys, shapes):
    """-> (arg_shapes, out_shapes, aux_shapes) as lists of int tuples, or
    (None, None, None) when the provided shapes underdetermine the graph
    (the reference's ``complete`` flag)."""
    sym = _sym_get(hid)
    kwargs = {k: tuple(int(d) for d in s) for k, s in zip(keys, shapes)}
    arg, out, aux = sym.infer_shape_partial(**kwargs)
    if (arg is None or out is None or aux is None
            or any(s is None for s in arg + out + aux)):
        return None, None, None
    return ([tuple(map(int, s)) for s in arg],
            [tuple(map(int, s)) for s in out],
            [tuple(map(int, s)) for s in aux])


def exec_bind(sym_hid, dev_type, dev_id, arg_hids, grad_hids,
              grad_req_codes, aux_hids):
    """Bind in ``list_arguments`` order (the reference MXExecutorBind
    contract).  ``grad_hids`` entries of 0 mean no gradient buffer for
    that argument; gradients are written IN PLACE into the caller's
    NDArray handles by exec_backward."""
    sym = _sym_get(sym_hid)
    ctx = _ctx_from_dev(dev_type, dev_id)
    names = sym.list_arguments()
    args = [_nd_get(h) for h in arg_hids]
    args_grad = {}
    grad_req = {}
    for name, ghid, code in zip(names, grad_hids, grad_req_codes):
        req = _GRAD_REQ_CODE.get(int(code), "null")
        grad_req[name] = req if ghid else "null"
        if ghid and req != "null":
            args_grad[name] = _nd_get(ghid)
    aux = [_nd_get(h) for h in aux_hids]
    ex = sym.bind(ctx, args, args_grad=args_grad or None,
                  grad_req=grad_req, aux_states=aux or None)
    return _executors.put(ex)


def _exec_get(hid):
    return _executors.get(hid, "Executor")


def exec_forward(hid, is_train):
    _exec_get(hid).forward(is_train=bool(is_train))


def exec_backward(hid, head_hids):
    ex = _exec_get(hid)
    if head_hids:
        ex.backward(out_grads=[_nd_get(h) for h in head_hids])
    else:
        ex.backward()


def exec_outputs(hid):
    """-> fresh NDArray registry handles for the executor outputs."""
    return [_nd_put(o) for o in _exec_get(hid).outputs]


def exec_free(hid):
    _executors.pop(hid)


# ---------------------------------------------------------------------------
# DataIter C API backing (src/c_api.cc — the reference's
# c_api.cc:446-543 MXListDataIters/MXDataIterCreateIter/Next/GetData/
# GetLabel/GetPadNum/BeforeFirst/Free).  String attrs are parsed with
# literal_eval (the reference's param-spec string parsing), so a C
# consumer writes batch_size="8", data_shape="(3, 64, 64)".
# ---------------------------------------------------------------------------

_dataiters = _HandleRegistry()

# iterators creatable from string params alone (file-backed; the
# array-backed NDArrayIter needs live buffers and stays Python-only,
# matching the reference where it is a Python-side class too)
_C_ITER_NAMES = ("MNISTIter", "CSVIter", "ImageRecordIter",
                 "ImageDetRecordIter")


def iter_list():
    return list(_C_ITER_NAMES)


# params that are strings by contract: a shard file named '123' must not
# become the int 123 (the reference parses against typed param specs)
_STR_ATTRS = frozenset((
    "data_csv", "label_csv", "image", "label", "path_imgrec",
    "path_imglist", "path_imgidx", "path_root", "mean_img", "data_name",
    "label_name"))


def _parse_attr(k, v):
    import ast

    if k in _STR_ATTRS:
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def iter_create(name, keys, vals):
    from . import image as image_mod
    from . import io as io_mod

    if name not in _C_ITER_NAMES:
        raise ValueError("unknown data iterator %r (have: %s)"
                         % (name, ", ".join(_C_ITER_NAMES)))
    cls = getattr(io_mod, name, None) or getattr(image_mod, name)
    kwargs = {k: _parse_attr(k, v) for k, v in zip(keys, vals)}
    return _dataiters.put({"iter": cls(**kwargs), "batch": None})


def _iter_get(hid):
    return _dataiters.get(hid, "DataIter")


def iter_next(hid):
    rec = _iter_get(hid)
    try:
        rec["batch"] = rec["iter"].next()
        return 1
    except StopIteration:
        rec["batch"] = None
        return 0


def iter_before_first(hid):
    rec = _iter_get(hid)
    rec["batch"] = None
    rec["iter"].reset()


def _iter_batch(hid):
    batch = _iter_get(hid)["batch"]
    if batch is None:
        raise RuntimeError("no current batch: call DataIterNext first")
    return batch


def iter_get_data(hid):
    return _nd_put(_iter_batch(hid).data[0])


def iter_get_label(hid):
    return _nd_put(_iter_batch(hid).label[0])


def iter_get_pad(hid):
    return int(_iter_batch(hid).pad or 0)


def iter_free(hid):
    _dataiters.pop(hid)


# ---------------------------------------------------------------------------
# KVStore C API backing (src/c_api.cc — the reference's c_api.cc:544-700
# MXKVStoreCreate/Init/Push/Pull/GetType/GetRank/GetGroupSize/Barrier).
# The C updater callback (MXKVStoreSetUpdater) is not exposed: on this
# framework the updater is the server-side optimizer (set via Python or
# the launcher), and the local kvstore's default is summing — matching
# how Module drives it.
# ---------------------------------------------------------------------------

_kvstores = _HandleRegistry()


def kv_create(kv_type):
    from . import kvstore

    return _kvstores.put(kvstore.create(kv_type))


def _kv_get(hid):
    return _kvstores.get(hid, "KVStore")


def kv_free(hid):
    try:
        kv = _kv_get(hid)
    except KeyError:
        return
    if hasattr(kv, "close"):
        try:
            kv.close()
        except Exception:
            pass
    _kvstores.pop(hid)


def kv_init(hid, keys, nd_hids):
    kv = _kv_get(hid)
    kv.init(list(keys), [_nd_get(h) for h in nd_hids])


def kv_push(hid, keys, nd_hids):
    kv = _kv_get(hid)
    kv.push(list(keys), [_nd_get(h) for h in nd_hids])


def kv_pull(hid, keys, nd_hids):
    """Pull INTO the caller's existing NDArray handles (reference
    MXKVStorePull semantics: out buffers are caller-provided)."""
    kv = _kv_get(hid)
    kv.pull(list(keys), out=[_nd_get(h) for h in nd_hids])


def kv_type(hid):
    return _kv_get(hid).type


def kv_rank(hid):
    return int(_kv_get(hid).rank)


def kv_group_size(hid):
    return int(_kv_get(hid).num_workers)


def kv_barrier(hid):
    _kv_get(hid)._barrier()


# ---------------------------------------------------------------------------
# Round-5 breadth: C-side graph building (reference c_api_symbolic.cc
# MXSymbolCreateVariable/CreateAtomicSymbol/Compose), NDArray views
# (c_api.cc MXNDArraySlice/Reshape/GetContext, CopyFromTo), executor
# reshape, version/seed.
# ---------------------------------------------------------------------------


def sym_variable(name):
    from . import symbol

    return _symbols.put(symbol.Variable(name))


class _PendingAtomic:
    """CreateAtomicSymbol's result before Compose wires its inputs —
    mirrors the reference's uncomposed nnvm node."""

    def __init__(self, op, attrs):
        self.op = op
        self.attrs = attrs


def sym_atomic(op_name, keys, vals):
    return _symbols.put(_PendingAtomic(op_name, dict(zip(keys, vals))))


def sym_compose(hid, name, keys, arg_hids):
    """Wire inputs into a symbol IN PLACE (the reference composes the
    same handle). Atomic handles become real symbols by calling the op;
    already-real symbols (e.g. loaded from JSON) have their free
    variables substituted via Symbol.compose. keys empty -> positional
    (atomic: the op's input order; real: list_arguments order)."""
    from . import symbol

    target = _symbols.get(hid, "Symbol")
    args = [_sym_get(h) for h in arg_hids]
    if isinstance(target, _PendingAtomic):
        op = getattr(symbol, target.op, None)
        if op is None:
            raise ValueError("unknown operator %r" % target.op)
        attrs = dict(target.attrs)
        if name:
            attrs.setdefault("name", name)
        if keys:
            composed = op(**dict(zip(keys, args)), **attrs)
        else:
            composed = op(*args, **attrs)
    else:
        # delegate to Symbol.__call__ so the positional mapping (and its
        # arity validation) lives in exactly one place
        composed = (target(**dict(zip(keys, args))) if keys
                    else target(*args))
    _symbols.replace(hid, composed)


def nd_slice(hid, begin, end):
    arr = _nd_get(hid)
    begin, end = int(begin), int(end)
    if not 0 <= begin <= end <= arr.shape[0]:
        # the reference MXNDArraySlice CHECKs the range; numpy's silent
        # clamping would hand a C caller a wrong-sized array
        raise ValueError("invalid slice [%d, %d) for axis-0 extent %d"
                         % (begin, end, arr.shape[0]))
    return _nd_put(arr[begin:end])


def nd_reshape(hid, dims):
    return _nd_put(_nd_get(hid).reshape(tuple(int(d) for d in dims)))


def nd_context(hid):
    ctx = _nd_get(hid).context
    return int(ctx.device_typeid), int(ctx.device_id)


def nd_copyfromto(src_hid, dst_hid):
    _nd_get(src_hid).copyto(_nd_get(dst_hid))


def exec_reshape(hid, keys, shapes):
    ex = _executors.get(hid, "Executor")
    new = ex.reshape(**{k: tuple(int(d) for d in s)
                        for k, s in zip(keys, shapes)})
    return _executors.put(new)


def random_seed(seed):
    from . import random as rnd

    rnd.seed(int(seed))


def version():
    from . import __version__

    return str(__version__)
