"""The C ABI on the port: ``libmxtpu_torch_capi`` (``src/c_api.cc`` and
``src/c_predict_api.cc`` as they are, with ``csrc/capi_common.cc`` driving
``mxnet_tpu_torch.capi_shim``) against the JAX package's
``libmxtpu_capi.so``, on the CPU (``dev_type`` 1).

Each case of ``tests/test_c_api.py`` runs through both libraries in this
process, which both libraries join, from the same inputs, and the two
results are compared: names, shapes, dtypes, error codes and integers
exactly; float32 values within 1e-5 relative (the two packages' products
sum in another order); and each against the port's own Python surface.
The standalone programs (``examples/c_predict/demo.c``, ``demo_symbol.c``,
``examples/cpp/train.cpp``) are compiled against the port's library and
run as processes of their own, which start the interpreter themselves.
The library's build also runs from several processes at once into one
fresh directory, as several test workers run it.
"""
import ctypes
import multiprocessing
import os
import subprocess
import sysconfig
import tempfile

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import native

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RTOL, ATOL = 1e-5, 1e-6


def _open(path):
    lib = ctypes.CDLL(path)
    lib.MXTPUGetLastError.restype = ctypes.c_char_p
    return lib


def _build_jax_lib(folder):
    """The JAX package's C library as ``src/Makefile``'s ``capi`` target
    builds it, into a folder of this test's own (``tests/test_c_api.py``
    builds ``mxnet_tpu/libmxtpu_capi.so`` in place, perhaps in another
    worker at the same time)."""
    out = os.path.join(folder, "libmxtpu_capi.so")
    src = os.path.join(ROOT, "src")
    run = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread",
         "-I", sysconfig.get_paths()["include"],
         "-I", os.path.join(ROOT, "include"), "-shared", "-o", out]
        + [os.path.join(src, f) for f in ("c_predict_api.cc", "c_api.cc",
                                          "capi_common.cc")]
        + ["-L", sysconfig.get_config_var("LIBDIR"),
           "-lpython" + sysconfig.get_config_var("LDVERSION")],
        capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-1500:]
    return out


@pytest.fixture(scope="module")
def jax_so(tmp_path_factory):
    return _build_jax_lib(str(tmp_path_factory.mktemp("jax_capi")))


@pytest.fixture(scope="module")
def libs(jax_so):
    """{"jax": (lib, package), "port": (lib, package)}, each built once."""
    return {"jax": (_open(jax_so), mx),
            "port": (_open(native.capi_lib_path()), mt)}


def _both(libs, case, *args):
    got = case(*libs["port"], *args)
    ref = case(*libs["jax"], *args)
    _same(got, ref)
    return got


def _same(got, ref, path="result"):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _same(got[k], ref[k], "%s[%r]" % (path, k))
    elif isinstance(ref, (list, tuple)) and not isinstance(ref, np.ndarray):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _same(a, b, "%s[%d]" % (path, i))
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape, path
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=path)
    else:
        assert got == ref, (path, got, ref)


def _checkpoint(folder):
    """The JAX test's trained 2-layer MLP checkpoint (both packages read
    its bytes)."""
    np.random.seed(3)
    X = np.random.randn(60, 6).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=10)
    with mx.NameManager():
        net = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(net, num_hidden=8, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2})
    prefix = os.path.join(folder, "m")
    mod.save_checkpoint(prefix, 3)
    return prefix, X


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _checkpoint(str(tmp_path_factory.mktemp("capi_ckpt")))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _predict(lib, pkg, prefix, X):
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read().encode()
    with open(prefix + "-0003.params", "rb") as f:
        params = f.read()
    keys = (ctypes.c_char_p * 2)(b"data", b"softmax_label")
    indptr = (ctypes.c_uint32 * 3)(0, 2, 3)
    shapes = (ctypes.c_uint32 * 3)(10, 6, 10)
    handle = ctypes.c_void_p()
    assert lib.MXTPUPredCreate(sym_json, params, len(params), 1, 0, 2, keys,
                               indptr, shapes, ctypes.byref(handle)) == 0, \
        lib.MXTPUGetLastError()
    data = np.ascontiguousarray(X[:10], np.float32)
    assert lib.MXTPUPredSetInput(handle, b"data", _f32p(data),
                                 data.size) == 0
    assert lib.MXTPUPredForward(handle) == 0
    sdata = ctypes.POINTER(ctypes.c_uint32)()
    ndim = ctypes.c_uint32()
    assert lib.MXTPUPredGetOutputShape(handle, 0, ctypes.byref(sdata),
                                       ctypes.byref(ndim)) == 0
    shape = tuple(sdata[i] for i in range(ndim.value))
    out = np.zeros(shape, np.float32)
    assert lib.MXTPUPredGetOutput(handle, 0, _f32p(out), out.size) == 0
    shapes4 = (ctypes.c_uint32 * 3)(4, 6, 4)
    h4 = ctypes.c_void_p()
    assert lib.MXTPUPredReshape(2, keys, indptr, shapes4, handle,
                                ctypes.byref(h4)) == 0
    d4 = np.ascontiguousarray(X[:4], np.float32)
    assert lib.MXTPUPredSetInput(h4, b"data", _f32p(d4), d4.size) == 0
    assert lib.MXTPUPredForward(h4) == 0
    out4 = np.zeros((4, 2), np.float32)
    assert lib.MXTPUPredGetOutput(h4, 0, _f32p(out4), out4.size) == 0
    assert lib.MXTPUPredFree(h4) == 0
    assert lib.MXTPUPredFree(handle) == 0
    return {"shape": shape, "out": out, "out4": out4}


def test_c_predict_roundtrip(libs, ckpt):
    prefix, X = ckpt
    got = _both(libs, _predict, prefix, X)
    assert got["shape"] == (10, 2)
    pred = mt.Predictor(prefix + "-symbol.json", prefix + "-0003.params",
                        {"data": (10, 6), "softmax_label": (10,)},
                        ctx=mt.cpu())
    want = pred.forward(data=X[:10])[0].asnumpy()
    np.testing.assert_allclose(got["out"], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["out4"], want[:4], rtol=1e-4, atol=ATOL)


def _bad_create(lib, pkg):
    keys = (ctypes.c_char_p * 1)(b"data",)
    indptr = (ctypes.c_uint32 * 2)(0, 2)
    shapes = (ctypes.c_uint32 * 2)(4, 4)
    handle = ctypes.c_void_p()
    rc = lib.MXTPUPredCreate(b"{not json", None, 0, 1, 0, 1, keys, indptr,
                             shapes, ctypes.byref(handle))
    return {"rc": rc, "has_error": len(lib.MXTPUGetLastError()) > 0}


def test_c_predict_error_reporting(libs):
    assert _both(libs, _bad_create) == {"rc": -1, "has_error": True}


def _nd(lib, a):
    h = ctypes.c_void_p()
    shp = (ctypes.c_uint32 * a.ndim)(*a.shape)
    assert lib.MXTPUNDArrayCreate(shp, a.ndim, 1, 0, 0, ctypes.byref(h)) == 0
    assert lib.MXTPUNDArraySyncCopyFromCPU(
        h, a.ctypes.data_as(ctypes.c_void_p), a.nbytes) == 0
    return h


def _read(lib, h, shape):
    out = np.zeros(shape, np.float32)
    assert lib.MXTPUNDArraySyncCopyToCPU(
        h, out.ctypes.data_as(ctypes.c_void_p), out.nbytes) == 0, \
        lib.MXTPUGetLastError()
    return out


def _core(lib, pkg, folder):
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    h = _nd(lib, src)
    ndim = ctypes.c_uint32()
    sdata = ctypes.POINTER(ctypes.c_uint32)()
    assert lib.MXTPUNDArrayGetShape(h, ctypes.byref(ndim),
                                    ctypes.byref(sdata)) == 0
    # returned buffers are the library's until its next call: read them now
    shape = [sdata[i] for i in range(ndim.value)]
    dt = ctypes.c_int()
    assert lib.MXTPUNDArrayGetDType(h, ctypes.byref(dt)) == 0
    n_out = ctypes.c_int()
    outs = ctypes.POINTER(ctypes.c_void_p)()
    ins = (ctypes.c_void_p * 1)(h)
    assert lib.MXTPUImperativeInvoke(
        b"sum", 1, ins, ctypes.byref(n_out), ctypes.byref(outs), 1,
        (ctypes.c_char_p * 1)(b"axis"), (ctypes.c_char_p * 1)(b"1")) == 0
    sum_h = ctypes.c_void_p(outs[0])
    lib.MXTPUFreeHandleArray(outs)
    fname = os.path.join(folder, "%s.params" % pkg.__name__).encode()
    assert lib.MXTPUNDArraySave(fname, 1, ins,
                                (ctypes.c_char_p * 1)(b"w",)) == 0
    with open(fname, "rb") as f:
        saved = f.read()
    n_arr, n_names = ctypes.c_uint32(), ctypes.c_uint32()
    arrs = ctypes.POINTER(ctypes.c_void_p)()
    out_names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXTPUNDArrayLoad(fname, ctypes.byref(n_arr),
                                ctypes.byref(arrs), ctypes.byref(n_names),
                                ctypes.byref(out_names)) == 0
    loaded_h = ctypes.c_void_p(arrs[0])
    lib.MXTPUFreeHandleArray(arrs)
    loaded_name = out_names[0]
    n_ops = ctypes.c_uint32()
    op_names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXTPUListAllOpNames(ctypes.byref(n_ops),
                                   ctypes.byref(op_names)) == 0
    ops = sorted(op_names[i] for i in range(n_ops.value))
    # the library lists its package's registry as it stands (a test run
    # earlier in this process may have registered ops of its own)
    assert ops == [n.encode() for n in pkg.capi_shim.list_op_names()]
    rc = lib.MXTPUImperativeInvoke(b"no_such_op", 1, ins, ctypes.byref(n_out),
                                   ctypes.byref(outs), 0, None, None)
    bad = b"no_such_op" in lib.MXTPUGetLastError()
    res = {"shape": shape, "dtype": dt.value,
           "sum": _read(lib, sum_h, (2,)), "saved": saved,
           "loaded": _read(lib, loaded_h, (2, 3)), "names": loaded_name,
           "n": (n_arr.value, n_names.value),
           "ops": sorted({b"Convolution", b"FullyConnected", b"sum",
                          b"_contrib_FlashAttention"} & set(ops)),
           "bad": (rc, bad)}
    for x in (sum_h, loaded_h, h):
        lib.MXTPUNDArrayFree(x)
    return res


def test_core_c_api_ndarray_and_invoke(libs, tmp_path):
    """NDArray CRUD, invoke with a string attr, save/load (the same file
    bytes from both libraries), the op list (each its package's registry,
    the core names in both) and the error path."""
    got = _both(libs, _core, str(tmp_path))
    assert got["shape"] == [2, 3] and got["dtype"] == 0
    np.testing.assert_array_equal(got["sum"], [3, 12])
    assert len(got["ops"]) == 4
    assert got["bad"] == (-1, True)


def _sym_exec(lib, pkg, json_bytes):
    sym = ctypes.c_void_p()
    assert lib.MXTPUSymbolCreateFromJSON(json_bytes, ctypes.byref(sym)) == 0
    n = ctypes.c_uint32()
    names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXTPUSymbolListArguments(sym, ctypes.byref(n),
                                        ctypes.byref(names)) == 0
    arg_names = [names[i].decode() for i in range(n.value)]
    assert lib.MXTPUSymbolListOutputs(sym, ctypes.byref(n),
                                      ctypes.byref(names)) == 0
    out_names = [names[i].decode() for i in range(n.value)]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u32pp = ctypes.POINTER(u32p)
    sizes = [ctypes.c_uint32() for _ in range(3)]
    ndims = [u32p() for _ in range(3)]
    datas = [u32pp() for _ in range(3)]
    complete = ctypes.c_int()

    def infer(k, keys, indptr, sdata):
        assert lib.MXTPUSymbolInferShape(
            sym, k, keys, indptr, sdata,
            *[ctypes.byref(x) for i in range(3)
              for x in (sizes[i], ndims[i], datas[i])],
            ctypes.byref(complete)) == 0, lib.MXTPUGetLastError()
        return complete.value, [[tuple(datas[j][i][d]
                                       for d in range(ndims[j][i]))
                                 for i in range(sizes[j].value)]
                                for j in range(2)]
    done, (arg_shapes, out_shapes) = infer(
        1, (ctypes.c_char_p * 1)(b"data"), (ctypes.c_uint32 * 2)(0, 2),
        (ctypes.c_uint32 * 2)(5, 7))
    rng = np.random.RandomState(7)
    arrays = [rng.randn(*s).astype(np.float32) * 0.3 for s in arg_shapes]
    arg_h = [_nd(lib, a) for a in arrays]
    grad_h = [_nd(lib, np.zeros_like(a)) for a in arrays]
    ex = ctypes.c_void_p()
    assert lib.MXTPUExecutorBind(
        sym, 1, 0, len(arg_h), (ctypes.c_void_p * len(arg_h))(
            *[h.value for h in arg_h]),
        (ctypes.c_void_p * len(grad_h))(*[h.value for h in grad_h]),
        (ctypes.c_uint32 * len(arg_h))(*([1] * len(arg_h))), 0, None,
        ctypes.byref(ex)) == 0, lib.MXTPUGetLastError()
    assert lib.MXTPUExecutorForward(ex, 1) == 0
    n_out = ctypes.c_uint32()
    outs = ctypes.POINTER(ctypes.c_void_p)()
    assert lib.MXTPUExecutorOutputs(ex, ctypes.byref(n_out),
                                    ctypes.byref(outs)) == 0
    out = _read(lib, ctypes.c_void_p(outs[0]), (5, 3))
    head_h = _nd(lib, rng.randn(5, 3).astype(np.float32))
    assert lib.MXTPUExecutorBackward(
        ex, 1, (ctypes.c_void_p * 1)(head_h.value)) == 0, \
        lib.MXTPUGetLastError()
    grads = [_read(lib, h, a.shape) for h, a in zip(grad_h, arrays)]
    partial, _ = infer(0, None, (ctypes.c_uint32 * 1)(0), None)
    for i in range(n_out.value):
        lib.MXTPUNDArrayFree(ctypes.c_void_p(outs[i]))
    lib.MXTPUFreeHandleArray(outs)
    for h in arg_h + grad_h + [head_h]:
        lib.MXTPUNDArrayFree(h)
    lib.MXTPUExecutorFree(ex)
    lib.MXTPUSymbolFree(sym)
    return {"args": arg_names, "outs": out_names, "complete": (done, partial),
            "arg_shapes": arg_shapes, "out_shapes": out_shapes, "out": out,
            "grads": grads}


def test_c_symbol_executor_surface(libs):
    with mt.NameManager():
        net = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(net, num_hidden=4, name="fc1")
        net = mt.sym.Activation(net, act_type="tanh")
        net = mt.sym.FullyConnected(net, num_hidden=3, name="fc2")
    got = _both(libs, _sym_exec, net.tojson().encode())
    assert got["args"] == net.list_arguments()
    assert got["complete"] == (1, 0)


def _run_prog(lib_path, src, run_args, compiler="gcc", std=None,
              timeout=300):
    libdir = sysconfig.get_config_var("LIBDIR")
    with tempfile.TemporaryDirectory() as d:
        exe = os.path.join(d, "prog")
        cmd = [compiler, "-O2"] + (["-std=" + std] if std else []) + [
            os.path.join(ROOT, src), "-I", os.path.join(ROOT, "include"),
            lib_path, "-Wl,-rpath," + libdir, "-o", exe]
        res = subprocess.run(cmd, capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-1200:]
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
        run = subprocess.run([exe] + run_args, capture_output=True,
                             text=True, timeout=timeout, env=env)
    assert run.returncode == 0, (run.stdout, run.stderr[-2000:])
    return run.stdout


@pytest.mark.parametrize("demo", ["demo.c", "demo_symbol.c"])
def test_standalone_c_demos_against_the_port(jax_so, ckpt, demo):
    """The demo compiled against each library: the same printed row
    (a softmax row), from a process that starts with no interpreter."""
    prefix, _ = ckpt
    src = os.path.join("examples", "c_predict", demo)
    args = [prefix, "3", "10", "6"]
    got = np.array([float(v) for v in _run_prog(
        native.capi_lib_path(), src, args).strip().split(",")])
    ref = np.array([float(v) for v in _run_prog(
        jax_so, src, args).strip().split(",")])
    assert got.shape == (2,) and abs(got.sum() - 1.0) < 1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_cpp_frontend_against_the_port():
    out = _run_prog(native.capi_lib_path(),
                    os.path.join("examples", "cpp", "train.cpp"), [],
                    compiler="g++", std="c++17")
    assert "cpp frontend ok" in out


def _dataiter(lib, pkg, folder):
    rng = np.random.RandomState(11)
    data_csv = os.path.join(folder, "d.csv")
    label_csv = os.path.join(folder, "l.csv")
    if not os.path.exists(data_csv):
        np.savetxt(data_csv, rng.randn(10, 6).astype(np.float32),
                   delimiter=",")
        np.savetxt(label_csv, (np.arange(10) % 3).astype(np.float32)
                   .reshape(10, 1), delimiter=",")
    n = ctypes.c_uint32()
    names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXTPUListDataIters(ctypes.byref(n), ctypes.byref(names)) == 0
    iters = sorted(names[i] for i in range(n.value))
    keys = (ctypes.c_char_p * 5)(b"data_csv", b"label_csv", b"data_shape",
                                 b"label_shape", b"batch_size")
    vals = (ctypes.c_char_p * 5)(data_csv.encode(), label_csv.encode(),
                                 b"(6,)", b"(1,)", b"4")
    it = ctypes.c_void_p()
    assert lib.MXTPUDataIterCreate(b"CSVIter", 5, keys, vals,
                                   ctypes.byref(it)) == 0, \
        lib.MXTPUGetLastError()

    def drain():
        got = []
        more, pad = ctypes.c_int(), ctypes.c_int()
        while True:
            assert lib.MXTPUDataIterNext(it, ctypes.byref(more)) == 0
            if not more.value:
                return got
            dh, lh = ctypes.c_void_p(), ctypes.c_void_p()
            assert lib.MXTPUDataIterGetData(it, ctypes.byref(dh)) == 0
            assert lib.MXTPUDataIterGetLabel(it, ctypes.byref(lh)) == 0
            assert lib.MXTPUDataIterGetPadNum(it, ctypes.byref(pad)) == 0
            got.append((_read(lib, dh, (4, 6)), _read(lib, lh, (4, 1)),
                        pad.value))
            lib.MXTPUNDArrayFree(dh)
            lib.MXTPUNDArrayFree(lh)
    first = drain()
    assert lib.MXTPUDataIterBeforeFirst(it) == 0
    again = drain()
    bad = ctypes.c_void_p()
    rc = lib.MXTPUDataIterCreate(b"NoSuchIter", 0, None, None,
                                 ctypes.byref(bad))
    err = b"NoSuchIter" in lib.MXTPUGetLastError()
    lib.MXTPUDataIterFree(it)
    return {"iters": iters, "first": first, "again": again,
            "bad": (rc, err)}


def test_c_dataiter_surface(libs, tmp_path):
    got = _both(libs, _dataiter, str(tmp_path))
    assert len(got["first"]) == 3 and got["first"][-1][2] == 2
    assert got["bad"] == (-1, True)
    py = [b.data[0].asnumpy() for b in mt.io.CSVIter(
        data_csv=str(tmp_path / "d.csv"), label_csv=str(tmp_path / "l.csv"),
        data_shape=(6,), label_shape=(1,), batch_size=4)]
    for (d, _, _), w in zip(got["first"], py):
        np.testing.assert_array_equal(d, w)


def _kvstore(lib, pkg):
    kv = ctypes.c_void_p()
    assert lib.MXTPUKVStoreCreate(b"local", ctypes.byref(kv)) == 0
    tp = ctypes.c_char_p()
    assert lib.MXTPUKVStoreGetType(kv, ctypes.byref(tp)) == 0
    rank, size = ctypes.c_int(), ctypes.c_int()
    assert lib.MXTPUKVStoreGetRank(kv, ctypes.byref(rank)) == 0
    assert lib.MXTPUKVStoreGetGroupSize(kv, ctypes.byref(size)) == 0
    wh = _nd(lib, np.arange(6, dtype=np.float32).reshape(2, 3))
    gh = _nd(lib, np.ones((2, 3), np.float32))
    keys = (ctypes.c_int * 1)(3)
    assert lib.MXTPUKVStoreInit(kv, 1, keys, (ctypes.c_void_p * 1)(wh.value)) \
        == 0
    for _ in range(2):
        assert lib.MXTPUKVStorePush(kv, 1, keys,
                                    (ctypes.c_void_p * 1)(gh.value)) == 0
    outh = _nd(lib, np.zeros((2, 3), np.float32))
    assert lib.MXTPUKVStorePull(kv, 1, keys,
                                (ctypes.c_void_p * 1)(outh.value)) == 0
    got = _read(lib, outh, (2, 3))
    barrier = lib.MXTPUKVStoreBarrier(kv)
    for h in (wh, gh, outh):
        lib.MXTPUNDArrayFree(h)
    return {"type": tp.value, "rank": rank.value, "size": size.value,
            "pulled": got, "barrier": barrier,
            "free": lib.MXTPUKVStoreFree(kv)}


def test_c_kvstore_surface(libs):
    got = _both(libs, _kvstore)
    assert got["type"] == b"local" and (got["rank"], got["size"]) == (0, 1)
    np.testing.assert_array_equal(got["pulled"], np.ones((2, 3)))


def _graph(lib, pkg):
    err = lib.MXTPUGetLastError
    out = ctypes.c_char_p()
    assert lib.MXTPUGetVersion(ctypes.byref(out)) == 0
    version = out.value.decode()
    assert lib.MXTPURandomSeed(7) == 0
    data, fc = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.MXTPUSymbolCreateVariable(b"data", ctypes.byref(data)) == 0
    assert lib.MXTPUSymbolCreateAtomicSymbol(
        b"FullyConnected", 2, (ctypes.c_char_p * 2)(b"num_hidden",
                                                    b"no_bias"),
        (ctypes.c_char_p * 2)(b"3", b"True"), ctypes.byref(fc)) == 0
    ckeys = (ctypes.c_char_p * 1)(b"data")
    args = (ctypes.c_void_p * 1)(data)
    assert lib.MXTPUSymbolCompose(fc, b"fc0", 1, ckeys, args) == 0, err()
    n = ctypes.c_uint32()
    names = ctypes.POINTER(ctypes.c_char_p)()
    assert lib.MXTPUSymbolListArguments(fc, ctypes.byref(n),
                                        ctypes.byref(names)) == 0
    arg_names = [names[i].decode() for i in range(n.value)]
    rng = np.random.RandomState(0)
    xv = rng.randn(4, 6).astype(np.float32)
    wv = rng.randn(3, 6).astype(np.float32)
    hx, hw = _nd(lib, xv), _nd(lib, wv)
    handles = (ctypes.c_void_p * 2)(hx, hw)
    ex = ctypes.c_void_p()
    assert lib.MXTPUExecutorBind(fc, 1, 0, 2, handles, None, None, 0, None,
                                 ctypes.byref(ex)) == 0, err()
    assert lib.MXTPUExecutorForward(ex, 0) == 0, err()
    n_out = ctypes.c_uint32()
    outs = ctypes.POINTER(ctypes.c_void_p)()
    assert lib.MXTPUExecutorOutputs(ex, ctypes.byref(n_out),
                                    ctypes.byref(outs)) == 0
    fwd = _read(lib, ctypes.c_void_p(outs[0]), (4, 3))
    hs, hr = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.MXTPUNDArraySlice(hx, 1, 3, ctypes.byref(hs)) == 0
    assert lib.MXTPUNDArrayReshape(hx, 2, (ctypes.c_int * 2)(8, 3),
                                   ctypes.byref(hr)) == 0
    dt, di = ctypes.c_int(), ctypes.c_int()
    assert lib.MXTPUNDArrayGetContext(hx, ctypes.byref(dt),
                                      ctypes.byref(di)) == 0
    hc = _nd(lib, np.zeros_like(xv))
    assert lib.MXTPUNDArrayCopyFromTo(hx, hc) == 0
    ex2 = ctypes.c_void_p()
    shape0 = (ctypes.c_uint32 * 2)(2, 6)
    assert lib.MXTPUExecutorReshape(
        ex, 1, ckeys, (ctypes.c_uint32 * 1)(2),
        (ctypes.POINTER(ctypes.c_uint32) * 1)(shape0), ctypes.byref(ex2)) \
        == 0, err()
    assert lib.MXTPUExecutorForward(ex2, 0) == 0, err()
    bad = ctypes.c_void_p()
    assert lib.MXTPUSymbolCreateAtomicSymbol(b"NoSuchOp", 0, None, None,
                                             ctypes.byref(bad)) == 0
    compose_bad = (lib.MXTPUSymbolCompose(bad, b"x", 1, ckeys, args) != 0,
                   b"NoSuchOp" in err())
    list_bad = (lib.MXTPUSymbolListArguments(bad, ctypes.byref(n),
                                             ctypes.byref(names)) != 0,
                b"uncomposed" in err())
    hbad = ctypes.c_void_p()
    slice_bad = (lib.MXTPUNDArraySlice(hx, 0, 100, ctypes.byref(hbad)) != 0,
                 b"invalid slice" in err())
    json_sym, scaled = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.MXTPUSymbolSaveToJSON(fc, ctypes.byref(out)) == 0
    assert lib.MXTPUSymbolCreateFromJSON(out.value,
                                         ctypes.byref(json_sym)) == 0
    assert lib.MXTPUSymbolCreateAtomicSymbol(
        b"_mul_scalar", 1, (ctypes.c_char_p * 1)(b"scalar"),
        (ctypes.c_char_p * 1)(b"2.0"), ctypes.byref(scaled)) == 0
    assert lib.MXTPUSymbolCompose(scaled, b"x2", 1, ckeys, args) == 0, err()
    assert lib.MXTPUSymbolCompose(json_sym, b"", 1, ckeys,
                                  (ctypes.c_void_p * 1)(scaled)) == 0, err()
    ex3 = ctypes.c_void_p()
    assert lib.MXTPUExecutorBind(json_sym, 1, 0, 2, handles, None, None, 0,
                                 None, ctypes.byref(ex3)) == 0, err()
    assert lib.MXTPUExecutorForward(ex3, 0) == 0, err()
    n3 = ctypes.c_uint32()
    outs3 = ctypes.POINTER(ctypes.c_void_p)()
    assert lib.MXTPUExecutorOutputs(ex3, ctypes.byref(n3),
                                    ctypes.byref(outs3)) == 0
    return {"version": version, "args": arg_names, "fwd": fwd,
            "slice": _read(lib, hs, (2, 6)), "reshape": _read(lib, hr, (8, 3)),
            "context": (dt.value, di.value), "copy": _read(lib, hc, (4, 6)),
            "errors": (compose_bad, list_bad, slice_bad),
            "grafted": _read(lib, ctypes.c_void_p(outs3[0]), (4, 3)),
            "x": xv, "w": wv}


def test_c_graph_building_and_views(libs):
    got = _graph(*libs["port"])
    ref = _graph(*libs["jax"])
    assert got.pop("version") == mt.__version__
    assert ref.pop("version") == mx.__version__
    _same(got, ref)
    x, w = got["x"], got["w"]
    assert got["args"] == ["data", "fc0_weight"]
    np.testing.assert_allclose(got["fwd"], x @ w.T, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["slice"], x[1:3])
    np.testing.assert_array_equal(got["reshape"], x.reshape(8, 3))
    assert got["context"] == (1, 0)
    assert got["errors"] == ((True, True),) * 3
    np.testing.assert_allclose(got["grafted"], (2 * x) @ w.T, rtol=1e-4,
                               atol=1e-5)


def _build_into(folder):
    native._BUILD = folder
    return native.capi_lib_path()


def test_concurrent_builds_into_one_directory(tmp_path):
    """Three processes build the library into one empty directory at
    once: each gets the same path, and the library there loads."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(3) as pool:
        paths = pool.map(_build_into, [str(tmp_path)] * 3)
    assert len(set(paths)) == 1 and os.path.dirname(paths[0]) == \
        str(tmp_path)
    assert os.path.basename(paths[0]).startswith("libmxtpu_torch_capi-")
    assert [f for f in os.listdir(tmp_path) if ".build." in f] == []
    _open(paths[0])
