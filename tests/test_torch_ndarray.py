"""The imperative ``mt.nd`` surface against ``mxnet_tpu.nd`` on the CPU:
every op of the elementwise tables (unary, binary, comparison, scalar,
broadcast, reduce) on identical numpy inputs from a seed, the NDArray
methods and operators, the creation functions, and ``_invoke``'s rules
(context, ``out=``, variadic inputs, results that never alias inputs).

Tolerance: 1e-5 relative with a 1e-6 floor for transcendental functions
(float32 libm in torch against XLA's own expansions); the rest exact."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.ops.elemwise as jelem
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import get_op as jget_op
from mxnet_tpu_torch.ops import get_op

RTOL, ATOL = 1e-5, 1e-6
_POS = ("log", "log10", "log2", "sqrt", "rsqrt", "gamma", "gammaln")
_UNIT = ("arccos", "arcsin", "arctanh")
_HALVES = ("round", "rint", "fix", "floor", "ceil", "sign")


def _unary_input(name, rng):
    if name in _POS:
        return rng.uniform(0.5, 3.0, (4, 5))
    if name in _UNIT:
        return rng.uniform(-0.9, 0.9, (4, 5))
    if name == "arccosh":
        return rng.uniform(1.1, 3.0, (4, 5))
    if name == "log1p":
        return rng.uniform(-0.5, 2.0, (4, 5))
    if name == "tan":
        return rng.uniform(-1.2, 1.2, (4, 5))
    if name in _HALVES:
        return np.concatenate([np.arange(-2.5, 2.6, 0.5)[:10],
                               rng.uniform(-3, 3, 10)]).reshape(4, 5)
    return rng.uniform(-2.0, 2.0, (4, 5))


def _close(got, ref, exact=False):
    got, ref = got.asnumpy(), np.asarray(ref.asnumpy())
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _pair(arrays):
    return ([mx.nd.array(a) for a in arrays],
            [mt.nd.array(a, mt.cpu()) for a in arrays])


def _run(name, arrays, **attrs):
    (jin, tin) = _pair([np.asarray(a, np.float32) for a in arrays])
    return (getattr(mt.nd, name)(*tin, **attrs),
            getattr(mx.nd, name)(*jin, **attrs))


@pytest.mark.parametrize("name", sorted(jelem._UNARY))
def test_unary(name):
    x = _unary_input(name, np.random.RandomState(0))
    _close(*_run(name, [x]))


_BIN_RHS_NONZERO = ("elemwise_div", "_mod", "broadcast_div", "broadcast_mod")


@pytest.mark.parametrize("name", sorted(jelem._BINARY) + sorted(jelem._COMPARE))
def test_binary_and_compare(name):
    rng = np.random.RandomState(1)
    if name in jelem._COMPARE:
        lhs, rhs = (rng.randint(0, 3, (3, 4)) for _ in range(2))
    else:
        lhs, rhs = rng.uniform(-2, 2, (3, 4)), rng.uniform(-2, 2, (3, 4))
    if name == "_power":
        lhs = np.abs(lhs) + 0.1
    if name in _BIN_RHS_NONZERO:
        rhs = np.sign(rhs) * (np.abs(rhs) + 0.5)
    _close(*_run(name, [lhs, rhs]), exact=name in jelem._COMPARE)


@pytest.mark.parametrize("name", sorted(jelem._SCALAR))
def test_scalar(name):
    rng = np.random.RandomState(2)
    x = rng.uniform(-2, 2, (3, 4))
    if name in ("_power_scalar", "_rdiv_scalar", "_rmod_scalar"):
        x = np.sign(x) * (np.abs(x) + 0.5)
    if name == "_power_scalar":
        x = np.abs(x)
    x[0, 0] = 1.5  # an element equal to the scalar
    _close(*_run(name, [x], scalar=1.5))


@pytest.mark.parametrize("name", sorted(jelem._BROADCAST)
                         + sorted(jelem._BROADCAST_CMP))
def test_broadcast(name):
    rng = np.random.RandomState(3)
    lhs, rhs = rng.uniform(-2, 2, (3, 1, 4)), rng.uniform(-2, 2, (1, 5, 4))
    if name in jelem._BROADCAST_CMP:
        lhs, rhs = np.round(lhs), np.round(rhs)
    if name == "broadcast_power":
        lhs = np.abs(lhs) + 0.1
    if name in _BIN_RHS_NONZERO:
        rhs = np.sign(rhs) * (np.abs(rhs) + 0.5)
    _close(*_run(name, [lhs, rhs]))


_REDUCE_ATTRS = [{}, {"axis": 1}, {"axis": (0, 2)}, {"axis": 1, "keepdims": True},
                 {"axis": (0,), "exclude": True}, {"keepdims": True}]


@pytest.mark.parametrize("attrs", _REDUCE_ATTRS,
                         ids=["all", "axis1", "axis02", "keep", "exclude",
                              "all-keep"])
@pytest.mark.parametrize("name", sorted(jelem._REDUCE))
def test_reduce(name, attrs):
    x = np.random.RandomState(4).uniform(0.5, 1.5, (3, 4, 5))
    if name.startswith("nan"):
        x[1, 2, 3] = np.nan
    _close(*_run(name, [x], **attrs))


@pytest.mark.parametrize("attrs", [{}, {"axis": 1}, {"axis": -1,
                                                      "keepdims": True}])
@pytest.mark.parametrize("name", ["argmax", "argmin"])
def test_argreduce(name, attrs):
    x = np.random.RandomState(5).randn(3, 4, 5)
    _close(*_run(name, [x], **attrs), exact=True)


@pytest.mark.parametrize("name,attrs", [
    ("softmax", {}), ("softmax", {"axis": 0, "temperature": 2.0}),
    ("log_softmax", {"axis": 1}), ("smooth_l1", {"scalar": 2.0}),
    ("make_loss", {"grad_scale": 3.0}), ("BlockGrad", {}), ("_copy", {}),
    ("identity", {}), ("_CrossDeviceCopy", {}), ("norm", {}),
    ("argmax_channel", {}), ("broadcast_axis", {"axis": 1, "size": 3}),
    ("broadcast_to", {"shape": (0, 3, 2)}), ("_broadcast", {"axis": 1,
                                                            "size": 3}),
])
def test_other_elemwise_ops(name, attrs):
    x = np.random.RandomState(6).randn(4, 1, 2)
    if name not in ("broadcast_axis", "broadcast_to", "_broadcast"):
        x = x.reshape(4, 2)
    _close(*_run(name, [x], **attrs))


def test_add_n_counts_its_inputs():
    rng = np.random.RandomState(7)
    xs = [rng.randn(2, 3) for _ in range(3)]
    got, ref = _run("add_n", xs)
    _close(got, ref)
    _close(*_run("ElementWiseSum", xs[:2]))


def test_same_names_aliases_params_and_hints():
    """Every name of the JAX package's elementwise tables (aliases
    included) is an op of the port with the same params and hint, and an
    alias names the same op."""
    names = set()
    for table in (jelem._UNARY, jelem._BINARY, jelem._COMPARE, jelem._SCALAR,
                  jelem._BROADCAST, jelem._BROADCAST_CMP, jelem._REDUCE):
        names |= set(table)
    for aliases in (jelem._BINARY_ALIASES, jelem._SCALAR_ALIASES,
                    jelem._BROADCAST_ALIASES, jelem._REDUCE_ALIASES):
        for v in aliases.values():
            names |= set(v)
    names |= {"_copy", "identity", "_copyto", "_CrossDeviceCopy", "_broadcast",
              "BlockGrad", "stop_gradient", "make_loss", "softmax",
              "log_softmax", "smooth_l1", "broadcast_axis", "broadcast_axes",
              "broadcast_to", "argmax", "argmin", "argmax_channel", "norm",
              "add_n", "ElementWiseSum", "_sum", "Equal", "GreaterEqual"}
    for name in sorted(names):
        top, jop = get_op(name), jget_op(name)
        assert top.name == jop.name, name
        assert top.hint == jop.hint, name
        assert sorted(top.params) == sorted(jop.params), name
        assert top.key_var_num_args == jop.key_var_num_args, name
        assert hasattr(mt.nd, name) and hasattr(mt.sym, name), name


# ---------------------------------------------------------------------------
# NDArray methods and operators
# ---------------------------------------------------------------------------


def _arrays():
    rng = np.random.RandomState(8)
    a = rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32)
    return a, b, _pair([a, b])


@pytest.mark.parametrize("expr", [
    "a + b", "a - b", "a * b", "a / b", "a % b", "a ** b",
    "a + 2", "2 + a", "a - 2", "2 - a", "a * 3", "3 * a", "a / 4", "4 / a",
    "a % 0.7", "3 % a", "a ** 2", "2 ** a", "-a", "abs(-a)",
    "a == b", "a != b", "a > b", "a >= b", "a < b", "a <= b",
    "a == a", "a > 1", "a <= 1", "a == 1.0", "a != 1.0",
])
def test_operators(expr):
    _, _, ((ja, jb), (ta, tb)) = _arrays()
    got = eval(expr, {"a": ta, "b": tb})
    ref = eval(expr, {"a": ja, "b": jb})
    _close(got, ref)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_inplace_operators_write_the_same_tensor(op):
    a, b, ((ja, jb), (ta, tb)) = _arrays()
    storage = ta._data.data_ptr()
    view = ta[0]
    exec("ta %s tb" % op, {"ta": ta, "tb": tb})
    exec("ja %s jb" % op, {"ja": ja, "jb": jb})
    _close(ta, ja)
    assert ta._data.data_ptr() == storage
    np.testing.assert_array_equal(view.asnumpy(), ta.asnumpy()[0])


def test_methods_match_jax():
    a, _, ((ja, _), (ta, _)) = _arrays()
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    jx, tx = mx.nd.array(x), mt.nd.array(x, mt.cpu())
    for shape in [(6, 4), (0, -1), (-1,), (-3, 4), (2, -4, 1, 3, 4), (2, -2)]:
        _close(tx.reshape(shape), jx.reshape(shape), exact=True)
    _close(tx.T, jx.T, exact=True)
    _close(tx.slice(1, 2), jx.slice(1, 2), exact=True)
    _close(ta.broadcast_to((3, 2, 3)), ja.broadcast_to((3, 2, 3)), exact=True)
    _close(ta.astype("float16"), ja.astype("float16"), exact=True)
    _close(ta.astype(np.int32), ja.astype(np.int32), exact=True)
    assert ta.astype("bfloat16").dtype == "bfloat16"
    assert (len(tx), tx.ndim, tx.size) == (len(jx), jx.ndim, jx.size)
    assert [r.shape for r in tx] == [r.shape for r in jx]
    assert mt.nd.array([3.5], mt.cpu()).asscalar() == 3.5
    assert bool(mt.nd.array([1.0], mt.cpu())) and \
        not bool(mt.nd.array([0.0], mt.cpu()))
    with pytest.raises(ValueError):
        bool(ta)
    with pytest.raises(ValueError):
        ta.broadcast_to((3, 4))
    assert (ta == None) is False and (ta != None) is True  # noqa: E711


def test_views_and_copies():
    """reshape, T, slice and indexing are views of the parent's storage
    (the reference's semantics); astype, copy and copyto are copies."""
    t = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), mt.cpu())
    r, s, tt = t.reshape((3, 2)), t.slice(0, 1), t.T
    c, cast = t.copy(), t.astype(np.float32)
    t[:] = 7.0
    for v in (r, s, tt):
        assert (v.asnumpy() == 7.0).all()
    for v in (c, cast):
        assert v.asnumpy()[1, 2] == 5.0
    dst = mt.nd.zeros((2, 3), mt.cpu(), dtype="float16")
    assert t.copyto(dst) is dst and dst.dtype == np.float16
    assert (dst.asnumpy() == 7.0).all()
    moved = t.copyto(mt.cpu())
    assert moved is not t and moved.context == mt.cpu()
    with pytest.raises(ValueError):
        t.copyto(mt.nd.zeros((3, 2), mt.cpu()))
    host = t.asnumpy()
    host[0, 0] = -1.0
    assert t.asnumpy()[0, 0] == 7.0  # asnumpy is a copy


def test_op_results_never_alias_inputs():
    t = mt.nd.array(np.ones((2, 3), np.float32), mt.cpu())
    outs = [mt.nd._copy(t), mt.nd.Reshape(t, shape=(3, 2)),
            mt.nd.BlockGrad(t), mt.nd.broadcast_to(t, shape=(2, 3))]
    t[:] = 5.0
    for o in outs:
        assert (o.asnumpy() == 1.0).all()


def test_creation_functions_match_jax():
    c = mt.cpu()
    pairs = [
        (mt.nd.ones((2, 3), c), mx.nd.ones((2, 3))),
        (mt.nd.ones(4, c, dtype="int32"), mx.nd.ones(4, dtype="int32")),
        (mt.nd.full((2, 2), 3.5, c), mx.nd.full((2, 2), 3.5)),
        (mt.nd.arange(5, ctx=c), mx.nd.arange(5)),
        (mt.nd.arange(1, 4, 0.5, repeat=2, ctx=c),
         mx.nd.arange(1, 4, 0.5, repeat=2)),
        (mt.nd.arange(0, 6, 2, ctx=c, dtype="int32"),
         mx.nd.arange(0, 6, 2, dtype="int32")),
    ]
    for got, ref in pairs:
        _close(got, ref, exact=True)
        assert got.context == c
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    (jx, jy), (tx, ty) = _pair([x, x + 100])
    for axis in (0, 1, 2):
        _close(mt.nd.concatenate([tx, ty], axis=axis),
               mx.nd.concatenate([jx, jy], axis=axis), exact=True)
    _close(mt.nd.moveaxis(tx, 0, 2), mx.nd.moveaxis(jx, 0, 2), exact=True)
    idx = np.array([0, 2, 5, 1], np.float32)
    tout, jout = mt.nd.zeros((4, 3), c), mx.nd.zeros((4, 3))
    assert mt.nd.onehot_encode(mt.nd.array(idx, c), tout) is tout
    mx.nd.onehot_encode(mx.nd.array(idx), jout)
    _close(tout, jout, exact=True)
    mt.nd.waitall()


def test_out_writes_in_place_and_casts():
    a, b, ((ja, jb), (ta, tb)) = _arrays()
    out = mt.nd.zeros((2, 3), mt.cpu())
    ptr = out._data.data_ptr()
    assert mt.nd.elemwise_add(ta, tb, out=out) is out
    assert out._data.data_ptr() == ptr
    np.testing.assert_array_equal(out.asnumpy(), a + b)
    half = mt.nd.zeros((2, 3), mt.cpu(), dtype="float16")
    mt.nd.exp(ta, out=half)
    assert half.dtype == np.float16
    np.testing.assert_allclose(half.asnumpy(), np.exp(a), rtol=1e-3)


def test_array_kwargs_and_context_rules():
    a, b, (_, (ta, tb)) = _arrays()
    got = mt.nd.broadcast_sub(lhs=ta, rhs=tb)
    np.testing.assert_array_equal(got.asnumpy(), a - b)
    got = mt.nd.broadcast_sub(ta, rhs=b)  # a numpy array input
    np.testing.assert_array_equal(got.asnumpy(), a - b)
    assert got.context == mt.cpu()
    # no NDArray input: the ctx attr, else the current context
    on_cpu = mt.nd.exp(b, ctx="cpu(0)")
    assert on_cpu.context == mt.cpu()
    np.testing.assert_allclose(on_cpu.asnumpy(), np.exp(b), rtol=1e-6)
    with mt.cpu():
        assert mt.nd.exp(b).context == mt.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="CUDA"):
            mt.nd.exp(b)  # the default context is gpu(0)


def test_nd_has_a_function_per_registered_op():
    from mxnet_tpu_torch.ops import registered_ops
    from mxnet_tpu_torch.ndarray import _OWN_NAMES

    for name in registered_ops():
        if name not in _OWN_NAMES:
            assert callable(getattr(mt.nd, name)), name
    assert "sum" in mt.nd.__all__ and "_plus_scalar" not in mt.nd.__all__
