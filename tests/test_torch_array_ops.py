"""The array, indexing, init and ordering ops of the port against the JAX
package's, on the CPU, from identical numpy inputs through both registries
(``mxnet_tpu.ops.get_op`` and ``mxnet_tpu_torch.ops.get_op``):
``transpose``, ``expand_dims``, ``SwapAxis``, ``Cast``, ``slice`` and the
slice assignments, ``clip``, ``repeat``, ``tile``, ``reverse``, ``where``,
``_identity_with_attr_like_rhs``, ``dot``, ``batch_dot``, ``Pad``,
``Crop``, ``batch_take``, ``one_hot``, ``pick``, ``fill_element_0index``,
``sort``, ``argsort``, ``topk`` and the init ops, with every alias, and
the ``sym`` functions over them.

Forward and gradient (``jax.vjp`` against autograd) use the harness of
``tests/test_torch_nn_ops.py``: float32 rtol = atol = 1e-5, bf16 2e-2 of
the largest value.  Discrete outputs (indices, masks, orders) must be equal
exactly, on tie-free inputs and on inputs with repeated values, where
``argsort``'s descending order puts the last of equal values first and
``topk`` the lower index first, as the JAX package does."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OpContext, get_op
from test_torch_nn_ops import _check_case, _f


def _ints(*shape, high):
    """Float arrays of integer indices in [0, high)."""
    return lambda rng: rng.randint(0, high, shape).astype(np.float32)


def _bits(*shape):
    return lambda rng: (rng.rand(*shape) > 0.5).astype(np.float32)


# op name, raw attrs, input makers (every op here has a gradient, or
# returns values whose gradient both packages give as zeros)
CASES = [
    ("transpose", {}, [_f(2, 3, 4)]),
    ("transpose", {"axes": (1, 0, 2)}, [_f(2, 3, 4)]),
    ("expand_dims", {"axis": 1}, [_f(2, 3)]),
    ("expand_dims", {"axis": -1}, [_f(2, 3)]),
    ("SwapAxis", {"dim1": 0, "dim2": 2}, [_f(2, 3, 4)]),
    ("swapaxes", {"dim1": 1, "dim2": 2}, [_f(2, 3, 4)]),
    ("SwapAxes", {}, [_f(2, 3)]),
    ("Cast", {"dtype": "float16"}, [_f(3, 4)]),
    ("cast", {"dtype": "float32"}, [_f(3, 4)]),
    ("slice", {"begin": (0, 1), "end": (2, 3)}, [_f(3, 4)]),
    ("crop", {"begin": (1, 0, 1), "end": (0, 2, -1)}, [_f(3, 4, 5)]),
    ("_slice_assign", {"begin": (1, 1), "end": (3, 3)},
     [_f(4, 5), _f(2, 2)]),
    ("_crop_assign", {"begin": (0, 2), "end": (2, 0)}, [_f(3, 5), _f(2, 3)]),
    ("_crop_assign_scalar", {"begin": (1, 0), "end": (2, 3),
                             "scalar": 2.5}, [_f(3, 4)]),
    ("clip", {"a_min": -0.5, "a_max": 0.7}, [_f(4, 5)]),
    ("repeat", {"repeats": 2}, [_f(2, 3)]),
    ("repeat", {"repeats": 3, "axis": 1}, [_f(2, 3)]),
    ("tile", {"reps": (2, 3)}, [_f(2, 3)]),
    ("tile", {"reps": (2, 1, 2)}, [_f(2, 3)]),
    ("reverse", {"axis": (1,)}, [_f(2, 3, 4)]),
    ("flip", {"axis": (0, 2)}, [_f(2, 3, 4)]),
    ("where", {}, [_bits(3, 4), _f(3, 4), _f(3, 4)]),
    ("_identity_with_attr_like_rhs", {}, [_f(3, 4), _f(3, 4)]),
    ("dot", {}, [_f(3, 4), _f(4, 5)]),
    ("dot", {"transpose_a": True}, [_f(4, 3), _f(4, 5)]),
    ("dot", {"transpose_b": True}, [_f(3, 4), _f(5, 4)]),
    ("dot", {"transpose_a": True, "transpose_b": True},
     [_f(4, 3), _f(5, 4)]),
    ("dot", {}, [_f(4), _f(4)]),
    ("dot", {}, [_f(3, 4), _f(4)]),
    ("dot", {}, [_f(4), _f(4, 2)]),
    ("dot", {}, [_f(2, 3, 4), _f(4, 5)]),
    ("dot", {}, [_f(2, 4), _f(3, 4, 5)]),
    ("dot", {"transpose_a": True}, [_f(4, 3, 2), _f(2, 4, 5)]),
    ("batch_dot", {}, [_f(2, 3, 4), _f(2, 4, 5)]),
    ("batch_dot", {"transpose_a": True, "transpose_b": True},
     [_f(2, 4, 3), _f(2, 5, 4)]),
    ("Pad", {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}, [_f(2, 3, 4, 5)]),
    ("pad", {"pad_width": (0, 0, 1, 0, 2, 2, 0, 3), "constant_value": 1.5},
     [_f(2, 3, 4, 5)]),
    ("Pad", {"pad_width": (0, 0, 0, 0, 2, 1, 1, 3), "mode": "edge"},
     [_f(2, 3, 4, 5)]),
    ("Pad", {"pad_width": (0, 0, 0, 0, 2, 1, 3, 3), "mode": "reflect"},
     [_f(2, 3, 4, 5)]),
    ("Pad", {"pad_width": (1, 1, 2, 0), "mode": "reflect"}, [_f(3, 4)]),
    ("Crop", {"h_w": (3, 2), "offset": (1, 2)}, [_f(2, 3, 5, 6)]),
    ("Crop", {"num_args": 2, "center_crop": True},
     [_f(2, 3, 7, 6), _f(1, 1, 4, 3)]),
    ("batch_take", {}, [_f(4, 5), _ints(4, high=5)]),
    ("one_hot", {"depth": 5}, [_ints(3, 4, high=5)]),
    ("one_hot", {"depth": 4, "on_value": 2.0, "off_value": -1.0},
     [_ints(6, high=4)]),
    ("pick", {}, [_f(3, 5), _ints(3, high=5)]),
    ("pick", {"axis": 0, "keepdims": True}, [_f(4, 3), _ints(3, high=4)]),
    ("choose_element_0index", {}, [_f(4, 6), _ints(4, high=6)]),
    ("pick", {"axis": 1}, [_f(2, 4, 3), _ints(2, 3, high=4)]),
    ("fill_element_0index", {}, [_f(4, 5), _f(4), _ints(4, high=5)]),
    ("sort", {}, [_f(3, 6)]),
    ("sort", {"axis": 0, "is_ascend": False}, [_f(5, 3)]),
    ("sort", {"axis": None}, [_f(3, 4)]),
    ("argsort", {}, [_f(3, 6)]),
    ("argsort", {"axis": 0, "is_ascend": False}, [_f(5, 3)]),
    ("argsort", {"axis": None}, [_f(3, 4)]),
    ("topk", {"k": 3}, [_f(4, 7)]),
    ("topk", {"k": 2, "ret_typ": "value", "axis": 0}, [_f(5, 3)]),
    ("topk", {"k": 2, "ret_typ": "both", "is_ascend": True}, [_f(3, 6)]),
    ("topk", {"k": 3, "ret_typ": "mask", "axis": 1}, [_f(2, 5, 3)]),
    ("topk", {"k": 4, "ret_typ": "both", "axis": None}, [_f(3, 4)]),
    ("topk", {"k": 2, "ret_typ": "mask", "axis": None}, [_f(3, 4)]),
    ("zeros_like", {}, [_f(3, 4)]),
    ("ones_like", {}, [_f(2, 5)]),
]


# every case in both dtypes, but Cast, whose own output dtype is the case
_DTYPED = [(c, dtype) for c in CASES for dtype in ("float32", "bfloat16")
           if dtype == "float32" or c[0] not in ("Cast", "cast")]


@pytest.mark.parametrize("case,dtype", _DTYPED,
                         ids=["%s-%d-%s" % (c[0], CASES.index(c), d)
                              for c, d in _DTYPED])
def test_op_forward_and_gradient_match_jax(case, dtype):
    name, attrs, makers = case
    _check_case(name, attrs, makers, [], dtype)


def _apply_both(name, attrs, inputs):
    """The op's outputs in both packages (numpy) on the same float32
    inputs, forward only."""
    import jax.numpy as jnp

    jop, op = jget_op(name), get_op(name)
    jouts, _ = jop.apply(JOpContext(), jop.parse_attrs(attrs),
                         [jnp.asarray(x) for x in inputs])
    touts, _ = op.apply(OpContext(), op.parse_attrs(attrs),
                        [torch.from_numpy(x) for x in inputs])
    return [np.asarray(j) for j in jouts], [
        t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        for t in touts]


@pytest.mark.parametrize("dtype", ["int32", "uint8", "float16", "bfloat16"])
def test_cast_to_every_dtype_matches_jax(dtype):
    x = np.array([[-2.7, -0.5, 0.0, 0.4, 1.5, 3.99, 200.0, 7.25]],
                 np.float32)
    if dtype == "uint8":
        x = np.abs(x)
    (j,), (t,) = _apply_both("Cast", {"dtype": dtype}, [x])
    (raw,), _ = get_op("Cast").apply(OpContext(), {"dtype": dtype},
                                     [torch.from_numpy(x)])
    assert str(raw.dtype) == "torch." + str(j.dtype)
    np.testing.assert_array_equal(t, j.astype(t.dtype))


# -- ties: orders must be the JAX package's exactly --------------------------

_TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 0.0, 2.0],
                  [5.0, 5.0, 5.0, 5.0, 4.0, 4.0, 6.0, 6.0]], np.float32)


@pytest.mark.parametrize("name,attrs", [
    ("argsort", {}), ("argsort", {"is_ascend": False}),
    ("argsort", {"axis": 0, "is_ascend": False}),
    ("argsort", {"axis": None, "is_ascend": False}),
    ("sort", {"is_ascend": False}),
    ("topk", {"k": 5}), ("topk", {"k": 5, "is_ascend": True}),
    ("topk", {"k": 3, "ret_typ": "both"}),
    ("topk", {"k": 3, "ret_typ": "mask"}),
    ("topk", {"k": 3, "ret_typ": "mask", "is_ascend": True}),
    ("topk", {"k": 6, "axis": None, "ret_typ": "both"}),
    ("topk", {"k": 1, "axis": 0, "is_ascend": True})])
def test_orders_with_ties_match_jax_exactly(name, attrs):
    jouts, touts = _apply_both(name, attrs, [_TIES])
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t, j)


def test_orders_on_tie_free_inputs_match_jax_exactly():
    x = np.random.RandomState(3).permutation(60).reshape(5, 12).astype(
        np.float32)
    for name, attrs in (("argsort", {"is_ascend": False}),
                        ("topk", {"k": 4, "ret_typ": "both"}),
                        ("topk", {"k": 2, "ret_typ": "mask", "axis": 0})):
        jouts, touts = _apply_both(name, attrs, [x])
        for j, t in zip(jouts, touts):
            np.testing.assert_array_equal(t, j)


# -- dot on N-d arrays: the op follows np.dot, as the JAX op does ------------


@pytest.mark.parametrize("a,b,want,inferred", [
    ((2, 4), (3, 4, 5), (2, 3, 5), (2, 4, 5)),
    ((2, 3, 4), (5, 4, 6), (2, 3, 5, 6), (2, 3, 4, 6))])
def test_dot_nd_follows_np_dot_where_the_reference_rule_disagrees(
        a, b, want, inferred):
    """``dot`` contracts lhs's last axis with rhs's second-to-last, as
    ``np.dot`` does, in both packages; their shape rule takes rhs's first
    axis instead (a reference-side defect kept, ROADMAP C): here the rule
    gives ``inferred`` where the op gives ``want``."""
    rng = np.random.RandomState(0)
    xa, xb = (rng.randn(*s).astype(np.float32) for s in (a, b))
    (j,), (t,) = _apply_both("dot", {}, [xa, xb])
    assert j.shape == t.shape == np.dot(xa, xb).shape == want
    np.testing.assert_allclose(t, np.dot(xa, xb), rtol=1e-5, atol=1e-5)
    for op in (jget_op("dot"), get_op("dot")):
        assert tuple(op.infer_shape(op.parse_attrs({}), [a, b])[1][0]) == \
            inferred


# -- the init ops: sources on the op's device --------------------------------

INIT_CASES = [
    ("_zeros", {"shape": (2, 3)}), ("_ones", {"shape": (4,),
                                              "dtype": "int32"}),
    ("_full", {"shape": (2, 2), "value": 3.5, "dtype": "float16"}),
    ("_arange", {"start": 2.0, "stop": 11.0, "step": 1.5}),
    ("_arange", {"start": 5.0, "repeat": 3, "dtype": "int32"}),
    ("_arange", {"start": -1.0, "stop": 1.0, "step": 0.3,
                 "dtype": "float16"}),
    ("_set_value", {"src": 2.25}),
]


@pytest.mark.parametrize("name,attrs", INIT_CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(INIT_CASES)])
def test_init_ops_match_jax(name, attrs):
    import jax.numpy as jnp

    jop, op = jget_op(name), get_op(name)
    (j,), _ = jop.apply(JOpContext(), jop.parse_attrs(attrs), [])
    (t,), _ = op.apply(OpContext(device=torch.device("cpu")),
                       op.parse_attrs(attrs), [])
    j = np.asarray(jnp.asarray(j, j.dtype))
    expect = "float32" if name == "_set_value" else \
        attrs.get("dtype", "float32")
    assert str(t.dtype).replace("torch.", "") == expect
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), j.astype(t.numpy().dtype))
    (m,), _ = op.apply(OpContext(device=torch.device("meta")),
                       op.parse_attrs(attrs), [])
    assert m.is_meta and tuple(m.shape) == j.shape
    if jop.infer_shape is None:  # _set_value: its function is the rule
        assert op.infer_shape is None
    else:
        assert list(op.infer_shape(op.parse_attrs(attrs), [])[1][0]) == \
            list(jop.infer_shape(jop.parse_attrs(attrs), [])[1][0])


@pytest.mark.parametrize("name", [c[0] for c in INIT_CASES[:4]])
def test_source_ops_without_a_device_raise(name):
    op = get_op(name)
    attrs = op.parse_attrs(dict(INIT_CASES)[name])
    with pytest.raises(MXNetError):
        op.apply(OpContext(), attrs, [])


def test_nd_source_ops_place_on_the_context_and_raise_without_cuda():
    cpu = mt.cpu()
    z = mt.nd._zeros(shape=(2, 3), ctx=cpu)
    assert z.context == cpu and z.shape == (2, 3)
    r = mt.nd._arange(start=3.0, ctx=cpu, dtype="int32")
    np.testing.assert_array_equal(r.asnumpy(), np.arange(3))
    if not torch.cuda.is_available():
        for call in (lambda: mt.nd._zeros(shape=(2,)),
                     lambda: mt.nd._full(shape=(2,), value=1.0),
                     lambda: mt.nd._arange(start=3.0)):
            with pytest.raises(MXNetError):
                call()


def test_source_ops_in_a_graph_run_on_the_executors_device():
    """A graph whose only inputs are source ops binds and runs on the
    executor's context, and infers its shapes from the ops' attrs."""
    for pkg in (mx, mt):
        with pkg.NameManager():
            net = pkg.sym.zeros((2, 3)) + pkg.sym.ones((2, 3)) * \
                pkg.sym.Variable("x")
        assert net.infer_shape(x=(2, 3))[1] == [(2, 3)]
    ex = net.bind(mt.cpu(), {"x": mt.nd.array(np.full((2, 3), 4.0),
                                               mt.cpu())})
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                  np.full((2, 3), 4.0))


# -- sym functions over the ops ---------------------------------------------

SYM_FNS = [
    ("zeros", lambda s: s.zeros((2, 3))),
    ("zeros-int", lambda s: s.zeros((4,), dtype="int32", name="z")),
    ("ones", lambda s: s.ones((2, 2))),
    ("arange", lambda s: s.arange(1.0, 7.0, 2.0, repeat=2, name="r")),
    ("arange-start", lambda s: s.arange(5)),
    ("pow-sym", lambda s: s.pow(s.Variable("a"), s.Variable("b"))),
    ("pow-scalar", lambda s: s.pow(s.Variable("a"), 3.0)),
    ("maximum", lambda s: s.maximum(s.Variable("a"), s.Variable("b"))),
    ("maximum-scalar", lambda s: s.maximum(2.0, s.Variable("a"))),
    ("minimum", lambda s: s.minimum(s.Variable("a"), s.Variable("b"))),
    ("minimum-scalar", lambda s: s.minimum(s.Variable("a"), -1.0)),
]


@pytest.mark.parametrize("fn", [f for _, f in SYM_FNS],
                         ids=[n for n, _ in SYM_FNS])
def test_sym_functions_json_is_byte_identical(fn):
    with mx.NameManager():
        jsym = fn(mx.sym)
    with mt.NameManager():
        tsym = fn(mt.sym)
    assert tsym.tojson() == jsym.tojson()


def test_sym_functions_compute_what_the_jax_package_computes():
    a = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    b = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    outs = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            va, vb = pkg.sym.Variable("a"), pkg.sym.Variable("b")
            net = pkg.sym.Group([pkg.sym.maximum(va, vb),
                                 pkg.sym.minimum(va, 0.5),
                                 pkg.sym.pow(pkg.sym.abs(va), 2.0),
                                 pkg.sym.arange(0.0, 4.0) + vb])
        ex = net.bind(pkg.cpu(), {"a": pkg.nd.array(a, pkg.cpu()),
                                  "b": pkg.nd.array(b, pkg.cpu())})
        outs.append([o.asnumpy() for o in ex.forward()])
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_num_gpus_counts_cuda_devices():
    assert mt.num_gpus() == mt.context.num_gpus() == \
        torch.cuda.device_count()


#: a value for each required parameter's type
_REQUIRED = {int: 1, float: 1.0, "shape": (1,), "dtype": "float32"}


@pytest.mark.parametrize("name", [
    "transpose", "expand_dims", "SwapAxis", "swapaxes", "SwapAxes", "Cast",
    "cast", "slice", "crop", "_slice_assign", "_crop_assign",
    "_crop_assign_scalar", "clip", "repeat", "tile", "reverse", "flip",
    "where", "_identity_with_attr_like_rhs", "dot", "batch_dot", "Pad",
    "pad", "Crop", "batch_take", "one_hot", "pick", "choose_element_0index",
    "fill_element_0index", "sort", "argsort", "topk", "_zeros", "_ones",
    "_full", "_arange", "zeros_like", "ones_like", "_set_value"])
def test_op_surface_matches_jax(name):
    """Name, hint, inputs, outputs, the no-gradient inputs and every
    parameter's type, default, requiredness and choices."""
    jop, op = jget_op(name), get_op(name)
    assert (op.name, op.hint, op.stochastic, op.key_var_num_args) == \
        (jop.name, jop.hint, jop.stochastic, jop.key_var_num_args)
    assert op.no_grad_inputs == jop.no_grad_inputs
    assert list(op.params) == list(jop.params)
    for key, p in op.params.items():
        jp = jop.params[key]
        assert (p.typ, p.default, p.required, p.enum) == \
            (jp.typ, jp.default, jp.required, jp.enum), (name, key)
    for attrs in ({}, {"num_args": 2}, {"ret_typ": "both"}):
        attrs = {k: v for k, v in attrs.items() if k in op.params}
        full = {k: _REQUIRED[p.typ] for k, p in op.params.items()
                if p.required}
        full.update(attrs)
        pa, ja = op.parse_attrs(full), jop.parse_attrs(full)
        assert op.input_names(pa) == jop.input_names(ja)
        assert op.num_outputs(pa) == jop.num_outputs(ja)
        assert op.output_names(pa, "n") == jop.output_names(ja, "n")
        assert op.aux_names(pa) == jop.aux_names(ja)
