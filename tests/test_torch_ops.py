"""Port parity for the serving slice's plain-torch ops: each op of
``mxnet_tpu_torch`` against the same-named op of ``mxnet_tpu`` on identical
numpy inputs, through both registries.  float32 tolerance rtol=atol=1e-5:
the same arithmetic, summed in another order.  Every op also runs on
``meta`` tensors, which shape inference relies on."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op
from mxnet_tpu_torch.ops import OpContext, get_op

TOL = 1e-5


def _f(*shape):
    return lambda rng: rng.randn(*shape).astype(np.float32)


def _ids(n, *shape):
    return lambda rng: rng.randint(0, n, shape).astype(np.float32)


# op name, raw attrs, input makers
CASES = [
    ("broadcast_add", {}, [_f(2, 3, 4), _f(1, 3, 4)]),
    ("broadcast_add", {}, [_f(2, 5, 8), _f(1, 1, 8)]),
    ("broadcast_plus", {}, [_f(3, 4), _f(3, 4)]),
    ("gelu", {}, [_f(4, 7)]),
    ("Reshape", {"shape": (-1, 8)}, [_f(2, 3, 8)]),
    ("Reshape", {"shape": (0, -1)}, [_f(2, 3, 8)]),
    ("Reshape", {"shape": (-2,)}, [_f(2, 3, 8)]),
    ("Reshape", {"shape": (-3, 0)}, [_f(2, 3, 8)]),
    ("Reshape", {"shape": (0, -4, 2, -1, 0)}, [_f(2, 6, 4)]),
    ("Reshape", {"shape": (-1, 6, 3, 2, 2)}, [_f(4, 6, 12)]),
    ("Reshape", {"target_shape": (8, 6)}, [_f(2, 3, 8)]),
    ("slice_axis", {"axis": 1, "begin": 1, "end": 3}, [_f(2, 5, 3)]),
    ("slice_axis", {"axis": -1, "begin": 2, "end": None}, [_f(2, 5, 6)]),
    ("SliceChannel", {"num_outputs": 3, "axis": 2, "squeeze_axis": True},
     [_f(2, 4, 3, 2, 5)]),
    ("SliceChannel", {"num_outputs": 2}, [_f(2, 6, 3)]),
    ("Embedding", {"input_dim": 10, "output_dim": 6}, [_ids(10, 2, 5),
                                                       _f(10, 6)]),
    ("take", {}, [_f(7, 3), _ids(7, 4, 2)]),
    ("take", {"axis": 1, "mode": "wrap"},
     [_f(3, 5), lambda rng: rng.randint(-7, 12, (4,)).astype(np.float32)]),
    ("take", {"mode": "clip"},
     [_f(5, 2), lambda rng: np.array([-3, 0, 4, 9], np.float32)]),
    ("FullyConnected", {"num_hidden": 6}, [_f(4, 5), _f(6, 5), _f(6)]),
    ("FullyConnected", {"num_hidden": 3, "no_bias": True},
     [_f(4, 2, 5), _f(3, 10)]),
    ("FullyConnected", {"num_hidden": 3, "flatten": False},
     [_f(4, 2, 5), _f(3, 5), _f(3)]),
    ("LayerNorm", {}, [_f(3, 4, 16), _f(16), _f(16)]),
    ("LayerNorm", {"axis": 1, "eps": 1e-3}, [_f(3, 8, 2), _f(8), _f(8)]),
    ("LayerNorm", {"output_mean_var": True}, [_f(5, 12), _f(12), _f(12)]),
    ("SoftmaxOutput", {}, [_f(6, 11), _ids(11, 6)]),
    ("SoftmaxOutput", {"multi_output": True}, [_f(2, 5, 3), _ids(5, 2, 3)]),
]


def _run_both(name, attrs, inputs):
    import jax.numpy as jnp

    jop = jget_op(name)
    jouts, _ = jop.apply(JOpContext(is_train=False), jop.parse_attrs(attrs),
                         [jnp.asarray(x) for x in inputs])
    op = get_op(name)
    outs, _ = op.apply(OpContext(), op.parse_attrs(attrs),
                       [torch.from_numpy(x) for x in inputs])
    return [np.asarray(o) for o in jouts], outs


@pytest.mark.parametrize("name,attrs,makers", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_op_matches_jax(name, attrs, makers):
    rng = np.random.RandomState(len(name))
    inputs = [m(rng) for m in makers]
    jouts, outs = _run_both(name, attrs, inputs)
    assert len(outs) == len(jouts)
    for j, t in zip(jouts, outs):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=TOL, atol=TOL)
    # the same op on data-free meta tensors gives the same shapes
    op = get_op(name)
    metas, _ = op.apply(OpContext(), op.parse_attrs(attrs),
                        [torch.empty(x.shape, device="meta") for x in inputs])
    assert [tuple(m.shape) for m in metas] == [j.shape for j in jouts]


def test_op_surface_names_and_params_match_jax():
    """The slice's ops carry the JAX package's names, hints, inputs and
    param specs — what graph JSON and auto-naming are made of."""
    for name in ["broadcast_add", "gelu", "Reshape", "slice_axis",
                 "SliceChannel", "Embedding", "take", "FullyConnected",
                 "LayerNorm", "SoftmaxOutput", "_contrib_FlashAttention"]:
        jop, op = jget_op(name), get_op(name)
        assert op.hint == jop.hint
        assert list(op.params) == list(jop.params)
        for key, p in op.params.items():
            jp = jop.params[key]
            assert (p.typ, p.default, p.required) == \
                (jp.typ, jp.default, jp.required), (name, key)
        attrs = {"num_hidden": 4, "num_outputs": 3, "axis": 0,
                 "input_dim": 3, "output_dim": 2}
        attrs = {k: v for k, v in attrs.items() if k in op.params}
        assert op.input_names(op.parse_attrs(attrs)) == \
            jop.input_names(jop.parse_attrs(attrs))


def test_unknown_attr_rejected():
    with pytest.raises(ValueError):
        mt.sym.FullyConnected(mt.sym.Variable("x"), num_hidden=2, bogus=1)


def test_register_kernel_op_forward_and_custom_gradient():
    """register_kernel_op: a forward-only op runs its function; with bwd
    the op becomes a torch.autograd.Function whose gradient is bwd's."""
    from mxnet_tpu_torch.ops import Param, register_kernel_op

    def fn(attrs, x):
        return attrs["alpha"] * x * x

    def bwd(attrs, res, ct):
        (x,) = res
        return (ct * 2.0 * attrs["alpha"] * x,)

    register_kernel_op("_test_scaled_square", fn, bwd=bwd,
                       params={"alpha": Param(float, 1.0)})
    register_kernel_op("_test_scaled_square_fwd_only", fn,
                       params={"alpha": Param(float, 1.0)})
    with pytest.raises(ValueError):
        register_kernel_op("_test_bad", fn, fwd=lambda a, x: (x, ()))

    # visible on the symbol surface after late registration
    s = mt.sym._test_scaled_square(mt.sym.Variable("x"), alpha=3.0)
    assert s.list_arguments() == ["x"]

    x = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)
    op = get_op("_test_scaled_square")
    (y,), _ = op.apply(OpContext(), op.parse_attrs({"alpha": 3.0}), [x])
    np.testing.assert_allclose(y.detach().numpy(), [3.0, 12.0, 0.75])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, -12.0, 3.0])

    op2 = get_op("_test_scaled_square_fwd_only")
    (y2,), _ = op2.apply(OpContext(), op2.parse_attrs({"alpha": 3.0}),
                         [x.detach()])
    np.testing.assert_allclose(y2.numpy(), y.detach().numpy())
