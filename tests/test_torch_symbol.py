"""Port parity for the symbol layer: graph JSON written by ``mxnet_tpu_torch``
is byte-identical to ``mxnet_tpu``'s, each package loads the other's JSON,
and shape inference agrees."""
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.transformer import get_transformer_lm as jax_lm
from mxnet_tpu_torch.models.transformer import get_transformer_lm as port_lm

LMS = [
    dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, seq_len=32),
    dict(vocab_size=100, num_layers=1, num_heads=2, hidden=16, seq_len=8,
         block_q=16, block_k=32),
    dict(vocab_size=32000, num_layers=6, num_heads=16, hidden=2048,
         seq_len=4096),
]


def _both(kw):
    with mx.NameManager():
        js = jax_lm(**kw)
    with mt.NameManager():
        ts = port_lm(**kw)
    return js, ts


@pytest.mark.parametrize("kw", LMS, ids=["small", "blocks", "full"])
def test_transformer_json_identical(kw):
    js, ts = _both(kw)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == []


@pytest.mark.parametrize("kw", LMS, ids=["small", "blocks", "full"])
def test_json_loads_across_packages(kw):
    js, ts = _both(kw)
    assert mt.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert mx.sym.load_json(ts.tojson()).tojson() == ts.tojson()


@pytest.mark.parametrize("kw", LMS, ids=["small", "blocks", "full"])
def test_infer_shape_matches(kw):
    js, ts = _both(kw)
    b, s = 2, kw["seq_len"]
    shapes = {"data": (b, s), "softmax_label": (b, s)}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    # the label alone cannot be deduced through its Reshape, in either
    assert ts.infer_shape(data=(b, s)) == js.infer_shape(data=(b, s)) == \
        (None, None, None)


def test_infer_shape_positional_and_meta_fallback():
    """Ops without a shape rule (broadcast_add, gelu, slice_axis) run on
    meta tensors; positional shapes follow list_arguments order."""
    def build(pkg):
        x = pkg.sym.Variable("x")
        y = pkg.sym.slice_axis(pkg.sym.gelu(x), axis=1, begin=1, end=4)
        return pkg.sym.broadcast_add(y, pkg.sym.Variable("b"))

    with mx.NameManager():
        js = build(mx)
    with mt.NameManager():
        ts = build(mt)
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape((2, 5), (1, 3)) == js.infer_shape((2, 5), (1, 3))
    assert ts.infer_shape(x=(2, 5), b=(1, 3))[1] == [(2, 3)]


def test_auto_names_scopes_and_groups():
    def build(pkg):
        with pkg.AttrScope(ctx_group="dev1"):
            data = pkg.sym.Variable("data", shape=(4, 3))
            fc = pkg.sym.FullyConnected(data, num_hidden=5)
        with pkg.name.Prefix("enc_"):
            ln = pkg.sym.LayerNorm(fc, output_mean_var=True)
        parts = pkg.sym.SliceChannel(ln[0], num_outputs=5, axis=1)
        return pkg.sym.Group([parts[1], ln[2], fc])

    with mx.NameManager():
        js = build(mx)
    with mt.NameManager():
        ts = build(mt)
    assert ts.tojson() == js.tojson()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.infer_shape() == js.infer_shape()
    assert ts[1].name == js[1].name and ts.name is None
    assert ts[0].attr("ctx_group") is None
    assert mt.sym.load_json(js.tojson())[2].attr("ctx_group") == "dev1"


@pytest.mark.parametrize("expr", [
    "(a + b) * 2.0 - a / b", "a - b", "2.0 - a", "3.0 / a", "a ** 2.0",
    "a ** b", "-a + 1.0", "a * b + a", "(a > b) + (a <= 1.0)",
    "(a == b) * 2.0 + (a != 3.0)", "(a < b) - (a >= b)",
])
def test_symbol_arithmetic_composition(expr):
    """Symbol operators build the JAX package's nodes (same JSON) and
    compute what it computes (tests/test_symbol.py's composition)."""
    import numpy as np

    vals = {"a": np.array([2.0, 4.0, 3.0], np.float32),
            "b": np.array([1.0, 2.0, 3.0], np.float32)}
    res = {}
    for key, pkg in (("jax", mx), ("port", mt)):
        with pkg.NameManager():
            a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
            s = eval(expr, {"a": a, "b": b})
        ex = s.bind(pkg.cpu(), {k: pkg.nd.array(v, pkg.cpu())
                                for k, v in vals.items()})
        res[key] = (s.tojson(), ex.forward()[0].asnumpy())
    assert res["port"][0] == res["jax"][0]
    np.testing.assert_allclose(res["port"][1], res["jax"][1], rtol=1e-6)
    if expr == "(a + b) * 2.0 - a / b":
        np.testing.assert_allclose(res["port"][1][:2], [4.0, 10.0])


def test_symbol_comparison_with_other_objects():
    a = mt.sym.Variable("a")
    assert (a == None) is False and (a != "a") is True  # noqa: E711
    assert a in {a: 1} and len({a, mt.sym.Variable("a")}) == 2


@pytest.mark.parametrize("grad_req", ["write", "null",
                                      {"data": "null", "fc_weight": "write",
                                       "fc_bias": "add"}])
def test_simple_bind_matches_jax(grad_req):
    """simple_bind allocates the arguments (shapes given and inferred),
    their gradients per grad_req, on the context; forward and backward
    then agree with the JAX package's executor (gradients within 1e-5 of
    their largest element)."""
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32)
    w = rng.randn(3, 6).astype(np.float32)
    out = {}
    for key, pkg in (("jax", mx), ("port", mt)):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3,
                                     name="fc")
        net = pkg.sym.sum(pkg.sym.square(net))
        ex = net.simple_bind(pkg.cpu(), grad_req=grad_req, data=(4, 6))
        assert [ex.arg_dict[n].shape for n in net.list_arguments()] == \
            [(4, 6), (3, 6), (3,)]
        assert all(ex.arg_dict[n].context == pkg.cpu() for n in ex.arg_dict)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["fc_weight"][:] = w
        ex.arg_dict["fc_bias"][:] = 0.5
        res = [ex.forward(is_train=True)[0].asnumpy()]
        if grad_req != "null":
            ex.backward()
        res.append(sorted(ex.grad_dict))
        res += [ex.grad_dict[n].asnumpy() for n in sorted(ex.grad_dict)]
        out[key] = res
    got, ref = out["port"], out["jax"]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert got[1] == ref[1]
    for g, r in zip(got[2:], ref[2:]):  # sums in another order
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


def test_simple_bind_type_dict_and_errors():
    net = mt.sym.broadcast_add(mt.sym.Variable("x"), mt.sym.Variable("y"))
    ex = net.simple_bind(mt.cpu(), type_dict={"x": "float16"}, x=(2, 3),
                         y=(1, 3))
    assert ex.arg_dict["x"].dtype == "float16" and ex.grad_dict["x"].dtype \
        == "float16"
    assert ex.arg_dict["y"].shape == (1, 3) and ex.arg_dict["y"].dtype == \
        "float32"
    with pytest.raises(ValueError, match="infer"):
        net.simple_bind(mt.cpu(), x=(2, 3))
