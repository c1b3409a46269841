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
