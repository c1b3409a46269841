"""``mt.caffe`` against the JAX package's ``mx.caffe``: each case of
``tests/test_caffe.py`` through both packages, on the CPU.

Fixtures are fabricated with the converters' own wire-format writer (no
Caffe, no protobuf).  ``encode_caffemodel`` writes the same bytes in both
packages; the parsed prototxt and blobs are equal; the converted symbols
serialize to the same JSON; the converted parameters are equal bit for
bit; and a converted net's forward agrees with the JAX package's within
1e-4 (relative to the output's largest magnitude; float32, the two
packages' convolutions sum in another order).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import caffe as jcaffe
from mxnet_tpu_torch import caffe

TOL = 1e-4

LENET_ISH = """
name: "tiny"
input: "data"
input_dim: 2
input_dim: 3
input_dim: 8
input_dim: 8
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 5 } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""

BN_SCALE = """
input: "data"
input_dim: 2
input_dim: 3
input_dim: 4
input_dim: 4
layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn" }
layer { name: "sc" type: "Scale" bottom: "bn" top: "bn"
  scale_param { bias_term: true } }
layer { name: "out" type: "ReLU" bottom: "bn" top: "out" }
"""

TWO_CONV = """
input: "data"
input_dim: 1
input_dim: 3
input_dim: 6
input_dim: 6
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "c2" type: "Convolution" bottom: "c1" top: "c2"
  convolution_param { num_output: 2 kernel_size: 3 pad: 1 } }
"""

V1 = """
input: "data"
input_dim: 1
input_dim: 1
input_dim: 6
input_dim: 6
layers: { name: "c" type: CONVOLUTION bottom: "data" top: "c"
  convolution_param { num_output: 1 kernel_size: 3 } }
layers: { name: "r" type: RELU bottom: "c" top: "r" }
layers: { name: "p" type: SOFTMAX bottom: "r" top: "p" }
"""

ELTWISE = """
input: "data"
input_dim: 2
input_dim: 3
layer { name: "e" type: "Eltwise" bottom: "data" bottom: "data"
  bottom: "data" top: "e" }
"""


def _lenet_blobs(seed=1):
    rng = np.random.RandomState(seed)
    return {"conv1": [rng.randn(4, 3, 3, 3).astype("f") * 0.2,
                      rng.randn(4).astype("f") * 0.1],
            "ip1": [rng.randn(5, 4 * 4 * 4).astype("f") * 0.2,
                    rng.randn(5).astype("f") * 0.1]}


def _bn_blobs(seed=2):
    rng = np.random.RandomState(seed)
    mean = rng.randn(3).astype("f")
    var = np.abs(rng.randn(3)).astype("f") + 1.0
    return {"bn": [mean * 2.0, var * 2.0, np.array(2.0, "f")],
            "sc": [rng.randn(3).astype("f"), rng.randn(3).astype("f")]}


def _two_conv_blobs(seed=7):
    rng = np.random.RandomState(seed)
    return {"c1": [rng.randn(4, 3, 3, 3).astype("f")],
            "c2": [rng.randn(2, 4, 3, 3).astype("f")]}


def _v1_blobs(seed=3):
    rng = np.random.RandomState(seed)
    return {"c": [rng.randn(1, 1, 3, 3).astype("f"),
                  rng.randn(1).astype("f")]}


CASES = {"lenet": (LENET_ISH, _lenet_blobs, (2, 3, 8, 8)),
         "bn_scale": (BN_SCALE, _bn_blobs, (2, 3, 4, 4)),
         "two_conv": (TWO_CONV, _two_conv_blobs, (1, 3, 6, 6)),
         "v1": (V1, _v1_blobs, (1, 1, 6, 6))}


def _json(sym):
    return json.loads(sym.tojson())


def _forward(pkg, sym, args, aux, x):
    ex = sym.simple_bind(pkg.cpu(), data=x.shape, grad_req="null")
    for k, v in args.items():
        ex.arg_dict[k][:] = v.asnumpy()
    for k, v in aux.items():
        ex.aux_dict[k][:] = v.asnumpy()
    return ex.forward(is_train=False, data=x)[0].asnumpy()


def test_prototxt_parser_matches():
    for proto, _, _ in CASES.values():
        assert caffe.parse_prototxt(proto) == jcaffe.parse_prototxt(proto)
    net = caffe.parse_prototxt(LENET_ISH)
    assert net["input_dim"] == [2, 3, 8, 8]
    assert net["layer"][0]["convolution_param"]["num_output"] == 4


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_caffemodel_same_bytes_and_parse(case):
    _, blobs, _ = CASES[case]
    data = caffe.encode_caffemodel(blobs())
    assert data == jcaffe.encode_caffemodel(blobs())
    back, jback = caffe.parse_caffemodel(data), jcaffe.parse_caffemodel(data)
    assert sorted(back) == sorted(jback) == sorted(blobs())
    for k in back:
        for a, b in zip(back[k], jback[k]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_model_matches_jax(case):
    """Same symbol JSON, parameters bit for bit (the BGR swap of the first
    convolution, the BatchNorm + Scale merge, the legacy V1 layout), and
    the forward within 1e-4."""
    proto, blobs, shape = CASES[case]
    model = caffe.encode_caffemodel(blobs())
    with mt.cpu(), mt.NameManager():
        sym, args, aux = caffe.convert_model(proto, model)
    with mx.NameManager():
        jsym, jargs, jaux = jcaffe.convert_model(proto, model)
    assert _json(sym) == _json(jsym)
    assert sorted(args) == sorted(jargs) and sorted(aux) == sorted(jaux)
    for got, ref in ((args, jargs), (aux, jaux)):
        for k in ref:
            assert got[k].context == mt.cpu()
            np.testing.assert_array_equal(got[k].asnumpy(), ref[k].asnumpy(),
                                          err_msg=k)
    x = np.random.RandomState(5).randn(*shape).astype("f")
    out = _forward(mt, sym, args, aux, x)
    ref = _forward(mx, jsym, jargs, jaux, x)
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def test_blobs_absent_from_prototxt_are_skipped():
    rng = np.random.RandomState(8)
    model = caffe.encode_caffemodel({
        "conv1": [rng.randn(4, 3, 3, 3).astype("f"),
                  rng.randn(4).astype("f")],
        "ip1": [rng.randn(5, 4 * 4 * 4).astype("f")],
        "loss_only_fc": [rng.randn(2, 5).astype("f"),
                         rng.randn(2).astype("f")]})
    with mt.cpu():
        _, args, aux = caffe.convert_model(LENET_ISH, model)
    _, jargs, jaux = jcaffe.convert_model(LENET_ISH, model)
    assert sorted(args) == sorted(jargs) == ["conv1_bias", "conv1_weight",
                                             "ip1_weight"]
    assert not aux and not jaux


def test_eltwise_three_bottoms_and_standalone_scale():
    sym, name = caffe.convert_symbol(ELTWISE)
    jsym, jname = jcaffe.convert_symbol(ELTWISE)
    assert name == jname == "data"
    ex = sym.simple_bind(mt.cpu(), data=(2, 3), grad_req="null")
    out = ex.forward(is_train=False, data=np.ones((2, 3), "f"))[0].asnumpy()
    np.testing.assert_array_equal(out, 3 * np.ones((2, 3), "f"))
    bad = ELTWISE.replace(
        'type: "Eltwise" bottom: "data" bottom: "data"\n  bottom: "data"',
        'type: "Scale" bottom: "data"')
    with pytest.raises(NotImplementedError, match="standalone Scale"):
        caffe.convert_symbol(bad)
    with pytest.raises(NotImplementedError, match="standalone Scale"):
        jcaffe.convert_symbol(bad)


def test_caffeop_single_layer_sugar():
    def build(pkg, mod):
        with pkg.NameManager():
            net = pkg.sym.Variable("data")
            net = mod.CaffeOp(net, 'layer { name: "c1" type: "Convolution" '
                                   'convolution_param { num_output: 2 '
                                   'kernel_size: 3 pad: 1 } }')
            return mod.CaffeOp(net, 'layer { type: "ReLU" }', name="r1")
    net, jnet = build(mt, caffe), build(mx, jcaffe)
    assert _json(net) == _json(jnet)
    rng = np.random.RandomState(0)
    args = {k: mt.nd.array(rng.randn(*s).astype("f") * 0.1, mt.cpu())
            for k, s in zip(net.list_arguments(), net.infer_shape(
                data=(1, 3, 5, 5))[0]) if k != "data"}
    x = rng.randn(1, 3, 5, 5).astype("f")
    out = _forward(mt, net, args, {}, x)
    ref = _forward(mx, jnet, {k: mx.nd.array(v.asnumpy())
                              for k, v in args.items()}, {}, x)
    assert out.shape == (1, 2, 5, 5) and (out >= 0).all()
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def test_caffeop_unnamed_layers_get_unique_params():
    net = mt.sym.Variable("data")
    for _ in range(2):
        net = caffe.CaffeOp(net, 'layer { type: "Convolution" '
                                 'convolution_param { num_output: 2 '
                                 'kernel_size: 1 } }')
    weights = [a for a in net.list_arguments() if a.endswith("_weight")]
    assert len(weights) == 2 and weights[0] != weights[1]


def test_convert_mean():
    arr = np.arange(12, dtype="f").reshape(1, 3, 2, 2)
    blob = caffe.encode_blob(arr)
    assert blob == jcaffe.encode_blob(arr)
    np.testing.assert_array_equal(caffe.convert_mean(blob), arr[0])
    data = arr.ravel().tobytes()
    legacy = (caffe._enc_field(1, 0, caffe._enc_varint(1))
              + caffe._enc_field(2, 0, caffe._enc_varint(3))
              + caffe._enc_field(3, 0, caffe._enc_varint(2))
              + caffe._enc_field(4, 0, caffe._enc_varint(2))
              + caffe._enc_field(5, 2,
                                 caffe._enc_varint(len(data)) + data))
    back = caffe.convert_mean(legacy)
    np.testing.assert_array_equal(back, jcaffe.convert_mean(legacy))
    assert back.shape == (3, 2, 2)


def test_v1_layers_field_and_legacy_blob_dims():
    W = np.arange(6, dtype="f").reshape(2, 3)
    nm = b"fc"
    blob = (caffe._enc_field(1, 0, caffe._enc_varint(1))
            + caffe._enc_field(2, 0, caffe._enc_varint(1))
            + caffe._enc_field(3, 0, caffe._enc_varint(2))
            + caffe._enc_field(4, 0, caffe._enc_varint(3)))
    data = W.ravel().tobytes()
    blob += caffe._enc_field(5, 2, caffe._enc_varint(len(data)) + data)
    layer = (caffe._enc_field(4, 2, caffe._enc_varint(len(nm)) + nm)
             + caffe._enc_field(6, 2,
                                caffe._enc_varint(len(blob)) + blob))
    net = caffe._enc_field(2, 2, caffe._enc_varint(len(layer)) + layer)
    out = caffe.parse_caffemodel(net)
    assert out["fc"][0].shape == (1, 1, 2, 3)
    np.testing.assert_array_equal(out["fc"][0],
                                  jcaffe.parse_caffemodel(net)["fc"][0])


def test_convert_reads_files(tmp_path):
    (tmp_path / "deploy.prototxt").write_text(LENET_ISH)
    (tmp_path / "w.caffemodel").write_bytes(
        caffe.encode_caffemodel(_lenet_blobs()))
    with mt.cpu():
        sym, args, _ = caffe.convert(str(tmp_path / "deploy.prototxt"),
                                     str(tmp_path / "w.caffemodel"))
    jsym, jargs, _ = jcaffe.convert(str(tmp_path / "deploy.prototxt"),
                                    str(tmp_path / "w.caffemodel"))
    for k in jargs:
        np.testing.assert_array_equal(args[k].asnumpy(), jargs[k].asnumpy())
