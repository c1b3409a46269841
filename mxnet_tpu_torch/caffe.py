"""Caffe model import — prototxt + caffemodel → (Symbol, params);
counterpart of ``mxnet_tpu/caffe.py``.

The reference ships ``plugin/caffe`` (a runtime operator bridge into an
installed Caffe) and ``tools/caffe_converter`` (a protobuf-compiled offline
converter, ``convert_symbol.py`` / ``convert_model.py``).  What migrating
users need is the model FORMAT, so this module implements the converter
natively, as the JAX package's does:

* ``.prototxt`` is protobuf text format — parsed with a small recursive
  reader (no protobuf dependency);
* ``.caffemodel`` is protobuf wire format — decoded with a minimal
  varint/length-delimited field walker against the public BVLC field
  numbers (NetParameter.layer=100 / V1 layers=2; BlobProto data=5,
  shape=7).  Only names and blobs are read from the binary; layer topology
  and attributes come from the prototxt.

Layer coverage matches the reference converter's supported set
(reference convert_symbol.py:60-180): Input/Data, Convolution,
Deconvolution, InnerProduct, Pooling, ReLU, PReLU, Sigmoid, TanH,
Dropout, LRN, BatchNorm+Scale (merged into one BatchNorm), Concat,
Eltwise, Flatten, Reshape, Split, Softmax(WithLoss).  The parameters come
back as NDArrays on the current context (``gpu(0)`` unless the caller
enters another), and ``encode_caffemodel`` writes the JAX package's bytes.

    sym, arg_params, aux_params = mt.caffe.convert(
        "deploy.prototxt", "weights.caffemodel")
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf text format (.prototxt)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<comment>\#[^\n]*)
  | (?P<open>[A-Za-z_][A-Za-z0-9_]*\s*:?\s*\{)   # `f {` and legal `f: {`
  | (?P<kv>[A-Za-z_][A-Za-z0-9_]*\s*:\s*(?:"(?:[^"\\]|\\.)*"|[^\s{}]+))
  | (?P<close>\})
""", re.VERBOSE)


def parse_prototxt(text: str) -> Dict:
    """Text-format protobuf → dict; repeated fields become lists."""
    root: Dict = {}
    stack: List[Dict] = [root]
    for m in _TOKEN.finditer(text):
        if m.lastgroup == "comment":
            continue
        if m.lastgroup == "open":
            name = m.group().rstrip("{").strip().rstrip(":").strip()
            child: Dict = {}
            _append(stack[-1], name, child)
            stack.append(child)
        elif m.lastgroup == "close":
            stack.pop()
        else:
            key, _, raw = m.group().partition(":")
            _append(stack[-1], key.strip(), _scalar(raw.strip()))
    return root


def _append(d, key, value):
    if key in d:
        if not isinstance(d[key], list):
            d[key] = [d[key]]
        d[key].append(value)
    else:
        d[key] = value


def _scalar(raw):
    if raw.startswith('"'):
        return raw[1:-1]
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        return raw


def _aslist(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------------------
# protobuf wire format (.caffemodel) — names + blobs only
# ---------------------------------------------------------------------------


def _walk_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message body."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v, i = bytes(buf[i:i + 8]), i + 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = bytes(buf[i:i + 4]), i + 4
        else:
            raise ValueError("unsupported wire type %d" % wt)
        yield field, wt, v


def _varint(buf, i):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _floats(wt, v, acc):
    """BlobProto.data (field 5): packed (wt=2) or repeated scalar (wt=5)."""
    if wt == 2:
        acc.append(np.frombuffer(bytes(v), "<f4"))
    else:
        acc.append(np.frombuffer(v, "<f4"))


def _parse_blob(body) -> np.ndarray:
    data, shape, legacy = [], [], {}
    for field, wt, v in _walk_fields(body):
        if field == 5:
            _floats(wt, v, data)
        elif field == 7 and wt == 2:  # BlobShape { repeated int64 dim=1 }
            for f2, wt2, v2 in _walk_fields(v):
                if f2 == 1:
                    if wt2 == 2:  # packed
                        j = 0
                        while j < len(v2):
                            d, j = _varint(v2, j)
                            shape.append(d)
                    else:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wt == 0:  # legacy num/channels/h/w
            legacy[field] = v
    arr = (np.concatenate(data) if data
           else np.zeros(0, "f"))
    if not shape and legacy:
        # legacy 4D num/channels/height/width kept as-is; the layer-aware
        # conversion (convert_model) squeezes where the layer type says
        # so — stripping leading 1s here would corrupt e.g. a
        # num_output=1 convolution weight
        shape = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
    return arr.reshape(shape) if shape else arr


def parse_caffemodel(data: bytes) -> Dict[str, List[np.ndarray]]:
    """{layer_name: [blob arrays]} from a NetParameter binary. Handles
    both layer (field 100, V2) and layers (field 2, V1)."""
    out: Dict[str, List[np.ndarray]] = {}
    for field, wt, v in _walk_fields(memoryview(data)):
        if field not in (100, 2) or wt != 2:
            continue
        name, blobs = None, []
        # V2 LayerParameter: name=1, blobs=7; V1: name=4, blobs=6
        name_f, blob_f = (1, 7) if field == 100 else (4, 6)
        for f2, wt2, v2 in _walk_fields(v):
            if f2 == name_f and wt2 == 2:
                name = bytes(v2).decode()
            elif f2 == blob_f and wt2 == 2:
                blobs.append(_parse_blob(v2))
        if name is not None:
            out[name] = blobs
    return out


# ---------------------------------------------------------------------------
# symbol conversion
# ---------------------------------------------------------------------------


# V1 prototxt `layers { type: CONVOLUTION }` enum names → V2 strings
# (protobuf text format carries enum NAMES; the old numeric wire values
# never appear in text)
_V1_TYPES = {
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "INNER_PRODUCT": "InnerProduct", "POOLING": "Pooling",
    "RELU": "ReLU", "PRELU": "PReLU", "SIGMOID": "Sigmoid",
    "TANH": "TanH", "DROPOUT": "Dropout", "LRN": "LRN",
    "CONCAT": "Concat", "ELTWISE": "Eltwise", "FLATTEN": "Flatten",
    "RESHAPE": "Reshape", "SPLIT": "Split", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "DATA": "Data",
    "ACCURACY": "Accuracy", "BN": "BatchNorm", "SCALE": "Scale",
}


def _norm_type(ltype):
    return _V1_TYPES.get(ltype, ltype) if isinstance(ltype, str) else ltype


def _kernel_pair(p, stem, default=0):
    """Caffe params are either isotropic (kernel_size) or _h/_w pairs."""
    iso = p.get("%s_size" % stem if stem == "kernel" else stem)
    if iso is not None:
        iso = _aslist(iso)[0]
        return (iso, iso)
    return (p.get("%s_h" % stem, default), p.get("%s_w" % stem, default))


def convert_symbol(prototxt_text: str):
    """prototxt → (mx Symbol, input_name). Reference parity:
    tools/caffe_converter/convert_symbol.py."""
    from . import symbol as sym_mod

    net = parse_prototxt(prototxt_text)
    layers = _aslist(net.get("layer")) or _aslist(net.get("layers"))
    tops: Dict[str, object] = {}
    input_name = None

    def get(bottom):
        if bottom not in tops:
            raise ValueError("unknown bottom %r" % bottom)
        return tops[bottom]

    # legacy top-level input declaration
    for iname in _aslist(net.get("input")):
        v = sym_mod.Variable(iname)
        tops[iname] = v
        input_name = input_name or iname

    last = None
    for layer in layers:
        ltype = _norm_type(layer.get("type"))
        name = layer.get("name")
        louts = _aslist(layer.get("top"))
        if ltype in ("Input", "Data", "HDF5Data", "ImageData"):
            v = sym_mod.Variable(louts[0] if louts else name)
            tops[louts[0] if louts else name] = v
            input_name = input_name or (louts[0] if louts else name)
            continue
        out = _emit_layer(sym_mod, layer, get, layers)
        if out is _SKIP:
            continue
        for t in (louts or [name]):
            tops[t] = out
        last = out

    if last is None:
        raise ValueError("prototxt contains no convertible layers")
    return last, input_name


_SKIP = object()


def _emit_layer(sym_mod, layer, get, layers):
    """One caffe layer → one mx symbol expression (the ONE mapping both
    convert_symbol and CaffeOp use). ``get(bottom)`` resolves inputs;
    returns _SKIP for non-compute layers."""
    ltype = _norm_type(layer.get("type"))
    name = layer.get("name")
    bots = _aslist(layer.get("bottom"))
    if ltype in ("SoftmaxWithLoss", "Softmax"):
        out = sym_mod.SoftmaxOutput(get(bots[0]), name=name)
    elif ltype in ("Convolution", "Deconvolution"):
        p = layer.get("convolution_param", {})
        kh, kw = _kernel_pair(p, "kernel")
        sh, sw = _kernel_pair(p, "stride", 1) if (
            "stride" in p or "stride_h" in p) else (1, 1)
        ph, pw = _kernel_pair(p, "pad", 0) if (
            "pad" in p or "pad_h" in p) else (0, 0)
        op = (sym_mod.Convolution if ltype == "Convolution"
              else sym_mod.Deconvolution)
        out = op(get(bots[0]), name=name,
                 num_filter=p["num_output"],
                 kernel=(kh, kw), stride=(sh or 1, sw or 1),
                 pad=(ph, pw),
                 num_group=p.get("group", 1),
                 no_bias=not p.get("bias_term", True))
    elif ltype in ("InnerProduct",):
        p = layer.get("inner_product_param", {})
        out = sym_mod.FullyConnected(
            sym_mod.Flatten(get(bots[0])), name=name,
            num_hidden=p["num_output"],
            no_bias=not p.get("bias_term", True))
    elif ltype in ("Pooling",):
        p = layer.get("pooling_param", {})
        kh, kw = _kernel_pair(p, "kernel")
        sh, sw = _kernel_pair(p, "stride", 1)
        ph, pw = _kernel_pair(p, "pad", 0)
        pool = {0: "max", 1: "avg", "MAX": "max",
                "AVE": "avg"}.get(p.get("pool", 0), "max")
        if p.get("global_pooling"):
            out = sym_mod.Pooling(get(bots[0]), name=name,
                                  kernel=(1, 1), global_pool=True,
                                  pool_type=pool)
        else:
            # Caffe pools with ceil-mode window placement
            out = sym_mod.Pooling(
                get(bots[0]), name=name, kernel=(kh, kw),
                stride=(sh or 1, sw or 1), pad=(ph, pw),
                pool_type=pool,
                pooling_convention="full")
    elif ltype in ("ReLU",):
        out = sym_mod.Activation(get(bots[0]), name=name,
                                 act_type="relu")
    elif ltype == "PReLU":
        out = sym_mod.LeakyReLU(get(bots[0]), name=name,
                                act_type="prelu")
    elif ltype in ("Sigmoid",):
        out = sym_mod.Activation(get(bots[0]), name=name,
                                 act_type="sigmoid")
    elif ltype in ("TanH",):
        out = sym_mod.Activation(get(bots[0]), name=name,
                                 act_type="tanh")
    elif ltype in ("Dropout",):
        p = layer.get("dropout_param", {})
        out = sym_mod.Dropout(get(bots[0]), name=name,
                              p=p.get("dropout_ratio", 0.5))
    elif ltype in ("LRN",):
        p = layer.get("lrn_param", {})
        out = sym_mod.LRN(get(bots[0]), name=name,
                          alpha=p.get("alpha", 1e-4),
                          beta=p.get("beta", 0.75),
                          knorm=p.get("k", 1.0),
                          nsize=p.get("local_size", 5))
    elif ltype == "BatchNorm":
        p = layer.get("batch_norm_param", {})
        # fix_gamma=False: a following Scale layer's gamma/beta fold
        # into this op's arg params (without Scale the defaults
        # gamma=1/beta=0 reproduce bare caffe BatchNorm)
        out = sym_mod.BatchNorm(get(bots[0]), name=name,
                                eps=p.get("eps", 1e-5),
                                use_global_stats=True,
                                fix_gamma=False)
    elif ltype == "Scale":
        # Caffe pairs BatchNorm (normalize) + Scale (gamma/beta);
        # mx BatchNorm holds all four — the Scale layer merges into
        # its bottom BatchNorm (reference convert_symbol.py does the
        # same): symbol-side it is identity, param-side
        # convert_model folds the blobs in. A standalone Scale has
        # no BatchNorm to fold into — refuse rather than silently
        # dropping the scaling math.
        if _bn_producer(layers, bots[0]) is None:
            raise NotImplementedError(
                "standalone Scale layer %r (bottom %r is not a "
                "BatchNorm output) is not supported" % (name, bots[0]))
        out = get(bots[0])
    elif ltype in ("Concat",):
        p = layer.get("concat_param", {})
        out = sym_mod.Concat(*[get(b) for b in bots], name=name,
                             dim=p.get("axis", 1))
    elif ltype == "Eltwise":
        p = layer.get("eltwise_param", {})
        op = p.get("operation", "SUM")
        ins = [get(b) for b in bots]  # caffe allows N bottoms
        out = ins[0]
        for rhs in ins[1:]:
            if op in ("SUM", 1):
                out = out + rhs
            elif op in ("PROD", 0):
                out = out * rhs
            else:
                out = sym_mod.maximum(out, rhs)
    elif ltype in ("Flatten",):
        out = sym_mod.Flatten(get(bots[0]), name=name)
    elif ltype == "Reshape":
        p = layer.get("reshape_param", {})
        dims = tuple(_aslist(p.get("shape", {}).get("dim", [])))
        out = sym_mod.Reshape(get(bots[0]), name=name, shape=dims)
    elif ltype in ("Split",):
        out = get(bots[0])
    elif ltype in ("Accuracy", "SoftmaxWithLossWeight"):
        return _SKIP
    else:
        raise NotImplementedError(
            "caffe layer type %r (%s) not supported" % (ltype, name))
    return out


def convert_model(prototxt_text: str, caffemodel_bytes: bytes):
    """→ (symbol, arg_params, aux_params), mx-native layouts. Reference
    parity: tools/caffe_converter/convert_model.py (incl. BatchNorm +
    Scale blob merging)."""
    from . import ndarray as nd

    sym, _ = convert_symbol(prototxt_text)
    blobs = parse_caffemodel(caffemodel_bytes)
    net = parse_prototxt(prototxt_text)
    layers = _aslist(net.get("layer")) or _aslist(net.get("layers"))
    by_name = {la.get("name"): la for la in layers}
    arg_params, aux_params = {}, {}
    # the reference converter swaps channels 0/2 of the FIRST convolution's
    # weight when it consumes 3/4-channel input (convert_model.py:68-71):
    # Caffe pipelines feed BGR (OpenCV), mx pipelines RGB
    first_conv = next((la.get("name") for la in layers
                       if _norm_type(la.get("type")) == "Convolution"), None)

    for name, lblobs in blobs.items():
        if name not in by_name:
            # train-vs-deploy mismatch (loss-only or renamed layers):
            # emitting params for them breaks bind/load of the converted
            # symbol, so skip the blobs like the reference prototxt-driven
            # converter implicitly does
            logging.warning(
                "caffe.convert_model: layer %r has blobs in the caffemodel "
                "but is absent from the deploy prototxt; skipping", name)
            continue
        layer = by_name[name]
        ltype = _norm_type(layer.get("type"))
        if not lblobs:
            continue
        if ltype == "BatchNorm":
            mean, var = lblobs[0], lblobs[1]
            scale = lblobs[2].reshape(()) if len(lblobs) > 2 else 1.0
            f = (1.0 / float(scale)) if float(np.asarray(scale)) else 0.0
            aux_params[name + "_moving_mean"] = nd.array(mean.ravel() * f)
            aux_params[name + "_moving_var"] = nd.array(var.ravel() * f)
            # gamma/beta defaults until a Scale layer overrides
            arg_params.setdefault(
                name + "_gamma", nd.array(np.ones_like(mean.ravel())))
            arg_params.setdefault(
                name + "_beta", nd.array(np.zeros_like(mean.ravel())))
        elif ltype == "Scale":
            bn = _aslist(layer.get("bottom"))[0]
            bn_layer = _bn_producer(layers, bn)
            if bn_layer is None:  # convert_symbol refuses these too
                raise NotImplementedError(
                    "standalone Scale layer %r is not supported" % name)
            arg_params[bn_layer + "_gamma"] = nd.array(lblobs[0].ravel())
            if len(lblobs) > 1:
                arg_params[bn_layer + "_beta"] = nd.array(
                    lblobs[1].ravel())
        elif ltype == "PReLU":
            arg_params[name + "_gamma"] = nd.array(lblobs[0].ravel())
        elif ltype == "InnerProduct":
            # V1 legacy blobs arrive (1, 1, out, in); V2 (out, in) —
            # the matrix is the last two dims either way
            W = lblobs[0]
            arg_params[name + "_weight"] = nd.array(
                W.reshape(W.shape[-2], W.shape[-1]))
            if len(lblobs) > 1:
                arg_params[name + "_bias"] = nd.array(lblobs[1].ravel())
        else:
            # conv [out,in,kh,kw] layout matches mx
            wmat = lblobs[0]
            if name == first_conv and wmat.ndim == 4 \
                    and wmat.shape[1] in (3, 4):
                wmat = wmat.copy()
                wmat[:, [0, 2]] = wmat[:, [2, 0]]  # BGR -> RGB
            arg_params[name + "_weight"] = nd.array(wmat)
            if len(lblobs) > 1:
                arg_params[name + "_bias"] = nd.array(lblobs[1].ravel())
    return sym, arg_params, aux_params


def _bn_producer(layers, top):
    """Name of the BatchNorm layer producing ``top`` (None if the
    producer is not a BatchNorm — a standalone Scale, refused)."""
    for la in layers:
        if top in _aslist(la.get("top")) and \
                _norm_type(la.get("type")) == "BatchNorm":
            return la.get("name")
    return None


def convert_mean(binaryproto: bytes) -> np.ndarray:
    """Mean-file BlobProto → (C, H, W) array (reference
    convert_mean.py). Accepts the raw bytes of a .binaryproto file.
    Real mean files carry legacy num/channels/height/width dims with
    num=1 — squeezed to match the reference tool's output shape."""
    arr = _parse_blob(memoryview(binaryproto))
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    return arr


_CAFFEOP_SEQ = 0


def CaffeOp(data, prototxt: str, name=None):
    """Single-layer runtime sugar — the reference plugin's CaffeOp
    (``plugin/caffe/caffe_operator.cc``) embedded a Caffe layer spec in
    the graph and ran Caffe's kernel; here the same prototxt snippet is
    mapped onto the native op registry at graph-build time:

        net = mx.caffe.CaffeOp(net, 'layer { name: "c1" '
                               'type: "Convolution" convolution_param '
                               '{ num_output: 8 kernel_size: 3 } }')

    The snippet must contain exactly one layer; bottom/top wiring is
    implied by ``data``."""
    cfg = parse_prototxt(prototxt)
    layers = _aslist(cfg.get("layer")) or _aslist(cfg.get("layers"))
    if not layers and cfg.get("type"):
        layers = [cfg]  # bare `name: ... type: ...` body
    if len(layers) != 1:
        raise ValueError("CaffeOp needs exactly one layer in the "
                         "prototxt snippet (got %d)" % len(layers))
    layer = dict(layers[0])
    if name is not None:
        layer["name"] = name
    if "name" not in layer:
        # unique per call — two unnamed parametric layers must not
        # silently share '<name>_weight' params
        global _CAFFEOP_SEQ
        _CAFFEOP_SEQ += 1
        layer["name"] = "caffeop%d" % _CAFFEOP_SEQ
    layer["bottom"] = "_caffeop_in"
    layer["top"] = layer["name"]
    from . import symbol as sym_mod

    out = _emit_layer(sym_mod, layer, lambda bottom: data, [layer])
    if out is _SKIP:
        raise ValueError("layer type %r emits no computation"
                         % layer.get("type"))
    return out


def convert(prototxt_path: str, caffemodel_path: str):
    """File-path front end: the prototxt's and the caffemodel's paths (or
    URIs ``filesystem.open_uri`` reads)."""
    from .filesystem import open_uri

    with open_uri(prototxt_path, "r") as f:
        text = f.read()
    with open_uri(caffemodel_path, "rb") as f:
        data = f.read()
    return convert_model(text, data)


# -- test/tooling support: a wire-format WRITER so tests can fabricate
# caffemodel binaries without Caffe or protobuf installed ----------------


def _enc_varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _enc_field(field, wt, payload):
    return _enc_varint(field << 3 | wt) + payload


def encode_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, "<f4")
    shape = b"".join(_enc_field(1, 0, _enc_varint(d)) for d in arr.shape)
    body = _enc_field(7, 2, _enc_varint(len(shape)) + shape)
    data = arr.ravel().tobytes()
    body += _enc_field(5, 2, _enc_varint(len(data)) + data)
    return body


def encode_caffemodel(layer_blobs: Dict[str, List[np.ndarray]]) -> bytes:
    """NetParameter binary (V2 layer field) for tests/fixtures."""
    out = b""
    for name, blobs in layer_blobs.items():
        nm = name.encode()
        body = _enc_field(1, 2, _enc_varint(len(nm)) + nm)
        for b in blobs:
            enc = encode_blob(b)
            body += _enc_field(7, 2, _enc_varint(len(enc)) + enc)
        out += _enc_field(100, 2, _enc_varint(len(body)) + body)
    return out
