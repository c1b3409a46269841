"""The paged-KV attention ops and the generation builders of the port
against the JAX package's, on the CPU, from identical numpy inputs.

The three ops of ``ops/paged.py`` (``_contrib_DenseAttention``,
``_contrib_PagedAttention``, ``_contrib_PagedAttentionWindow``) run through
both registries: outputs within 1e-6 of the largest |value| in float32,
the pool outputs exactly equal (where inactive lanes' or pad slots' writes
collide in the scratch page, both packages keep the last).  Cases cover
inactive lanes on scratch page 0, positions on both sides of a page
boundary, window pad slots, ``causal`` on and off and an explicit
``scale``; ``infer_shape`` agrees between the packages and each op runs
on ``meta`` tensors; a call through ``nd`` leaves its inputs unchanged.

The four builders (prefill in both ``attn_impl``s, verify, catch-up,
decode) give byte-identical JSON under fresh ``NameManager``s and, bound
by ``Predictor`` on the same weights and inputs, outputs within 1e-5 of
the JAX package's (the flash prefill runs K1's plain version on the CPU,
the JAX one its Pallas kernel in interpret mode).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import get_op as jget_op
from mxnet_tpu.ops.registry import OpContext as JOpContext
from mxnet_tpu_torch.ops import OpContext, get_op

PAGED = ("_contrib_PagedAttention", "_contrib_PagedAttentionWindow")


def _run_both(name, attrs, inputs):
    """The op's outputs in both packages, as numpy (JAX, port)."""
    import jax.numpy as jnp

    jop, op = jget_op(name), get_op(name)
    jouts, _ = jop.apply(JOpContext(is_train=False), jop.parse_attrs(attrs),
                         [jnp.asarray(x) for x in inputs], ())
    touts, _ = op.apply(OpContext(is_train=False), op.parse_attrs(attrs),
                        [torch.as_tensor(x) for x in inputs], ())
    return ([np.asarray(o) for o in jouts], [o.numpy() for o in touts])


def _assert_close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, "%s: %.3g of the largest |value|" % (what, err)


def _check(name, attrs, inputs):
    (jo, to) = _run_both(name, attrs, inputs)
    assert [o.shape for o in to] == [o.shape for o in jo]
    _assert_close(to[0], jo[0], 1e-6, name)
    for i in range(1, len(jo)):  # the pools: exactly the JAX package's
        assert np.array_equal(to[i], jo[i]), "%s pool %d" % (name, i)
    # infer_shape agrees between the packages, and the op runs on meta
    shapes = [x.shape for x in inputs]
    jop, op = jget_op(name), get_op(name)
    jinf = jop.infer_shape(jop.parse_attrs(attrs), list(shapes))
    tinf = op.infer_shape(op.parse_attrs(attrs), list(shapes))
    assert [list(map(tuple, s)) for s in jinf[:2]] == \
        [list(map(tuple, s)) for s in tinf[:2]]
    metas, _ = op.apply(OpContext(is_train=False), op.parse_attrs(attrs),
                        [torch.empty(s, device="meta") for s in shapes], ())
    assert [tuple(m.shape) for m in metas] == [o.shape for o in jo]
    assert all(m.device.type == "meta" for m in metas)


# ---------------------------------------------------------------------------
# _contrib_DenseAttention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("shape", [((2, 7, 3, 8), 7), ((1, 5, 2, 16), 9)],
                         ids=["square", "sk9"])
def test_dense_attention_matches_jax(causal, scale, shape):
    (b, sq, h, d), sk = shape
    rng = np.random.RandomState(sq + sk)
    inputs = [rng.randn(b, sq, h, d).astype(np.float32),
              rng.randn(b, sk, h, d).astype(np.float32),
              rng.randn(b, sk, h, d).astype(np.float32)]
    attrs = {"causal": causal}
    if scale is not None:
        attrs["scale"] = scale
    _check("_contrib_DenseAttention", attrs, inputs)


# ---------------------------------------------------------------------------
# _contrib_PagedAttention / _contrib_PagedAttentionWindow
# ---------------------------------------------------------------------------

PS, NUM_PAGES, MAX_PAGES, HEADS, HD = 4, 12, 5, 2, 8


def _pools(rng):
    shape = (NUM_PAGES, PS, HEADS, HD)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _tables(rows):
    """Page-table rows as float carriers, padded with the scratch page."""
    table = np.zeros((len(rows), MAX_PAGES), np.float32)
    for i, row in enumerate(rows):
        table[i, :len(row)] = row
    return table


# (page-table rows, positions): live lanes on both sides of a page
# boundary (3 = last slot of page one, 4 = first slot of page two, 8 the
# first of page three), and inactive lanes (zero rows, position 0) that
# all write into the scratch page
DECODE_CASES = {
    "boundary": ([[3, 5], [2, 9], [7, 1, 4]], [3, 4, 8]),
    "inactive": ([[3, 5, 6], [2], [], []], [9, 0, 0, 0]),
    "one_lane": ([[11, 10, 9, 8, 7]], [19]),
}


@pytest.mark.parametrize("scale", [None, 0.25])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_attention_matches_jax(case, scale):
    rows, positions = DECODE_CASES[case]
    rng = np.random.RandomState(len(rows))
    lanes = len(rows)
    kp, vp = _pools(rng)
    inputs = [rng.randn(lanes, HEADS, HD).astype(np.float32)
              for _ in range(3)] + [kp, vp, _tables(rows),
                                    np.asarray(positions, np.float32)]
    attrs = {"page_size": PS}
    if scale is not None:
        attrs["scale"] = scale
    _check("_contrib_PagedAttention", attrs, inputs)


# (page-table rows, each lane's first position, live slots per lane) at
# window width 4: pad slots park at max_seq_len - 1 = 19, which a row
# shorter than MAX_PAGES sends to the scratch page
WINDOW_CASES = {
    "full": ([[3, 5], [2, 9, 6]], [1, 6], [4, 4]),
    "pads": ([[3, 5], [2, 9, 6], []], [2, 9, 0], [2, 3, 0]),
    "crossing": ([[7, 1, 4]], [2], [4]),
}


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_paged_attention_window_matches_jax(case, scale):
    rows, starts, spans = WINDOW_CASES[case]
    width = 4
    rng = np.random.RandomState(7 + len(rows))
    lanes = len(rows)
    positions = np.full((lanes, width), MAX_PAGES * PS - 1, np.float32)
    for i, (start, span) in enumerate(zip(starts, spans)):
        positions[i, :span] = np.arange(start, start + span)
    kp, vp = _pools(rng)
    inputs = [rng.randn(lanes * width, HEADS, HD).astype(np.float32)
              for _ in range(3)] + [kp, vp, _tables(rows), positions]
    attrs = {"page_size": PS}
    if scale is not None:
        attrs["scale"] = scale
    _check("_contrib_PagedAttentionWindow", attrs, inputs)


@pytest.mark.parametrize("name", PAGED)
def test_standalone_paged_op_leaves_its_inputs_unchanged(name):
    """The op is functional, as the JAX op is: called on its own through
    ``nd`` it returns new pools and its input pools keep their values."""
    rng = np.random.RandomState(3)
    window = name.endswith("Window")
    rows = 2 * (2 if window else 1)
    kp, vp = _pools(rng)
    pos = np.array([[1, 2], [5, 6]] if window else [1, 5], np.float32)
    arrays = [rng.randn(rows, HEADS, HD).astype(np.float32)
              for _ in range(3)] + [kp, vp, _tables([[3], [2, 9]]), pos]
    nds = [mt.nd.array(a, mt.cpu()) for a in arrays]
    out, k_out, v_out = getattr(mt.nd, name)(*nds, page_size=PS)
    for a, x in zip(arrays, nds):
        assert np.array_equal(x.asnumpy(), a)
    assert not np.array_equal(k_out.asnumpy(), kp)  # the new K landed
    assert k_out._data.data_ptr() != nds[3]._data.data_ptr()


def test_registry_lists_every_op_of_the_jax_registry():
    """A fresh listing of both registries (in a new process: tests in this
    one register ops of their own in either package)."""
    import json
    import os
    import subprocess
    import sys

    code = ("import json, mxnet_tpu, mxnet_tpu_torch\n"
            "from mxnet_tpu.ops.registry import _REGISTRY as J\n"
            "from mxnet_tpu_torch.ops.registry import _REGISTRY as T\n"
            "print(json.dumps([sorted(J), sorted(T)]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    jr, tr = (set(x) for x in json.loads(out.stdout.strip().splitlines()[-1]))
    assert tr == jr
    assert (len(jr), len(tr)) == (275, 275)


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

V, LAYERS, NH, HID, S = 64, 2, 2, 32, 32
GEN_PS, GEN_PAGES = 4, 16
GEN_MAX_PAGES = S // GEN_PS


def _builder(pkg, which, lanes):
    tr = pkg.models.transformer
    kw = dict(vocab_size=V, num_layers=LAYERS, num_heads=NH, hidden=HID)
    paged = dict(max_seq_len=S, lanes=lanes, num_pages=GEN_PAGES,
                 page_size=GEN_PS, max_pages=GEN_MAX_PAGES)
    if which.startswith("prefill"):
        return tr.get_transformer_lm_prefill(
            seq_len=16, max_seq_len=S,
            attn_impl="flash" if which == "prefill_flash" else "dense", **kw)
    if which == "decode":
        return tr.get_transformer_lm_decode(**kw, **paged)
    return getattr(tr, "get_transformer_lm_" + which)(width=3, **kw,
                                                      **paged)


BUILDERS = ("prefill_dense", "prefill_flash", "decode", "catchup", "verify")


def _weights(rng):
    net = mx.models.get_transformer_lm(vocab_size=V, num_layers=LAYERS,
                                       num_heads=NH, hidden=HID, seq_len=S)
    shapes, _, _ = net.infer_shape(data=(1, S), softmax_label=(1, S))
    return {n: (rng.randn(*s) * 0.05).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _builder_inputs(which, rng, lanes):
    if which.startswith("prefill"):
        return {"data": rng.randint(0, V, (2, 16)).astype(np.float32)}
    width = None if which == "decode" else 3
    rows = [[3, 5, 7], [2, 9], [11]][:lanes]
    starts = [9, 5, 2][:lanes]
    if width is None:
        positions = np.asarray(starts, np.float32)
        data = rng.randint(0, V, (lanes,))
    else:
        positions = np.stack([np.arange(s, s + width) for s in starts])
        positions = positions.astype(np.float32)
        data = rng.randint(0, V, (lanes, width))
    table = np.zeros((lanes, GEN_MAX_PAGES), np.float32)
    for i, row in enumerate(rows):
        table[i, :len(row)] = row
    inputs = {"data": data.astype(np.float32), "positions": positions,
              "page_table": table}
    pool = (GEN_PAGES, GEN_PS, NH, HID // NH)
    for i in range(LAYERS):
        for kv in "kv":
            inputs["layer%d_%s_pool" % (i, kv)] = rng.randn(*pool).astype(
                np.float32)
    return inputs


@pytest.mark.parametrize("which", BUILDERS)
def test_builder_json_and_outputs_match_jax(which):
    """Byte-identical JSON, and the same outputs through ``Predictor`` on
    one set of weights and inputs (the lanes' positions cross pages)."""
    lanes = 3
    with mx.name.NameManager():
        jsym = _builder(mx, which, lanes)
    with mt.NameManager():
        tsym = _builder(mt, which, lanes)
    assert tsym.tojson() == jsym.tojson()
    rng = np.random.RandomState(BUILDERS.index(which))
    weights = _weights(rng)
    inputs = _builder_inputs(which, rng, lanes)
    shapes = {k: v.shape for k, v in inputs.items()}
    jpred = mx.Predictor(jsym, {k: mx.nd.array(v) for k, v in
                                weights.items()}, shapes)
    tpred = mt.Predictor(tsym, {k: mt.nd.array(v, mt.cpu()) for k, v in
                                weights.items()}, shapes, ctx=mt.cpu())
    jouts = [o.asnumpy() for o in jpred.forward(**inputs)]
    touts = [o.asnumpy() for o in tpred.forward(**inputs)]
    assert tsym.list_outputs() == jsym.list_outputs()
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.shape == j.shape
        _assert_close(t, j, 1e-5, "%s output %d" % (which, i))


def test_predictor_binds_pool_planes_given_as_params():
    """The decode graph's pools bound as parameters (the engine's way:
    shared, not copied) infer their shapes from the arrays given."""
    rng = np.random.RandomState(5)
    inputs = _builder_inputs("decode", rng, 2)
    with mt.NameManager():
        sym = _builder(mt, "decode", 2)
    params = {k: mt.nd.array(v, mt.cpu())
              for k, v in _weights(rng).items()}
    planes = {k: mt.nd.array(v, mt.cpu()) for k, v in inputs.items()
              if k.endswith("_pool")}
    params.update(planes)
    feed = {k: inputs[k] for k in ("data", "positions", "page_table")}
    pred = mt.Predictor(sym, params, {k: v.shape for k, v in feed.items()},
                        ctx=mt.cpu())
    for name, arr in planes.items():
        assert pred._exec.arg_dict[name] is arr
    again = pred.reshape({"data": (1,), "positions": (1,),
                          "page_table": (1, GEN_MAX_PAGES)})
    for name, arr in planes.items():
        assert again._exec.arg_dict[name] is arr
    assert len(pred.forward(**feed)) == 1 + 2 * LAYERS
