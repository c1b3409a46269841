"""The port's recurrent ops and cells against the JAX package's, on the CPU,
from the same seeded numpy inputs (mirrors tests/test_rnn.py).

Tolerances: the Sequence ops exactly (forward and gradient); ``RNN`` in
every mode, bidirectional and over two layers, forward and every gradient
within 1e-4 of the largest |value| in float32; unrolled cells' symbol JSON
byte for byte; ``FusedRNN``'s initialized vector and ``BucketSentenceIter``'s
batches exactly.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.rnn_op import rnn_param_size as jax_param_size
from mxnet_tpu_torch.ops.rnn_op import rnn_param_size, rnn_unpack_layout

RTOL = 1e-4
PKGS = (mx, mt)


def _close(got, ref, tol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max()


def _bind(pkg, net, inputs, grad_names=()):
    args = {k: pkg.nd.array(v, pkg.cpu()) for k, v in inputs.items()}
    grads = {k: pkg.nd.zeros(inputs[k].shape, pkg.cpu()) for k in grad_names}
    return net.bind(pkg.cpu(), args, args_grad=grads or None,
                    grad_req={k: "write" if k in grads else "null"
                              for k in inputs})


def _run(pkg, build, inputs, grad_names, head_grads):
    """Forward outputs and the gradients of ``grad_names`` under
    ``head_grads``, as numpy."""
    ex = _bind(pkg, build(pkg), inputs, grad_names)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([pkg.nd.array(g, pkg.cpu()) for g in head_grads])
    return outs, {k: ex.grad_dict[k].asnumpy() for k in grad_names}


# ---------------------------------------------------------------------------
# Sequence ops
# ---------------------------------------------------------------------------

SEQ_CASES = [
    ("SequenceLast", {}), ("SequenceLast", {"use_sequence_length": True}),
    ("SequenceMask", {}), ("SequenceMask", {"use_sequence_length": True}),
    ("SequenceMask", {"use_sequence_length": True, "value": -2.5}),
    ("SequenceReverse", {}),
    ("SequenceReverse", {"use_sequence_length": True}),
]


@pytest.mark.parametrize("op,attrs", SEQ_CASES)
def test_sequence_op_matches_jax(op, attrs):
    """Forward and data gradient exactly, lengths 0, fractional, in range,
    T and past T included."""
    T, N, C = 6, 5, 3
    rng = np.random.RandomState(0)
    x = rng.randn(T, N, C).astype(np.float32)
    lengths = np.array([0, 2.7, 6, 9, 4], np.float32)
    inputs = {"data": x}
    if attrs.get("use_sequence_length"):
        inputs["sequence_length"] = lengths

    def build(pkg):
        syms = [pkg.sym.Variable(k) for k in inputs]
        return getattr(pkg.sym, op)(*syms, name="s", **attrs)

    out_shape = (N, C) if op == "SequenceLast" else (T, N, C)
    head = rng.randn(*out_shape).astype(np.float32)
    ref = _run(mx, build, inputs, ["data"], [head])
    got = _run(mt, build, inputs, ["data"], [head])
    np.testing.assert_array_equal(got[0][0], ref[0][0])
    np.testing.assert_array_equal(got[1]["data"], ref[1]["data"])


def test_sequence_length_takes_no_gradient():
    for pkg in PKGS:
        net = pkg.sym.SequenceMask(pkg.sym.Variable("data"),
                                   pkg.sym.Variable("sequence_length"),
                                   use_sequence_length=True)
        ex = net.simple_bind(pkg.cpu(), data=(3, 2, 2), sequence_length=(2,))
        assert "sequence_length" not in ex.grad_dict
        last = pkg.sym.SequenceLast(pkg.sym.Variable("data"),
                                    pkg.sym.Variable("sequence_length"),
                                    use_sequence_length=True)
        assert last.infer_shape(data=(3, 2, 2))[:2] == \
            ([(3, 2, 2), (2,)], [(2, 2)])


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
def test_rnn_op_matches_jax(mode, layers, bidir):
    """Output and final states, and the gradients of data, the packed
    parameters and the begin states, under random head gradients."""
    T, N, I, H = 5, 3, 4, 6
    d = 2 if bidir else 1
    rng = np.random.RandomState(1)
    ps = rnn_param_size(I, H, layers, mode, bidir)
    assert ps == jax_param_size(I, H, layers, mode, bidir)
    inputs = {"data": rng.randn(T, N, I).astype(np.float32),
              "parameters": (0.3 * rng.randn(ps)).astype(np.float32),
              "state": (0.2 * rng.randn(layers * d, N, H)).astype(np.float32)}
    if mode == "lstm":
        inputs["state_cell"] = (0.2 * rng.randn(layers * d, N, H)).astype(
            np.float32)

    def build(pkg):
        syms = {k: pkg.sym.Variable(k) for k in inputs}
        return pkg.sym.RNN(state_size=H, num_layers=layers,
                           bidirectional=bidir, mode=mode, state_outputs=True,
                           name="rnn", **syms)

    shapes = [(T, N, H * d)] + [(layers * d, N, H)] * (
        2 if mode == "lstm" else 1)
    heads = [rng.randn(*s).astype(np.float32) for s in shapes]
    ref_outs, ref_grads = _run(mx, build, inputs, list(inputs), heads)
    got_outs, got_grads = _run(mt, build, inputs, list(inputs), heads)
    for g, r in zip(got_outs, ref_outs):
        _close(g, r)
    for k in inputs:
        _close(got_grads[k], ref_grads[k])


@pytest.mark.parametrize("mode,nstate", [("rnn_relu", 1), ("rnn_tanh", 1),
                                         ("lstm", 2), ("gru", 1)])
def test_rnn_op_shapes(mode, nstate):
    T, N, I, H, L = 7, 4, 5, 6, 2
    ps = rnn_param_size(I, H, L, mode, True)
    ins = dict(data=mt.nd.array(np.random.randn(T, N, I).astype(np.float32),
                                mt.cpu()),
               parameters=mt.nd.array(
                   0.1 * np.random.randn(ps).astype(np.float32), mt.cpu()),
               state=mt.nd.zeros((L * 2, N, H), mt.cpu()))
    if mode == "lstm":
        ins["state_cell"] = mt.nd.zeros((L * 2, N, H), mt.cpu())
    outs = mt.nd.RNN(state_size=H, num_layers=L, bidirectional=True,
                     mode=mode, state_outputs=True, **ins)
    outs = outs if isinstance(outs, list) else [outs]
    assert len(outs) == 1 + nstate
    assert outs[0].shape == (T, N, 2 * H)
    assert all(o.shape == (L * 2, N, H) for o in outs[1:])


def test_packed_layout_matches_jax():
    from mxnet_tpu.ops.rnn_op import rnn_unpack_layout as jax_layout

    for mode in ("rnn_tanh", "lstm", "gru"):
        for bidir in (False, True):
            assert rnn_unpack_layout(5, 7, 3, mode, bidir) == \
                jax_layout(5, 7, 3, mode, bidir)


def test_rnn_dropout_only_in_training_and_replays():
    """Dropout between layers: inference is the JAX package's; training
    drops about p of the first layer's outputs, the same masks under one
    seed, none with one layer."""
    T, N, I, H = 4, 8, 3, 16
    rng = np.random.RandomState(2)
    ps = rnn_param_size(I, H, 2, "lstm")
    inputs = {"data": rng.randn(T, N, I).astype(np.float32),
              "parameters": (0.3 * rng.randn(ps)).astype(np.float32),
              "state": np.zeros((2, N, H), np.float32),
              "state_cell": np.zeros((2, N, H), np.float32)}

    def run(pkg, is_train, p=0.5, layers=2, seed=0):
        params = inputs["parameters"] if layers == 2 else \
            inputs["parameters"][:rnn_param_size(I, H, 1, "lstm")]
        ins = dict(inputs, parameters=params,
                   state=inputs["state"][:layers],
                   state_cell=inputs["state_cell"][:layers])
        syms = {k: pkg.sym.Variable(k) for k in ins}
        net = pkg.sym.RNN(state_size=H, num_layers=layers, mode="lstm", p=p,
                          **syms)
        ex = _bind(pkg, net, ins)
        pkg.random.seed(seed)
        return ex.forward(is_train=is_train)[0].asnumpy()

    _close(run(mt, False), run(mx, False))
    a, b = run(mt, True, seed=3), run(mt, True, seed=3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, run(mt, False))
    assert not np.array_equal(a, run(mt, True, seed=4))
    np.testing.assert_array_equal(run(mt, True, layers=1),
                                  run(mt, False, layers=1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rnn_state_zeros_matches_jax(dtype):
    outs = []
    for pkg in PKGS:
        x = pkg.nd.array(np.ones((3, 5, 2)), pkg.cpu(), dtype=dtype)
        out = pkg.nd._rnn_state_zeros(x, shape=(2, 0, 7), batch_axis=1)
        outs.append(out)
        net = pkg.sym._rnn_state_zeros(pkg.sym.Variable("data"),
                                       shape=(0, 4))
        assert net.infer_shape(data=(6, 2))[1] == [(6, 4)]
    assert outs[0].shape == outs[1].shape == (2, 5, 7)
    assert str(outs[1].dtype) == str(np.dtype(dtype))
    assert not outs[1].asnumpy().any()


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _cell(pkg, kind):
    r = pkg.rnn
    if kind == "stack":
        c = r.SequentialRNNCell()
        c.add(r.LSTMCell(8, prefix="l0_"))
        c.add(r.GRUCell(8, prefix="l1_"))
        c.add(r.DropoutCell(0.3))
        c.add(r.ResidualCell(r.RNNCell(8, activation="relu", prefix="l2_")))
        return c
    if kind == "fused":
        return r.FusedRNNCell(8, num_layers=2, mode="lstm", bidirectional=True,
                              dropout=0.2, get_next_state=True)
    if kind == "fused_gru":
        return r.FusedRNNCell(6, num_layers=1, mode="gru")
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(4, prefix="a_"),
                                   r.GRUCell(4, prefix="b_"))
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(5, prefix="z_"), 0.3, 0.2)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["stack", "fused", "fused_gru",
                                  "bidirectional", "zoneout"])
@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", False)])
def test_unroll_json_matches_jax(kind, layout, merge):
    """The unrolled graph's JSON byte for byte, and each package loads the
    other's."""
    texts = []
    for pkg in PKGS:
        with pkg.NameManager():
            out, states = _cell(pkg, kind).unroll(
                4, inputs=pkg.sym.Variable("data"), layout=layout,
                merge_outputs=merge)
            out = out if isinstance(out, list) else [out]
            texts.append(pkg.sym.Group(out + list(states)).tojson())
    assert texts[0] == texts[1]
    assert mt.sym.load_json(texts[0]).tojson() == texts[0]
    assert mx.sym.load_json(texts[1]).tojson() == texts[1]


def test_unroll_with_begin_state_and_step_inputs_json_matches_jax():
    texts = []
    for pkg in PKGS:
        with pkg.NameManager():
            cell = pkg.rnn.LSTMCell(10, prefix="l_")
            begin = cell.begin_state()
            outs, states = cell.unroll(3, begin_state=begin, input_prefix="t_")
            texts.append(pkg.sym.Group(outs + states).tojson())
            zeros = cell.begin_state(func=pkg.sym.zeros, batch_size=2)
            texts.append(pkg.sym.Group(zeros).tojson())
    assert texts[0] == texts[2] and texts[1] == texts[3]


def test_cell_unroll_shapes():
    cell = mt.rnn.LSTMCell(10, prefix="l_")
    outputs, states = cell.unroll(3, input_prefix="t_")
    assert len(outputs) == 3 and len(states) == 2
    _, out_shapes, _ = mt.sym.Group(outputs).infer_shape(
        t_t0_data=(2, 7), t_t1_data=(2, 7), t_t2_data=(2, 7))
    assert all(tuple(s) == (2, 10) for s in out_shapes)
    stack = mt.rnn.SequentialRNNCell()
    stack.add(mt.rnn.LSTMCell(8, prefix="l0_"))
    stack.add(mt.rnn.LSTMCell(8, prefix="l1_"))
    out, states = stack.unroll(4, inputs=mt.sym.Variable("data"),
                               merge_outputs=True)
    assert len(states) == 4
    assert tuple(out.infer_shape(data=(2, 4, 6))[1][0]) == (2, 4, 8)
    o, s = mt.rnn.DropoutCell(0.5)(mt.sym.Variable("x"), [])
    assert s == []


def _cell_forward(pkg, net, x, params, extra=None):
    args = {"data": pkg.nd.array(x, pkg.cpu())}
    args.update({k: pkg.nd.array(np.asarray(v), pkg.cpu())
                 for k, v in params.items()})
    return net.bind(pkg.cpu(), args).forward()[0].asnumpy()


@pytest.mark.parametrize("mode,bidir", [("rnn_tanh", False), ("lstm", False),
                                        ("gru", False), ("lstm", True)])
def test_fused_vs_unfused_matches_jax(mode, bidir):
    """FusedRNNCell and its unfuse()d stack through unpack_weights agree in
    the port, and each matches the JAX package's; unpack and pack give the
    JAX package's arrays."""
    T, N, I, H, L = 5, 3, 4, 6, 1 if bidir else 2
    rng = np.random.RandomState(3)
    x = rng.randn(N, T, I).astype(np.float32)
    packed = (0.2 * rng.randn(rnn_param_size(I, H, L, mode, bidir))).astype(
        np.float32)
    name = "%s_parameters" % mode
    outs = {}
    for pkg in PKGS:
        fused = pkg.rnn.FusedRNNCell(H, num_layers=L, mode=mode,
                                     bidirectional=bidir, prefix="%s_" % mode)
        data = pkg.sym.Variable("data")
        f_out, _ = fused.unroll(T, inputs=data, merge_outputs=True)
        u_out, _ = fused.unfuse().unroll(T, inputs=data, merge_outputs=True)
        unpacked = fused.unpack_weights({name: packed})
        outs[pkg] = (_cell_forward(pkg, f_out, x, {name: packed}),
                     _cell_forward(pkg, u_out, x, unpacked), unpacked,
                     fused.pack_weights(unpacked)[name])
    got, ref = outs[mt], outs[mx]
    assert got[0].shape == (N, T, H * (2 if bidir else 1))
    _close(got[0], got[1])
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        np.testing.assert_array_equal(got[2][k], ref[2][k])
    np.testing.assert_array_equal(got[3], packed)
    np.testing.assert_array_equal(ref[3], packed)


@pytest.mark.parametrize("writer,reader", [(mx, mt), (mt, mx)])
@pytest.mark.parametrize("fused", [False, True])
def test_symbol_and_params_written_by_one_package_load_in_the_other(
        tmp_path, writer, reader, fused):
    """An unrolled LSTM stack or a FusedRNNCell: symbol JSON and .params
    saved by one package load in the other and give the same forward; the
    packed vector unpacks to the stack's per-layer parameters there."""
    T, N, I, H = 4, 2, 3, 5
    rng = np.random.RandomState(4)
    x = rng.randn(N, T, I).astype(np.float32)
    packed = (0.3 * rng.randn(rnn_param_size(I, H, 2, "lstm"))).astype(
        np.float32)

    def net(pkg):
        cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                    prefix="lstm_")
        if not fused:
            cell = cell.unfuse()
        out, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                             merge_outputs=True)
        return out, cell

    out, cell = net(writer)
    params = {"lstm_parameters": packed}
    if not fused:
        params = writer.rnn.FusedRNNCell(
            H, num_layers=2, mode="lstm", prefix="lstm_").unpack_weights(params)
    prefix = str(tmp_path / "m")
    writer.model.save_checkpoint(
        prefix, 1, out, {k: writer.nd.array(v, writer.cpu())
                         for k, v in params.items()}, {})
    want = _cell_forward(writer, out, x, params)
    sym, args, _ = reader.model.load_checkpoint(prefix, 1)
    assert sym.tojson() == out.tojson()
    got = _cell_forward(reader, sym, x, {k: v.asnumpy()
                                         for k, v in args.items()})
    _close(got, want)
    if fused:
        r_cell = reader.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                         prefix="lstm_")
        stack_out, _ = r_cell.unfuse().unroll(
            T, inputs=reader.sym.Variable("data"), merge_outputs=True)
        per_layer = r_cell.unpack_weights(args)
        _close(_cell_forward(reader, stack_out, x, per_layer), want)


@pytest.mark.parametrize("writer,reader", [(mx, mt), (mt, mx)])
def test_per_gate_params_carry_over(tmp_path, writer, reader):
    """A packed vector unpacked by the writer to per-gate arrays (each
    LSTMCell's unpack_weights), saved as .params, loads in the reader and
    packs back to the same vector; the JAX package's arrays also carry over
    through convert.params_from_numpy."""
    H, I, L = 5, 3, 2
    rng = np.random.RandomState(6)
    packed = rng.randn(rnn_param_size(I, H, L, "lstm")).astype(np.float32)

    def cells(pkg):
        return (pkg.rnn.FusedRNNCell(H, num_layers=L, mode="lstm",
                                     prefix="lstm_"),
                [pkg.rnn.LSTMCell(H, prefix="lstm_l%d_" % i)
                 for i in range(L)])

    fused, layers = cells(writer)
    args = fused.unpack_weights({"lstm_parameters": packed})
    for cell in layers:
        args = cell.unpack_weights(args)
    assert "lstm_l1_h2h_f_weight" in args and "lstm_l0_i2h_weight" not in args
    fname = str(tmp_path / "gates.params")
    writer.nd.save(fname, {"arg:" + k: writer.nd.array(v, writer.cpu())
                           for k, v in args.items()})
    loaded = {k[4:]: v for k, v in reader.nd.load(fname).items()}
    if reader is mt:
        loaded = mt.convert.params_from_numpy(
            {k: v.asnumpy() for k, v in loaded.items()}, mt.cpu())
    fused, layers = cells(reader)
    for cell in layers:
        loaded = cell.pack_weights(loaded)
    np.testing.assert_array_equal(
        fused.pack_weights(loaded)["lstm_parameters"], packed)


def test_fused_rnn_initializer_matches_jax():
    """dumps is the JAX package's; with a deterministic inner init the
    packed vector is too, and a random one draws every unpacked array."""
    H, L, I = 4, 2, 3
    ps = rnn_param_size(I, H, L, "lstm", True)
    got = {}
    for pkg in PKGS:
        init = pkg.init.FusedRNN(pkg.init.Constant(0.25), H, L, "lstm",
                                 bidirectional=True, forget_bias=2.0)
        inner = pkg.init.Constant(0.25).dumps()
        assert pkg.init.FusedRNN(inner, H, L, "lstm", True, 2.0) \
            .dumps() == init.dumps()
        arr = pkg.nd.zeros((ps,), pkg.cpu())
        init._init_weight(pkg.init.InitDesc("lstm_parameters"), arr)
        got[pkg] = (init.dumps(), arr.asnumpy())
        desc = pkg.init.InitDesc("lstm_parameters",
                                 {"__init__": init.dumps()})
        arr2 = pkg.nd.zeros((ps,), pkg.cpu())
        pkg.init.Uniform(0.1)(desc, arr2)
        np.testing.assert_array_equal(arr2.asnumpy(), got[pkg][1])
    assert got[mt][0] == got[mx][0]
    np.testing.assert_array_equal(got[mt][1], got[mx][1])
    arr = mt.nd.zeros((ps,), mt.cpu())
    mt.init.FusedRNN(mt.init.Xavier(), H, L, "lstm", True)._init_weight(
        mt.init.InitDesc("lstm_parameters"), arr)
    cell = mt.rnn.FusedRNNCell(H, L, "lstm", True)
    for k, v in cell.unpack_weights({"lstm_parameters": arr}).items():
        assert v.any() == k.endswith("weight"), k


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    """One seed of Python's and numpy's generators gives both packages the
    same batches, in the same bucket order, over two epochs."""
    rng = np.random.RandomState(5)
    sents = [list(rng.randint(1, 30, size=rng.randint(2, 12)))
             for _ in range(80)] + [[1] * 20]  # one past the buckets
    seen = {}
    for pkg in PKGS:
        random.seed(7)
        np.random.seed(7)
        it = pkg.rnn.BucketSentenceIter(sents, 4, buckets=[4, 8, 11],
                                        invalid_label=0, layout=layout)
        batches = []
        for _ in range(2):
            for b in it:
                batches.append((b.bucket_key, b.data[0].asnumpy(),
                                b.label[0].asnumpy(), b.provide_data[0].shape))
            it.reset()
        seen[pkg] = (batches, it.provide_data[0].shape, it.default_bucket_key)
    (got, gshape, gkey), (ref, rshape, rkey) = seen[mt], seen[mx]
    assert (gshape, gkey) == (rshape, rkey)
    assert len(got) == len(ref) > 10
    for g, r in zip(got, ref):
        assert g[0] == r[0] and g[3] == r[3]
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_array_equal(g[2], r[2])
    b = got[0]
    shift = (b[2][:, :-1], b[1][:, 1:]) if layout == "NT" else \
        (b[2][:-1], b[1][1:])
    np.testing.assert_array_equal(*shift)
