"""The GSPMD layer of the port (``mxnet_tpu_torch.sharding``,
``Executor.set_shardings``, ``Module.bind(mesh=, partition_rules=)``)
against the JAX package's (tests/test_sharding.py) on its 8 virtual CPU
devices: the port runs on ``[mt.cpu(i) for i in range(8)]``, eight
contexts of the one torch CPU device.  The same numpy inputs go through
both; the mesh forms and errors, rule resolution, ``explain`` rows,
``validate_specs``, placement and byte accounting agree, and the MLP and
the 1-layer megatron LM train to the JAX package's sharded Module within
its own tolerances, their weights stored as pieces of the shapes the JAX
package's tests assert."""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import sharding as jsh
from mxnet_tpu_torch import sharding as tsh

CTXS = [mt.cpu(i) for i in range(8)]


def JP(*args):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*args)


TP = tsh.PartitionSpec


def _error(fn):
    """The MXNetError text ``fn`` raises."""
    with pytest.raises((mx.base.MXNetError, mt.MXNetError)) as info:
        fn()
    return str(info.value)


# ----------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("axes", [
    "data=-1,model=2", None, (("model", 2), ("data", -1)),
    {"data": 2, "model": 4}, "data=8", (("data", 2), ("seq", 2), ("x", 2))])
def test_mesh_forms_match_jax(axes):
    if axes is None:
        want, got = jsh.build_mesh(), tsh.build_mesh(devices=CTXS)
    else:
        want = jsh.build_mesh(axes)
        got = tsh.build_mesh(axes, devices=CTXS)
    assert tsh.mesh_axes(got) == jsh.mesh_axes(want)
    assert got.axis_names == tuple(want.axis_names)


def test_mesh_config_parse_matches_jax():
    for text in ("data=8", " data = -1 , model=2 ", "a=1,b=2,c=4"):
        want, got = jsh.MeshConfig.parse(text), tsh.MeshConfig.parse(text)
        assert (got.names, got.sizes) == (want.names, want.sizes)
        assert repr(got) == repr(want)
        assert tsh.mesh_axes(tsh.build_mesh(got, CTXS)) == \
            jsh.mesh_axes(jsh.build_mesh(want))


@pytest.mark.parametrize("case", [
    lambda sh, devs: sh.MeshConfig(("data", 2), ("data", 4)),
    lambda sh, devs: sh.MeshConfig(("a", -1), ("b", -1)),
    lambda sh, devs: sh.MeshConfig(("a", 0)),
    lambda sh, devs: sh.MeshConfig(),
    lambda sh, devs: sh.MeshConfig(("a",)),
    lambda sh, devs: sh.MeshConfig.parse("data:4"),
    lambda sh, devs: sh.MeshConfig.parse("data=x"),
    lambda sh, devs: sh.build_mesh("data=-1,model=3", **devs),
    lambda sh, devs: sh.build_mesh("data=2,model=2", **devs),
], ids=["duplicate", "two_inferred", "zero", "empty", "not_a_pair",
        "no_equals", "not_an_int", "not_divisible", "covers"])
def test_mesh_errors_match_jax(case):
    assert _error(lambda: case(tsh, {"devices": CTXS})) == \
        _error(lambda: case(jsh, {}))


def test_build_mesh_keeps_the_given_axis_order():
    """The leading axis is the batch axis: ``build_mesh`` keeps the order
    it is given, where ``parallel.make_mesh`` orders axes canonically."""
    mesh = tsh.build_mesh("model=2,data=-1", CTXS)
    assert mesh.axis_names == ("model", "data")
    assert mesh.devices.shape == (2, 4)
    assert list(mesh.devices.flat) == CTXS
    assert mt.parallel.make_mesh({"model": 2, "data": 4}, CTXS).axis_names \
        == ("data", "model")


def test_mesh_contexts_may_repeat_and_default_needs_cuda():
    mesh = tsh.build_mesh("data=1,model=2", [mt.cpu(0)] * 2)
    assert tsh.mesh_axes(mesh) == {"data": 1, "model": 2}
    assert tsh.build_mesh(mesh) is mesh
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            tsh.build_mesh("data=-1")


def test_mesh_fingerprint_names_axes_and_contexts():
    a = tsh.build_mesh("data=-1,model=2", CTXS)
    b = tsh.build_mesh("data=-1,model=2", CTXS)
    assert tsh.mesh_fingerprint(a) == tsh.mesh_fingerprint(b) == (
        (("data", 4), ("model", 2)), tuple(str(c) for c in CTXS))
    assert tsh.mesh_fingerprint(tsh.build_mesh("data=8", CTXS)) != \
        tsh.mesh_fingerprint(a)
    # the JAX package's fingerprint has the same axes half
    assert tsh.mesh_fingerprint(a)[0] == \
        jsh.mesh_fingerprint(jsh.build_mesh("data=-1,model=2"))[0]


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------
def _rules(sh, P):
    return sh.PartitionRules([
        (r"_weight$", P("model", None)),
        (r"fc1_weight$", P(None, "model")),  # shadowed by the rule above
        (r"_bias$", P()),
    ], fallback=P(), name="t")


PARAMS = {"fc1_weight": (8, 4), "fc1_bias": (8,), "gamma": (4,),
          "scalar": (), "one": (1, 1)}


def test_rule_resolution_and_explain_rows_match_jax():
    want, got = _rules(jsh, JP), _rules(tsh, TP)
    for name, spec in want.match(PARAMS).items():
        assert tuple(got.match(PARAMS)[name]) == tuple(spec), name
    assert got.explain(PARAMS) == [dict(r, spec=tuple(r["spec"]))
                                   for r in want.explain(PARAMS)]
    assert got.explain_str(PARAMS) == want.explain_str(PARAMS)
    assert repr(got) == repr(want)


def test_unmatched_parameter_and_bad_regex_raise_as_jax():
    for sh, P in ((jsh, JP), (tsh, TP)):
        rules = sh.PartitionRules([(r"_weight$", P("model", None))])
        assert "mystery_param" in _error(
            lambda: rules.match({"mystery_param": (4, 4)}))
    assert _error(lambda: tsh.PartitionRules([("(", TP())])) == \
        _error(lambda: jsh.PartitionRules([("(", JP())]))
    assert _error(lambda: tsh.get_preset("nope")) == \
        _error(lambda: jsh.get_preset("nope"))


def _lm(pkg, layers=1):
    from importlib import import_module

    tr = import_module(pkg.__name__ + ".models.transformer")
    with pkg.NameManager():
        return tr.get_transformer_lm(vocab_size=64, num_layers=layers,
                                     num_heads=2, hidden=32, seq_len=16,
                                     block_q=16, block_k=16)


@pytest.mark.parametrize("preset", sorted(tsh.PRESETS))
def test_presets_resolve_the_lm_as_jax(preset):
    arg_shapes, _, _ = _lm(mx, 2).infer_shape(data=(8, 16),
                                              softmax_label=(8, 16))
    params = {n: tuple(s) for n, s in zip(_lm(mx, 2).list_arguments(),
                                          arg_shapes)
              if n not in ("data", "softmax_label")}
    want = jsh.get_preset(preset).explain(params)
    got = tsh.get_preset(preset).explain(params)
    assert got == [dict(r, spec=tuple(r["spec"])) for r in want]
    assert tsh.match_partition_rules(preset, params) == {
        r["param"]: TP(*r["spec"]) for r in want}


def test_functional_forms_match_jax():
    got = tsh.match_partition_rules([(r"w$", TP("data"))],
                                    {"w": (8,), "b": (4,)}, fallback=TP())
    assert got == {"w": TP("data"), "b": TP()}
    rows = tsh.explain_partition_rules([(r"w$", TP("data"))], {"w": (8,)})
    assert rows == [{"param": "w", "shape": (8,), "rule": "w$",
                     "spec": ("data",)}]
    assert tsh.as_rules("replicated").name == "replicated"


# ----------------------------------------------------------------------
# validation and placement
# ----------------------------------------------------------------------
@pytest.mark.parametrize("specs,shapes", [
    ({"w1": ("_", "model")}, {"w1": (4, 7)}),
    ({"w1": ("pipeline",)}, {"w1": (8, 8)}),
    ({"w1": ("model", "data")}, {"w1": (6, 6)}),
    ({"a": ("data",), "b": (None, "model")}, {"a": (3,), "b": (2, 5)}),
])
def test_validate_specs_rejects_what_jax_rejects(specs, shapes):
    def conv(P):
        return {k: P(*[None if a == "_" else a for a in v])
                for k, v in specs.items()}

    want = _error(lambda: jsh.validate_specs(
        jsh.build_mesh("data=4,model=2"), conv(JP), shapes))
    got = _error(lambda: tsh.validate_specs(
        tsh.build_mesh("data=4,model=2", CTXS), conv(TP), shapes))
    assert got == want
    for name in specs:
        assert name in got


def test_validate_specs_accepts_even_splits():
    mesh = tsh.build_mesh("data=4,model=2", CTXS)
    tsh.validate_specs(mesh, {"w": TP("data", "model"), "b": TP()},
                       {"w": (8, 4), "b": (3,)})


def test_shard_and_gather_roundtrip_and_bytes_match_jax():
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    r = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    jm = jsh.build_mesh("data=4,model=2")
    tm = tsh.build_mesh("data=4,model=2", CTXS)
    jp = jsh.shard_params({"w": mx.nd.array(w), "r": mx.nd.array(r),
                           "b": mx.nd.ones((3,))}, jm, {"w": JP("model", None)})
    tp = tsh.shard_params({"w": mt.nd.array(w, mt.cpu()),
                           "r": mt.nd.array(r, mt.cpu()),
                           "b": mt.nd.ones((3,), mt.cpu())}, tm,
                          {"w": TP("model", None)})
    pieces = tp["w"]._data
    assert {tuple(p.shape) for p in pieces.shards.values()} == \
        {tuple(s.data.shape) for s in jp["w"]._data.addressable_shards} \
        == {(4, 8)}
    assert len(pieces.shards) == 2 and len(tp["r"]._data.shards) == 1
    host = tsh.gather_params(tp)
    for k, v in jsh.gather_params(jp).items():
        np.testing.assert_array_equal(host[k], v, err_msg=k)
    assert tsh.param_bytes(tp.values()) == jsh.param_bytes(jp.values())
    assert tp["w"].shape == (8, 8) and tp["w"].asnumpy().sum() == w.sum()


def test_shard_params_validates_like_jax():
    assert _error(lambda: tsh.shard_params(
        {"w": mt.nd.zeros((4, 7), mt.cpu())},
        tsh.build_mesh("data=4,model=2", CTXS),
        {"w": TP(None, "model")})) == _error(lambda: jsh.shard_params(
            {"w": mx.nd.zeros((4, 7))}, jsh.build_mesh("data=4,model=2"),
            {"w": JP(None, "model")}))


def test_place_passes_a_placed_array_through():
    mesh = tsh.build_mesh("data=8", CTXS)
    x = tsh.place(np.arange(64, dtype=np.float32).reshape(8, 8), mesh,
                  TP("data", None))
    assert tsh.place(x, mesh, TP("data", None)) is x
    # an equal mesh of the same contexts is the same layout
    assert tsh.place(x, tsh.build_mesh("data=8", CTXS),
                     TP("data", None)) is x
    y = tsh.place(x, mesh, TP(None, "data"))
    assert y is not x
    assert [tuple(p.shape) for p in y.shards.values()] == [(8, 1)] * 8
    np.testing.assert_array_equal(y.full().numpy(), x.full().numpy())


def test_exec_group_replicate_passes_a_placed_array_through():
    from mxnet_tpu_torch.module.executor_group import \
        DataParallelExecutorGroup

    mesh = tsh.build_mesh("data=8", CTXS)
    group = DataParallelExecutorGroup.__new__(DataParallelExecutorGroup)
    group._mesh = mesh
    x = tsh.place(np.ones(4, np.float32), mesh, TP())
    assert group._replicate(x) is x
    placed = group._replicate(np.ones(4, np.float32))
    assert isinstance(placed, tsh.ShardedTensor) and \
        placed.is_fully_replicated


def test_set_shardings_rejects_unknown_names_as_jax():
    def bind(pkg, P):
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
        ex = net.simple_bind(pkg.cpu(), data=(8, 6))
        mesh = (tsh.build_mesh("data=8", CTXS) if pkg is mt
                else jsh.build_mesh("data=8"))
        ex.set_shardings(mesh, {"nope": P(), "fc_weight": P()})

    assert _error(lambda: bind(mt, TP)) == _error(lambda: bind(mx, JP))


# ----------------------------------------------------------------------
# sharded training
# ----------------------------------------------------------------------
def _mlp(pkg):
    with pkg.NameManager():
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=8, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_rules(sh, P):
    return sh.PartitionRules([
        (r"fc1_weight$", P("model", None)),
        (r"fc1_bias$", P("model")),
        (r"fc2_weight$", P(None, "model")),
    ], fallback=P(), name="mlp")


def _batches(pkg, data_shape, label_shape, n, vocab=None):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        if vocab:
            X = rng.randint(0, vocab, size=data_shape).astype(np.float32)
            y = rng.randint(0, vocab, size=label_shape).astype(np.float32)
        else:
            X = rng.randn(*data_shape).astype(np.float32)
            y = (rng.rand(*label_shape) * 8).astype(np.float32)
        out.append(pkg.io.DataBatch(data=[pkg.nd.array(X, pkg.cpu())],
                                    label=[pkg.nd.array(y, pkg.cpu())]))
    return out


def _init_params(pkg, symbol, input_shapes):
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    rng = np.random.RandomState(11)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in input_shapes:
            continue
        args[name] = pkg.nd.array(
            (rng.randn(*shape) * 0.05).astype(np.float32), pkg.cpu())
    auxs = {name: pkg.nd.zeros(shape, pkg.cpu())
            for name, shape in zip(symbol.list_auxiliary_states(),
                                   aux_shapes)}
    return args, auxs


def _train(mod, batches, lr=0.1, two_phase=False):
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": lr,
                                         "momentum": 0.9})
    for batch in batches:
        mod.forward_backward(batch)
        if two_phase:
            mod.get_outputs()  # the gradients are wanted before update()
        mod.update()
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def _sharded(pkg, net, shapes, mesh, rules, batch_shapes):
    ctx = CTXS if pkg is mt else pkg.cpu()
    mod = pkg.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", batch_shapes[0])],
             label_shapes=[("softmax_label", batch_shapes[1])],
             mesh=mesh, partition_rules=rules)
    mod.set_params(*_init_params(pkg, net, shapes))
    return mod


@pytest.fixture(scope="module")
def jax_mlp():
    shapes = {"data": (16, 64), "softmax_label": (16,)}
    mod = _sharded(mx, _mlp(mx), shapes, jsh.build_mesh("data=-1,model=2"),
                   _mlp_rules(jsh, JP), ((16, 64), (16,)))
    return _train(mod, _batches(mx, (16, 64), (16,), 3))[0]


@pytest.mark.parametrize("two_phase", [False, True],
                         ids=["fused", "two_phase"])
def test_mlp_sharded_matches_jax_sharded_module(jax_mlp, two_phase):
    shapes = {"data": (16, 64), "softmax_label": (16,)}
    mod = _sharded(mt, _mlp(mt), shapes, "data=-1,model=2",
                   _mlp_rules(tsh, TP), ((16, 64), (16,)))
    got, _ = _train(mod, _batches(mt, (16, 64), (16,), 3),
                    two_phase=two_phase)
    for name in jax_mlp:
        np.testing.assert_allclose(got[name], jax_mlp[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    ex = mod._exec_group.execs[0]
    w = ex.arg_dict["fc1_weight"]._data
    assert isinstance(w, tsh.ShardedTensor)
    assert [tuple(p.shape) for p in w.shards.values()] == [(16, 64)] * 2
    # the optimizer's momentum takes its parameter's spec
    idx = mod._exec_group.param_names.index("fc1_weight")
    state = mod._updater.states[idx]._data
    assert tuple(state.spec) == ("model", None)
    assert [tuple(p.shape) for p in state.shards.values()] == [(16, 64)] * 2
    assert mod._update_on_kvstore is False
    strategies = {n.name: ex._dp.strategy[id(n)][0]
                  for n in ex._plan.nodes if not n.is_variable}
    assert strategies["fc1"] == "col" and strategies["fc2"] == "row"


@pytest.fixture(scope="module")
def jax_lm():
    import mxnet_tpu.telemetry as telemetry

    net = _lm(mx)
    shapes = {"data": (8, 16), "softmax_label": (8, 16)}
    telemetry._reset_for_tests()
    telemetry.enable()
    try:
        mod = _sharded(mx, net, shapes, jsh.build_mesh("data=-1,model=2"),
                       "transformer_megatron", ((8, 16), (8, 16)))
        snap = telemetry.registry().snapshot()
        gauges = (snap.get("mxtpu_params_sharded_bytes"),
                  snap.get("mxtpu_params_replicated_bytes"))
    finally:
        telemetry._reset_for_tests()
    got, _ = _train(mod, _batches(mx, (8, 16), (8, 16), 2, vocab=64),
                    lr=0.05)
    return got, gauges


def test_megatron_lm_2d_mesh_matches_jax_sharded_module(jax_lm):
    """The 1-layer megatron LM on data=-1,model=2 (4 x 2 over the 8
    contexts): two SGD-momentum steps within the JAX package's own
    tolerances of its sharded Module, the qkv weight in two (48, 32)
    pieces, and the byte gauges the JAX package's."""
    want, gauges = jax_lm
    net = _lm(mt)
    shapes = {"data": (8, 16), "softmax_label": (8, 16)}
    mod = _sharded(mt, net, shapes, "data=-1,model=2",
                   "transformer_megatron", ((8, 16), (8, 16)))
    snap = mt.telemetry.registry().snapshot()
    assert (snap["mxtpu_params_sharded_bytes"],
            snap["mxtpu_params_replicated_bytes"]) == gauges
    assert gauges[0] < gauges[1]
    got, _ = _train(mod, _batches(mt, (8, 16), (8, 16), 2, vocab=64),
                    lr=0.05)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=5e-4,
                                   atol=5e-5, err_msg=name)
    ex = mod._exec_group.execs[0]
    w = ex.arg_dict["layer0_qkv_weight"]._data
    assert [tuple(p.shape) for p in w.shards.values()] == [(48, 32)] * 2
    assert tsh.mesh_axes(mod._exec_group._mesh) == {"data": 4, "model": 2}
    strategies = {n.name: ex._dp.strategy[id(n)][0]
                  for n in ex._plan.nodes if not n.is_variable}
    assert [strategies[k] for k in ("layer0_qkv", "layer0_proj",
                                    "layer0_fc1", "layer0_gelu",
                                    "layer0_fc2", "lm_head")] == \
        ["col", "row", "col", "elem", "row", "col"]
    # the qkv output's pieces do not fall on head boundaries: the reshape
    # after it reads the gathered value, and attention runs per batch
    # shard on the whole heads
    assert strategies["layer0_attn"] == "one"
    assert ex._dp.local[next(id(n) for n in ex._plan.nodes
                             if n.name == "layer0_attn")]


def test_sharded_outputs_and_metric_read_whole_arrays():
    shapes = {"data": (16, 64), "softmax_label": (16,)}
    mod = _sharded(mt, _mlp(mt), shapes, "data=-1,model=2",
                   _mlp_rules(tsh, TP), ((16, 64), (16,)))
    batch = _batches(mt, (16, 64), (16,), 1)[0]
    mod.forward(batch, is_train=False)
    out = mod.get_outputs()[0]
    assert out.shape == (16, 8)
    ref = mt.mod.Module(_mlp(mt), context=mt.cpu())
    ref.bind(data_shapes=[("data", (16, 64))],
             label_shapes=[("softmax_label", (16,))])
    ref.set_params(*_init_params(mt, _mlp(mt), shapes))
    ref.forward(batch, is_train=False)
    np.testing.assert_allclose(out.asnumpy(),
                               ref.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)
    w = mod._exec_group.execs[0].arg_dict["fc1_weight"]
    np.testing.assert_array_equal(w.asnumpy(),
                                  _init_params(mt, _mlp(mt), shapes)[0][
                                      "fc1_weight"].asnumpy())
    metric = mt.metric.Accuracy()
    metric.update([batch.label[0]], [out])
    assert 0.0 <= metric.get()[1] <= 1.0
    # predictions stored as pieces are gathered and colocated with the
    # labels before the compare
    labels = np.arange(8) % 2
    acc = mt.metric.Accuracy()
    acc.update([mt.nd.array(labels, mt.cpu())],
               [mt.nd.NDArray(tsh.place(np.eye(2, dtype=np.float32)[labels],
                                        mod._exec_group._mesh,
                                        TP("data", None)), mt.cpu())])
    assert acc.get()[1] == 1.0


def test_default_path_unchanged_without_rules():
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (8, 64))],
             label_shapes=[("softmax_label", (8,))])
    assert mod._exec_group._rules is None
    assert mod._exec_group._mesh is None
    assert mod._exec_group.execs[0]._dp is None


def test_env_var_activation(monkeypatch):
    monkeypatch.setenv("MXNET_SHARDING_MESH", "data=-1,model=2")
    monkeypatch.setenv("MXNET_SHARDING_RULES", "replicated")
    mod = mt.mod.Module(_mlp(mt), context=CTXS)
    mod.bind(data_shapes=[("data", (8, 64))],
             label_shapes=[("softmax_label", (8,))])
    group = mod._exec_group
    assert group._rules is not None and group._rules.name == "replicated"
    assert tsh.mesh_axes(group._mesh) == {"data": 4, "model": 2}
    assert group.slices == [slice(2 * i, 2 * i + 2) for i in range(4)]


def test_bind_rejects_uneven_rule_split_naming_the_parameter():
    def bind(pkg, sh, P, ctx):
        with pkg.NameManager():
            data = pkg.sym.Variable("data")
            net = pkg.sym.FullyConnected(data, num_hidden=7, name="odd")
            net = pkg.sym.SoftmaxOutput(net, name="softmax")
        rules = sh.PartitionRules([(r"odd_weight$", P("model", None))],
                                  fallback=P())
        mod = pkg.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[("data", (8, 64))],
                 label_shapes=[("softmax_label", (8,))],
                 mesh="data=-1,model=2", partition_rules=rules)

    got = _error(lambda: bind(mt, tsh, TP, CTXS))
    assert "odd_weight" in got
    assert got == _error(lambda: bind(mx, jsh, JP, mx.cpu()))


def test_explain_logs_the_rule_table(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_SHARDING_EXPLAIN", "1")
    mod = mt.mod.Module(_mlp(mt), context=CTXS)
    with caplog.at_level(logging.INFO):
        mod.bind(data_shapes=[("data", (8, 64))],
                 label_shapes=[("softmax_label", (8,))],
                 mesh="data=-1,model=2",
                 partition_rules=_mlp_rules(tsh, TP))
    text = caplog.text
    assert "partition rules (mlp)" in text
    assert "fc1_weight" in text and "<fallback>" in text
