"""The long tail of the port against the JAX package, on the CPU:
``Symbol.infer_shape_partial``/``eval``/``grad``, ``Symbol.compose`` and
``Executor.reshape``, dims split over a tuple of mesh axes, ``viz``,
``mt.th``, ``contrib``, ``notebook``, ``log``, ``misc``, ``libinfo``, the doc
registries and the internal-op namespaces, each as the JAX package's own
test covers it (``test_viz.py``, ``test_profiler_contrib.py``,
``test_notebook.py``, ``test_legacy_modules.py``,
``test_rtc_torch_models.py``).

Tolerances: shapes, placements, printed text and parameter pieces are
compared exactly; float32 forwards within 1e-5 relative (one op's
summation order); the tuple-split LM's 3 steps against one context within
1e-4 (the row-parallel sums add partial products in another order).
"""
import glob
import logging
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from jax.sharding import Mesh as JMesh, NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P
from mxnet_tpu_torch.sharding import placement


# ---------------------------------------------------------------------------
# Symbol: partial inference, eval, grad, compose; Executor.reshape
# ---------------------------------------------------------------------------


def _partial_net(pkg):
    """Two branches: one reaches the output from ``data``; ``other``'s
    FullyConnected has no known input, so its shapes stay unknown."""
    with pkg.NameManager():
        data = pkg.sym.Variable("data")
        other = pkg.sym.Variable("other")
        a = pkg.sym.FullyConnected(data, num_hidden=5, name="fa")
        b = pkg.sym.FullyConnected(other, num_hidden=5, name="fb")
        return pkg.sym.Group([pkg.sym.Activation(a, act_type="relu"),
                              pkg.sym.BatchNorm(b, name="bn")])


@pytest.mark.parametrize("given", [{"data": (3, 4)}, {"other": (2, 7)},
                                   {"data": (3, 4), "other": (2, 7)}, {}])
def test_infer_shape_partial_matches_jax(given):
    got = _partial_net(mt).infer_shape_partial(**given)
    ref = _partial_net(mx).infer_shape_partial(**given)
    assert list(got) == list(ref)
    full = _partial_net(mt).infer_shape(**given)
    assert (full[0] is None) == (None in got[0] + got[1])


def test_eval_and_grad():
    with mt.NameManager():
        net = mt.sym.FullyConnected(mt.sym.Variable("x"), num_hidden=3,
                                    name="fc")
    with mx.NameManager():
        jnet = mx.sym.FullyConnected(mx.sym.Variable("x"), num_hidden=3,
                                     name="fc")
    rng = np.random.RandomState(0)
    arrs = {"x": rng.randn(2, 4).astype(np.float32),
            "fc_weight": rng.randn(3, 4).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}
    with mt.cpu():
        got = net.eval(**{k: mt.nd.array(v) for k, v in arrs.items()})
    ref = jnet.eval(mx.cpu(), **{k: mx.nd.array(v) for k, v in arrs.items()})
    assert len(got) == 1 and got[0].context == mt.cpu()
    np.testing.assert_allclose(got[0].asnumpy(), ref[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="not supported"):
        net.grad(["x"])
    with pytest.raises(mx.base.MXNetError):
        jnet.grad(["x"])


def test_compose_and_executor_reshape():
    with mt.NameManager():
        inner = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                      name="fc1")
        outer = mt.sym.Activation(mt.sym.Variable("h"), act_type="tanh",
                                  name="act")
        net = outer(h=inner)
        assert net.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
        assert outer(inner).list_arguments() == net.list_arguments()
        with pytest.raises(ValueError, match="not free arguments"):
            outer(nope=inner)
        with pytest.raises(TypeError):
            outer(inner, h=inner)
    assert "fc1_output" in net.get_internals().list_outputs()
    rng = np.random.RandomState(1)
    ex = net.simple_bind(mt.cpu(), data=(3, 5), grad_req="null")
    ex.arg_dict["fc1_weight"][:] = rng.randn(4, 5).astype(np.float32)
    x = rng.randn(6, 5).astype(np.float32)
    ex2 = ex.reshape(data=(6, 5))
    assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    out = ex2.forward(data=x)[0].asnumpy()
    w = ex.arg_dict["fc1_weight"].asnumpy()
    np.testing.assert_allclose(out, np.tanh(x @ w.T), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# a dim split over a tuple of mesh axes
# ---------------------------------------------------------------------------

MESH_AXES = (("data", 2), ("model", 4))
TUPLE_SPECS = [(("data", "model"), None), (None, ("model", "data")),
               (("model",), "data"), (("data", "model"),)]


@pytest.mark.parametrize("spec", TUPLE_SPECS, ids=str)
def test_tuple_axis_blocks_match_jax(spec):
    """Each coordinate's block of a (16, 8) array under a spec naming a
    tuple of axes is the slice JAX's ``NamedSharding.devices_indices_map``
    gives the device at that coordinate (8 host devices, data=2 x
    model=4), and the gathered array is the array."""
    shape = (16, 8)
    x = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    jmesh = JMesh(devs, ("data", "model"))
    idx = JNamed(jmesh, JP(*spec)).devices_indices_map(shape)
    mesh = mt.sharding.build_mesh(dict(MESH_AXES),
                                  [mt.cpu(i) for i in range(8)])
    st = placement.place(x, mesh, P(*spec))
    for coord in mesh.coords():
        want = x.numpy()[idx[devs[coord]]]
        got = placement._block(x, P(*spec), mesh, coord)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(st.piece(coord).numpy(), want)
    assert torch.equal(st.full(), x)
    assert tuple(st.shape) == shape
    per_dev, repl = mt.sharding.param_bytes([st])
    factor = mt.sharding.spec_shard_factor(mesh, P(*spec))
    assert per_dev * factor == repl


def test_tuple_axis_uneven_split_raises():
    mesh = mt.sharding.build_mesh(dict(MESH_AXES),
                                  [mt.cpu(i) for i in range(8)])
    with pytest.raises(MXNetError, match="split"):
        mt.sharding.shard_params(
            {"w": mt.nd.array(np.zeros((12, 2), np.float32), mt.cpu())},
            mesh, {"w": P(("data", "model"), None)})


LM = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=64, seq_len=16)


def test_lm_trains_with_a_tuple_split_dim():
    """3 sgd steps of the 2-layer float32 LM on data=2 x model=2 (4 CPU
    contexts) with the Megatron rules and ``tok_embed_weight`` split by
    rows over ("data", "model"): the losses and parameters of one
    context within 1e-4, and the embedding stored as 4 row blocks."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    with mt.NameManager():
        net = get_transformer_lm(**LM)
    shape = (4, LM["seq_len"])
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    rng = np.random.RandomState(0)
    params = {n: rng.randn(*s).astype(np.float32) * 0.3
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    X = rng.randint(0, LM["vocab_size"], shape).astype(np.float32)
    Y = (X + 1) % LM["vocab_size"]
    megatron = mt.sharding.get_preset("transformer_megatron")
    rules = mt.sharding.PartitionRules(
        [(r"tok_embed_weight$", P(("data", "model"), None))]
        + megatron.rules, fallback=P(), name="tuple_embed")

    def train(**bind):
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", shape)], **bind)
        mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                                [mt.nd.array(Y, mt.cpu())])
        losses = []
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
            p = mod.get_outputs()[0].asnumpy()
            losses.append(float(-np.log(p[np.arange(p.shape[0]),
                                          Y.reshape(-1).astype(int)]).mean()))
        return mod, losses

    mesh = mt.sharding.build_mesh("data=2,model=2",
                                  [mt.cpu(i) for i in range(4)])
    split, got = train(mesh=mesh, partition_rules=rules)
    one, ref = train()
    emb = split._exec_group.execs[0].arg_dict["tok_embed_weight"]._data
    assert sorted(tuple(p.shape) for p in emb.shards.values()) == \
        [(LM["vocab_size"] // 4, LM["hidden"])] * 4
    assert ref[-1] < ref[0]
    for a, b in zip(got, ref):
        assert abs(a - b) / abs(b) <= 1e-4, (got, ref)
    ga, _ = split.get_params()
    ra, _ = one.get_params()
    scale = max(np.abs(v.asnumpy()).max() for v in ra.values())
    for k in ra:
        assert np.abs(ga[k].asnumpy() - ra[k].asnumpy()).max() / scale \
            <= 1e-4, k


# ---------------------------------------------------------------------------
# visualization, mt.th, contrib, notebook
# ---------------------------------------------------------------------------


def _viz_net(pkg):
    with pkg.NameManager():
        data = pkg.sym.Variable("data")
        net = pkg.sym.Convolution(data, num_filter=8, kernel=(3, 3),
                                  pad=(1, 1), name="conv")
        net = pkg.sym.BatchNorm(net, name="bn")
        net = pkg.sym.Activation(net, act_type="relu", name="relu")
        net = pkg.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                              pool_type="max", name="pool")
        net = pkg.sym.FullyConnected(pkg.sym.Flatten(net), num_hidden=10,
                                     name="fc")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_print_summary_text_for_text(capsys):
    mt.viz.print_summary(_viz_net(mt), shape={"data": (1, 3, 16, 16)})
    got = capsys.readouterr().out
    mx.viz.print_summary(_viz_net(mx), shape={"data": (1, 3, 16, 16)})
    ref = capsys.readouterr().out
    assert got == ref
    assert "Total params: 5154" in got and "8x8x8" in got


def test_plot_network_graphviz():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="graphviz"):
            mt.viz.plot_network(_viz_net(mt))
        with pytest.raises(ImportError, match="graphviz"):
            mx.viz.plot_network(_viz_net(mx))
        return
    dot = mt.viz.plot_network(_viz_net(mt), shape={"data": (1, 3, 16, 16)},
                              save_format="dot")
    ref = mx.viz.plot_network(_viz_net(mx), shape={"data": (1, 3, 16, 16)},
                              save_format="dot")
    assert dot.source == ref.source


def test_torch_bridge():
    assert mt.th.is_available()
    x = mt.nd.array(np.array([[1.0, 4.0], [9.0, 16.0]], np.float32),
                    mt.cpu())
    out = mt.th.sqrt(x)
    ref = mx.th.sqrt(mx.nd.array(x.asnumpy()))
    assert isinstance(out, mt.nd.NDArray) and out.context == x.context
    np.testing.assert_array_equal(out.asnumpy(), ref.asnumpy())
    u, s, v = mt.th.linalg.svd(x)
    _, rs, _ = mx.th.linalg.svd(mx.nd.array(x.asnumpy()))
    assert isinstance(s, mt.nd.NDArray) and s.shape == (2,)
    np.testing.assert_allclose(s.asnumpy(), rs.asnumpy(), rtol=1e-5)
    out2 = mt.th.apply("clamp", x, min=2.0, max=10.0)
    np.testing.assert_array_equal(out2.asnumpy(), [[2, 4], [9, 10]])
    # the NDArray's own tensor, not a copy: an in-place function writes it
    mt.th.apply(torch.Tensor.mul_, x, 2.0)
    np.testing.assert_array_equal(x.asnumpy(), [[2, 8], [18, 32]])
    m = mt.metric.create("torch")
    m.update(None, [mt.nd.array(np.array([1.0, 3.0], np.float32),
                                mt.cpu())])
    assert m.get() == ("torch", 2.0)


def test_contrib_namespace_spellings():
    assert callable(mt.contrib.sym.MultiBoxPrior)
    assert callable(mt.contrib.sym.MultiBoxTarget)
    assert callable(mt.contrib.sym.MultiBoxDetection)
    assert callable(mt.contrib.nd.fft)
    assert sorted(mt.contrib.symbol.__all__) == \
        sorted(mx.contrib.symbol.__all__)
    data = mt.sym.Variable("data")
    anchors = mt.contrib.sym.MultiBoxPrior(data, sizes=(0.5,), ratios=(1.0,))
    _, out_shapes, _ = anchors.infer_shape(data=(1, 3, 8, 8))
    assert out_shapes[0] == (1, 64, 4)
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    out = mt.contrib.nd.fft(mt.nd.array(x, mt.cpu()))
    ref = mx.contrib.nd.fft(mx.nd.array(x))
    assert out.shape == (2, 16)
    np.testing.assert_allclose(out.asnumpy(), ref.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def _fit(tmp_path, **callbacks):
    rng = np.random.RandomState(0)
    X = rng.randn(64, 10).astype(np.float32)
    w = rng.randn(10, 2).astype(np.float32)
    y = (X @ w).argmax(axis=1).astype(np.float32)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=2), name="softmax")
    it = mt.io.NDArrayIter(X, y, batch_size=16)
    val = mt.io.NDArrayIter(X, y, batch_size=16)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.fit(it, eval_data=val, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5}, **callbacks)


def test_tensorboard_log_metrics_callback(tmp_path):
    logdir = str(tmp_path / "tb")
    cb = mt.contrib.tensorboard.LogMetricsCallback(logdir, prefix="train")
    _fit(tmp_path, batch_end_callback=cb)
    assert cb.step >= 5
    wrote_tb = bool(glob.glob(os.path.join(logdir, "events.out.tfevents.*")))
    wrote_jsonl = os.path.exists(os.path.join(logdir, "scalars.jsonl"))
    assert wrote_tb or wrote_jsonl


def test_notebook_metrics_logger(tmp_path, capsys):
    from mxnet_tpu_torch.notebook.callback import (LiveLearningCurve,
                                                   MetricsLogger)

    logger = MetricsLogger(frequent=1)
    live = LiveLearningCurve(metric_name="accuracy", frequent=1)
    _fit(tmp_path, batch_end_callback=[logger.train_cb, live.train_cb],
         eval_end_callback=logger.eval_cb)
    accs = logger.values("accuracy")
    assert len(accs) >= 3
    assert accs[-1] > accs[0] or accs[-1] > 0.9
    assert logger.values("accuracy", "eval")
    line = logger.sparkline("accuracy", width=10)
    assert 0 < len(line) <= 10
    assert "accuracy" in capsys.readouterr().out
    path = tmp_path / "curves.csv"
    logger.to_csv(str(path))
    rows = path.read_text().strip().splitlines()
    assert rows[0].startswith("phase,metric")
    assert any(r.startswith("train,accuracy") for r in rows[1:])
    assert any(r.startswith("eval,accuracy") for r in rows[1:])
    logger._append(logger.train, "accuracy", float("nan"), 99, 0)
    assert len(logger.sparkline("accuracy")) > 0


# ---------------------------------------------------------------------------
# log, misc, libinfo, the doc registries, the internal-op namespaces
# ---------------------------------------------------------------------------


def test_log_module(tmp_path):
    logger = mt.log.get_logger("t_port_parity", level=mt.log.DEBUG)
    assert logger.level == logging.DEBUG
    f = tmp_path / "x.log"
    flog = mt.log.get_logger("t_port_file", filename=str(f),
                             level=mt.log.INFO)
    flog.info("hello-parity")
    for h in flog.handlers:
        h.flush()
    assert "hello-parity" in f.read_text()
    assert mt.log.getLogger is mt.log.get_logger


def test_misc_factor_scheduler():
    from mxnet_tpu.misc import FactorScheduler as JSched
    from mxnet_tpu_torch.misc import FactorScheduler

    sched, ref = FactorScheduler(step=10, factor=0.5), JSched(10, 0.5)
    sched.base_lr = ref.base_lr = 1.0
    assert [sched(i) for i in (0, 10, 25, 40)] == \
        [ref(i) for i in (0, 10, 25, 40)] == [1.0, 0.5, 0.25, 0.0625]
    with pytest.raises(ValueError):
        FactorScheduler(step=0)
    with pytest.raises(ValueError):
        FactorScheduler(step=1, factor=1.5)


def test_libinfo_names_the_ports_libraries():
    from mxnet_tpu_torch import libinfo, native

    capi = native.capi_lib_path()
    paths = libinfo.find_lib_path()
    assert paths and paths[0] == capi
    assert all(p.endswith(".so") and "mxnet_tpu_torch" in p for p in paths)
    assert mt.__version__ == libinfo.__version__


def test_internal_namespaces():
    from mxnet_tpu_torch import _ndarray_internal, _symbol_internal

    out = _ndarray_internal._plus_scalar(mt.nd.ones((2,), mt.cpu()),
                                         scalar=3.0)
    np.testing.assert_array_equal(out.asnumpy(), [4, 4])
    s = _symbol_internal._plus_scalar(mt.sym.Variable("x"), scalar=1.0)
    assert s.list_arguments() == ["x"]
    with pytest.raises(AttributeError):
        _ndarray_internal._no_such_op_xyz
    assert "_plus_scalar" in dir(_ndarray_internal)
    assert "_plus_scalar" in dir(_symbol_internal)


def test_doc_registries():
    from mxnet_tpu_torch import ndarray_doc, symbol_doc

    class FullyConnected(ndarray_doc.NDArrayDoc):
        """Extra FC doc."""

    class Convolution(symbol_doc.SymbolDoc):
        """Extra conv doc."""

    assert ndarray_doc.get_extra_doc("FullyConnected") == "Extra FC doc."
    assert symbol_doc.get_extra_doc("Convolution") == "Extra conv doc."
    shapes = symbol_doc.SymbolDoc.get_output_shape(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3),
        data=(2, 5))
    assert list(shapes.values())[0] == (2, 3)


def test_package_exposes_the_jax_packages_modules():
    for name in ("visualization", "viz", "contrib", "th", "caffe",
                 "notebook", "log", "misc", "libinfo", "__version__"):
        assert hasattr(mt, name), name
