"""``model.FeedForward``, ``executor_manager``, ``callback.ProgressBar`` and
``test_utils`` against the JAX package, on the CPU.

``FeedForward`` trains a small MLP 2 epochs from one numpy init and the
same batches in both packages (parameters within 1e-5 of the largest),
then ``predict``, ``score``, ``save`` and ``load`` agree.
``check_numeric_gradient`` passes on a few ops and fails on an op whose
gradient is wrong.  Without CUDA the default context is the card and work
on it raises, in ``FeedForward`` and in ``test_utils`` alike.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.test_utils  # noqa: F401
import mxnet_tpu_torch as mt
from mxnet_tpu.models.mlp import get_mlp as jax_mlp
from mxnet_tpu_torch.models.mlp import get_mlp as port_mlp

BATCH = 8


def _data(seed=0, n=40):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32) + (X[:, 1] > 0.5)
    return X, Y


def _init(net, seed=1):
    arg_shapes, _, _ = net.infer_shape(data=(BATCH, 6))
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _feedforward(pkg, params, **kwargs):
    with pkg.NameManager():
        net = (jax_mlp if pkg is mx else port_mlp)(num_classes=3,
                                                   hidden=(12,))
    return pkg.model.FeedForward(
        net, ctx=pkg.cpu(), num_epoch=2, optimizer="sgd", learning_rate=0.1,
        momentum=0.9, wd=1e-3,
        arg_params={k: pkg.nd.array(v, pkg.cpu()) for k, v in params.items()},
        aux_params={}, numpy_batch_size=BATCH, **kwargs)


def test_feedforward_fit_predict_score_save_load_match_jax(tmp_path):
    with mx.NameManager():
        params = _init(jax_mlp(num_classes=3, hidden=(12,)))
    X, Y = _data()
    got = {}
    for pkg in (mx, mt):
        ff = _feedforward(pkg, params)
        ff.fit(pkg.io.NDArrayIter(X, Y, BATCH), eval_metric="acc")
        prefix = str(tmp_path / pkg.__name__)
        ff.save(prefix)
        loaded = pkg.model.FeedForward.load(prefix, 2, ctx=pkg.cpu(),
                                            numpy_batch_size=BATCH)
        got[pkg] = ({k: v.asnumpy() for k, v in ff.arg_params.items()},
                    ff.predict(X), ff.score(pkg.io.NDArrayIter(X, Y, BATCH)),
                    loaded.predict(X),
                    loaded.score(pkg.io.NDArrayIter(X, Y, BATCH)))
    (jp, jpred, jacc, jlpred, jlacc) = got[mx]
    (tp, tpred, tacc, tlpred, tlacc) = got[mt]
    scale = max(np.abs(v).max() for v in jp.values())
    moved = max(np.abs(jp[k] - params[k]).max() for k in params)
    assert moved > 1e-2 * scale
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 1e-5 * scale, k
    assert tpred.shape == (40, 3)
    np.testing.assert_allclose(tpred, jpred, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpred.sum(1), 1, rtol=1e-6)
    np.testing.assert_array_equal(tlpred, tpred)
    assert tacc == jacc and tlacc == tacc == jlacc


def test_feedforward_numpy_input_callbacks_and_progress_bar(caplog):
    """Arrays as ``X``/``y`` go through an NDArrayIter of
    ``numpy_batch_size``; the batch-end callbacks (Speedometer and
    ProgressBar) run every batch, and ProgressBar draws the JAX
    package's bar."""
    with mx.NameManager():
        params = _init(jax_mlp(num_classes=3, hidden=(12,)))
    X, Y = _data()
    counts = []
    with caplog.at_level(logging.INFO):
        ff = _feedforward(mt, params)
        ff.fit(X, Y, batch_end_callback=[
            mt.callback.Speedometer(BATCH, 2),
            mt.callback.ProgressBar(5, length=10),
            lambda p: counts.append(p.nbatch)])
    assert counts == [0, 1, 2, 3, 4] * 2
    bars = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("[")]
    assert "[====------] 40%\r" in bars
    for pkg in (mx, mt):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            pkg.callback.ProgressBar(7, 14)(
                pkg.model.BatchEndParam(0, 3, None, None))
        assert caplog.records[-1].getMessage() == "[" + "=" * 6 + "-" * 8 \
            + "] 43%\r"


def test_feedforward_on_the_default_context_needs_the_card():
    """``ctx=None`` is the current context, the card: without CUDA,
    ``fit`` raises rather than training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with mt.NameManager():
        net = port_mlp(num_classes=3, hidden=(12,))
    X, Y = _data()
    ff = mt.model.FeedForward(net, num_epoch=1, numpy_batch_size=BATCH)
    with pytest.raises(mt.MXNetError):
        ff.fit(X, Y)
    assert mt.test_utils.default_context() == mt.gpu(0)
    with pytest.raises(mt.MXNetError):
        mt.test_utils.rand_ndarray((2, 3))
    with mt.cpu():
        assert mt.test_utils.default_context() == mt.cpu()
        assert mt.test_utils.rand_ndarray((2, 3)).context == mt.cpu()


def test_executor_manager_matches_jax():
    """``_split_input_slice`` and ``_check_arguments`` as the JAX
    package's; ``DataParallelExecutorManager`` steps a net on one device,
    and over two contexts, and gives the JAX package's gradients."""
    for work in ([1], [1, 1], [1, 2, 1], [3, 1]):
        assert mt.executor_manager._split_input_slice(12, work) == \
            mx.executor_manager._split_input_slice(12, work)
    with pytest.raises(ValueError):
        mt.executor_manager._split_input_slice(2, [1, 1, 1])
    for pkg in (mx, mt):
        with pkg.NameManager():
            w = pkg.sym.Variable("w")
            dup = pkg.sym.FullyConnected(pkg.sym.FullyConnected(
                pkg.sym.Variable("data"), weight=w, num_hidden=4,
                no_bias=True), weight=w, num_hidden=4, no_bias=True)
        assert pkg.executor_manager._check_arguments(dup) is None
    with mx.NameManager():
        params = _init(jax_mlp(num_classes=3, hidden=(12,)))
    X, Y = _data()
    grads = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            net = (jax_mlp if pkg is mx else port_mlp)(num_classes=3,
                                                       hidden=(12,))
        it = pkg.io.NDArrayIter(X, Y, BATCH)
        man = pkg.executor_manager.DataParallelExecutorManager(
            net, pkg.cpu(), it)
        man.set_params({k: pkg.nd.array(v, pkg.cpu())
                        for k, v in params.items()}, {})
        assert man.slices == [slice(0, BATCH)]
        man.load_data_batch(it.next())
        man.forward(is_train=True)
        man.backward()
        grads.append([g.asnumpy() for g in man.grad_arrays])
        metric = pkg.metric.Accuracy()
        man.update_metric(metric, it.getlabel())
    for a, b in zip(*grads):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    # over two contexts: the batch split in halves, the JAX package's
    # one-device gradients
    with mt.NameManager():
        net = port_mlp(num_classes=3, hidden=(12,))
    it = mt.io.NDArrayIter(X, Y, BATCH)
    man = mt.executor_manager.DataParallelExecutorManager(
        net, [mt.cpu(0), mt.cpu(1)], it)
    man.set_params({k: mt.nd.array(v, mt.cpu())
                    for k, v in params.items()}, {})
    assert man.slices == [slice(0, BATCH // 2), slice(BATCH // 2, BATCH)]
    man.load_data_batch(it.next())
    man.forward(is_train=True)
    man.backward()
    for a, b in zip(grads[0], man.grad_arrays):
        np.testing.assert_allclose(b.asnumpy(), a, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# test_utils
# ---------------------------------------------------------------------------


def _ops(pkg):
    with pkg.NameManager():
        x = pkg.sym.Variable("x")
        y = pkg.sym.Variable("y")
        return {"tanh-fc": pkg.sym.FullyConnected(
                    pkg.sym.Activation(x, act_type="tanh"), num_hidden=3,
                    name="fc"),
                "mul": x * y,
                "softmax": pkg.sym.softmax(x * 2.0)}


@pytest.mark.parametrize("name", ["tanh-fc", "mul", "softmax"])
def test_check_numeric_gradient_passes_on_ops(name):
    rng = np.random.RandomState(3)
    net = _ops(mt)[name]
    shapes = {"x": (4, 5), "y": (4, 5)}
    arg_shapes, _, _ = net.infer_shape(
        **{k: v for k, v in shapes.items() if k in net.list_arguments()})
    location = {n: rng.randn(*s) for n, s in zip(net.list_arguments(),
                                                 arg_shapes)}
    mt.test_utils.check_numeric_gradient(net, location, ctx=mt.cpu())


def test_check_numeric_gradient_fails_on_a_wrong_gradient():
    """An op whose backward doubles the gradient is caught."""
    @mt.operator.register("_torchtest_wrong_square")
    class WrongProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Wrong(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0], x * x)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    x = in_data[0].asnumpy()
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0], 4 * x * g)

            return Wrong()

    net = mt.sym.Custom(data=mt.sym.Variable("x"),
                        op_type="_torchtest_wrong_square")
    location = {"x": np.random.RandomState(0).randn(3, 4)}
    with pytest.raises(AssertionError, match="numeric"):
        mt.test_utils.check_numeric_gradient(net, location, ctx=mt.cpu())


def test_symbolic_checks_and_helpers_match_jax():
    """check_symbolic_forward/backward against closed forms, and
    check_consistency across dtypes (the JAX package's form) and across
    contexts (here two CPU runs); the helpers agree with the JAX
    package's."""
    tu = mt.test_utils
    x = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    net = _ops(mt)["mul"]
    tu.check_symbolic_forward(net, {"x": x, "y": 2 * x}, [2 * x * x],
                              ctx=mt.cpu())
    tu.check_symbolic_backward(net, {"x": x, "y": 2 * x}, [np.ones_like(x)],
                               {"x": 2 * x, "y": x}, ctx=mt.cpu())
    with mt.cpu():
        outs = tu.check_consistency(_ops(mt)["softmax"], {"x": x})
        assert len(outs) == 2
        tu.check_consistency(_ops(mt)["tanh-fc"],
                             {"x": x, "fc_weight": x[:3],
                              "fc_bias": x[0, :3]}, dtypes=(np.float32,),
                             ctx_list=[mt.cpu(), mt.cpu()], rtol=0, atol=0)
    assert tu.reldiff(x, x + 1) == mx.test_utils.reldiff(x, x + 1)
    assert tu.same(x, x) and not tu.same(x, x + 1)
    assert tu.almost_equal(x, x + 1e-8)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(x, x + 1)
    np.random.seed(2)
    shape = tu.rand_shape_nd(3)
    np.random.seed(2)
    assert shape == mx.test_utils.rand_shape_nd(3)
    g = tu.numeric_grad(lambda a: float((a["v"] ** 2).sum()),
                        {"v": np.arange(3.0)})
    np.testing.assert_allclose(g["v"], 2 * np.arange(3.0), atol=1e-6)
