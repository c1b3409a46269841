"""Initializers and metrics against the JAX package, on the CPU.

Initializers: the name rules of ``Initializer.__call__`` (``upsampling*``
weights get the bilinear kernel, ``stn_loc*`` weights zero and biases the
identity affine transform) give the JAX package's values exactly, also
through ``Module.init_params`` on a bilinear ``UpSampling`` net;
Orthogonal's Q·Qᵀ = scale²·I, MSRAPrelu's variance and ``dumps()``,
Bilinear and LSTMBias exactly.  Random draws differ between the packages
(torch generators against threefry keys), so the random initializers are
held by their statistics.

Metrics: each against the JAX package on the same labels and predictions
(1e-6 relative: the port reduces in float64 on the device, the JAX package
in float32 numpy), F1's binary check, and TopKAccuracy on tied
predictions, where the JAX package's unstable ``numpy.argsort`` may rank
differently from ``torch.topk``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def _init_both(init_name, kwargs, name, shape):
    out = []
    for pkg in (mx, mt):
        arr = pkg.nd.zeros(shape, pkg.cpu())
        getattr(pkg.init, init_name)(**kwargs)(pkg.init.InitDesc(name), arr)
        out.append(arr.asnumpy())
    return out


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 2, 5, 7), (4, 4, 8, 8),
                                   (1, 1, 3, 16)])
@pytest.mark.parametrize("init", ["Xavier", "Uniform", "Normal", "Zero"])
def test_upsampling_weights_get_the_bilinear_kernel(init, shape):
    """Every initializer writes the JAX package's bilinear kernel into an
    ``upsampling*`` weight, bit for bit."""
    jax_w, port_w = _init_both(init, {}, "upsampling0_weight", shape)
    np.testing.assert_array_equal(port_w, jax_w)
    assert port_w.ravel()[0] == jax_w.ravel()[0] != 0


@pytest.mark.parametrize("name,shape", [("stn_loc_weight", (6, 10)),
                                        ("stn_loc_bias", (6,)),
                                        ("stn_loc2_bias", (6,))])
def test_stn_loc_parameters_get_the_identity_transform(name, shape):
    jax_v, port_v = _init_both("Xavier", {}, name, shape)
    np.testing.assert_array_equal(port_v, jax_v)
    if name.endswith("bias"):
        np.testing.assert_array_equal(port_v, [1, 0, 0, 0, 1, 0])
    else:
        assert not port_v.any()


def test_module_init_params_of_a_bilinear_upsampling_net_matches_jax():
    """``Module.init_params(Xavier())`` on an UpSampling (bilinear) net
    with a ``stn_loc`` layer: every parameter equal in both packages."""
    got = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            data = pkg.sym.Variable("data")
            up = pkg.sym.UpSampling(data, scale=2, sample_type="bilinear",
                                    num_filter=3, num_args=1)
            net = pkg.sym.FullyConnected(pkg.sym.Flatten(up), num_hidden=6,
                                         name="stn_loc")
        mod = pkg.mod.Module(net, label_names=(), context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 3, 5, 5))], for_training=False)
        mod.init_params(pkg.init.Xavier())
        args, _ = mod.get_params()
        got.append({k: v.asnumpy() for k, v in args.items()})
    assert sorted(got[0]) == sorted(got[1]) == \
        ["stn_loc_bias", "stn_loc_weight", "upsampling0_weight"]
    for k in got[0]:
        np.testing.assert_array_equal(got[1][k], got[0][k])


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(8, 6), (6, 8), (4, 3, 2, 2)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape, rand_type):
    """Q·Qᵀ = scale²·I over the smaller side, in both packages."""
    for w in _init_both("Orthogonal", {"scale": 1.5, "rand_type": rand_type},
                        "fc_weight", shape):
        q = w.reshape(shape[0], -1).astype(np.float64)
        g = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(g, 2.25 * np.eye(len(g)), atol=1e-5)


def test_msra_prelu_variance_and_dumps():
    """Gaussian at variance 2 / (1 + slope²) / fan (avg of in and out);
    ``dumps()`` names the class and its own kwargs, as the JAX package's."""
    kwargs = {"factor_type": "in", "slope": 0.5}
    shape = (256, 128, 3, 3)
    jax_w, port_w = _init_both("MSRAPrelu", kwargs, "conv_weight", shape)
    var = 2.0 / (1 + 0.25) / (128 * 9)
    n = port_w.size
    for w in (jax_w, port_w):
        assert abs(w.mean()) <= 6 * np.sqrt(var / n)
        assert abs(w.var() - var) <= 6 * np.sqrt(2 * var ** 2 / n)
    assert mt.init.MSRAPrelu(**kwargs).dumps() == \
        mx.init.MSRAPrelu(**kwargs).dumps()
    assert mt.init.MSRAPrelu().dumps() == mx.init.MSRAPrelu().dumps()


@pytest.mark.parametrize("name,shape", [("a_weight", (2, 3, 6, 6)),
                                        ("b_weight", (1, 1, 5, 5))])
def test_bilinear_initializer_matches_jax(name, shape):
    jax_w, port_w = _init_both("Bilinear", {}, name, shape)
    np.testing.assert_array_equal(port_w, jax_w)


@pytest.mark.parametrize("name", ["lstm_i2h_bias", "lstm_h2h_weight"])
def test_lstm_bias_matches_jax(name):
    jax_b, port_b = _init_both("LSTMBias", {"forget_bias": 2.5}, name, (16,))
    np.testing.assert_array_equal(port_b, jax_b)
    np.testing.assert_array_equal(port_b[4:8], 2.5)


def test_initializers_by_attr_and_registry():
    """An ``__init__`` attr naming a new initializer dispatches to it in
    the port as in the JAX package."""
    attrs = {"__init__": mx.init.Bilinear().dumps()}
    got = []
    for pkg in (mx, mt):
        arr = pkg.nd.zeros((1, 1, 4, 4), pkg.cpu())
        pkg.init.Xavier()(pkg.init.InitDesc("w_weight", attrs), arr)
        got.append(arr.asnumpy())
    np.testing.assert_array_equal(got[1], got[0])
    assert {"Orthogonal", "MSRAPrelu", "Bilinear", "LSTMBias"} <= \
        set(mt.init.__all__)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _pairs(seed, n=24, classes=5, batches=3):
    rng = np.random.RandomState(seed)
    labels = [rng.randint(0, classes, n).astype(np.float32)
              for _ in range(batches)]
    preds = [rng.rand(n, classes).astype(np.float32) for _ in range(batches)]
    return labels, preds


def _update(metric_of, labels, preds):
    out = []
    for pkg in (mx, mt):
        m = metric_of(pkg)
        for lab, pred in zip(labels, preds):
            m.update([pkg.nd.array(lab, pkg.cpu())],
                     [pkg.nd.array(pred, pkg.cpu())])
        out.append(m.get())
    return out


def _assert_metric(got, ref):
    assert got[0] == ref[0]
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(ref[1], np.float64),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,kwargs", [
    ("top_k_accuracy", {"top_k": 2}), ("top_k_accuracy", {"top_k": 3}),
    ("acc", {}), ("ce", {}), ("loss", {}), ("f1", {}),
])
def test_classification_metrics_match_jax(name, kwargs):
    labels, preds = _pairs(1, classes=2 if name == "f1" else 5)
    ref, got = _update(lambda pkg: pkg.metric.create(name, **kwargs),
                       labels, preds)
    _assert_metric(got, ref)


@pytest.mark.parametrize("name", ["mae", "mse", "rmse"])
@pytest.mark.parametrize("label_shape", [(16,), (16, 1), (16, 3)])
def test_regression_metrics_match_jax(name, label_shape):
    """A 1-d label is made a column first in both packages (so it
    broadcasts against the prediction alike)."""
    rng = np.random.RandomState(2)
    pred_shape = label_shape if len(label_shape) == 2 else (16, 1)
    labels = [rng.randn(*label_shape).astype(np.float32) for _ in range(2)]
    preds = [rng.randn(*pred_shape).astype(np.float32) for _ in range(2)]
    ref, got = _update(lambda pkg: pkg.metric.create(name), labels, preds)
    _assert_metric(got, ref)


def test_f1_refuses_more_than_two_classes_and_handles_no_positives():
    labels = [np.array([0, 1, 2, 1], np.float32)]
    preds = [np.eye(3, dtype=np.float32)[[0, 1, 2, 1]][:, :2]]
    for pkg in (mx, mt):
        with pytest.raises(ValueError, match="binary"):
            pkg.metric.F1().update([pkg.nd.array(labels[0], pkg.cpu())],
                                   [pkg.nd.array(preds[0], pkg.cpu())])
    labels = [np.zeros(4, np.float32)]
    preds = [np.tile(np.array([[0.9, 0.1]], np.float32), (4, 1))]
    ref, got = _update(lambda pkg: pkg.metric.F1(), labels, preds)
    _assert_metric(got, ref)
    assert got[1] == 0.0


def test_custom_metric_np_and_create_callable():
    def close(label, pred):
        return float((np.abs(label - pred.argmax(1)) < 1).sum()), len(label)

    labels, preds = _pairs(3)
    for make in (lambda pkg: pkg.metric.np(close),
                 lambda pkg: pkg.metric.create(close),
                 lambda pkg: pkg.metric.CustomMetric(
                     lambda lab, p: float(lab.sum()), name="tot")):
        ref, got = _update(make, labels, preds)
        _assert_metric(got, ref)
    assert mt.metric.np(close).name == "close"


def test_composite_of_the_train_api_metrics():
    labels, preds = _pairs(4)
    ref, got = _update(lambda pkg: pkg.metric.create(
        ["acc", pkg.metric.TopKAccuracy(top_k=3), "ce"]), labels, preds)
    assert got[0] == ref[0] == ["accuracy", "top_k_accuracy_3",
                                "cross-entropy"]
    _assert_metric(got, ref)


def test_top_k_accuracy_on_tied_predictions():
    """Tied scores: the JAX package ranks with ``numpy.argsort`` (not
    stable: which members of a tie it ranks last depends on numpy's sort),
    the port with ``torch.topk``.  Each package's accuracy is what its own
    ranking gives; on nine classes tied at the top with k = 3 and every
    label 9, numpy here ranks 9, 8, 7 first and torch 8, 7, 6, so the two
    read 1 and 0 (ROADMAP C records it as a kept difference).  With the tie
    broken by a small step the two agree."""
    pred = np.full((8, 10), 0.5, np.float32)
    pred[:, 0] = 0.1
    lab = np.full(8, 9, np.float32)
    ref, got = _update(lambda pkg: pkg.metric.TopKAccuracy(top_k=3),
                       [lab], [pred])
    top_np = np.argsort(pred, axis=1)[:, ::-1][:, :3]
    top_torch = torch.topk(torch.from_numpy(pred), 3, dim=1).indices.numpy()
    assert ref[1] == (top_np == lab[:, None]).any(1).mean()
    assert got[1] == (top_torch == lab[:, None]).any(1).mean()
    broken = pred + np.arange(10, dtype=np.float32)[None] * 1e-3
    ref, got = _update(lambda pkg: pkg.metric.TopKAccuracy(top_k=3),
                       [lab], [broken])
    _assert_metric(got, ref)
    assert got[1] == 1.0
