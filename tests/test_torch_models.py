"""The port's image model zoo and ``Module`` with BatchNorm's aux states,
against the JAX package on the CPU, from identical numpy inputs.

- Every builder's ``tojson()`` is byte-identical to the JAX package's.
- Each model's inference forward at its smallest valid input (batch 2,
  random moving statistics) within 1e-4 of the largest output.
- Module training of small ResNets: the helpers here (``_resnet_case``,
  ``_train``, ``_distances``); the parity cases and ROADMAP C.7's float32
  ResNet-50 are in ``tests/test_torch_models_train.py`` (the two files
  take about equal time).
- The aux path: the initializer's moving statistics, Xavier's fan-in over
  4-d weights, aux written on a training forward and not by ``backward``,
  ``.params`` with ``aux:`` keys crossing packages byte for byte.

Small ResNets are chaotic in float32 at their usual init: BatchNorm's
gradients explode with depth at small batches, so the 50-layer model
(32x32, batch 8) moves further under one float32 ulp of its init than the
two packages differ (``test_small_resnet_training_is_chaotic_...``).  The
parity cases start both ResNets from the zero-γ init (the last BatchNorm
of each residual branch at γ = 0, Goyal et al. 2017), which keeps the
same graphs well-conditioned."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import models as jm
from mxnet_tpu_torch import models as tm

#: bf16 training: the parameter (and aux) change against the JAX
#: package's, relative to its norm, as in tests/test_torch_train.py
BF16_CHANGE_LIMIT = 0.15
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}


def _nets(fn, **kw):
    with mx.NameManager():
        jn = getattr(jm, fn)(**kw)
    with mt.NameManager():
        tn = getattr(tm, fn)(**kw)
    return jn, tn


# ---------------------------------------------------------------------------
# graph JSON
# ---------------------------------------------------------------------------

BUILDERS = [
    ("get_mlp", {}), ("get_mlp", {"num_classes": 3, "hidden": (16, 8, 4)}),
    ("get_lenet", {}), ("get_lenet", {"num_classes": 100}),
    ("get_resnet", {}),
    ("get_resnet", {"num_layers": 18, "image_shape": (3, 32, 32),
                    "num_classes": 10}),
    ("get_resnet", {"num_layers": 34, "image_shape": (3, 64, 64)}),
    ("get_resnet", {"num_layers": 101, "image_shape": (3, 65, 65)}),
    ("get_resnet", {"num_layers": 152, "num_classes": 11}),
    ("get_alexnet", {}), ("get_alexnet", {"num_classes": 10}),
    ("get_vgg", {}), ("get_vgg", {"num_layers": 11, "batch_norm": True}),
    ("get_vgg", {"num_layers": 13}),
    ("get_vgg", {"num_layers": 19, "num_classes": 100}),
    ("get_googlenet", {}), ("get_googlenet", {"num_classes": 10}),
    ("get_inception_bn", {}), ("get_inception_bn", {"num_classes": 21}),
    ("get_inception_v3", {}), ("get_inception_v3", {"num_classes": 5}),
]


@pytest.mark.parametrize("fn,kw", BUILDERS,
                         ids=["%s-%d" % (b[0][4:], i) for i, b in
                              enumerate(BUILDERS)])
def test_builder_json_is_byte_identical(fn, kw):
    jn, tn = _nets(fn, **kw)
    assert tn.tojson() == jn.tojson()
    # and the port reads it back to the same graph
    assert mt.sym.load_json(jn.tojson()).tojson() == jn.tojson()


@pytest.mark.parametrize("fn,kw", [("get_resnet", {"num_layers": 20}),
                                   ("get_vgg", {"num_layers": 12})])
def test_builders_refuse_unknown_depths_alike(fn, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jm, fn)(**kw)
    with pytest.raises(ValueError) as terr:
        getattr(tm, fn)(**kw)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# inference forward of each model at its smallest valid input
# ---------------------------------------------------------------------------

FORWARD = [
    ("get_mlp", {}, (2, 20)),
    ("get_lenet", {}, (2, 1, 16, 16)),
    ("get_resnet", {"num_layers": 50, "image_shape": (3, 32, 32),
                    "num_classes": 10}, (2, 3, 1, 1)),
    ("get_resnet", {"num_layers": 18, "num_classes": 10}, (2, 3, 1, 1)),
    ("get_alexnet", {"num_classes": 10}, (2, 3, 67, 67)),
    ("get_vgg", {"num_layers": 11, "batch_norm": True, "num_classes": 10},
     (2, 3, 32, 32)),
    ("get_googlenet", {"num_classes": 10}, (2, 3, 1, 1)),
    ("get_inception_bn", {"num_classes": 10}, (2, 3, 1, 1)),
    ("get_inception_v3", {"num_classes": 10}, (2, 3, 75, 75)),
]


def _init(names, shapes, rng, zero_gamma=None):
    """Numpy parameters: He-scaled uniform weights (Xavier in, magnitude
    2.34), unit gammas (0 for each residual branch's last BatchNorm, named
    ``..._<zero_gamma>_bn_gamma``: "c" in a bottleneck, "b" in a basic
    unit), zero betas and biases."""
    out = {}
    for name, shape in zip(names, shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("weight"):
            s = np.sqrt(2.34 / np.prod(shape[1:]))
            out[name] = rng.uniform(-s, s, shape).astype(np.float32)
        elif name.endswith("gamma"):
            g = 0.0 if zero_gamma and name.startswith("stage") and \
                name.endswith("_%s_bn_gamma" % zero_gamma) else 1.0
            out[name] = np.full(shape, g, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


@pytest.mark.parametrize("fn,kw,shape", FORWARD,
                         ids=[f[0][4:] + "-%d" % i
                              for i, f in enumerate(FORWARD)])
def test_model_inference_forward_matches_jax(fn, kw, shape):
    jn, tn = _nets(fn, **kw)
    arg_shapes, _, aux_shapes = jn.infer_shape(data=shape)
    rng = np.random.RandomState(2)
    args = _init(jn.list_arguments(), arg_shapes, rng)
    args["data"] = rng.uniform(-1, 1, shape).astype(np.float32)
    args["softmax_label"] = rng.randint(0, 10, shape[:1]).astype(np.float32)
    aux = {n: (rng.randn(*s) * 0.1 if n.endswith("mean") else
               rng.uniform(0.5, 1.5, s)).astype(np.float32)
           for n, s in zip(jn.list_auxiliary_states(), aux_shapes)}
    outs = []
    for pkg, net in ((mx, jn), (mt, tn)):
        ex = net.bind(pkg.cpu(), {k: pkg.nd.array(v, pkg.cpu())
                                  for k, v in args.items()},
                      aux_states={k: pkg.nd.array(v, pkg.cpu())
                                  for k, v in aux.items()})
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    assert outs[1].shape == outs[0].shape == (shape[0], 10)
    err = np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max()
    assert err <= 1e-4, err


# ---------------------------------------------------------------------------
# Module training with aux states
# ---------------------------------------------------------------------------

#: (layers, image size, batch, zero-γ init, SGD learning rate)
RESNETS = {"resnet50-cifar": (50, 32, 8, True, 0.01),
           "resnet18-imagenet-stem": (18, 72, 4, True, 0.01)}


def _resnet_case(name, zero_gamma=None):
    layers, size, batch, zg, _ = RESNETS[name]
    jn, tn = _nets("get_resnet", num_layers=layers, num_classes=10,
                   image_shape=(3, size, size))
    shape = (batch, 3, size, size)
    arg_shapes, _, aux_shapes = jn.infer_shape(data=shape)
    rng = np.random.RandomState(0)
    zg = zg if zero_gamma is None else zero_gamma
    args = _init(jn.list_arguments(), arg_shapes, rng,
                 ("c" if layers >= 50 else "b") if zg else None)
    aux = {n: (np.zeros if n.endswith("mean") else np.ones)(s, np.float32)
           for n, s in zip(jn.list_auxiliary_states(), aux_shapes)}
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    Y = rng.randint(0, 10, (batch,)).astype(np.float32)
    return jn, tn, args, aux, X, Y, RESNETS[name][4]


def _train(pkg, net, args, aux, X, Y, dtype, lr=0.01, steps=3):
    """``steps`` SGD-momentum steps of ``net`` through Module from numpy
    ``args``/``aux`` on one batch: (losses, params, aux) as numpy."""
    mod = pkg.mod.Module(net, context=pkg.cpu(), compute_dtype=dtype)
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("softmax_label", Y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=dict(SGD, learning_rate=lr))
    batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                             [pkg.nd.array(Y, pkg.cpu())])
    losses = []
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
        p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float32)
        losses.append(float(-np.log(p[np.arange(len(Y)),
                                      Y.astype(int)]).mean()))
    arg_out, aux_out = mod.get_params()
    return (losses, {k: v.asnumpy() for k, v in arg_out.items()},
            {k: v.asnumpy() for k, v in aux_out.items()})


def _largest_err(got, ref):
    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale


def _change_err(got, ref, init):
    """||(got - init) - (ref - init)|| / ||ref - init|| over a dict."""
    num = sum(float(((got[k].astype(np.float64) - ref[k]) ** 2).sum())
              for k in ref)
    den = sum(float(((ref[k].astype(np.float64) - init[k]) ** 2).sum())
              for k in ref)
    return (num / den) ** 0.5


def _distances(a, b, args, aux):
    """(relative loss error, parameter error / largest, aux error /
    largest, parameter change error, aux change error) of run ``a``
    against run ``b``."""
    loss = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
    return (loss, _largest_err(a[1], b[1]), _largest_err(a[2], b[2]),
            _change_err(a[1], b[1], args), _change_err(a[2], b[2], aux))


@pytest.mark.parametrize("name,dtype,limit", [
    ("resnet50-cifar", None, 1e-4),
    ("resnet18-imagenet-stem", "bfloat16", BF16_CHANGE_LIMIT)],
    ids=["resnet50-cifar-f32", "resnet18-bf16"])
def test_small_resnet_training_is_chaotic_where_parity_is_not_held(
        name, dtype, limit):
    """Why the parity above takes the small ResNets from the zero-γ init:
    from the unit-γ init, ResNet-50 in float32 and ResNet-18 in bf16, the
    port's own run with the weights moved one float32 ulp ends further
    from the port's run than the parity limit (parameter error of the
    largest in float32, the change norm in bf16), and the JAX package lies
    within 3x that spread."""
    zero_gamma = False
    jn, tn, args, aux, X, Y, lr = _resnet_case(name, zero_gamma)
    nudged = {k: np.nextafter(v, np.float32(np.inf)).astype(np.float32)
              if k.endswith("weight") else v for k, v in args.items()}
    port = _train(mt, tn, args, aux, X, Y, dtype, lr)
    witness = _distances(_train(mt, tn, nudged, aux, X, Y, dtype, lr), port,
                         args, aux)
    jax_run = _distances(_train(mx, jn, args, aux, X, Y, dtype, lr), port,
                         args, aux)
    which = 1 if dtype is None else 3  # parameter error, or change error
    assert witness[which] > limit, witness
    assert jax_run[which] <= 3 * witness[which], (jax_run, witness)


# ---------------------------------------------------------------------------
# the aux path through Module, checkpoints and convert
# ---------------------------------------------------------------------------


def _lenet_bn(pkg):
    """A small conv net with BatchNorm (aux states) and every image op."""
    with pkg.NameManager():
        sym = pkg.sym
        net = sym.Convolution(sym.Variable("data"), kernel=(3, 3),
                              num_filter=4, pad=(1, 1), name="conv1")
        net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = sym.Activation(net, act_type="relu")
        net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2))
        net = sym.Dropout(net, p=0.25)
        net = sym.FullyConnected(sym.Flatten(net), num_hidden=3, name="fc")
        return sym.SoftmaxOutput(net, name="softmax")


SHAPE = (4, 2, 6, 6)


def _bound(pkg, init=True, **kw):
    mod = pkg.mod.Module(_lenet_bn(pkg), context=pkg.cpu(), **kw)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (SHAPE[0],))])
    if init:
        mod.init_params(pkg.init.Xavier(factor_type="in", magnitude=2.34))
    return mod


def test_initializer_sets_moving_stats_and_xavier_fan_in():
    """moving_mean 0 and moving_var 1 in both packages; Xavier("in",
    2.34) draws a 4-d weight from U(-s, s) with s = sqrt(2.34 / (C·kh·kw))
    in the port."""
    for pkg in (mx, mt):
        _, aux = _bound(pkg).get_params()
        assert sorted(aux) == ["bn1_moving_mean", "bn1_moving_var"]
        np.testing.assert_array_equal(aux["bn1_moving_mean"].asnumpy(), 0)
        np.testing.assert_array_equal(aux["bn1_moving_var"].asnumpy(), 1)
        assert aux["bn1_moving_var"].dtype == np.float32
    mt.random.seed(3)
    args, _ = _bound(mt).get_params()
    w = args["conv1_weight"].asnumpy()
    s = np.sqrt(2.34 / (2 * 3 * 3))
    assert w.shape == (4, 2, 3, 3)
    assert np.abs(w).max() <= s and np.abs(w).max() > 0.8 * s


def test_batch_norm_aux_states_stay_float32_under_bf16_compute():
    """BatchNorm's moving statistics are float32 arrays in both packages
    when the Module computes in bf16, before and after a training step
    that moves them, and the symbol's ``infer_type`` says float32."""
    rng = np.random.RandomState(2)
    X = rng.randn(*SHAPE).astype(np.float32)
    Y = rng.randint(0, 3, SHAPE[:1]).astype(np.float32)
    for pkg in (mx, mt):
        mod = _bound(pkg, compute_dtype="bfloat16")
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
        before = _bound_aux(mod)
        mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                                              [pkg.nd.array(Y, pkg.cpu())]))
        mod.update()
        after = _bound_aux(mod)
        ex = mod._exec_group.execs[0]
        assert sorted(ex.aux_dict) == ["bn1_moving_mean", "bn1_moving_var"]
        for k, v in ex.aux_dict.items():
            assert v.dtype == np.float32, (pkg.__name__, k, v.dtype)
            assert before[k].dtype == after[k].dtype == np.float32
            assert not np.array_equal(before[k], after[k]), (pkg.__name__, k)
        aux_types = _lenet_bn(pkg).infer_type(data=np.float32)[2]
        assert [np.dtype(t) for t in aux_types] == [np.dtype(np.float32)] * 2


def _numpy_state(mod):
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _bound_aux(mod):
    """The executor's aux states as numpy (``get_params`` of the JAX
    package syncs them only after an update)."""
    ex = mod._exec_group.execs[0]
    return {k: v.asnumpy() for k, v in ex.aux_dict.items()}


def test_aux_written_by_a_training_forward_not_by_backward():
    """As in the JAX package: ``forward(is_train=True)`` writes the moving
    statistics once, ``backward`` (which re-runs the forward) does not
    write them again, an inference forward leaves them, and the fused
    step (``forward_backward`` + ``update``) writes them once per step."""
    rng = np.random.RandomState(5)
    X = rng.randn(*SHAPE).astype(np.float32)
    Y = rng.randint(0, 3, SHAPE[:1]).astype(np.float32)
    jmod = _bound(mx)
    args, aux = _numpy_state(jmod)
    got = {}
    for pkg in (mx, mt):
        mod = _bound(pkg, init=False)
        mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in args.items()},
                        aux_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in aux.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
        batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                                 [pkg.nd.array(Y, pkg.cpu())])
        seen = []
        mod.forward(batch, is_train=True)
        seen.append(_bound_aux(mod))
        mod.backward()
        seen.append(_bound_aux(mod))
        mod.forward(batch, is_train=False)
        seen.append(_bound_aux(mod))
        mod.forward_backward(batch)
        mod.update()
        seen.append(_bound_aux(mod))
        assert all(np.array_equal(v, seen[-1][k])
                   for k, v in _numpy_state(mod)[1].items())
        got[pkg.__name__] = seen
    for seen in got.values():
        for k in aux:
            assert not np.array_equal(seen[0][k], aux[k])
            np.testing.assert_array_equal(seen[1][k], seen[0][k])
            np.testing.assert_array_equal(seen[2][k], seen[0][k])
            assert not np.array_equal(seen[3][k], seen[0][k])
    for jseen, tseen in zip(got["mxnet_tpu"], got["mxnet_tpu_torch"]):
        for k in aux:
            np.testing.assert_allclose(tseen[k], jseen[k], rtol=1e-5,
                                       atol=1e-6)


def test_params_with_aux_keys_cross_packages(tmp_path):
    """``save_params`` writes ``arg:`` and ``aux:`` keys; the bytes one
    package writes, the other loads and writes again unchanged, both ways;
    ``convert.params_from_numpy`` carries the ``aux:`` names across."""
    jmod = _bound(mx)
    jargs, jaux = _numpy_state(jmod)
    jaux = {k: v + 0.5 for k, v in jaux.items()}  # distinguishable values
    jmod.set_params({k: mx.nd.array(v, mx.cpu()) for k, v in jargs.items()},
                    {k: mx.nd.array(v, mx.cpu()) for k, v in jaux.items()})
    jfile, tfile = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jmod.save_params(jfile)
    keys = sorted(mt.nd.load(jfile))
    assert "aux:bn1_moving_mean" in keys and "arg:conv1_weight" in keys
    tmod = _bound(mt, init=False)
    tmod.load_params(jfile)
    targs, taux = _numpy_state(tmod)
    for k in jaux:
        np.testing.assert_array_equal(taux[k], jaux[k])
    tmod.save_params(tfile)
    raw = open(jfile, "rb").read()
    assert open(tfile, "rb").read() == raw
    jmod2 = _bound(mx, init=False)
    jmod2.load_params(tfile)
    jmod2.save_params(jfile)
    assert open(jfile, "rb").read() == raw
    loaded = {k: v.asnumpy() for k, v in mx.nd.load(tfile).items()}
    conv = mt.convert.params_from_numpy(loaded, mt.cpu())
    assert sorted(conv) == keys
    np.testing.assert_array_equal(conv["aux:bn1_moving_var"].asnumpy(),
                                  jaux["bn1_moving_var"])


def test_default_context_resnet_module_raises_without_cuda():
    """No fallback hides the device: a ResNet Module on the default context
    (the card) raises at bind when there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with mt.NameManager():
        net = tm.get_resnet(num_layers=18, num_classes=10,
                            image_shape=(3, 32, 32))
    mod = mt.mod.Module(net)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mod.bind(data_shapes=[("data", (2, 3, 32, 32))],
                 label_shapes=[("softmax_label", (2,))])


# ---------------------------------------------------------------------------
# SSD (slice 11): the detection graphs through Module and Predictor
# ---------------------------------------------------------------------------

#: the small SSD of tests/test_ssd.py
SMALL_SSD = dict(num_classes=2, num_filters=(8, 16, 16, 16))
SSD_SGD = {"learning_rate": 0.2, "momentum": 0.9}  # the example's


@pytest.mark.parametrize("fn,kw", [
    ("get_ssd_train", {}), ("get_ssd_detect", {}),
    ("get_ssd_train", SMALL_SSD), ("get_ssd_detect", SMALL_SSD),
    ("get_ssd_detect", dict(num_classes=5, nms_thresh=0.45,
                            force_suppress=True, nms_topk=100)),
    ("get_ssd_train", dict(num_classes=20, num_filters=(16, 32, 64, 64)))],
    ids=["train", "detect", "train-small", "detect-small", "detect-nms",
         "train-20"])
def test_ssd_json_is_byte_identical(fn, kw):
    jn, tn = _nets(fn, **kw)
    assert tn.tojson() == jn.tojson()
    assert mt.sym.load_json(jn.tojson()).tojson() == jn.tojson()


def test_ssd_symbols_share_every_parameter():
    with mx.NameManager():
        jtrain, jdet = jm.get_ssd_symbols(**SMALL_SSD)
    with mt.NameManager():
        ttrain, tdet = tm.get_ssd_symbols(**SMALL_SSD)
    assert ttrain.tojson() == jtrain.tojson() and \
        tdet.tojson() == jdet.tojson()
    params = set(tdet.list_arguments()) - {"data"}
    assert params == set(ttrain.list_arguments()) - {"data", "label"}
    assert tdet.list_auxiliary_states() == ttrain.list_auxiliary_states()


def _ssd_boxes(n, size=64, seed=0, dense=False):
    """``examples/ssd/train_ssd.py``'s synthetic images (one square a
    sample; labels padded with -1 rows) or, ``dense``, the same labels on
    U(0, 1) images."""
    import sys
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples", "ssd"))
    from train_ssd import synthetic_detection

    X, L = synthetic_detection(n, size=size, num_classes=2, seed=seed)
    if dense:
        X = np.random.RandomState(seed + 1).uniform(0, 1, X.shape).astype(
            np.float32)
    return X, L


def _ssd_init(net, X, L):
    """Xavier-uniform weights (fan in + fan out), unit gammas, zero biases
    and betas, zero moving means and unit moving variances."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=X.shape, label=L.shape)
    rng = np.random.RandomState(0)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "label"):
            continue
        if n.endswith("weight"):
            rf = int(np.prod(s[2:]))
            scale = np.sqrt(6.0 / (s[1] * rf + s[0] * rf))
            args[n] = rng.uniform(-scale, scale, s).astype(np.float32)
        else:
            args[n] = (np.ones if n.endswith("gamma") else np.zeros)(
                s, np.float32)
    aux = {n: (np.zeros if n.endswith("mean") else np.ones)(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _ssd_loss(outs):
    """The example's cls + loc loss from the train graph's outputs."""
    cls_prob, loc_loss, cls_target = (o.asnumpy() for o in outs)
    valid = cls_target >= 0
    idx = np.maximum(cls_target.astype(int), 0)
    picked = np.take_along_axis(cls_prob, idx[:, None, :], axis=1)[:, 0, :]
    return float(-np.log(np.maximum(picked, 1e-8))[valid].mean()
                 + loc_loss.sum() / max(valid.sum(), 1))


def _ssd_train(pkg, net, args, aux, X, L, steps=3, prefix=None):
    """``steps`` SGD-momentum steps of the SSD train graph through
    ``Module`` (an ``NDArrayIter`` with ``label_name="label"``, 3-d
    labels), as the example drives it: (losses, cls targets, params,
    aux) as numpy."""
    it = pkg.io.NDArrayIter(data=X, label=L, batch_size=len(X),
                            label_name="label")
    mod = pkg.mod.Module(net, data_names=("data",), label_names=("label",),
                         context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=SSD_SGD)
    losses, targets = [], []
    for _ in range(steps):
        it.reset()
        batch = next(iter(it))
        mod.forward(batch, is_train=True)
        outs = mod.get_outputs()
        losses.append(_ssd_loss(outs))
        targets.append(outs[2].asnumpy())
        mod.backward()
        mod.update()
    if prefix:
        mod.save_checkpoint(prefix, steps)
    a, x = mod.get_params()
    return (losses, targets, {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def test_small_ssd_forward_matches_jax():
    """The small SSD's train graph, training forward on U(0, 1) images with
    the example's box labels: cls_prob and loc_loss within 1e-5 of the
    largest value, the MultiBox targets equal; the detect graph in
    inference as tests/test_ssd.py drives it (U(-0.1, 0.1) parameters,
    U(0, 1) images; the initializer's aux states, zero means and unit
    variances): boxes and scores within 1e-5, class ids (NMS keeps)
    equal."""
    X, L = _ssd_boxes(4, dense=True)
    jn, tn = _nets("get_ssd_train", **SMALL_SSD)
    args, aux = _ssd_init(jn, X, L)
    outs = []
    for pkg, net in ((mx, jn), (mt, tn)):
        feed = {k: pkg.nd.array(v, pkg.cpu()) for k, v in args.items()}
        feed.update(data=pkg.nd.array(X, pkg.cpu()),
                    label=pkg.nd.array(L, pkg.cpu()))
        ex = net.bind(pkg.cpu(), feed, aux_states={
            k: pkg.nd.array(v, pkg.cpu()) for k, v in aux.items()})
        outs.append([o.asnumpy() for o in ex.forward(is_train=True)])
    for j, t in zip(outs[0][:2], outs[1][:2]):
        assert np.abs(t - j).max() <= 1e-5 * max(1.0, np.abs(j).max())
    np.testing.assert_array_equal(outs[1][2], outs[0][2])
    assert (outs[1][2] > 0).sum() > 0 and (outs[1][2] == -1).sum() > 0

    jd, td = _nets("get_ssd_detect", **SMALL_SSD)
    rng = np.random.RandomState(0)
    shape = (2, 3, 64, 64)
    arg_shapes, _, aux_shapes = jd.infer_shape(data=shape)
    feed = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(jd.list_arguments(), arg_shapes) if n != "data"}
    feed["data"] = rng.uniform(0, 1, shape).astype(np.float32)
    dets = []
    for pkg, net in ((mx, jd), (mt, td)):
        ex = net.bind(pkg.cpu(), {k: pkg.nd.array(v, pkg.cpu())
                                  for k, v in feed.items()},
                      aux_states={n: (pkg.nd.zeros if n.endswith("mean")
                                      else pkg.nd.ones)(s, pkg.cpu())
                                  for n, s in zip(jd.list_auxiliary_states(),
                                                  aux_shapes)})
        dets.append(ex.forward(is_train=False)[0].asnumpy())
    j, t = dets
    assert t.shape == j.shape == (2, 4 * (16 * 16 + 8 * 8 + 4 * 4), 6)
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    np.testing.assert_allclose(t[..., 1:], j[..., 1:], rtol=1e-5, atol=1e-5)
    assert (t[..., 0] >= 0).sum() > 0 and (t[..., 0] == -1).sum() > 0


def test_small_ssd_module_training_matches_jax():
    """3 SGD-momentum steps (lr 0.2, momentum 0.9, the example's) of the
    small SSD through ``Module`` from one numpy init on U(0, 1) images
    with the example's labels: the example's loss 1e-4 relative,
    parameters and aux states within 1e-4 of the largest of each, and
    every step's MultiBox class targets equal."""
    X, L = _ssd_boxes(8, dense=True)
    jn, tn = _nets("get_ssd_train", **SMALL_SSD)
    args, aux = _ssd_init(jn, X, L)
    ref = _ssd_train(mx, jn, args, aux, X, L)
    got = _ssd_train(mt, tn, args, aux, X, L)
    assert got[0][-1] < got[0][0]
    assert max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0])) <= 1e-4
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    assert _largest_err(got[2], ref[2]) <= 1e-4
    assert _largest_err(got[3], ref[3]) <= 1e-4
    moved = [k for k in aux if not np.array_equal(got[3][k], aux[k])]
    assert sorted(moved) == sorted(aux)


def test_ssd_on_the_examples_images_where_the_reference_batch_norm_rounds():
    """On the example's own images (one square on zeros) the first
    BatchNorm's channels are nearly constant over 32,768 values: the JAX
    package's float32 mean of them drifts (its output reads ~1e-4 off a
    float64 evaluation, the port's ~1e-7), and the two packages' parameters
    part by ~1e-3 of the largest within 3 steps.  Held here: the port's
    BatchNorm within 1e-6 of float64, the reference's further off; and
    through Module the example's loss within 1e-4 and every step's
    MultiBox class targets equal."""
    X, L = _ssd_boxes(8)
    jn, tn = _nets("get_ssd_train", **SMALL_SSD)
    args, aux = _ssd_init(jn, X, L)
    # the first conv block's BatchNorm on its conv's output
    w, b = args["b1_conv_weight"], args["b1_conv_bias"]
    conv = torch.nn.functional.conv2d(torch.from_numpy(X),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), padding=1).numpy()
    c64 = conv.astype(np.float64)
    mean = c64.mean(axis=(0, 2, 3), keepdims=True)
    var = ((c64 - mean) ** 2).mean(axis=(0, 2, 3), keepdims=True)
    truth = (c64 - mean) / np.sqrt(var + 1e-3)
    errs = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            bn = pkg.sym.BatchNorm(pkg.sym.Variable("data"), name="bn")
        c = conv.shape[1]
        ex = bn.bind(pkg.cpu(), {"data": pkg.nd.array(conv, pkg.cpu()),
                                 "bn_gamma": pkg.nd.ones((c,), pkg.cpu()),
                                 "bn_beta": pkg.nd.zeros((c,), pkg.cpu())},
                     aux_states={"bn_moving_mean": pkg.nd.zeros((c,),
                                                                pkg.cpu()),
                                 "bn_moving_var": pkg.nd.ones((c,),
                                                              pkg.cpu())})
        out = ex.forward(is_train=True)[0].asnumpy()
        errs.append(float(np.abs(out - truth).max()))
    assert errs[1] <= 1e-6 < errs[0], errs
    ref = _ssd_train(mx, jn, args, aux, X, L)
    got = _ssd_train(mt, tn, args, aux, X, L)
    assert max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0])) <= 1e-4
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a, b)


def test_ssd_checkpoint_serves_through_predictor_like_jax(tmp_path):
    """Train 2 steps, ``save_checkpoint``, then a ``Predictor`` built from
    ``get_ssd_detect`` with the trained parameters, in both packages from
    the port's checkpoint file: rows (32, A, 6) with ids in [-1, 1],
    scores in [0, 1] and boxes in [0, 1], the ids (NMS keeps) equal and
    the rest within 1e-5."""
    X, L = _ssd_boxes(8, dense=True)
    _, tn = _nets("get_ssd_train", **SMALL_SSD)
    args, aux = _ssd_init(tn, X, L)
    prefix = str(tmp_path / "ssd")
    _ssd_train(mt, tn, args, aux, X, L, steps=2, prefix=prefix)
    jd, td = _nets("get_ssd_detect", **SMALL_SSD)
    shapes = {"data": X.shape}
    params = prefix + "-0002.params"
    outs = []
    for pkg, det in ((mx, jd), (mt, td)):
        pred = pkg.Predictor(det, params, shapes, ctx=pkg.cpu())
        pred.forward(data=X)
        outs.append(pred.get_output(0).asnumpy())
    j, t = outs
    a = 4 * (16 * 16 + 8 * 8 + 4 * 4)
    assert t.shape == (8, a, 6)
    assert set(np.unique(t[..., 0])) <= {-1.0, 0.0, 1.0}
    assert t[..., 1].min() >= 0 and t[..., 1].max() <= 1
    assert t[..., 2:].min() >= 0 and t[..., 2:].max() <= 1
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    np.testing.assert_allclose(t[..., 1:], j[..., 1:], rtol=1e-5, atol=1e-5)
    assert (t[..., 0] >= 0).sum() > 0


def test_make_loss_with_zero_grad_scale_gives_zero_gradients():
    """``MakeLoss(grad_scale=0)`` (the SSD's cls_label output) passes its
    input through and sends back zeros, whatever the head gradient."""
    with mt.NameManager():
        x = mt.sym.Variable("x")
        net = mt.sym.MakeLoss(x * 2.0, grad_scale=0.0)
    xs = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    ex = net.bind(mt.cpu(), {"x": mt.nd.array(xs, mt.cpu())},
                  args_grad={"x": mt.nd.ones((3, 4), mt.cpu())})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(mt.nd.array(np.full((3, 4), 7.0), mt.cpu()))
    np.testing.assert_allclose(out, xs * 2.0)
    np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(),
                                  np.zeros((3, 4), np.float32))


def test_default_context_ssd_module_raises_without_cuda():
    """No fallback hides the device: an SSD Module on the default context
    (the card) raises at bind without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with mt.NameManager():
        net = tm.get_ssd_train(**SMALL_SSD)
    mod = mt.mod.Module(net, data_names=("data",), label_names=("label",))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mod.bind(data_shapes=[("data", (2, 3, 64, 64))],
                 label_shapes=[("label", (2, 4, 5))])
