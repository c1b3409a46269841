"""The spatial ops of the port (``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``ROIPooling``, ``Correlation``) against the JAX
package's, on the CPU, from identical numpy inputs through both
registries, with the harness of ``tests/test_torch_nn_ops.py``: forward and
gradient (``jax.vjp`` against autograd) within float32 rtol = atol = 1e-5.

``ROIPooling`` is held exactly on its forward (a max is exact) on
ReLU'd features, where zeros tie, with ties within a row and across rows,
bins that overlap (``floor``/``ceil`` put one row into two bins), bins that
are empty (outside the map) and corners that land on .5 after the scale,
where both packages round half to even and the reference's C++ ``round``
would not.  An STN-LeNet (MXNet's lenet.py with ``add_stn``) trains 3
steps through ``Module`` in both packages from one numpy init."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import get_op as jget_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OpContext, get_op
from test_torch_nn_ops import _both, _check_case, _f


def _rois(r, n, h, w, scale, seed=0):
    """``r`` boxes (batch index, x0, y0, x1, y1) in image pixels inside an
    image of the feature map's size over ``scale``."""
    def make(rng):
        out = np.zeros((r, 5), np.float32)
        ih, iw = int(h / scale), int(w / scale)
        out[:, 0] = rng.randint(0, n, r)
        x0 = rng.randint(0, iw, r)
        y0 = rng.randint(0, ih, r)
        out[:, 1] = x0
        out[:, 2] = y0
        out[:, 3] = np.minimum(x0 + rng.randint(0, iw, r), iw + 4)
        out[:, 4] = np.minimum(y0 + rng.randint(0, ih, r), ih + 4)
        return out
    return make


def _relu(*shape):
    return lambda rng: np.maximum(rng.randn(*shape), 0).astype(np.float32)


CASES = [
    ("GridGenerator", {"transform_type": "affine", "target_shape": (5, 7)},
     [_f(2, 6)]),
    ("GridGenerator", {"transform_type": "warp"}, [_f(2, 2, 5, 6)]),
    ("BilinearSampler", {}, [_f(2, 3, 6, 5), _f(2, 2, 4, 7, scale=0.7)]),
    ("SpatialTransformer", {"target_shape": (5, 4)},
     [_f(2, 3, 6, 5), _f(2, 6, scale=0.5)]),
    ("SpatialTransformer", {}, [_f(2, 3, 6, 5), _f(2, 6, scale=0.5)]),
    ("ROIPooling", {"pooled_size": (3, 2), "spatial_scale": 0.5},
     [_relu(2, 3, 8, 9), _rois(6, 2, 8, 9, 0.5)]),
    ("ROIPooling", {"pooled_size": (2, 3), "spatial_scale": 0.25},
     [_f(1, 4, 7, 6), _rois(5, 1, 7, 6, 0.25)]),
    ("Correlation", {"kernel_size": 1, "max_displacement": 2, "stride2": 2,
                     "pad_size": 2}, [_f(2, 3, 7, 8), _f(2, 3, 7, 8)]),
    ("Correlation", {"kernel_size": 1, "max_displacement": 2, "stride2": 2,
                     "pad_size": 2, "is_multiply": False},
     [_f(2, 3, 7, 8), _f(2, 3, 7, 8)]),
    ("Correlation", {"kernel_size": 3, "max_displacement": 2, "stride1": 2,
                     "pad_size": 3}, [_f(1, 2, 7, 8), _f(1, 2, 7, 8)]),
    ("Correlation", {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
                     "pad_size": 3, "is_multiply": False},
     [_f(1, 2, 6, 7), _f(1, 2, 6, 7)]),
]


@pytest.mark.parametrize("name,attrs,makers", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_spatial_op_forward_and_gradient_match_jax(name, attrs, makers):
    """Forward and every input's gradient within 1e-5, and the op on
    ``meta`` tensors gives the JAX package's shapes."""
    _check_case(name, attrs, makers, [], "float32")


def _roi_both(data, rois, attrs):
    rng = np.random.RandomState(7)
    (jo, _, jg), (to, _, tg), _ = _both("ROIPooling", attrs, [data, rois],
                                        rng=rng)
    return jo[0], to[0], jg[0], tg[0]


# (name, data, rois, attrs): a feature map with exact ties, bins that
# overlap, empty bins and corners on .5
ROI_EDGE_CASES = {
    # ties within one row: every value of a bin's row equal
    "ties-in-a-row": (np.tile(np.array([[0, 1, 1, 0, 2, 2]], np.float32),
                              (1, 2, 6, 1)).reshape(1, 2, 6, 6),
                      np.array([[0, 0, 0, 5, 5]], np.float32),
                      {"pooled_size": (2, 2), "spatial_scale": 1.0}),
    # ties across rows: the max appears in two rows of one bin
    "ties-across-rows": (np.array([[[[3, 0, 0], [0, 0, 3], [1, 3, 2]]]],
                                  np.float32),
                         np.array([[0, 0, 0, 2, 2]], np.float32),
                         {"pooled_size": (1, 1), "spatial_scale": 1.0}),
    # ReLU'd zeros: a whole bin of zeros ties everywhere
    "zero-bins": (np.zeros((1, 2, 5, 5), np.float32),
                  np.array([[0, 0, 0, 4, 4], [0, 1, 1, 3, 2]], np.float32),
                  {"pooled_size": (2, 2), "spatial_scale": 1.0}),
    # roi_h = 5 into 3 bins: edges floor(5/3)=1, ceil(10/3)=4 overlap
    "overlapping-bins": (np.arange(1 * 1 * 6 * 6, dtype=np.float32)
                         .reshape(1, 1, 6, 6) % 7,
                         np.array([[0, 0, 0, 4, 4], [0, 1, 0, 5, 3]],
                                  np.float32),
                         {"pooled_size": (3, 3), "spatial_scale": 1.0}),
    # a box past the map: its outer bins are empty (0, no gradient)
    "empty-bins": (np.ones((1, 1, 4, 4), np.float32),
                   np.array([[0, 2, 2, 9, 9]], np.float32),
                   {"pooled_size": (4, 4), "spatial_scale": 1.0}),
    # corners x 1/16 = .5: 8 -> 0, 24 -> 2, 40 -> 2 (half to even)
    "half-to-even": (np.arange(2 * 3 * 5 * 6, dtype=np.float32)
                     .reshape(2, 3, 5, 6),
                     np.array([[1, 8, 24, 40, 56], [0, 24, 8, 72, 40]],
                              np.float32),
                     {"pooled_size": (2, 2), "spatial_scale": 0.0625}),
}


@pytest.mark.parametrize("case", sorted(ROI_EDGE_CASES))
def test_roi_pooling_edge_cases_match_jax(case):
    """The forward bit for bit; the gradient, ``g / count`` to each tied
    element and summed over overlapping bins, within 1e-5."""
    data, rois, attrs = ROI_EDGE_CASES[case]
    jo, to, jg, tg = _roi_both(data, rois, attrs)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


def test_roi_pooling_ties_split_the_gradient():
    """A bin whose max ties at three places passes a third to each, as
    ``jnp.max`` over both axes does (not all to one index)."""
    data = np.array([[[[3, 0, 0], [0, 0, 3], [1, 3, 2]]]], np.float32)
    rois = np.array([[0, 0, 0, 2, 2]], np.float32)
    op = get_op("ROIPooling")
    x = torch.from_numpy(data).requires_grad_(True)
    out, _ = op.apply(OpContext(), op.parse_attrs(
        {"pooled_size": (1, 1), "spatial_scale": 1.0}),
        [x, torch.from_numpy(rois)])
    out[0].sum().backward()
    expect = np.zeros_like(data)
    expect[0, 0][data[0, 0] == 3] = 1.0 / 3
    np.testing.assert_array_equal(x.grad.numpy(), expect)


def test_roi_corners_round_half_to_even_in_both_packages():
    """8/16 = 0.5 rounds to 0 in both packages (half to even); the
    reference's C++ ``round`` (half away from zero) would give 1.  On a row
    that falls to the right, the box's one bin then starts at column 0 and
    its max is column 0's value, 5, where the reference's would be 4."""
    data = np.tile(np.arange(5, -1, -1, dtype=np.float32), (1, 1, 3, 1))
    rois = np.array([[0, 8, 0, 24, 0]], np.float32)
    attrs = {"pooled_size": (1, 1), "spatial_scale": 0.0625}
    jo, to, _, _ = _roi_both(data, rois, attrs)
    np.testing.assert_array_equal(to, jo)
    assert to[0, 0, 0, 0] == 5.0


def test_roi_pooling_chunks_agree_with_one_pass(monkeypatch):
    """Gathering the bins' windows a few ROIs at a time gives the same
    bits as one pass (the card gathers Fast R-CNN's 300 ROIs in chunks)."""
    from mxnet_tpu_torch.ops import spatial

    rng = np.random.RandomState(3)
    data = torch.from_numpy(_relu(2, 4, 9, 11)(rng))
    rois = torch.from_numpy(_rois(12, 2, 9, 11, 0.5)(rng))
    g = torch.from_numpy(rng.randn(12, 4, 3, 3).astype(np.float32))

    def run():
        x = data.clone().requires_grad_(True)
        out = spatial._ROIMax.apply(x, rois, (3, 3), 0.5)
        out.backward(g)
        return out.detach(), x.grad

    one = run()
    monkeypatch.setattr(spatial, "ROI_CHUNK_ELEMENTS", 1)
    chunked = run()
    assert torch.equal(one[0], chunked[0])
    torch.testing.assert_close(chunked[1], one[1], rtol=1e-6, atol=1e-7)


def test_sampler_gradients_replay_bitwise():
    """Two backward passes of the warp (GridGenerator + BilinearSampler)
    give the same bits: the gather's gradient is a sorted segment sum."""
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(2, 3, 9, 10).astype(np.float32))
    flow = torch.from_numpy((rng.randn(2, 2, 9, 10) * 2).astype(np.float32))
    gen, samp = get_op("GridGenerator"), get_op("BilinearSampler")

    def run():
        x = img.clone().requires_grad_(True)
        f = flow.clone().requires_grad_(True)
        grid, _ = gen.apply(OpContext(), gen.parse_attrs(
            {"transform_type": "warp"}), [f])
        out, _ = samp.apply(OpContext(), {}, [x, grid[0]])
        (out[0] * out[0]).sum().backward()
        return x.grad, f.grad

    a, b = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_affine_grid_and_sampler_equal_spatial_transformer():
    rng = np.random.RandomState(1)
    data = mt.nd.array(rng.rand(2, 3, 6, 7).astype(np.float32), mt.cpu())
    loc = mt.nd.array((rng.randn(2, 6) * 0.3).astype(np.float32), mt.cpu())
    grid = mt.nd.GridGenerator(loc, transform_type="affine",
                               target_shape=(5, 4))
    two = mt.nd.BilinearSampler(data, grid)
    one = mt.nd.SpatialTransformer(data, loc, target_shape=(5, 4))
    np.testing.assert_array_equal(two.asnumpy(), one.asnumpy())


SHAPE_CASES = [
    ("GridGenerator", {"transform_type": "affine", "target_shape": (4, 5)},
     {"data": (3, 6)}),
    ("GridGenerator", {"transform_type": "warp"}, {"data": (3, 2, 4, 5)}),
    ("BilinearSampler", {}, {"data": (2, 3, 8, 8), "grid": (2, 2, 4, 5)}),
    ("SpatialTransformer", {"target_shape": (6, 7)},
     {"data": (2, 3, 8, 9)}),
    ("SpatialTransformer", {}, {"data": (2, 3, 8, 9)}),
    ("ROIPooling", {"pooled_size": (7, 7), "spatial_scale": 0.0625},
     {"data": (1, 16, 38, 63), "rois": (12, 5)}),
    ("Correlation", {"pad_size": 20, "kernel_size": 1,
                     "max_displacement": 20, "stride1": 1, "stride2": 2},
     {"data1": (2, 8, 24, 32), "data2": (2, 8, 24, 32)}),
]


@pytest.mark.parametrize("name,attrs,shapes", SHAPE_CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(SHAPE_CASES)])
def test_spatial_shapes_and_json_match_jax(name, attrs, shapes):
    """``infer_shape`` (SpatialTransformer infers loc as (N, 6)) equal in
    both packages, the op on ``meta`` tensors agrees, and ``sym.<op>``'s
    JSON is byte-identical under fresh name managers."""
    def build(pkg):
        with pkg.NameManager():
            ins = [pkg.sym.Variable(n) for n in get_op(name)
                   .input_names(get_op(name).parse_attrs(attrs))]
            return getattr(pkg.sym, name)(*ins, **attrs)

    js, ts = build(mx), build(mt)
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    op = get_op(name)
    parsed = op.parse_attrs(attrs)
    args = ts.infer_shape(**shapes)[0]
    metas, _ = op.apply(OpContext(), parsed,
                        [torch.empty(s, device="meta") for s in args])
    assert [tuple(m.shape) for m in metas] == ts.infer_shape(**shapes)[1]
    assert jget_op(name).name == op.name


def test_default_context_spatial_op_raises_without_cuda():
    """``nd.<op>`` on numpy inputs runs on the current context, the card;
    without CUDA it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is usable")
    with pytest.raises(MXNetError):
        mt.nd.GridGenerator(np.zeros((1, 6), np.float32),
                            transform_type="affine", target_shape=(2, 2))


def stn_lenet(pkg, num_classes=10):
    """MXNet's example/image-classification/symbols/lenet.py with
    ``add_stn=True``: the localisation net, SpatialTransformer (28, 28),
    then LeNet."""
    s = pkg.sym
    data = s.Variable("data")
    loc = s.Convolution(data=data, num_filter=30, kernel=(5, 5),
                        stride=(2, 2))
    loc = s.Activation(data=loc, act_type="relu")
    loc = s.Pooling(data=loc, kernel=(2, 2), stride=(2, 2), pool_type="max")
    loc = s.Convolution(data=loc, num_filter=60, kernel=(3, 3), pad=(1, 1))
    loc = s.Activation(data=loc, act_type="relu")
    loc = s.Pooling(data=loc, global_pool=True, kernel=(2, 2),
                    pool_type="avg")
    loc = s.Flatten(data=loc)
    loc = s.FullyConnected(data=loc, num_hidden=6, name="stn_loc",
                           attr={"lr_mult": "0.01"})
    data = s.SpatialTransformer(data=data, loc=loc, target_shape=(28, 28),
                                transform_type="affine",
                                sampler_type="bilinear")
    net = s.Convolution(data=data, kernel=(5, 5), num_filter=20)
    net = s.Activation(data=net, act_type="tanh")
    net = s.Pooling(data=net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = s.Convolution(data=net, kernel=(5, 5), num_filter=50)
    net = s.Activation(data=net, act_type="tanh")
    net = s.Pooling(data=net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = s.Flatten(data=net)
    net = s.FullyConnected(data=net, num_hidden=500)
    net = s.Activation(data=net, act_type="tanh")
    net = s.FullyConnected(data=net, num_hidden=num_classes)
    return s.SoftmaxOutput(data=net, name="softmax")


def _stn_module(pkg, X, Y):
    with pkg.NameManager():
        net = stn_lenet(pkg)
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("softmax_label", Y.shape)])
    return mod


def _stn_steps(pkg, init, X, Y, states=None, steps=3):
    """``steps`` SGD-momentum steps (train_mnist.py's settings) of the
    STN-LeNet through Module from numpy ``init``, the stn_loc parameters
    set by the package's own Xavier (its name rules).  With ``states``
    (a run's parameters before each step) each step starts from those
    parameters.  Returns (stn_loc init, losses, parameters before each
    step and after the last)."""
    mod = _stn_module(pkg, X, Y)
    mod.init_params(pkg.init.Xavier(factor_type="in", magnitude=2.34))
    rules = {k: v.asnumpy() for k, v in mod.get_params()[0].items()
             if k.startswith("stn_loc")}
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in dict(init, **rules).items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        learning_rate=0.05, momentum=0.9, wd=1e-4))
    batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                             [pkg.nd.array(Y, pkg.cpu())])
    losses, seen = [], []
    for t in range(steps):
        if states is not None:
            mod.set_params({k: pkg.nd.array(v, pkg.cpu())
                            for k, v in states[t].items()}, {},
                           force_init=True)
        seen.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
        mod.forward_backward(batch)
        mod.update()
        p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float64)
        losses.append(float(-np.log(p[np.arange(len(Y)),
                                      Y.astype(int)]).mean()))
    seen.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    return rules, losses, seen


def test_stn_lenet_trains_alike_in_both_packages():
    """3 SGD-momentum steps of the STN-LeNet through Module in both
    packages from one numpy init, the stn_loc rules (weight 0, bias the
    identity) applied by each package's Xavier: the same stn_loc init;
    each port step, started from the JAX package's parameters at that
    step, gives its loss within 1e-5 and its new parameters within 1e-5
    of the largest.

    Each step starts from the JAX package's state because this net is
    chaotic in both packages: at the identity every sampling point sits
    on a pixel, where the gradient to the grid jumps with the side
    ``floor`` takes.  After one step the points sit within a few ulps of
    pixels, so a difference of 4e-7 in stn_loc's bias (summation order)
    moves the next gradients of the localisation convolutions by up to
    11%, in the JAX package's own runs as in the port's."""
    with mx.NameManager():
        jnet = stn_lenet(mx)
    X = np.random.RandomState(0).rand(8, 1, 28, 28).astype(np.float32)
    Y = (np.arange(8) % 10).astype(np.float32)
    arg_shapes, _, _ = jnet.infer_shape(data=X.shape)
    rng = np.random.RandomState(1)
    init = {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(jnet.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")
            and not n.startswith("stn_loc")}
    jrules, jl, jstates = _stn_steps(mx, init, X, Y)
    trules, tl, tstates = _stn_steps(mt, init, X, Y, states=jstates)
    for k in jrules:
        np.testing.assert_array_equal(trules[k], jrules[k])
    np.testing.assert_array_equal(trules["stn_loc_bias"],
                                  [1, 0, 0, 0, 1, 0])
    assert not trules["stn_loc_weight"].any()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for t in range(1, 4):
        ref = jstates[t]
        scale = max(float(np.abs(v).max()) for v in ref.values())
        for k in ref:
            np.testing.assert_allclose(tstates[t][k], ref[k], rtol=1e-5,
                                       atol=1e-5 * scale,
                                       err_msg="%s after step %d" % (k, t))
    assert not np.array_equal(jstates[1]["stn_loc_bias"],
                              jrules["stn_loc_bias"])


def jax_stn_lenet_reading(folder, n=6000, n_val=1000, batch=64, epochs=5):
    """The JAX package's own validation accuracy of the STN-LeNet after
    training, on the CPU, with the net, data and settings of ``chip_smoke.py``'s spatial
    phase: its synthetic digits written as idx-ubyte (training) and CSV
    (validation) files, read by ``MNISTIter`` and ``CSVIter``; 5 epochs of
    ``FeedForward`` at batch 64, SGD lr 0.05 momentum 0.9 wd 1e-4,
    Xavier("in", 2.34).  Run as ``JAX_PLATFORMS=cpu python
    tests/test_torch_spatial.py``."""
    import struct

    rng = np.random.RandomState(0)
    templates = rng.uniform(0, 1, (10, 28, 28)).astype(np.float32)
    labels = rng.randint(0, 10, n)
    imgs = templates[labels]
    shifts = rng.randint(-2, 3, (n, 2))
    x = np.empty_like(imgs)
    for i in range(n):
        x[i] = np.roll(imgs[i], tuple(shifts[i]), axis=(0, 1))
    x += rng.normal(0, 0.3, x.shape).astype(np.float32)
    u8 = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    y = labels.astype(np.float32)
    paths = {k: os.path.join(folder, k) for k in
             ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "val-data.csv", "val-label.csv")}
    train, val = u8[n_val:], u8[:n_val]
    with open(paths["train-images-idx3-ubyte"], "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(train), 28, 28))
        f.write(train.tobytes())
    with open(paths["train-labels-idx1-ubyte"], "wb") as f:
        f.write(struct.pack(">II", 2049, len(train)))
        f.write(y[n_val:].astype(np.uint8).tobytes())
    np.savetxt(paths["val-data.csv"], val.reshape(len(val), -1) / 255.0,
               delimiter=",", fmt="%.8g")
    np.savetxt(paths["val-label.csv"], y[:n_val], delimiter=",", fmt="%d")
    train_it = mx.io.MNISTIter(image=paths["train-images-idx3-ubyte"],
                               label=paths["train-labels-idx1-ubyte"],
                               batch_size=batch, shuffle=True)
    val_it = mx.io.ResizeIter(mx.io.CSVIter(
        data_csv=paths["val-data.csv"], data_shape=(1, 28, 28),
        label_csv=paths["val-label.csv"], label_shape=(),
        batch_size=batch), -(-n_val // batch))
    with mx.NameManager():
        net = stn_lenet(mx)
    mx.random.seed(0)
    ff = mx.model.FeedForward(
        net, ctx=mx.cpu(), num_epoch=epochs, optimizer="sgd",
        initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
        learning_rate=0.05, momentum=0.9, wd=1e-4)
    ff.fit(train_it, eval_metric="acc")
    val_it.reset()
    return ff.score(val_it)


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        acc = jax_stn_lenet_reading(tmp)
    print("JAX package STN-LeNet final validation accuracy %.6f" % acc)
