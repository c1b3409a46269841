"""``mt.register_kernel_op`` — user kernels as graph ops — against
``mx.register_pallas_op`` on the CPU: the counterpart of
``tests/test_pallas_op.py`` (imperative, symbolic forward and backward,
``Module`` training), with the port's kernel pushed through ``mt.rtc.MXRtc``
and the JAX package's through a Pallas kernel in interpret mode; then the
whole slice: a small transformer LM whose gelu nodes are the user op
``rtc_gelu`` trained in the port against the JAX package's unmodified LM.

Ops are registered under names the JAX tests do not use.  Tolerances:
float32 1e-5 relative for one op; Module parameters within 1e-5 (the MLP)
and 1e-4 (the LM, as tests/test_torch_train.py) of the largest
parameter."""
import functools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.transformer import get_transformer_lm as jax_lm
from mxnet_tpu_torch import rtc_kernels
from mxnet_tpu_torch.models.transformer import get_transformer_lm as port_lm

NAME = "_torchtest_scaled_square"

_SQUARE_PY = """
def scaled_square(x_ref, y_ref):
    y_ref[...] = {alpha!r} * x_ref[...] * x_ref[...]
"""
_SQUARE_CUDA = """
for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
     i < y_size; i += (long long)gridDim.x * blockDim.x)
  y[i] = {alpha!r}f * x[i] * x[i];
"""


def _port_square(attrs, x):
    """y = alpha·x² pushed through MXRtc: the CUDA body on the card, the
    Python source on the CPU (alpha is compiled into the source); on the
    meta device, shape inference's, only the output's shape."""
    if x.device.type == "meta":
        return torch.empty_like(x)
    alpha = float(attrs.get("alpha", 1.0))
    src = _SQUARE_CUDA if x.is_cuda else _SQUARE_PY
    x = x.contiguous()
    y = torch.empty_like(x)
    xs, ys = rtc_kernels._nd(x), rtc_kernels._nd(y)
    mt.rtc.MXRtc("scaled_square", [("x", xs)], [("y", ys)],
                 src.format(alpha=alpha)).push([xs], [ys])
    return y


def _register():
    import jax
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref, *, alpha):
        x = x_ref[...]
        o_ref[...] = alpha * x * x

    def jfn(attrs, x):
        return pl.pallas_call(
            functools.partial(kernel, alpha=attrs.get("alpha", 1.0)),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=jax.default_backend() != "tpu")(x)

    def bwd(attrs, res, ct):
        (x,) = res
        return (2.0 * attrs.get("alpha", 1.0) * x * ct,)

    mx.register_pallas_op(NAME, jfn, bwd=bwd,
                          params={"alpha": mx.Param(float, 1.0)})
    mt.register_kernel_op(NAME, _port_square, bwd=bwd,
                          params={"alpha": mt.Param(float, 1.0)})


_register()


def test_late_registration_reaches_nd_and_sym():
    assert mt.register_kernel_op is mt.ops.register_kernel_op
    assert callable(getattr(mt.nd, NAME)) and callable(getattr(mt.sym, NAME))
    with pytest.raises(ValueError, match="fwd without bwd"):
        mt.register_kernel_op("_torchtest_never", _port_square,
                              fwd=lambda attrs, x: (x, ()))


def test_kernel_op_imperative():
    x = np.array([1.0, 2.0, 3.0], np.float32)
    got = getattr(mt.nd, NAME)(mt.nd.array(x, mt.cpu()), alpha=2.0)
    ref = getattr(mx.nd, NAME)(mx.nd.array(x), alpha=2.0)
    np.testing.assert_array_equal(got.asnumpy(), [2.0, 8.0, 18.0])
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


def test_kernel_op_symbolic_forward_backward():
    x = np.array([[1.0, -2.0], [0.5, 4.0]], np.float32)
    res = {}
    for key, pkg in (("jax", mx), ("port", mt)):
        with pkg.NameManager():
            net = getattr(pkg.sym, NAME)(pkg.sym.Variable("data"), alpha=3.0)
        ex = net.bind(pkg.cpu(), {"data": pkg.nd.array(x, pkg.cpu())},
                      args_grad={"data": pkg.nd.zeros(x.shape, pkg.cpu())})
        ex.forward(is_train=True)
        out = ex.outputs[0].asnumpy()
        ex.backward(out_grads=pkg.nd.ones(x.shape, pkg.cpu()))
        res[key] = (out, ex.grad_dict["data"].asnumpy(), net.tojson())
    np.testing.assert_allclose(res["port"][0], 3.0 * x * x, rtol=1e-6)
    np.testing.assert_allclose(res["port"][1], 6.0 * x, rtol=1e-6)
    for a, b in zip(res["port"][:2], res["jax"][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert res["port"][2] == res["jax"][2]


def test_kernel_op_trains_through_module_like_jax():
    """The registered kernel inside Module.fit: 3 epochs of SGD from one
    init give the JAX package's parameters."""
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    init = {"fullyconnected0_weight": (rng.randn(2, 8) * 0.1)
            .astype(np.float32),
            "fullyconnected0_bias": np.zeros(2, np.float32)}
    params = {}
    for key, pkg in (("jax", mx), ("port", mt)):
        with pkg.NameManager():
            net = getattr(pkg.sym, NAME)(pkg.sym.Variable("data"), alpha=1.0)
            net = pkg.sym.FullyConnected(net, num_hidden=2)
            net = pkg.sym.SoftmaxOutput(net, name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(X, y, batch_size=16), num_epoch=3,
                optimizer="sgd", optimizer_params={"learning_rate": 0.2},
                arg_params={k: pkg.nd.array(v, pkg.cpu())
                            for k, v in init.items()})
        params[key] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    scale = max(np.abs(v).max() for v in params["jax"].values())
    for k, ref in params["jax"].items():
        assert np.abs(params["port"][k] - ref).max() <= 1e-5 * scale, k
        assert np.abs(params["port"][k] - init[k]).max() > 1e-3, k


# ---------------------------------------------------------------------------
# the whole slice: an LM with rtc_gelu against the JAX package's LM
# ---------------------------------------------------------------------------

LM = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=64, seq_len=32)
SHAPE = (2, LM["seq_len"])


def test_with_rtc_gelu_swaps_only_the_op_names():
    with mt.NameManager():
        net = port_lm(**LM)
    swapped = rtc_kernels.with_rtc_gelu(net)
    js, sw = net.tojson(), swapped.tojson()
    assert sw.count('"op": "rtc_gelu"') == LM["num_layers"]
    assert '"op": "gelu"' not in sw
    assert sw.replace('"op": "rtc_gelu"', '"op": "gelu"') == js
    shapes = {"data": SHAPE, "softmax_label": SHAPE}
    assert swapped.infer_shape(**shapes) == net.infer_shape(**shapes)
    assert callable(mt.nd.rtc_gelu) and callable(mt.sym.rtc_gelu)
    with pytest.raises(mt.MXNetError, match="no gelu"):
        rtc_kernels.with_rtc_gelu(mt.sym.Variable("x"))


def test_lm_with_rtc_gelu_trains_like_the_jax_lm():
    """3 adam steps of the 2-layer LM whose gelu nodes are rtc_gelu (the
    Python-source route of gelu_fwd/gelu_bwd) give the JAX package's
    unmodified LM's losses and parameters."""
    with mx.NameManager():
        jn = jax_lm(**LM)
    with mt.NameManager():
        tn = rtc_kernels.with_rtc_gelu(port_lm(**LM))
    shapes = {"data": SHAPE, "softmax_label": SHAPE}
    arg_shapes, _, _ = jn.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    init = {}
    for name, shape in zip(jn.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            init[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            init[name] = np.zeros(shape, np.float32)
        else:
            init[name] = rng.randn(*shape).astype(np.float32) * 0.3
    X = rng.randint(0, LM["vocab_size"], SHAPE).astype(np.float32)
    Y = (X + 1) % LM["vocab_size"]
    runs = {}
    for key, pkg, net in (("jax", mx, jn), ("port", mt, tn)):
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", SHAPE)],
                 label_shapes=[("softmax_label", SHAPE)])
        mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in init.items()},
                        aux_params={})
        mod.init_optimizer(optimizer="adam", optimizer_params={
            "learning_rate": 1e-3, "epsilon": 1e-4})
        batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                                 [pkg.nd.array(Y, pkg.cpu())])
        losses = []
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
            p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float32)
            losses.append(float(-np.log(p[np.arange(p.shape[0]),
                                           Y.reshape(-1).astype(int)])
                                .mean()))
        runs[key] = (losses, {k: v.asnumpy()
                              for k, v in mod.get_params()[0].items()})
    (lt, pt), (lj, pj) = runs["port"], runs["jax"]
    assert lt[-1] < lt[0]
    for a, b in zip(lt, lj):
        assert abs(a - b) / abs(b) <= 1e-4, (lt, lj)
    scale = max(np.abs(v).max() for v in pj.values())
    assert sorted(pt) == sorted(pj)
    for k in pj:
        assert np.abs(pt[k] - pj[k]).max() <= 1e-4 * scale, k
