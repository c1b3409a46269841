"""The image-classification ops of the port against the JAX package's, on
the CPU, from identical numpy inputs through both registries
(``mxnet_tpu.ops.get_op`` and ``mxnet_tpu_torch.ops.get_op``):
``Activation``, ``Convolution``, ``Pooling``, ``BatchNorm``, ``LRN``,
``Flatten``, ``Concat`` and their aliases, forward and gradient
(``jax.vjp`` against autograd, one numpy cotangent per output), and
BatchNorm's aux updates; ``Dropout`` by its statistics, since its masks
come from a ``torch.Generator`` where the JAX package draws threefry bits.

Tolerances: float32 rtol = atol = 1e-5, atol scaled by an array's largest
magnitude where that is above 1 (the same arithmetic summed in another
order); bf16 2e-2 of the largest reference value (the packages
round to bf16 at different places).  Every op also runs on ``meta``
tensors and gives the JAX shapes; its names, aliases, parameters and
shape inference are the JAX op's."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op
from mxnet_tpu_torch.ops import OpContext, get_op

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _f(*shape, scale=1.0, shift=0.0):
    return lambda rng: (rng.randn(*shape) * scale + shift).astype(np.float32)


def _pos(*shape):
    return lambda rng: (rng.rand(*shape) + 0.5).astype(np.float32)


def _labels(*shape, high):
    """Class labels in [0, high), as floats."""
    return lambda rng: rng.randint(0, high, shape).astype(np.float32)


# op name, raw attrs, input makers, aux makers
CASES = [
    ("Activation", {"act_type": "relu"}, [_f(3, 4, 5)], []),
    ("Activation", {"act_type": "sigmoid"}, [_f(3, 4, 5)], []),
    ("Activation", {"act_type": "tanh"}, [_f(3, 4, 5)], []),
    ("Activation", {"act_type": "softrelu"}, [_f(3, 4, 5, scale=3.0)], []),
    ("Convolution", {"kernel": (3,), "num_filter": 4, "stride": (2,),
                     "pad": (1,), "dilate": (2,), "num_group": 2},
     [_f(2, 4, 11), _f(4, 2, 3), _f(4)], []),
    ("Convolution", {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1)},
     [_f(2, 3, 7, 6), _f(6, 3, 3, 3), _f(6)], []),
    ("Convolution", {"kernel": (3, 2), "num_filter": 6, "stride": (2, 1),
                     "dilate": (1, 2), "num_group": 3, "no_bias": True,
                     "workspace": 512, "cudnn_tune": "fastest",
                     "cudnn_off": True, "layout": "NCHW"},
     [_f(2, 6, 9, 8), _f(6, 2, 3, 2)], []),
    ("Convolution_v1", {"kernel": (1, 1), "num_filter": 5, "stride": (2, 2)},
     [_f(2, 3, 5, 5), _f(5, 3, 1, 1), _f(5)], []),
    ("Convolution", {"kernel": (2, 3, 2), "num_filter": 4, "pad": (1, 0, 1),
                     "stride": (1, 2, 1), "num_group": 2},
     [_f(2, 4, 4, 5, 3), _f(4, 2, 2, 3, 2), _f(4)], []),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)},
     [_f(2, 3, 8, 7)], []),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pooling_convention": "full"}, [_f(2, 3, 8, 7)], []),
    ("Pooling", {"kernel": (2, 3), "stride": (2, 2), "pool_type": "avg",
                 "pooling_convention": "full"}, [_f(2, 3, 7, 8)], []),
    ("Pooling", {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
                 "pool_type": "avg"}, [_f(2, 3, 6, 6)], []),
    ("Pooling", {"kernel": (2, 2), "stride": (2, 1), "pool_type": "sum",
                 "pad": (1, 0)}, [_f(2, 3, 5, 6)], []),
    ("Pooling", {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
     [_f(2, 4, 5, 3)], []),
    ("Pooling", {"kernel": (1, 1), "global_pool": True}, [_f(2, 4, 5, 3)],
     []),
    ("Pooling_v1", {"kernel": (2, 2), "stride": (2, 2), "cudnn_off": True},
     [_f(1, 2, 6, 6)], []),
    ("Pooling", {"kernel": (3,), "stride": (2,), "pad": (1,),
                 "pool_type": "max", "pooling_convention": "full"},
     [_f(2, 3, 10)], []),
    ("Pooling", {"kernel": (3,), "stride": (2,), "pool_type": "sum"},
     [_f(2, 3, 9)], []),
    ("Pooling", {"kernel": (2, 2, 2), "stride": (2, 2, 1), "pad": (1, 0, 0),
                 "pool_type": "avg"}, [_f(2, 2, 5, 4, 3)], []),
    ("Pooling", {"kernel": (2, 2, 2), "stride": (1, 2, 2),
                 "pooling_convention": "full"}, [_f(1, 2, 4, 5, 5)], []),
    ("LRN", {"nsize": 5}, [_f(2, 7, 3, 4)], []),
    ("LRN", {"nsize": 3, "alpha": 1e-2, "beta": 0.5, "knorm": 1.0},
     [_f(2, 4, 5, 2, scale=3.0)], []),
    ("Flatten", {}, [_f(2, 3, 4, 5)], []),
    ("flatten", {}, [_f(3, 7)], []),
    ("Concat", {"num_args": 3}, [_f(2, 3, 4), _f(2, 1, 4), _f(2, 2, 4)],
     []),
    ("concat", {"num_args": 2, "dim": 0}, [_f(2, 3, 4), _f(1, 3, 4)], []),
    # slice 11: the rest of ops/nn.py
    ("LeakyReLU", {}, [_f(3, 4, 5)], []),
    ("LeakyReLU", {"act_type": "leaky", "slope": 0.1}, [_f(2, 6)], []),
    ("LeakyReLU", {"act_type": "elu", "slope": 0.7}, [_f(3, 4, 5)], []),
    ("LeakyReLU", {"act_type": "prelu"}, [_f(2, 3, 4, 4), _f(3)], []),
    ("LeakyReLU", {"act_type": "prelu"}, [_f(5, 4), _f(4)], []),
    ("LeakyReLU", {"act_type": "rrelu", "lower_bound": 0.2,
                   "upper_bound": 0.5}, [_f(3, 7)], []),
    ("Deconvolution", {"kernel": (4, 4), "num_filter": 5, "stride": (2, 2),
                       "pad": (1, 1)}, [_f(2, 3, 5, 4), _f(3, 5, 4, 4),
                                        _f(5)], []),
    ("Deconvolution", {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2),
                       "pad": (1, 1), "adj": (1, 1), "num_group": 2,
                       "no_bias": True},
     [_f(2, 4, 3, 5), _f(4, 2, 3, 3)], []),
    ("Deconvolution", {"kernel": (3,), "num_filter": 3, "stride": (3,),
                       "target_shape": (9,)},
     [_f(2, 2, 3), _f(2, 3, 3), _f(3)], []),
    ("Deconvolution", {"kernel": (2, 3, 2), "num_filter": 2,
                       "stride": (1, 2, 2), "pad": (0, 1, 0)},
     [_f(1, 2, 3, 4, 3), _f(2, 2, 2, 3, 2), _f(2)], []),
    ("InstanceNorm", {}, [_f(2, 3, 4, 5, scale=2.0, shift=1.0), _f(3),
                          _f(3)], []),
    ("InstanceNorm", {"eps": 1e-5}, [_f(3, 2, 7, shift=-1.0), _f(2), _f(2)],
     []),
    ("L2Normalization", {}, [_f(3, 4, 5)], []),
    ("L2Normalization", {"mode": "channel", "eps": 1e-4}, [_f(2, 3, 4, 5)],
     []),
    ("L2Normalization", {"mode": "spatial"}, [_f(2, 3, 4, 5)], []),
    ("SoftmaxActivation", {}, [_f(3, 4, 5, scale=2.0)], []),
    ("SoftmaxActivation", {"mode": "channel"}, [_f(2, 5, 3, 4, scale=2.0)],
     []),
    ("LinearRegressionOutput", {}, [_f(4, 3), _f(4, 3)], []),
    ("LinearRegressionOutput", {"grad_scale": 2.0}, [_f(5, 1), _f(5)], []),
    ("LogisticRegressionOutput", {}, [_f(4, 3), _pos(4, 3)], []),
    ("MAERegressionOutput", {"grad_scale": 0.5}, [_f(3, 2, 2), _f(3, 2, 2)],
     []),
    ("SVMOutput", {}, [_f(5, 4), _labels(5, high=4)], []),
    ("SVMOutput", {"margin": 0.5, "regularization_coefficient": 2.0,
                   "use_linear": True}, [_f(6, 3), _labels(6, high=3)], []),
    ("MakeLoss", {}, [_f(3, 4)], []),
    ("MakeLoss", {"grad_scale": 3.0, "normalization": "batch"}, [_f(4, 5)],
     []),
    ("MakeLoss", {"normalization": "valid", "valid_thresh": 0.2},
     [_f(4, 6)], []),
    ("MakeLoss", {"grad_scale": 0.0, "normalization": "valid"}, [_f(3, 4)],
     []),
    ("softmax_cross_entropy", {}, [_f(5, 4, scale=2.0), _labels(5, high=4)],
     []),
    ("UpSampling", {"scale": 2, "sample_type": "nearest"}, [_f(2, 3, 4, 5)],
     []),
    ("UpSampling", {"scale": 3, "sample_type": "nearest", "num_args": 2},
     [_f(2, 3, 2, 3), _f(2, 2, 2, 3)], []),
    ("UpSampling", {"scale": 2, "sample_type": "nearest", "num_args": 3,
                    "multi_input_mode": "sum", "workspace": 256},
     [_f(1, 2, 3, 3), _f(1, 2, 3, 3), _f(1, 2, 3, 3)], []),
    ("UpSampling", {"scale": 2, "sample_type": "bilinear", "num_filter": 3},
     [_f(2, 3, 4, 5), _f(3, 1, 4, 4)], []),
    ("UpSampling", {"scale": 3, "sample_type": "bilinear", "num_filter": 2},
     [_f(1, 2, 3, 4), _f(2, 1, 5, 5)], []),
]

# BatchNorm: data with a non-zero mean (the variance formulas differ by
# dtype), gamma, beta; moving mean and variance
_BN_IN = [_f(4, 3, 5, 6, scale=2.0, shift=1.0), _f(3, shift=1.0), _f(3)]
_BN_AUX = [_f(3, scale=0.1), _pos(3)]
BN_CASES = [
    ({}, _BN_IN, _BN_AUX),
    ({"fix_gamma": False, "eps": 2e-5, "momentum": 0.8}, _BN_IN, _BN_AUX),
    ({"fix_gamma": False, "output_mean_var": True}, _BN_IN, _BN_AUX),
    ({"fix_gamma": False, "use_global_stats": True}, _BN_IN, _BN_AUX),
    ({"fix_gamma": False}, [_f(6, 4, scale=3.0, shift=-2.0), _f(4),
                            _f(4)], [_f(4), _pos(4)]),
]


def _cast(x, dtype, lib):
    if dtype == "float32":
        return lib(x)
    if lib is torch.from_numpy:
        return torch.from_numpy(x).to(torch.bfloat16)
    import jax.numpy as jnp

    return jnp.asarray(x).astype(jnp.bfloat16)


def _port(op, attrs, inputs, aux, is_train, cotangents, dtype):
    """The port's outputs, aux updates and input gradients (float64 numpy)
    on ``inputs`` cast to ``dtype`` (a torch dtype)."""
    tins = [torch.from_numpy(x).to(dtype).requires_grad_(True)
            for x in inputs]
    tout, tnew_aux = op.apply(OpContext(is_train=is_train), attrs, tins,
                              tuple(torch.from_numpy(a) for a in aux))
    heads = [o for o in tout if o.requires_grad]
    cts = [torch.from_numpy(c).to(o.dtype)
           for c, o in zip(cotangents, tout) if o.requires_grad]
    tgrads = torch.autograd.grad(heads, tins, cts, allow_unused=True)

    def t64(xs):
        return [None if x is None else x.detach().double().numpy()
                for x in xs]

    return t64(tout), t64(tnew_aux), t64(tgrads)


def _both(name, attrs, inputs, aux=(), is_train=False, dtype="float32",
          rng=None):
    """Outputs, aux updates and input gradients of op ``name``: (JAX, port,
    truth), each (outs, aux, grads) as float64 numpy.  Gradients are
    taken for every input against one numpy cotangent per output (drawn
    from ``rng``).  In bf16 the inputs and cotangents are rounded to bf16
    first; the third entry is then the JAX op in float32 on those rounded
    values (None in float32)."""
    import jax
    import jax.numpy as jnp

    jop, op = jget_op(name), get_op(name)
    jattrs, attrs_ = jop.parse_attrs(attrs), op.parse_attrs(attrs)
    if dtype == "bfloat16":  # round once; every run sees the same values
        inputs = [_round_bf16(x) for x in inputs]
    jins = [_cast(x, dtype, jnp.asarray) for x in inputs]
    jaux = [jnp.asarray(a) for a in aux]

    def jfn(*xs):
        outs, new_aux = jop.apply(JOpContext(is_train=is_train), jattrs,
                                  list(xs), tuple(jaux))
        return tuple(outs), tuple(new_aux)

    def jrun(ins, cotangents):
        outs, new_aux = jfn(*ins)
        grads = jax.vjp(lambda *xs: jfn(*xs)[0], *ins)[1](
            tuple(jnp.asarray(c).astype(o.dtype)
                  for c, o in zip(cotangents, outs)))
        return tuple([np.asarray(jnp.asarray(x, jnp.float32), np.float64)
                      for x in xs] for xs in (outs, new_aux, grads))

    cotangents = [rng.randn(*o.shape).astype(np.float32)
                  for o in jax.eval_shape(jfn, *jins)[0]]
    if dtype == "bfloat16":
        cotangents = [_round_bf16(c) for c in cotangents]
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    port = _port(op, attrs_, inputs, aux, is_train, cotangents, tdtype)
    truth = None if dtype == "float32" else jrun(
        [jnp.asarray(x) for x in inputs], cotangents)
    return jrun(jins, cotangents), port, truth


def _round_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _err(got, ref):
    """max |got - ref| over max |ref| on the finite entries, which must
    match."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    scale = max(float(np.abs(ref[fin]).max(initial=0.0)), 1e-30)
    return float(np.abs(got[fin] - ref[fin]).max(initial=0.0)) / scale


def _close(got, ref, dtype, what, truth=None):
    """float32: rtol = 1e-5 against the JAX package, atol 1e-5 of the
    array's largest magnitude (at least 1e-5: a sum of many terms, such as
    gamma's gradient, differs by its summation order in absolute terms).  bf16: within
    2e-2 of the JAX package's largest value.  Where the JAX package's own
    bf16 result is farther than 1e-2 from the JAX op's float32 result on
    the same rounded inputs (``truth``: its CPU reductions of bf16 sums,
    e.g. a bias gradient, accumulate in bf16), the port is held instead to
    2e-2 of that float32 result and to no more error than the JAX
    package's."""
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if dtype == "float32":
        scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
        np.testing.assert_allclose(got, ref, rtol=F32_TOL,
                                   atol=F32_TOL * scale, err_msg=what)
        return
    if truth is not None and _err(ref, truth) > BF16_TOL / 2:
        port_err, jax_err = _err(got, truth), _err(ref, truth)
        assert port_err <= BF16_TOL and port_err <= jax_err, \
            (what, port_err, jax_err)
        return
    err = _err(got, ref)
    assert err <= BF16_TOL, (what, err)


def _check_case(name, attrs, makers, aux_makers, dtype, is_train=False):
    rng = np.random.RandomState(len(name) + len(attrs))
    inputs = [m(rng) for m in makers]
    aux = [m(rng) for m in aux_makers]
    (jo, ja, jg), (to, ta, tg), truth = _both(name, attrs, inputs, aux,
                                              is_train, dtype, rng=rng)
    truth = truth or ([None] * len(jo), [None] * len(ja), [None] * len(jg))
    assert len(to) == len(jo)
    for i, (t, j, r) in enumerate(zip(to, jo, truth[0])):
        _close(t, j, dtype, "%s output %d" % (name, i), r)
    for i, (t, j, r) in enumerate(zip(ta, ja, truth[1])):
        _close(t, j, dtype, "%s aux %d" % (name, i), r)
    for i, (t, j, r) in enumerate(zip(tg, jg, truth[2])):
        _close(np.zeros_like(j) if t is None else t, j, dtype,
               "%s gradient %d" % (name, i), r)
    # the same op on data-free meta tensors gives the same shapes
    op = get_op(name)
    metas, meta_aux = op.apply(
        OpContext(is_train=is_train), op.parse_attrs(attrs),
        [torch.empty(x.shape, device="meta") for x in inputs],
        tuple(torch.empty(a.shape, device="meta") for a in aux))
    assert [tuple(m.shape) for m in metas] == [j.shape for j in jo]
    assert [tuple(m.shape) for m in meta_aux] == [j.shape for j in ja]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,attrs,makers,aux", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_op_forward_and_gradient_match_jax(name, attrs, makers, aux, dtype):
    _check_case(name, attrs, makers, aux, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("alias", ["BatchNorm", "CuDNNBatchNorm"])
@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_batch_norm_matches_jax(case, alias, is_train, dtype):
    """Outputs, gradients of data, gamma and beta, and the updated moving
    statistics (float32 in both dtypes)."""
    attrs, makers, aux = BN_CASES[case]
    _check_case(alias, attrs, makers, aux, dtype, is_train)


def test_batch_norm_bf16_rounds_scale_and_shift_before_the_product():
    """In bf16, scale and shift are rounded before data·scale + shift: the
    port gives the bits of that formula written out, not those of one
    rounding after float32 arithmetic."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(8, 4, 3, 3).astype(np.float32) * 3 + 2)
    x = x.to(torch.bfloat16)
    gamma = torch.from_numpy(rng.randn(4).astype(np.float32))
    beta = torch.from_numpy(rng.randn(4).astype(np.float32))
    op = get_op("BatchNorm")
    (out,), _ = op.apply(OpContext(is_train=True),
                         op.parse_attrs({"fix_gamma": False}),
                         [x, gamma.to(torch.bfloat16),
                          beta.to(torch.bfloat16)],
                         (torch.zeros(4), torch.ones(4)))
    from mxnet_tpu_torch.ops.nn import _StatsF32

    mean, meansq = _StatsF32.apply(x, (0, 2, 3))
    np.testing.assert_allclose(
        meansq.numpy(), (x.float() ** 2).mean(dim=(0, 2, 3)).numpy(),
        rtol=1e-6)
    var = torch.clamp(meansq - mean * mean, min=0)
    inv = torch.rsqrt(var + 1e-3)
    g = gamma.to(torch.bfloat16).float()
    scale = (g * inv).to(torch.bfloat16).reshape(1, -1, 1, 1)
    shift = (beta.to(torch.bfloat16).float() - mean * inv * g).to(
        torch.bfloat16).reshape(1, -1, 1, 1)
    assert torch.equal(out, x * scale + shift)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)},
    {"kernel": (2, 2), "stride": (2, 2), "pooling_convention": "full"},
    {"kernel": (3, 3), "stride": (1, 1)}], ids=["stem", "full", "overlap"])
def test_relu_then_max_pool_with_ties_matches_jax(pool, dtype):
    """Max pooling after a ReLU, as ResNet's stem does: windows full of
    zeros tie.  The two packages may route a tie's gradient to different
    positions, but every tied zero came from a negative input, which the
    ReLU's gradient masks, so the chain's gradients agree."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(11)
    x = (rng.randn(2, 3, 9, 8) - 0.8).astype(np.float32)
    jrelu, jpool = jget_op("Activation"), jget_op("Pooling")
    relu, pool_op = get_op("Activation"), get_op("Pooling")
    rattrs = {"act_type": "relu"}

    def jchain(v):
        (h,), _ = jrelu.apply(JOpContext(), jrelu.parse_attrs(rattrs), [v])
        (o,), _ = jpool.apply(JOpContext(), jpool.parse_attrs(pool), [h])
        return o

    jx = _cast(x, dtype, jnp.asarray)
    jout, vjp = jax.vjp(jchain, jx)
    ct = rng.randn(*jout.shape).astype(np.float32)
    (jg,) = vjp(_cast(ct, dtype, jnp.asarray))
    tx = _cast(x, dtype, torch.from_numpy).requires_grad_(True)
    (h,), _ = relu.apply(OpContext(), relu.parse_attrs(rattrs), [tx])
    (tout,), _ = pool_op.apply(OpContext(), pool_op.parse_attrs(pool), [h])
    (tg,) = torch.autograd.grad(tout, tx, _cast(ct, dtype, torch.from_numpy))
    zero_windows = int((np.asarray(jnp.asarray(jout, jnp.float32)) == 0)
                       .sum())
    assert zero_windows > 0  # the input has tied windows
    _close(tout.detach().double().numpy(),
           np.asarray(jnp.asarray(jout, jnp.float32), np.float64), dtype,
           "relu -> pool output")
    _close(tg.double().numpy(),
           np.asarray(jnp.asarray(jg, jnp.float32), np.float64), dtype,
           "relu -> pool gradient")


@pytest.mark.parametrize("name", ["Activation", "Convolution",
                                  "Convolution_v1", "Pooling", "Pooling_v1",
                                  "BatchNorm", "CuDNNBatchNorm", "Dropout",
                                  "LRN", "Flatten", "flatten", "Concat",
                                  "concat"])
def test_op_surface_matches_jax(name):
    """Name, hint, inputs, aux states, the stochastic flag, the variadic
    attr and every parameter's type, default and requiredness — what graph
    JSON and auto-naming are made of."""
    jop, op = jget_op(name), get_op(name)
    assert op.name == jop.name and op.hint == jop.hint
    assert list(op.params) == list(jop.params)
    for key, p in op.params.items():
        jp = jop.params[key]
        assert (p.typ, p.default, p.required, p.enum) == \
            (jp.typ, jp.default, jp.required, jp.enum), (name, key)
    attrs = {"act_type": "relu", "kernel": (3, 3), "num_filter": 2,
             "nsize": 3, "num_args": 3}
    attrs = {k: v for k, v in attrs.items() if k in op.params}
    assert op.input_names(op.parse_attrs(attrs)) == \
        jop.input_names(jop.parse_attrs(attrs))
    assert op.aux_names(op.parse_attrs(attrs)) == \
        jop.aux_names(jop.parse_attrs(attrs))
    assert (op.stochastic, op.key_var_num_args) == \
        (jop.stochastic, jop.key_var_num_args)


@pytest.mark.parametrize("name,attrs,shapes", [
    ("Convolution", {"kernel": (3, 3), "num_filter": 8, "stride": (2, 2),
                     "pad": (1, 1), "num_group": 2}, [(2, 4, 9, 10)]),
    ("Convolution", {"kernel": (3,), "num_filter": 2, "dilate": (3,),
                     "no_bias": True}, [(1, 3, 20)]),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pooling_convention": "full"}, [(2, 4, 9, 10)]),
    ("Pooling", {"kernel": (7, 7), "global_pool": True}, [(2, 4, 9, 10)]),
    ("BatchNorm", {"output_mean_var": True}, [(2, 4, 9, 10)]),
    ("BatchNorm", {}, [(5, 6)]),
    ("Flatten", {}, [(2, 4, 9, 10)]),
    ("Concat", {"num_args": 2, "dim": 2}, [(2, 4, 9), (2, 4, 3)]),
], ids=["conv2d", "conv1d", "pool-full", "pool-global", "bn-3out", "bn-2d",
        "flatten", "concat"])
def test_infer_shape_matches_jax(name, attrs, shapes):
    jop, op = jget_op(name), get_op(name)
    shapes = list(shapes) + [None] * (
        len(op.input_names(op.parse_attrs(attrs))) - len(shapes))
    got = op.infer_shape(op.parse_attrs(attrs), shapes)
    ref = jop.infer_shape(jop.parse_attrs(attrs), shapes)
    assert [list(map(tuple, g)) if g is not None else g for g in got] == \
        [list(map(tuple, r)) if r is not None else r for r in ref]


# ---------------------------------------------------------------------------
# Dropout: statistics and replay, not bits
# ---------------------------------------------------------------------------


def _dropout(x, p, is_train, gen):
    op = get_op("Dropout")
    (out,), _ = op.apply(OpContext(is_train, gen), op.parse_attrs({"p": p}),
                         [x])
    return out


def test_dropout_is_identity_in_inference_at_p0_and_without_generator():
    x = torch.randn(64, 33)
    gen = torch.Generator().manual_seed(0)
    for p, is_train, g in ((0.5, False, gen), (0.0, True, gen),
                           (-0.1, True, gen), (0.5, True, None)):
        assert _dropout(x, p, is_train, g) is x


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_dropout_keep_rate_and_scale(p):
    """Kept elements are x / (1 - p) exactly, dropped ones 0, and the kept
    share of n = 2**20 elements is 1 - p within 5 standard deviations
    (sqrt(p (1 - p) / n) <= 4.9e-4)."""
    n = 1 << 20
    x = torch.rand(n) + 1.0  # no zeros of its own
    out = _dropout(x, p, True, torch.Generator().manual_seed(3))
    kept = out != 0
    share = kept.double().mean().item()
    assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(out[kept], x[kept] / (1 - p))


def test_dropout_same_seed_same_mask_and_backward_replays_it():
    """One seed gives one mask: through the op with equal generators, and
    through an executor, where ``backward`` re-runs the forward before it
    on a generator in that forward's state, so the gradient's mask is the
    forward's; a later forward draws a new mask."""
    x = torch.rand(32, 40) + 1.0
    a = _dropout(x, 0.5, True, torch.Generator().manual_seed(5))
    b = _dropout(x, 0.5, True, torch.Generator().manual_seed(5))
    c = _dropout(x, 0.5, True, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)

    data = mt.sym.Variable("data")
    net = mt.sym.Dropout(data * mt.sym.Variable("w"), p=0.5)
    xs = np.random.RandomState(0).rand(16, 24).astype(np.float32) + 1.0
    masks = []
    for _ in range(2):
        mt.random.seed(42)
        ex = net.bind(mt.cpu(), {"data": mt.nd.array(xs, mt.cpu()),
                                 "w": mt.nd.ones((16, 24), mt.cpu())},
                      args_grad={"w": mt.nd.zeros((16, 24), mt.cpu())})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mt.nd.ones((16, 24), mt.cpu()))
        grad = ex.grad_dict["w"].asnumpy()
        # d out / d w = x / keep where kept, 0 where dropped: the same mask
        np.testing.assert_array_equal(out != 0, grad != 0)
        np.testing.assert_allclose(grad[grad != 0], xs[grad != 0] * 2.0)
        masks.append(out != 0)
        again = ex.forward(is_train=True)[0].asnumpy()
        assert not np.array_equal(again != 0, out != 0)
    np.testing.assert_array_equal(masks[0], masks[1])
    assert 0.35 < masks[0].mean() < 0.65


def test_dropout_in_a_graph_trains_and_infers_like_jax_in_inference():
    """A graph with Dropout: inference (is_train False) matches the JAX
    package exactly (the identity); a training forward keeps about half."""
    import mxnet_tpu as mx

    xs = np.random.RandomState(1).randn(8, 6).astype(np.float32)
    outs = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            net = pkg.sym.Dropout(pkg.sym.Variable("data"), p=0.3)
        ex = net.bind(pkg.cpu(), {"data": pkg.nd.array(xs, pkg.cpu())})
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], xs)


@pytest.mark.parametrize("xs,ws,stride,pad,dil,groups", [
    ((2, 4, 11), (4, 2, 3), (2,), (1,), (2,), 2),
    ((2, 3, 9, 8), (6, 3, 3, 3), (2, 1), (1, 1), (1, 2), 1),
    ((2, 6, 7, 7), (6, 1, 3, 3), (1, 1), (1, 1), (1, 1), 6),
    ((1, 2, 4, 5, 3), (4, 2, 2, 3, 2), (1, 2, 1), (1, 0, 1), (1, 1, 1), 1)],
    ids=["1d-grouped-dilated", "2d-strided-dilated", "2d-depthwise", "3d"])
def test_float32_card_convolution_function_matches_autograd(xs, ws, stride,
                                                           pad, dil, groups):
    """``_WideConv``, the float32 convolution the card runs (cuDNN off
    around its forward and its backward), gives what ``F.conv1d/2d/3d``
    and autograd give, here on the CPU tensors it is handed."""
    from mxnet_tpu_torch.ops.nn import _CONV, _WideConv

    rng = np.random.RandomState(9)
    x0 = torch.from_numpy(rng.randn(*xs).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(*ws).astype(np.float32))
    got, ref = [], []
    for fn, out in ((lambda x, w: _WideConv.apply(x, w, stride, pad, dil,
                                                  groups), got),
                    (lambda x, w: _CONV[len(stride)](x, w, None, stride, pad,
                                                     dil, groups), ref)):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        o = fn(x, w)
        ct = torch.from_numpy(np.random.RandomState(1).randn(*o.shape)
                              .astype(np.float32))
        out += [o.detach()] + list(torch.autograd.grad(o, (x, w), ct))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("attrs", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)},
    {"kernel": (2, 2), "stride": (2, 2), "pooling_convention": "full"}],
    ids=["padded", "full"])
def test_integer_max_pooling_matches_jax(attrs):
    """Max pooling of int32 data, which torch's pooling does not take:
    the windows unfolded, padding at the dtype's least value as the JAX
    package pads."""
    import jax.numpy as jnp

    x = np.random.RandomState(4).randint(-50, 50, (2, 3, 7, 6)).astype(
        np.int32)
    jop, op = jget_op("Pooling"), get_op("Pooling")
    (ref,), _ = jop.apply(JOpContext(), jop.parse_attrs(attrs),
                          [jnp.asarray(x)])
    (got,), _ = op.apply(OpContext(), op.parse_attrs(attrs),
                         [torch.from_numpy(x)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# slice 11: KL-sparse aux, rrelu's draws, the transposed convolution the
# card runs in float32, and the surface of the new ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attrs", [
    {}, {"sparseness_target": 0.3, "penalty": 0.01, "momentum": 0.5}])
def test_identity_attach_kl_sparse_reg_matches_jax(attrs):
    """Identity forward and the moving average of the batch mean per
    channel, against the JAX op.  The JAX op's gradient raises (its custom
    vjp keeps the shape and dtype among its residuals, which JAX refuses:
    a reference-side defect kept, ROADMAP C), so the port's gradient is
    held to the formula of that vjp: the head gradient plus
    penalty·(−ρ̂/ρ + (1 − ρ̂)/(1 − ρ)) per channel, ρ the batch mean."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    x = (rng.rand(4, 3, 2, 2) * 0.8 + 0.1).astype(np.float32)
    avg = (rng.rand(3) * 0.5).astype(np.float32)
    ct = rng.randn(*x.shape).astype(np.float32)
    jop, op = jget_op("IdentityAttachKLSparseReg"), \
        get_op("IdentityAttachKLSparseReg")
    ja = jop.parse_attrs(attrs)

    def jfn(v):
        return jop.apply(JOpContext(True), ja, [v], (jnp.asarray(avg),))

    (jout,), (javg,) = jfn(jnp.asarray(x))
    with pytest.raises(TypeError):
        jax.vjp(lambda v: jfn(v)[0][0], jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tout,), (tavg,) = op.apply(OpContext(True), op.parse_attrs(attrs), [tx],
                                (torch.from_numpy(avg),))
    (grad,) = torch.autograd.grad(tout, tx, torch.from_numpy(ct))
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(tavg.numpy(), np.asarray(javg), rtol=1e-6,
                               atol=1e-7)
    st = ja["sparseness_target"]
    rho = x.astype(np.float64).mean(axis=(0, 2, 3))
    kl = ja["penalty"] * (-st / (rho + 1e-12) + (1 - st) / (1 - rho + 1e-12))
    np.testing.assert_allclose(grad.numpy(), ct + kl.reshape(1, -1, 1, 1),
                               rtol=1e-5, atol=1e-6)


def test_rrelu_draws_slopes_in_training_and_replays_them():
    """In training each element's slope is drawn from U(lower, upper)
    with the ``OpContext`` generator: negative inputs come out scaled by
    a slope in that range, the same generator state gives the same
    slopes, and an executor's ``backward`` replays the forward's
    slopes."""
    op = get_op("LeakyReLU")
    attrs = op.parse_attrs({"act_type": "rrelu", "lower_bound": 0.1,
                            "upper_bound": 0.4})
    x = -torch.rand(1 << 16) - 0.5
    outs = [op.apply(OpContext(True, torch.Generator().manual_seed(s)),
                     attrs, [x])[0][0] for s in (1, 1, 2)]
    slope = outs[0] / x
    assert float(slope.min()) >= 0.1 - 1e-6 and float(slope.max()) <= 0.4
    assert abs(float(slope.mean()) - 0.25) < 6 * 0.3 / np.sqrt(12 << 16)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    data = mt.sym.Variable("data")
    net = mt.sym.LeakyReLU(data * mt.sym.Variable("w"), act_type="rrelu")
    xs = -np.random.RandomState(0).rand(6, 5).astype(np.float32) - 0.5
    ex = net.bind(mt.cpu(), {"data": mt.nd.array(xs, mt.cpu()),
                             "w": mt.nd.ones((6, 5), mt.cpu())},
                  args_grad={"w": mt.nd.zeros((6, 5), mt.cpu())})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(mt.nd.ones((6, 5), mt.cpu()))
    # d out / d w = slope · x: the forward's slopes
    np.testing.assert_allclose(ex.grad_dict["w"].asnumpy(), out, rtol=1e-6)
    np.testing.assert_allclose(ex.forward(is_train=False)[0].asnumpy(),
                               xs * (0.125 + 0.334) / 2, rtol=1e-6)


@pytest.mark.parametrize("xs,ws,stride,pad,adj,groups", [
    ((2, 4, 5), (4, 3, 4), (2,), (1,), (1,), 1),
    ((2, 3, 5, 4), (3, 5, 4, 4), (2, 2), (1, 1), (0, 0), 1),
    ((2, 4, 3, 5), (4, 2, 3, 3), (2, 2), (1, 1), (1, 1), 2),
    ((2, 6, 4, 4), (6, 1, 4, 4), (2, 2), (1, 1), (0, 0), 6),
    ((1, 2, 3, 4, 3), (2, 2, 2, 3, 2), (1, 2, 2), (0, 1, 0), (0, 1, 1), 1)],
    ids=["1d-adj", "2d", "2d-grouped-adj", "2d-bilinear-like", "3d"])
def test_float32_card_transposed_convolution_matches_autograd(
        xs, ws, stride, pad, adj, groups):
    """``_WideConv`` as a transposed convolution (Deconvolution and
    bilinear UpSampling on the card in float32) gives what
    ``F.conv_transpose1d/2d/3d`` and autograd give, on the CPU."""
    from mxnet_tpu_torch.ops.nn import _CONV_T, _WideConv

    rng = np.random.RandomState(9)
    x0 = torch.from_numpy(rng.randn(*xs).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(*ws).astype(np.float32))
    nd = len(stride)
    got, ref = [], []
    for fn, out in (
            (lambda x, w: _WideConv.apply(x, w, list(stride), list(pad),
                                          [1] * nd, groups, True, list(adj)),
             got),
            (lambda x, w: _CONV_T[nd](x, w, None, stride, pad, adj, groups),
             ref)):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        o = fn(x, w)
        ct = torch.from_numpy(np.random.RandomState(1).randn(*o.shape)
                              .astype(np.float32))
        out += [o.detach()] + list(torch.autograd.grad(o, (x, w), ct))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", [
    "LeakyReLU", "Deconvolution", "InstanceNorm", "L2Normalization",
    "SoftmaxActivation", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
    "MakeLoss", "softmax_cross_entropy", "IdentityAttachKLSparseReg",
    "UpSampling"])
@pytest.mark.parametrize("attrs", [
    {}, {"act_type": "prelu", "sample_type": "bilinear", "num_args": 2},
    {"sample_type": "nearest", "num_args": 3}])
def test_new_op_surface_matches_jax(name, attrs):
    """Name, hint, inputs (which vary with act_type, sample_type and
    num_args), outputs, aux states, the no-gradient inputs, the
    stochastic flag and every parameter."""
    jop, op = jget_op(name), get_op(name)
    assert (op.name, op.hint, op.stochastic, op.key_var_num_args,
            op.no_grad_inputs) == (jop.name, jop.hint, jop.stochastic,
                                   jop.key_var_num_args, jop.no_grad_inputs)
    assert list(op.params) == list(jop.params)
    for key, p in op.params.items():
        jp = jop.params[key]
        assert (p.typ, p.default, p.required, p.enum) == \
            (jp.typ, jp.default, jp.required, jp.enum), (name, key)
    full = {"kernel": (3, 3), "num_filter": 2, "scale": 2,
            "sample_type": "nearest"}
    full.update(attrs)
    full = {k: v for k, v in full.items() if k in op.params}
    pa, ja = op.parse_attrs(full), jop.parse_attrs(full)
    assert op.input_names(pa) == jop.input_names(ja)
    assert op.output_names(pa, "n") == jop.output_names(ja, "n")
    assert op.aux_names(pa) == jop.aux_names(ja)


@pytest.mark.parametrize("name,attrs,shapes", [
    ("LeakyReLU", {"act_type": "prelu"}, [(2, 5, 3, 3)]),
    ("Deconvolution", {"kernel": (4, 4), "num_filter": 6, "stride": (2, 2),
                       "pad": (1, 1), "adj": (1, 0), "num_group": 2},
     [(2, 4, 5, 6)]),
    ("Deconvolution", {"kernel": (3, 3), "num_filter": 2, "no_bias": True},
     [(1, 3, 4, 4)]),
    ("InstanceNorm", {}, [(2, 3, 4, 4)]),
    ("LinearRegressionOutput", {}, [(4, 1)]),
    ("MAERegressionOutput", {}, [(4, 3)]),
    ("SVMOutput", {}, [(4, 3)]),
    ("softmax_cross_entropy", {}, [(4, 3), (4,)]),
    ("IdentityAttachKLSparseReg", {}, [(4, 3, 2)]),
    ("UpSampling", {"scale": 2, "sample_type": "bilinear"}, [(2, 3, 4, 5)]),
    ("UpSampling", {"scale": 3, "sample_type": "nearest", "num_args": 2},
     [(2, 3, 4, 5), (2, 2, 4, 5)]),
], ids=["prelu", "deconv", "deconv-nobias", "instancenorm", "linreg",
        "maereg", "svm", "sce", "klsparse", "up-bilinear", "up-nearest"])
def test_new_op_infer_shape_matches_jax(name, attrs, shapes):
    jop, op = jget_op(name), get_op(name)
    shapes = list(shapes) + [None] * (
        len(op.input_names(op.parse_attrs(attrs))) - len(shapes))
    got = op.infer_shape(op.parse_attrs(attrs), shapes)
    ref = jop.infer_shape(jop.parse_attrs(attrs), shapes)
    assert [list(map(tuple, g)) if g is not None else g for g in got] == \
        [list(map(tuple, r)) if r is not None else r for r in ref]


def test_deconvolution_target_shape_is_inferred_but_not_applied():
    """``target_shape`` sets the inferred spatial size, but neither the
    JAX op nor the port's crops or pads to it (a reference-side defect
    kept, ROADMAP C): the op's output keeps s·(x − 1) + k − 2p + adj."""
    import jax.numpy as jnp

    attrs = {"kernel": (3, 3), "num_filter": 2, "stride": (2, 2),
             "target_shape": (8, 8), "no_bias": True}
    x = np.random.RandomState(0).randn(1, 3, 3, 3).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 2, 3, 3).astype(np.float32)
    for op, lib, ctx in ((jget_op("Deconvolution"), jnp.asarray,
                          JOpContext()),
                         (get_op("Deconvolution"), torch.from_numpy,
                          OpContext())):
        pa = op.parse_attrs(attrs)
        assert tuple(op.infer_shape(pa, [x.shape, None])[1][0]) == \
            (1, 2, 8, 8)
        (out,), _ = op.apply(ctx, pa, [lib(x), lib(w)])
        assert tuple(out.shape) == (1, 2, 7, 7)
