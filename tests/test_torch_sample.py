"""The sampling ops and ``mxnet_tpu_torch.random`` against the JAX
package's, on the CPU.

The port draws from ``torch.Generator``s, the JAX package from threefry
keys, so one seed gives different numbers in the two packages (ROADMAP C,
kept differences).  The tests hold what both must share instead: the op
surface (names, aliases, parameters, shape inference), shapes and dtypes,
the distribution's mean and variance over 2**20 draws within 6 standard
errors in both packages, same-seed replay, ``get_state``/``set_state``
replay, and the reference's call forms of ``random.uniform``/``normal``
(ROADMAP C.6)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OpContext, get_op

N = 1 << 20
CPU = torch.device("cpu")


def _moments(name, attrs):
    """(mean, variance, fourth central moment) of the op's distribution."""
    if name == "_sample_uniform":
        lo, hi = attrs.get("low", 0.0), attrs.get("high", 1.0)
        w = hi - lo
        return (lo + hi) / 2, w * w / 12, w ** 4 / 80
    if name == "_sample_normal":
        s = attrs.get("scale", 1.0)
        return attrs.get("loc", 0.0), s * s, 3 * s ** 4
    if name == "_sample_gamma":
        a, b = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)
        var = a * b * b
        return a * b, var, var * var * (3 + 6 / a)
    if name == "_sample_exponential":
        lam = attrs.get("lam", 1.0)
        return 1 / lam, 1 / lam ** 2, 9 / lam ** 4
    lam = attrs.get("lam", 1.0)  # poisson
    return lam, lam, lam * (1 + 3 * lam)


SAMPLERS = [
    ("_sample_uniform", {}), ("_sample_uniform", {"low": -2.0, "high": 5.0}),
    ("_sample_normal", {}), ("_sample_normal", {"loc": 3.0, "scale": 0.5}),
    ("_sample_gamma", {"alpha": 2.5, "beta": 1.5}),
    ("_sample_gamma", {"alpha": 0.5}),
    ("_sample_exponential", {"lam": 4.0}),
    ("_sample_poisson", {"lam": 3.0}), ("_sample_poisson", {"lam": 0.7}),
]


def _port_draw(name, attrs, gen, shape=(N,), dtype="float32"):
    op = get_op(name)
    (out,), _ = op.apply(OpContext(True, gen, CPU),
                         op.parse_attrs(dict(attrs, shape=shape,
                                             dtype=dtype)), [])
    return out


def _check_moments(x, name, attrs):
    mean, var, mu4 = _moments(name, attrs)
    x = np.asarray(x, np.float64)
    n = x.size
    assert abs(x.mean() - mean) <= 6 * np.sqrt(var / n), (name, x.mean())
    assert abs(x.var() - var) <= 6 * np.sqrt((mu4 - var * var) / n), \
        (name, x.var())


@pytest.mark.parametrize("name,attrs", SAMPLERS,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(SAMPLERS)])
def test_sampler_moments_in_both_packages(name, attrs):
    """Mean and variance of 2**20 draws within 6 standard errors of the
    distribution's (the variance's standard error from the fourth central
    moment), in the port and in the JAX package."""
    import jax

    x = _port_draw(name, attrs, torch.Generator().manual_seed(11))
    assert x.shape == (N,) and x.dtype == torch.float32
    _check_moments(x.numpy(), name, attrs)
    jop = jget_op(name)
    (j,), _ = jop.apply(JOpContext(True, jax.random.PRNGKey(11)),
                        jop.parse_attrs(dict(attrs, shape=(N,))), [])
    _check_moments(np.asarray(j), name, attrs)


@pytest.mark.parametrize("name", [n for n, _ in SAMPLERS[::2]])
def test_sampler_same_seed_same_bits_and_dtype_and_meta(name):
    a = _port_draw(name, {}, torch.Generator().manual_seed(5), (3, 4),
                   "float16")
    b = _port_draw(name, {}, torch.Generator().manual_seed(5), (3, 4),
                   "float16")
    c = _port_draw(name, {}, torch.Generator().manual_seed(6), (3, 4),
                   "float16")
    assert a.dtype == torch.float16 and a.shape == (3, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    op = get_op(name)
    (m,), _ = op.apply(OpContext(True, gen, torch.device("meta")),
                       op.parse_attrs({"shape": (7, 2)}), [])
    assert m.is_meta and tuple(m.shape) == (7, 2)
    assert torch.equal(gen.get_state(), before)  # nothing drawn
    with pytest.raises(MXNetError):  # no device: no default
        op.apply(OpContext(True, gen), op.parse_attrs({"shape": (2,)}), [])


@pytest.mark.parametrize("name", ["_sample_uniform", "uniform",
                                  "random_uniform", "_sample_normal",
                                  "normal", "random_normal", "_sample_gamma",
                                  "random_gamma", "_sample_exponential",
                                  "random_exponential", "_sample_poisson",
                                  "random_poisson"])
def test_sampler_surface_matches_jax(name):
    jop, op = jget_op(name), get_op(name)
    assert (op.name, op.hint, op.stochastic, op.no_grad_inputs) == \
        (jop.name, jop.hint, jop.stochastic, jop.no_grad_inputs)
    assert list(op.params) == list(jop.params)
    for key, p in op.params.items():
        jp = jop.params[key]
        assert (p.typ, p.default, p.required, p.enum) == \
            (jp.typ, jp.default, jp.required, jp.enum), (name, key)
    attrs = {"shape": (2, 5)}
    assert op.input_names(attrs) == jop.input_names(attrs) == []
    assert op.infer_shape(op.parse_attrs(attrs), []) == \
        jop.infer_shape(jop.parse_attrs(attrs), [])


def test_sym_sampler_json_is_byte_identical():
    outs = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            net = pkg.sym.Group([
                pkg.sym.uniform(low=-1.0, high=2.0, shape=(3, 4)),
                pkg.sym.random_normal(loc=1.0, shape=(2,), dtype="float16"),
                pkg.sym._sample_poisson(lam=2.0, shape=(5,))])
        outs.append(net.tojson())
    assert outs[0] == outs[1]


def test_samplers_in_a_graph_draw_from_the_executors_generator():
    """A graph with a sampler binds on the CPU, infers its shape from the
    attrs, draws from the device generator that ``random.seed`` reseeds,
    and ``backward`` replays the forward's draws."""
    with mt.NameManager():
        noise = mt.sym.normal(shape=(4, 6))
        net = mt.sym.Variable("w") * noise
    assert net.infer_shape(w=(4, 6))[1] == [(4, 6)]
    runs = []
    for _ in range(2):
        mt.random.seed(123)
        ex = net.bind(mt.cpu(), {"w": mt.nd.ones((4, 6), mt.cpu())},
                      args_grad={"w": mt.nd.zeros((4, 6), mt.cpu())})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mt.nd.ones((4, 6), mt.cpu()))
        np.testing.assert_array_equal(ex.grad_dict["w"].asnumpy(), out)
        runs.append(out)
        again = ex.forward(is_train=True)[0].asnumpy()
        assert not np.array_equal(again, out)
    np.testing.assert_array_equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# mt.random: the reference's call (C.6), randint, get_state / set_state
# ---------------------------------------------------------------------------

CALLS = [
    ("defaults", {}, (1,), "float32"),
    ("shape", {"shape": (2,)}, (2,), "float32"),
    ("shape-2d", {"shape": (3, 2)}, (3, 2), "float32"),
    ("dtype", {"shape": (4,), "dtype": "float16"}, (4,), "float16"),
    ("ctx-none", {"shape": (2, 2), "ctx": None}, (2, 2), "float32"),
]


@pytest.mark.parametrize("fn", ["uniform", "normal"])
@pytest.mark.parametrize("what,kwargs,shape,dtype", CALLS,
                         ids=[c[0] for c in CALLS])
def test_random_call_forms_match_jax(fn, what, kwargs, shape, dtype):
    """``mt.random.uniform``/``normal`` take the JAX package's argument
    forms (ROADMAP C.6) and give its shapes and dtypes.  The port's
    default context is the card: without CUDA a call that names no CPU
    context raises ``MXNetError``, and with ``mt.cpu()`` as the current
    context the same call runs."""
    j = getattr(mx.random, fn)(**kwargs)
    assert j.shape == shape and str(j.dtype) == dtype
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            getattr(mt.random, fn)(**kwargs)
    with mt.cpu():
        t = getattr(mt.random, fn)(**kwargs)
    assert t.shape == shape and str(t.dtype) == dtype
    assert t.context == mt.cpu()
    t = getattr(mt.random, fn)(**dict(kwargs, ctx=mt.cpu()))
    assert t.shape == shape and t.context == mt.cpu()


@pytest.mark.parametrize("fn", ["uniform", "normal"])
def test_random_out_writes_in_place_on_outs_context(fn):
    """``out=`` receives the draws in place, on ``out``'s context; the
    positional form (low, high, shape, ctx) the initializers use still
    works."""
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        out = pkg.nd.zeros((3, 5), ctx)
        got = getattr(pkg.random, fn)(2.0, 0.5, shape=(3, 5), out=out)
        assert got is out and out.shape == (3, 5)
        assert float(np.abs(out.asnumpy()).sum()) > 0
    mt.random.seed(9)
    a = mt.random.uniform(-1.0, 1.0, (5, 3), mt.cpu()).asnumpy()
    assert a.shape == (5, 3) and a.min() >= -1.0 and a.max() < 1.0
    mt.random.seed(9)
    b = mt.nd.uniform(low=-1.0, high=1.0, shape=(5, 3), ctx=mt.cpu())
    np.testing.assert_array_equal(b.asnumpy(), a)


def test_random_uniform_and_normal_statistics():
    mt.random.seed(0)
    u = mt.random.uniform(2.0, 4.0, shape=(N,), ctx=mt.cpu()).asnumpy()
    n = mt.random.normal(1.0, 3.0, shape=(N,), ctx=mt.cpu()).asnumpy()
    _check_moments(u, "_sample_uniform", {"low": 2.0, "high": 4.0})
    _check_moments(n, "_sample_normal", {"loc": 1.0, "scale": 3.0})


def test_randint_matches_the_jax_call_and_range():
    j = mx.random.randint(3, 9, shape=(1000,))
    mt.random.seed(1)
    t = mt.random.randint(3, 9, shape=(1000,), ctx=mt.cpu())
    for arr in (j, t):
        a = arr.asnumpy()
        assert a.shape == (1000,) and str(arr.dtype) == "int32"
        assert a.min() >= 3 and a.max() <= 8
        assert set(np.unique(a)) == set(range(3, 9))
    mt.random.seed(1)
    again = mt.random.randint(3, 9, shape=(1000,), ctx=mt.cpu())
    np.testing.assert_array_equal(again.asnumpy(), t.asnumpy())
    out = mt.nd.zeros((4,), mt.cpu(), dtype="int32")
    assert mt.random.randint(0, 2, shape=(4,), out=out) is out
    assert mt.random.randint(0, 5, ctx=mt.cpu(), dtype="float32").dtype == \
        np.float32
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            mt.random.randint(0, 5)


def test_get_state_set_state_replays_the_bits():
    """A snapshot, more draws, then ``set_state``: the same bits again on
    that device, through ``random`` and through a graph's sampler; the
    snapshot is plain host data (numpy), as the JAX package's is."""
    mt.random.seed(21)
    mt.random.uniform(shape=(7,), ctx=mt.cpu())
    state = mt.random.get_state()
    assert state["seed"] == 21 and all(
        isinstance(v, np.ndarray) for v in state["generators"].values())
    first = [mt.random.normal(shape=(5,), ctx=mt.cpu()).asnumpy(),
             mt.random.randint(0, 100, shape=(5,), ctx=mt.cpu()).asnumpy(),
             mt.nd._sample_gamma(alpha=2.0, shape=(5,),
                                 ctx=mt.cpu()).asnumpy()]
    mt.random.set_state(state)
    assert mt.random.current_seed() == 21
    second = [mt.random.normal(shape=(5,), ctx=mt.cpu()).asnumpy(),
              mt.random.randint(0, 100, shape=(5,), ctx=mt.cpu()).asnumpy(),
              mt.nd._sample_gamma(alpha=2.0, shape=(5,),
                                  ctx=mt.cpu()).asnumpy()]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    js = mx.random.get_state()
    assert set(js) == {"seed", "key"}


def test_random_all_names_the_reference_functions():
    for name in ("seed", "uniform", "normal", "randint", "get_state",
                 "set_state"):
        assert name in mt.random.__all__ and name in mx.random.__all__
