"""The training API's update path against the JAX package, on the CPU, from
identical numpy inputs: the five update ops as registered ops (forward, aux
write-back, ``meta`` shape inference, symbol JSON), every optimizer through
``Module`` (the fused step and the two-phase path) on a small MLP and a
small LM, the list update against its one-array case, optimizer states
carried across by ``convert``, and SGLD's noise.

Tolerances: the update ops 1e-6 relative (one formula, rounded alike but
for the order of one sum); three Module steps 1e-5 of the largest
parameter in float32 (the list update's fused ops round once where the
JAX package rounds twice).  SGLD draws its noise from a torch generator,
the JAX package from threefry keys, so its deterministic part is held to
the JAX package's, and its noise by the mean and variance of 2^20 draws
(within 6 standard errors) and by same-seed replay.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.mlp import get_mlp as jax_mlp
from mxnet_tpu.models.transformer import get_transformer_lm as jax_lm
from mxnet_tpu_torch.models.mlp import get_mlp as port_mlp
from mxnet_tpu_torch.models.transformer import get_transformer_lm as port_lm
from mxnet_tpu_torch.ops import OpContext, get_op

STEPS = 3
TOL = 1e-5
# every optimizer of the JAX package, in its registry order, with clip,
# wd and rescale exercised across them; adam at epsilon 1e-4: at 1e-8 its
# first steps are ±lr for any gradient, so roundoff in the LM's key-bias
# gradient (0 in exact arithmetic) would become a step of either sign
OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
    "sgd-plain": ("sgd", {"learning_rate": 0.05, "clip_gradient": 0.05}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9,
                          "wd": 1e-3, "lamda": 0.5}),
    "dcasgd-plain": ("dcasgd", {"learning_rate": 0.05, "lamda": 0.5}),
    "nag": ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
    "ccsgd": ("ccsgd", {"learning_rate": 0.05, "momentum": 0.9}),
    "adam": ("adam", {"learning_rate": 1e-3, "epsilon": 1e-4, "wd": 1e-3,
                      "clip_gradient": 0.5}),
    "adagrad": ("adagrad", {"learning_rate": 0.05, "wd": 1e-3}),
    "rmsprop": ("rmsprop", {"learning_rate": 1e-3, "wd": 1e-3,
                            "clip_weights": 0.5}),
    "rmsprop-centered": ("rmsprop", {"learning_rate": 1e-3,
                                     "centered": True, "clip_gradient": 1.0}),
    "adadelta": ("adadelta", {"wd": 1e-3}),
    "test": ("test", {"rescale_grad": 0.01}),
}
DETERMINISTIC = [k for k in OPTIMIZERS]  # SGLD is held apart below

MLP_SHAPE = (8, 10)
LM = dict(vocab_size=32, num_layers=1, num_heads=2, hidden=32, seq_len=16)
LM_SHAPE = (2, LM["seq_len"])


def _nets(which):
    if which == "mlp":
        with mx.NameManager():
            jn = jax_mlp(num_classes=4, hidden=(16, 8))
        with mt.NameManager():
            tn = port_mlp(num_classes=4, hidden=(16, 8))
        return jn, tn, MLP_SHAPE, (MLP_SHAPE[0],)
    with mx.NameManager():
        jn = jax_lm(**LM)
    with mt.NameManager():
        tn = port_lm(**LM)
    return jn, tn, LM_SHAPE, LM_SHAPE


def _setup(which):
    """Both nets, numpy parameters (N(0, 0.3) matrices for the MLP, N(0,
    0.05) for the LM, unit gains, zero biases), one batch."""
    jn, tn, dshape, lshape = _nets(which)
    arg_shapes, _, _ = jn.infer_shape(data=dshape, softmax_label=lshape)
    rng = np.random.RandomState(0)
    std = 0.3 if which == "mlp" else 0.05
    params = {}
    for name, shape in zip(jn.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = rng.randn(*shape).astype(np.float32) * 0.1
        else:
            params[name] = rng.randn(*shape).astype(np.float32) * std
    if which == "mlp":
        X = rng.randn(*dshape).astype(np.float32)
        Y = rng.randint(0, 4, lshape).astype(np.float32)
    else:
        X = rng.randint(0, LM["vocab_size"], dshape).astype(np.float32)
        Y = (X + 1) % LM["vocab_size"]
    return jn, tn, dshape, lshape, params, X, Y


def _module(pkg, net, dshape, lshape, params, opt):
    name, kwargs = OPTIMIZERS[opt] if isinstance(opt, str) else opt
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", dshape)],
             label_shapes=[("softmax_label", lshape)])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in params.items()}, aux_params={})
    mod.init_optimizer(optimizer=name, optimizer_params=dict(kwargs))
    return mod


def _loss(mod, Y):
    p = mod.get_outputs()[0].asnumpy().astype(np.float64)
    p = p.reshape(-1, p.shape[-1])
    return float(-np.log(p[np.arange(p.shape[0]),
                           Y.reshape(-1).astype(int)]).mean())


def _run(pkg, mod, X, Y, path):
    batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                             [pkg.nd.array(Y, pkg.cpu())])
    losses = []
    for _ in range(STEPS):
        if path == "fused":
            mod.forward_backward(batch)
        else:
            mod.forward(batch, is_train=True)
            mod.backward()
        mod.update()
        losses.append(_loss(mod, Y))
    args, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in args.items()}


_CACHE = {}


def _results(which, opt):
    """(JAX losses, JAX params, {path: (port losses, port params)}, init)
    of STEPS steps, computed once per (model, optimizer)."""
    key = (which, opt)
    if key not in _CACHE:
        jn, tn, dshape, lshape, params, X, Y = _setup(which)
        ref = _run(mx, _module(mx, jn, dshape, lshape, params, opt), X, Y,
                   "fused")
        port = {}
        for path in ("fused", "two-phase"):
            mod = _module(mt, tn, dshape, lshape, params, opt)
            assert mod._fused_ok
            port[path] = _run(mt, mod, X, Y, path)
        _CACHE[key] = (ref, port, params)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# the registered update ops
# ---------------------------------------------------------------------------

_UPDATE_OPS = {
    "sgd_update": (0, {"lr": 0.1, "momentum": None}),
    "sgd_mom_update": (1, {"lr": 0.1, "momentum": 0.9}),
    "adam_update": (2, {"lr": 0.01, "beta1": 0.8, "epsilon": 1e-3}),
    "rmsprop_update": (1, {"lr": 0.01, "gamma1": 0.9, "clip_weights": 0.9}),
    "rmspropalex_update": (3, {"lr": 0.01, "gamma1": 0.9, "gamma2": 0.8,
                               "clip_weights": 0.9}),
}
_EXTRAS = {"plain": {}, "clip-wd": {"clip_gradient": 0.3, "wd": 0.05,
                                     "rescale_grad": 2.0}}


def _op_inputs(n_states, seed=6):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 5).astype(np.float32)
    g = rng.randn(4, 5).astype(np.float32)
    # non-negative states; rmspropalex's n (the first) above its g squared
    states = [np.abs(rng.randn(4, 5)).astype(np.float32) * 0.1 + (i == 0)
              for i in range(n_states)]
    return w, g, states


@pytest.mark.parametrize("extra", sorted(_EXTRAS))
@pytest.mark.parametrize("name", sorted(_UPDATE_OPS))
def test_registered_update_op_matches_jax(name, extra):
    """``nd.<op>(weight, grad, *states, out=weight)`` from the registry in
    both packages: the weight written through ``out`` and every aux state
    written back, twice."""
    n_states, attrs = _UPDATE_OPS[name]
    attrs = {k: v for k, v in attrs.items() if v is not None}
    attrs.update(_EXTRAS[extra])
    assert name in mt.ops.registered_ops()
    w0, g, states0 = _op_inputs(n_states)
    results = []
    for pkg in (mx, mt):
        w = pkg.nd.array(w0, pkg.cpu())
        states = [pkg.nd.array(s, pkg.cpu()) for s in states0]
        for _ in range(2):
            getattr(pkg.nd, name)(w, pkg.nd.array(g, pkg.cpu()), *states,
                                  out=w, **attrs)
        results.append([w.asnumpy()] + [s.asnumpy() for s in states])
    for got, ref in zip(results[1], results[0]):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if n_states:
        assert not np.array_equal(results[1][1], states0[0])


@pytest.mark.parametrize("name", sorted(_UPDATE_OPS))
def test_registered_update_op_params_aux_json_and_meta(name):
    """The op's inputs, aux names and ``Param`` defaults are the JAX
    op's; it runs on ``meta`` tensors; ``sym.<op>`` writes the JAX
    package's JSON byte for byte."""
    n_states, attrs = _UPDATE_OPS[name]
    attrs = {k: v for k, v in attrs.items() if v is not None}
    top, jop = get_op(name), mx.ops.registry.get_op(name)
    assert top.input_names({}) == jop.input_names({})
    assert top.aux_names({}) == jop.aux_names({})
    assert sorted(top.params) == sorted(jop.params)
    assert {k: p.default for k, p in top.params.items()} == \
        {k: p.default for k, p in jop.params.items()}
    meta = torch.empty(4, 5, device="meta")
    outs, aux = top.apply(OpContext(device=torch.device("meta")),
                          top.parse_attrs(attrs), [meta, meta],
                          tuple(meta for _ in range(n_states)))
    assert [tuple(o.shape) for o in outs + aux] == [(4, 5)] * (1 + n_states)
    assert all(o.is_meta for o in outs + aux)
    jsons = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            ins = [pkg.sym.Variable(n) for n in ("weight", "grad")]
            net = getattr(pkg.sym, name)(*ins, name="upd", **attrs)
        jsons.append(net.tojson())
        assert net.list_auxiliary_states() == \
            ["upd_" + a for a in jop.aux_names({})]
    assert jsons[0] == jsons[1]


# ---------------------------------------------------------------------------
# every optimizer through Module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["fused", "two-phase"])
@pytest.mark.parametrize("which", ["mlp", "lm"])
@pytest.mark.parametrize("opt", DETERMINISTIC)
def test_module_optimizer_matches_jax(opt, which, path):
    """STEPS steps through ``Module`` from one numpy init and batch: the
    port's fused step or its two-phase path (forward, backward, the
    updater's list update) against the JAX package's fused step."""
    (ref_losses, ref_params), port, params = _results(which, opt)
    losses, got = port[path]
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= TOL * abs(b), (losses, ref_losses)
    scale = max(np.abs(v).max() for v in ref_params.values())
    moved = max(np.abs(ref_params[k] - params[k]).max() for k in params)
    assert moved > 1e-3 * scale
    for k in ref_params:
        err = np.abs(got[k] - ref_params[k]).max() / scale
        assert err <= TOL, (k, err)


@pytest.mark.parametrize("opt", DETERMINISTIC)
def test_fused_step_and_two_phase_path_are_bit_equal(opt):
    """Both paths run the same list update on the same groups in the same
    order: their parameters are the same bits."""
    for which in ("mlp", "lm"):
        _, port, _ = _results(which, opt)
        fused, two = port["fused"][1], port["two-phase"][1]
        for k in fused:
            np.testing.assert_array_equal(fused[k], two[k])


def _arrays(seed, n=5):
    """A list of weights (odd sizes, one of them a bias), gradients and
    indices with names, as an optimizer sees them."""
    rng = np.random.RandomState(seed)
    shapes = [(7, 3), (5,), (2, 3, 4), (1,), (33,)]
    names = ["a_weight", "a_bias", "b_weight", "c_gamma", "c_beta"]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes[:n]]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes[:n]]
    return names[:n], ws, gs


@pytest.mark.parametrize("opt", DETERMINISTIC + ["sgld"])
def test_list_update_equals_its_one_array_case_bitwise(opt):
    """``update_tensors_list`` over five arrays (with the no-wd default of
    biases and an lr_mult) against ``update_tensors`` array by array, 3
    times: the same bits (SGLD from one seed)."""
    name, kwargs = OPTIMIZERS.get(opt, ("sgld", {"learning_rate": 0.01,
                                                 "wd": 1e-2}))
    names, ws, gs = _arrays(1)
    runs = []
    for listed in (True, False):
        mt.random.seed(3)
        o = mt.optimizer.create(name, param_idx2name=dict(enumerate(names)),
                                **kwargs)
        o.set_lr_mult({"b_weight": 0.5})
        weights = [mt.nd.array(w, mt.cpu()) for w in ws]
        states = [o.create_state(i, w) for i, w in enumerate(weights)]
        for t in range(1, 4):
            grads = [torch.from_numpy(g * t) for g in gs]
            tens = [o_._data for o_ in weights]
            st = [mt.optimizer._tensors(s) for s in states]
            if listed:
                o.update_tensors_list(list(range(len(ws))), tens, grads, st,
                                      [t] * len(ws))
            else:
                for i in range(len(ws)):
                    o.update_tensors(i, tens[i], grads[i], st[i], t)
        runs.append([w.asnumpy() for w in weights])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][0], ws[0])


@pytest.mark.parametrize("opt", DETERMINISTIC)
def test_two_phase_update_leaves_the_gradients_unchanged(opt):
    """The gradients the two-phase path exposes (``grad_arrays``) are read,
    never written, by the updater's list update."""
    jn, tn, dshape, lshape, params, X, Y = _setup("mlp")
    mod = _module(mt, tn, dshape, lshape, params, opt)
    batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                            [mt.nd.array(Y, mt.cpu())])
    mod.forward(batch, is_train=True)
    mod.backward()
    before = [g.asnumpy() for g in mod._exec_group.grad_arrays]
    mod.update()
    for g, b in zip(mod._exec_group.grad_arrays, before):
        np.testing.assert_array_equal(g.asnumpy(), b)


@pytest.mark.parametrize("opt", [k for k in DETERMINISTIC
                                 if not k.startswith("sgd-plain")])
def test_jax_updater_states_carry_across_by_convert(opt):
    """Two steps in the JAX package; its parameters and its updater's
    states (every layout: one array, tuples, DCASGD's (None, previous
    weight)), as numpy through ``convert``, continue in the port; the third
    step agrees with the JAX package's own."""
    jn, tn, dshape, lshape, params, X, Y = _setup("mlp")
    jmod = _module(mx, jn, dshape, lshape, params, opt)
    batch = mx.io.DataBatch([mx.nd.array(X)], [mx.nd.array(Y)])
    for _ in range(2):
        jmod.forward_backward(batch)
        jmod.update()
    jargs, _ = jmod.get_params()

    def host(st):
        if st is None:
            return None
        if isinstance(st, tuple):
            return tuple(host(s) for s in st)
        return st.asnumpy()

    states = {i: host(st) for i, st in jmod._updater.states.items()}
    if opt == "dcasgd-plain":
        assert all(s[0] is None for s in states.values())
    tmod = _module(mt, tn, dshape, lshape, mt.convert.params_from_numpy(
        {k: v.asnumpy() for k, v in jargs.items()}, mt.cpu()), opt)
    tmod._updater.states = mt.convert.optimizer_states_from_numpy(
        states, mt.cpu())
    tmod._optimizer.begin_num_update = jmod._optimizer.num_update
    jmod.forward_backward(batch)
    jmod.update()
    ref = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tmod.forward_backward(mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                                          [mt.nd.array(Y, mt.cpu())]))
    tmod.update()
    got = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    scale = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= TOL * scale, k


def test_test_optimizer_eager_update_keeps_the_count():
    """Test's eager update does not advance the update count (the JAX
    package's does not either); its state is the new weight."""
    for pkg in (mx, mt):
        o = pkg.optimizer.create("test", rescale_grad=0.5)
        u = pkg.optimizer.get_updater(o)
        w = pkg.nd.array(np.ones(3, np.float32), pkg.cpu())
        u(0, pkg.nd.array(np.full(3, 2.0, np.float32), pkg.cpu()), w)
        assert o.num_update == 0 and not o._index_update_count
        np.testing.assert_array_equal(w.asnumpy(), np.full(3, 2.0))
        np.testing.assert_array_equal(u.states[0].asnumpy(), w.asnumpy())


def test_updater_update_list_falls_back_to_update():
    """An optimizer with only an eager ``update`` (a user's) is called once
    per index by ``Updater.update_list`` and never fused."""
    calls = []

    class Mine(mt.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            calls.append(index)
            weight[:] = weight.asnumpy() - grad.asnumpy()

    assert not Mine.has_tensor_update()
    u = mt.optimizer.get_updater(Mine())
    ws = [mt.nd.array(np.ones(2, np.float32), mt.cpu()) for _ in range(2)]
    gs = [mt.nd.array(np.ones(2, np.float32), mt.cpu()) for _ in range(2)]
    u.update_list([0, 1], gs, ws)
    assert calls == [0, 1]
    assert all(not w.asnumpy().any() for w in ws)


# ---------------------------------------------------------------------------
# SGLD
# ---------------------------------------------------------------------------


def test_sgld_deterministic_part_matches_jax(monkeypatch):
    """SGLD with its noise subtracted (the port's drawn again from the
    generator's state before the update) against the JAX package's with a
    zero noise: weight - lr / 2 · (g + wd · weight)."""
    import jax

    names, ws, gs = _arrays(2)
    kwargs = dict(learning_rate=0.01, wd=1e-2, rescale_grad=0.5,
                  param_idx2name=dict(enumerate(names)))
    jo = mx.optimizer.create("sgld", **kwargs)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jax.numpy.zeros(
                            shape, dtype))
    jw = [mx.nd.array(w) for w in ws]
    for i, (w, g) in enumerate(zip(jw, gs)):
        jo.update(i, w, mx.nd.array(g), None)
    o = mt.optimizer.create("sgld", **kwargs)
    tw = [mt.nd.array(w, mt.cpu()) for w in ws]
    gen = mt.random.optimizer_generator(torch.device("cpu"))
    state = gen.get_state()
    o.update_list(list(range(len(ws))), tw,
                  [mt.nd.array(g, mt.cpu()) for g in gs], [None] * len(ws))
    gen.set_state(state)
    for i, w in enumerate(tw):
        noise = torch.empty(ws[i].shape).normal_(
            0.0, np.sqrt(o._get_lr(i)), generator=gen)
        got = (w._data.double() - noise.double()).numpy()
        np.testing.assert_allclose(got, jw[i].asnumpy(), rtol=0, atol=1e-6)


def test_sgld_noise_moments_replay_and_generator():
    """2^20 draws of SGLD's noise (lr 0.04: N(0, 0.2)) have its mean and
    variance within 6 standard errors; one seed replays the same bits; the
    draws come from the optimizer's stream, which leaves the generator the
    ops draw from (and the fused step replays dropout from) untouched."""
    n, lr = 1 << 20, 0.04
    results = []
    for _ in range(2):
        mt.random.seed(11)
        ops_gen = mt.random.generator(torch.device("cpu"))
        before = ops_gen.get_state().clone()
        o = mt.optimizer.create("sgld", learning_rate=lr)
        w = torch.zeros(n)
        o.update_tensors(0, w, torch.zeros(n), None, 1)
        assert torch.equal(ops_gen.get_state(), before)
        results.append(w)
    assert torch.equal(results[0], results[1])
    x = results[0].double()
    var = lr
    assert abs(x.mean().item()) <= 6 * np.sqrt(var / n)
    # the variance of a sample variance of normals is 2 sigma^4 / n
    assert abs(x.var().item() - var) <= 6 * np.sqrt(2 * var ** 2 / n)
    mt.random.seed(12)
    o = mt.optimizer.create("sgld", learning_rate=lr)
    w = torch.zeros(n)
    o.update_tensors(0, w, torch.zeros(n), None, 1)
    assert not torch.equal(w, results[0])


def test_sgld_module_paths_replay_from_one_seed():
    """SGLD through ``Module``: from one seed the fused step and the
    two-phase path draw the same noise and give the same bits."""
    jn, tn, dshape, lshape, params, X, Y = _setup("mlp")
    sgld = ("sgld", {"learning_rate": 0.01, "wd": 1e-3})
    runs = []
    for path in ("fused", "two-phase"):
        mt.random.seed(5)
        runs.append(_run(mt, _module(mt, tn, dshape, lshape, params, sgld),
                         X, Y, path)[1])
    moved = max(np.abs(runs[0][k] - params[k]).max() for k in params)
    assert moved > 1e-3
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
