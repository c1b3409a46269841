"""The training slice against the JAX package, on the CPU, from identical
numpy inputs: the SoftmaxOutput loss gradient, the fused optimizer update
ops, executor gradients (grad_req write and add), 3-step Module training of
a 2-layer LM with SGD and adam in float32 and bf16, optimizer states
carried across by ``convert``, NDArrayIter, Perplexity, Xavier, and
checkpoints crossing packages byte for byte.

Tolerances: float32 1e-4 relative — the same arithmetic, summed in another
order; bf16 2e-2 — the packages round to bf16 at different places.  A
Module comparison measures each parameter's error against the largest
parameter magnitude of the model (a bias starting at zero has no scale of
its own).  In bf16 that limit is wider than three small steps, so the
update itself is held separately: against the JAX optimizer applied to
the port's own float32 gradients (1e-4 of the largest change), and the
whole change of the parameters against the JAX package's within
``BF16_CHANGE_LIMIT`` of its norm (a lost or mis-scaled update moves it to
1).  The two packages' bf16 gradients differ by up to 8% because XLA keeps
intermediates of fused ops in float32 (``xla_allow_excess_precision``, on by
default), where the port rounds every op's output to bf16, as each op of
both packages does on its own (``test_bf16_ops_round_where_jax_ops_round``);
the change norms read 0.116 (sgd) and 0.100 (adam), and 0.024 and 0.045
with the flag off.  Adam runs with epsilon 1e-4: with the usual 1e-8 its first
steps are ±lr for any gradient, so roundoff in a gradient that is 0 in
exact arithmetic (the key bias: softmax ignores a per-row shift) would
become a full step of either sign in either package."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.transformer import get_transformer_lm as jax_lm
from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op
from mxnet_tpu_torch.models.transformer import get_transformer_lm as port_lm
from mxnet_tpu_torch.ops import OpContext, get_op

LM = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=64, seq_len=32)
BATCH = 2
SHAPE = (BATCH, LM["seq_len"])
TOL = {None: 1e-4, "bfloat16": 2e-2}
#: bf16 training: the port's parameter change against the JAX package's,
#: relative to its norm (read 0.116 with sgd and 0.100 with adam)
BF16_CHANGE_LIMIT = 0.15
OPTIMIZERS = {"adam": {"learning_rate": 1e-3, "epsilon": 1e-4},
              "sgd": {"learning_rate": 1e-3, "momentum": 0.9},
              "nag": {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-2},
              "dcasgd": {"learning_rate": 1e-3, "momentum": 0.9},
              "ccsgd": {"learning_rate": 1e-3, "momentum": 0.9},
              "adagrad": {"learning_rate": 1e-3, "wd": 1e-2},
              "rmsprop": {"learning_rate": 1e-3, "centered": True},
              "adadelta": {"wd": 1e-2},
              "test": {}}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _nets():
    with mx.NameManager():
        jn = jax_lm(**LM)
    with mt.NameManager():
        tn = port_lm(**LM)
    return jn, tn


@pytest.fixture(scope="module")
def lm_setup():
    """The LM in both packages, numpy weights (N(0, 0.3) matrices, unit
    gains, zero shifts and biases) and one next-token batch."""
    jn, tn = _nets()
    shapes = {"data": SHAPE, "softmax_label": SHAPE}
    arg_shapes, _, _ = jn.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    params = {}
    for name, shape in zip(jn.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = rng.randn(*shape).astype(np.float32) * 0.3
    X = rng.randint(0, LM["vocab_size"], SHAPE).astype(np.float32)
    Y = (X + 1) % LM["vocab_size"]
    return jn, tn, params, X, Y


def _loss(mod, Y):
    p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float32)
    return float(-np.log(p[np.arange(p.shape[0]),
                           Y.reshape(-1).astype(int)]).mean())


def _module(pkg, net, ctx, params, optimizer, compute_dtype=None):
    mod = pkg.mod.Module(net, context=ctx, compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", SHAPE)])
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=OPTIMIZERS[optimizer])
    return mod


def _train(pkg, mod, X, Y, steps):
    ctx = pkg.cpu()
    batch = pkg.io.DataBatch([pkg.nd.array(X, ctx)], [pkg.nd.array(Y, ctx)])
    losses = []
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
        losses.append(_loss(mod, Y))
    args, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in args.items()}


def _assert_close(losses, params, ref_losses, ref_params, tol):
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) / abs(b) <= tol, (losses, ref_losses)
    scale = max(np.abs(v).max() for v in ref_params.values())
    assert sorted(params) == sorted(ref_params)
    for k in ref_params:
        err = np.abs(params[k] - ref_params[k]).max() / scale
        assert err <= tol, (k, err)


# ---------------------------------------------------------------------------
# (f) Module training, (h) checkpoints, optimizer states through convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_module_training_matches_jax(lm_setup, tmp_path, optimizer,
                                     compute_dtype):
    """3 steps of the 2-layer LM from one numpy ``.params`` file in both
    packages, through bind / init_params / init_optimizer /
    forward_backward / update (the fused step in both)."""
    jn, tn, params, X, Y = lm_setup
    fname = str(tmp_path / "init.params")
    mx.nd.save(fname, {k: mx.nd.array(v, mx.cpu()) for k, v in
                       params.items()})
    jmod = _module(mx, jn, mx.cpu(), mx.nd.load(fname), optimizer,
                   compute_dtype)
    tmod = _module(mt, tn, mt.cpu(), mt.nd.load(fname), optimizer,
                   compute_dtype)
    assert tmod._fused_ok
    ref_losses, ref_params = _train(mx, jmod, X, Y, 3)
    losses, got = _train(mt, tmod, X, Y, 3)
    assert losses[-1] < losses[0]
    moved = max(np.abs(got[k] - params[k]).max() for k in params)
    assert moved > 1e-3
    _assert_close(losses, got, ref_losses, ref_params, TOL[compute_dtype])
    change = {k: got[k] - params[k] for k in params}
    ref_change = {k: ref_params[k] - params[k] for k in params}
    limit = BF16_CHANGE_LIMIT if compute_dtype else TOL[None]
    assert _rel_norm(change, ref_change) <= limit


def _rel_norm(got, ref):
    """||got - ref|| / ||ref|| over every array of two dicts."""
    num = sum(float(((got[k].astype(np.float64) - ref[k]) ** 2).sum())
              for k in ref)
    den = sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "nag", "dcasgd",
                                       "ccsgd", "adagrad", "rmsprop",
                                       "adadelta", "test"])
def test_module_bf16_update_writes_float32_masters(lm_setup, optimizer):
    """With bf16 compute the update lands on the float32 parameters: two
    steps through forward / backward / update give, from the port's own
    float32 gradients, what the JAX package's optimizer gives from them;
    the fused step (forward_backward / update) gives the same parameters."""
    jn, tn, params, X, Y = lm_setup
    batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                            [mt.nd.array(Y, mt.cpu())])
    init = {k: mt.nd.array(v, mt.cpu()) for k, v in params.items()}
    mod = _module(mt, tn, mt.cpu(), init, optimizer, "bfloat16")
    fused = _module(mt, tn, mt.cpu(), init, optimizer, "bfloat16")
    names = mod._exec_group.param_names
    jopt = mx.optimizer.create(optimizer, sym=jn,
                               param_idx2name=dict(enumerate(names)),
                               rescale_grad=1.0 / BATCH,
                               **OPTIMIZERS[optimizer])
    jupdater = mx.optimizer.get_updater(jopt)
    ref = {k: mx.nd.array(v, mx.cpu()) for k, v in params.items()}
    ex = mod._exec_group.execs[0]
    for _ in range(2):
        mod.forward(batch, is_train=True)
        mod.backward()
        for i, name in enumerate(names):
            jupdater(i, mx.nd.array(ex.grad_dict[name].asnumpy()), ref[name])
        mod.update()
        fused.forward_backward(batch)
        fused.update()
    got, _ = mod.get_params()
    got = {k: v.asnumpy() for k, v in got.items()}
    assert all(v.dtype == np.float32 for v in got.values())
    change = {k: got[k] - params[k] for k in params}
    ref_change = {k: ref[k].asnumpy() - params[k] for k in params}
    scale = max(np.abs(v).max() for v in ref_change.values())
    assert scale > 1e-3
    for k in params:
        assert np.abs(change[k] - ref_change[k]).max() <= 1e-4 * scale, k
    fargs, _ = fused.get_params()
    for k, v in fargs.items():
        np.testing.assert_array_equal(v.asnumpy(), got[k])


def test_module_eager_update_matches_fused(lm_setup):
    """``forward(is_train=True)`` + ``backward`` write ``grad_dict``, and
    ``update`` then runs the per-parameter updater loop over it; that gives
    what the fused step (``forward_backward`` + ``update``) gives."""
    _, tn, params, X, Y = lm_setup
    runs = []
    for fused in (True, False):
        mod = _module(mt, tn, mt.cpu(), {k: mt.nd.array(v, mt.cpu())
                                         for k, v in params.items()}, "adam")
        assert mod._fused_ok
        batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                                [mt.nd.array(Y, mt.cpu())])
        losses = []
        for _ in range(2):
            if fused:
                mod.forward_backward(batch)
            else:
                mod.forward(batch, is_train=True)
                mod.backward()
                assert mod._fused_pending is None
            mod.update()
            losses.append(_loss(mod, Y))
        args, _ = mod.get_params()
        runs.append((losses, {k: v.asnumpy() for k, v in args.items()}))
    _assert_close(*runs[1], *runs[0], 1e-6)


def test_adam_states_carry_across_packages(lm_setup):
    """Two adam steps in the JAX package; its parameters and adam
    mean/var, converted by ``convert``, continue in the port; the third
    step agrees with the JAX package's own third step."""
    jn, tn, params, X, Y = lm_setup
    jmod = _module(mx, jn, mx.cpu(), {k: mx.nd.array(v, mx.cpu())
                                      for k, v in params.items()}, "adam")
    _train(mx, jmod, X, Y, 2)
    jargs, _ = jmod.get_params()
    states = {i: tuple(s.asnumpy() for s in st)
              for i, st in jmod._updater.states.items()}
    tmod = _module(mt, tn, mt.cpu(), mt.convert.params_from_numpy(
        {k: v.asnumpy() for k, v in jargs.items()}, mt.cpu()), "adam")
    tmod._updater.states = mt.convert.optimizer_states_from_numpy(
        states, mt.cpu())
    tmod._optimizer.begin_num_update = jmod._optimizer.num_update
    ref = _train(mx, jmod, X, Y, 1)
    got = _train(mt, tmod, X, Y, 1)
    _assert_close(*got, *ref, TOL[None])


def test_checkpoint_crosses_packages_byte_identical(lm_setup, tmp_path):
    """A checkpoint written by one package's ``Module.save_checkpoint``
    loads in the other's ``Module.load``, and saving it again reproduces
    its ``.params`` bytes — both ways."""
    jn, tn, params, X, Y = lm_setup
    jmod = _module(mx, jn, mx.cpu(), {k: mx.nd.array(v, mx.cpu())
                                      for k, v in params.items()}, "sgd")
    _train(mx, jmod, X, Y, 1)
    jprefix, tprefix = str(tmp_path / "jax"), str(tmp_path / "port")
    jmod.save_checkpoint(jprefix, 1)
    tmod = mt.mod.Module.load(jprefix, 1, context=mt.cpu())
    tmod.bind(data_shapes=[("data", SHAPE)],
              label_shapes=[("softmax_label", SHAPE)])
    tmod.save_checkpoint(tprefix, 1)
    raw = open(jprefix + "-0001.params", "rb").read()
    assert open(tprefix + "-0001.params", "rb").read() == raw
    assert mt.sym.load(jprefix + "-symbol.json").tojson() == \
        open(tprefix + "-symbol.json").read()

    tmod.init_optimizer(optimizer="sgd", optimizer_params=OPTIMIZERS["sgd"])
    _train(mt, tmod, X, Y, 1)
    tmod.save_checkpoint(tprefix, 2)
    jmod2 = mx.mod.Module.load(tprefix, 2, context=mx.cpu())
    jmod2.bind(data_shapes=[("data", SHAPE)],
               label_shapes=[("softmax_label", SHAPE)])
    jmod2.save_checkpoint(jprefix, 2)
    assert open(jprefix + "-0002.params", "rb").read() == \
        open(tprefix + "-0002.params", "rb").read()


# ---------------------------------------------------------------------------
# (e) executor gradients
# ---------------------------------------------------------------------------


def _mlp(pkg):
    with pkg.NameManager():
        data = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = pkg.sym.gelu(h, name="act")
        h = pkg.sym.LayerNorm(h, name="ln")
        h = pkg.sym.FullyConnected(h, num_hidden=5, name="fc2")
        return pkg.sym.SoftmaxOutput(h, name="softmax")


def _executor_case(which, lm_setup):
    if which == "mlp":
        rng = np.random.RandomState(3)
        js, ts = _mlp(mx), _mlp(mt)
        shapes = {"data": (6, 7), "softmax_label": (6,)}
        arg_shapes, _, _ = js.infer_shape(**shapes)
        args = {n: rng.randn(*s).astype(np.float32) for n, s in
                zip(js.list_arguments(), arg_shapes)}
        args["softmax_label"] = rng.randint(0, 5, (6,)).astype(np.float32)
        return js, ts, args
    jn, tn, params, X, Y = lm_setup
    return jn, tn, dict(params, data=X, softmax_label=Y)


@pytest.mark.parametrize("which", ["mlp", "lm"])
@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_gradients_match_jax(lm_setup, which, grad_req):
    """``Executor.forward_backward`` gradients (and outputs) of both
    packages; with ``add`` the gradients of two calls accumulate onto the
    bound arrays' initial values."""
    js, ts, args = _executor_case(which, lm_setup)
    rng = np.random.RandomState(4)
    names = [n for n in js.list_arguments() if n not in ("data",
                                                          "softmax_label")]
    init = {n: rng.randn(*args[n].shape).astype(np.float32) for n in names}
    reqs = {n: grad_req for n in names}
    results = []
    for pkg, sym in ((mx, js), (mt, ts)):
        ex = sym.bind(pkg.cpu(), {k: pkg.nd.array(v, pkg.cpu())
                                  for k, v in args.items()},
                      args_grad={n: pkg.nd.array(init[n], pkg.cpu())
                                 for n in names},
                      grad_req=reqs)
        for _ in range(2 if grad_req == "add" else 1):
            out = ex.forward_backward()[0].asnumpy()
        results.append((out, {n: ex.grad_dict[n].asnumpy() for n in names}))
    (jout, jgrads), (tout, tgrads) = results
    assert _rel(tout, jout) <= 1e-4
    for n in names:
        assert _rel(tgrads[n], jgrads[n]) <= 1e-4, n


def test_executor_grad_req_forms_and_backward(lm_setup):
    """grad_req as a list; inputs an op declares non-differentiable
    (SoftmaxOutput's label, Embedding's ids) get none; ``backward`` after
    ``forward(is_train=True)`` gives forward_backward's gradients, whatever
    head gradient a loss op is handed."""
    js, ts, args = _executor_case("mlp", lm_setup)
    names = ts.list_arguments()
    ex = ts.bind(mt.cpu(), {k: mt.nd.array(v, mt.cpu())
                            for k, v in args.items()},
                 grad_req=["write"] * len(names))
    ex.forward(is_train=True)
    ex.backward(out_grads=mt.nd.array(np.full((6, 5), 7.0, np.float32),
                                      mt.cpu()))
    assert "softmax_label" not in ex.grad_dict
    g1 = {k: v.asnumpy() for k, v in ex.grad_dict.items()}
    ex.forward_backward()
    for k, v in ex.grad_dict.items():
        np.testing.assert_array_equal(v.asnumpy(), g1[k])
    assert ex.grad_arrays[names.index("fc1_weight")] is \
        ex.grad_dict["fc1_weight"]


# ---------------------------------------------------------------------------
# (c) the SoftmaxOutput loss gradient, (d) the update ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attrs", [
    {},
    {"normalization": "batch", "grad_scale": 2.0},
    {"normalization": "valid"},
    {"use_ignore": True, "ignore_label": 3},
    {"use_ignore": True, "ignore_label": 3, "normalization": "valid"},
    {"use_ignore": True, "ignore_label": 3, "normalization": "batch"},
    {"multi_output": True, "normalization": "valid"},
], ids=["null", "batch", "valid", "ignore", "ignore-valid", "ignore-batch",
        "multi-output"])
def test_softmax_output_gradient_matches_jax_vjp(attrs):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    if attrs.get("multi_output"):
        data = rng.randn(3, 6, 4).astype(np.float32)
        label = rng.randint(0, 6, (3, 4)).astype(np.float32)
    else:
        data = rng.randn(8, 6).astype(np.float32)
        label = rng.randint(0, 6, (8,)).astype(np.float32)
    ct = rng.randn(*data.shape).astype(np.float32)  # ignored by both
    jop = jget_op("SoftmaxOutput")
    jattrs = jop.parse_attrs(attrs)
    out_ref, vjp = jax.vjp(
        lambda d, l: jop.apply(JOpContext(), jattrs, [d, l])[0][0],
        jnp.asarray(data), jnp.asarray(label))
    gd_ref, gl_ref = vjp(jnp.asarray(ct))

    op = get_op("SoftmaxOutput")
    d = torch.from_numpy(data).requires_grad_(True)
    lab = torch.from_numpy(label).requires_grad_(True)
    (out,), _ = op.apply(OpContext(is_train=True), op.parse_attrs(attrs),
                         [d, lab])
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd_ref),
                               rtol=1e-5, atol=1e-6)
    assert not lab.grad.numpy().any() and not np.asarray(gl_ref).any()


_UPDATES = [
    ("sgd_update", 0, {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}),
    ("sgd_update", 0, {"lr": 0.1, "clip_gradient": 0.3}),
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam_update", 2, {"lr": 0.01, "beta1": 0.8, "wd": 0.01,
                        "clip_gradient": 0.5}),
    ("rmsprop_update", 1, {"lr": 0.01, "gamma1": 0.9,
                           "clip_weights": 0.95}),
    ("rmspropalex_update", 3, {"lr": 0.01, "gamma1": 0.9, "gamma2": 0.8,
                               "rescale_grad": 2.0}),
]


@pytest.mark.parametrize("name,n_states,attrs", _UPDATES,
                         ids=["sgd", "sgd-clip", "sgd_mom", "adam", "rmsprop",
                              "rmspropalex"])
def test_update_ops_match_jax(name, n_states, attrs):
    """Two applications of each update op in both packages, called as the
    optimizers call them: the weight written through ``out`` and every
    state updated in place."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(2)]
    # non-negative states; rmspropalex's n (the first) above its g squared
    states0 = [np.abs(rng.randn(4, 5)).astype(np.float32) * 0.1 + (i == 0)
               for i in range(n_states)]
    results = []
    for pkg in (mx, mt):
        w = pkg.nd.array(w0, pkg.cpu())
        states = [pkg.nd.array(s, pkg.cpu()) for s in states0]
        for g in grads:
            getattr(pkg.nd, name)(w, pkg.nd.array(g, pkg.cpu()), *states,
                                  out=w, **attrs)
        results.append([w.asnumpy()] + [s.asnumpy() for s in states])
    for got, ref in zip(*results[::-1]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (g) NDArrayIter, Perplexity, Xavier
# ---------------------------------------------------------------------------


def test_ndarray_iter_matches_jax():
    """Batches, padding of the last one, provide_data/label and the
    shuffle order (numpy's global state in both; an explicit RandomState
    in the port gives the same order)."""
    X = np.arange(70, dtype=np.float32).reshape(10, 7)
    Y = np.arange(10, dtype=np.float32)
    np.random.seed(3)
    jit = mx.io.NDArrayIter(X, Y, batch_size=4, shuffle=True)
    np.random.seed(3)
    tit = mt.io.NDArrayIter(X, Y, batch_size=4, shuffle=True)
    rit = mt.io.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                            rng=np.random.RandomState(3))
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _ in range(2):  # two epochs
        jb, tb, rb = list(jit), list(tit), list(rit)
        assert len(jb) == len(tb) == len(rb) == 3
        for a, b, c in zip(jb, tb, rb):
            assert a.pad == b.pad == c.pad
            for x, y, z in zip(a.data + a.label, b.data + b.label,
                               c.data + c.label):
                assert y.context == mt.cpu()
                np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
                np.testing.assert_array_equal(z.asnumpy(), x.asnumpy())
        for it in (jit, tit, rit):
            it.reset()


@pytest.mark.parametrize("ignore_label", [None, 2])
def test_perplexity_and_cross_entropy_match_jax(ignore_label):
    rng = np.random.RandomState(7)
    logits = rng.randn(12, 5)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    labels = rng.randint(0, 5, (12,)).astype(np.float32)
    for jm, tm in ((mx.metric.Perplexity(ignore_label),
                    mt.metric.Perplexity(ignore_label)),
                   (mx.metric.CrossEntropy(), mt.metric.CrossEntropy()),
                   (mx.metric.Accuracy(), mt.metric.Accuracy())):
        for _ in range(2):
            jm.update([mx.nd.array(labels)], [mx.nd.array(probs)])
            tm.update([mt.nd.array(labels, mt.cpu())],
                      [mt.nd.array(probs, mt.cpu())])
        (jname, jval), (tname, tval) = jm.get(), tm.get()
        assert jname == tname
        assert abs(tval - jval) <= 1e-5 * abs(jval), (tname, tval, jval)
    comp = mt.metric.create(["acc", "ce"])
    comp.update([mt.nd.array(labels, mt.cpu())],
                [mt.nd.array(probs, mt.cpu())])
    assert [n for n, _ in comp.get_name_value()] == ["accuracy",
                                                     "cross-entropy"]


@pytest.mark.parametrize("kwargs,shape", [
    ({"factor_type": "in", "magnitude": 2.34}, (256, 512)),
    ({}, (300, 200)),
    ({"rnd_type": "gaussian", "factor_type": "out"}, (128, 64, 3)),
])
def test_xavier_shape_and_scale_match_jax(kwargs, shape):
    """The two packages draw different numbers from one seed; their
    Xavier draws have the same shape, bound and spread."""
    jarr = mx.nd.zeros(shape, mx.cpu())
    tarr = mt.nd.zeros(shape, mt.cpu())
    mx.random.seed(0)
    mx.init.Xavier(**kwargs)("fc_weight", jarr)
    mt.random.seed(0)
    mt.init.Xavier(**kwargs)("fc_weight", tarr)
    j, t = jarr.asnumpy(), tarr.asnumpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    assert abs(t.std() / j.std() - 1) < 0.05
    assert abs(t.mean()) < 0.05 * t.std()
    if kwargs.get("rnd_type", "uniform") == "uniform":
        assert np.abs(t).max() <= np.abs(j).max() * 1.01
        assert np.abs(t).max() >= np.abs(j).max() * 0.99
    # name dispatch: biases zero, gammas one
    b = mt.nd.zeros((4,), mt.cpu())
    mt.init.Xavier()("fc_bias", b)
    g = mt.nd.zeros((4,), mt.cpu())
    mt.init.Xavier()("ln_gamma", g)
    assert not b.asnumpy().any() and (g.asnumpy() == 1).all()


def test_bf16_compute_rounds_token_ids_in_both_packages():
    """The defect ROADMAP.md §C records: with compute_dtype bfloat16 the
    executor casts every float32 argument not in cast_exclude, token ids
    included, so Embedding sees ids above 256 rounded to bf16 (257 -> 256,
    259 -> 260).  The port keeps the JAX package's answer."""
    ids = np.array([[257.0, 259.0, 300.0, 5.0]], np.float32)
    weight = np.arange(1000 * 4, dtype=np.float32).reshape(1000, 4) / 4000
    rows = []
    for pkg in (mx, mt):
        with pkg.NameManager():
            net = pkg.sym.Embedding(pkg.sym.Variable("data"), input_dim=1000,
                                    output_dim=4, name="emb")
        ex = pkg.executor.Executor(
            net, pkg.cpu(), {"data": pkg.nd.array(ids, pkg.cpu()),
                             "emb_weight": pkg.nd.array(weight, pkg.cpu())},
            grad_req="null", compute_dtype="bfloat16")
        rows.append(np.asarray(ex.forward()[0].asnumpy(), np.float32))
    expected = torch.from_numpy(weight[[256, 260, 300, 5]]).bfloat16().float()
    for r in rows:
        np.testing.assert_array_equal(r[0], expected.numpy())


def test_init_optimizer_takes_dist_async(lm_setup):
    """The update goes to the parameter server (an in-process one here,
    its updater on the CPU) through the async comm engine."""
    _, tn, params, _, _ = lm_setup
    mod = mt.mod.Module(tn, context=mt.cpu())
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", SHAPE)])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in params.items()}, aux_params={})
    with mt.cpu():
        mod.init_optimizer(kvstore="dist_async")
    try:
        assert mod._update_on_kvstore and mod._kvstore.type == "dist_async"
        assert isinstance(mod._kvstore.inner, mt.kvstore.DistAsyncKVStore)
    finally:
        mod._kvstore.close()


def test_mesh_binds_over_the_module_contexts(lm_setup):
    # a mesh, which raised before the GSPMD layer was ported, now binds:
    # resolved over the Module's own two contexts
    _, tn, _, _, _ = lm_setup
    meshed = mt.mod.Module(tn, context=[mt.cpu(0), mt.cpu(1)])
    meshed.bind(data_shapes=[("data", SHAPE)],
                label_shapes=[("softmax_label", SHAPE)], mesh="data=-1")
    assert meshed._exec_group._mesh.shape == {"data": 2}


def test_module_default_context_is_the_card(lm_setup):
    """Without CUDA a Module on the default context raises at bind;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default context works")
    _, tn, _, _, _ = lm_setup
    mod = mt.mod.Module(tn)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mod.bind(data_shapes=[("data", SHAPE)],
                 label_shapes=[("softmax_label", SHAPE)])


def test_lr_schedulers_match_jax():
    for make in (lambda pkg: pkg.lr_scheduler.FactorScheduler(3, 0.5),
                 lambda pkg: pkg.lr_scheduler.MultiFactorScheduler(
                     [2, 5, 9], 0.1)):
        js, ts = make(mx), make(mt)
        js.base_lr = ts.base_lr = 0.1
        for n in range(1, 15):
            assert ts(n) == js(n)


def test_fit_with_callbacks_and_score(lm_setup, tmp_path):
    """``Module.fit`` end to end: Xavier init, adam, a Perplexity metric,
    Speedometer and do_checkpoint callbacks; the checkpoint loads in the
    JAX package and the trained model scores better than the first
    epoch."""
    _, tn, _, X, Y = lm_setup
    data = np.concatenate([X, X])
    it = mt.io.NDArrayIter(data, (data + 1) % LM["vocab_size"],
                           batch_size=BATCH)
    mod = mt.mod.Module(tn, context=mt.cpu())
    mt.random.seed(0)
    prefix = str(tmp_path / "fit")
    metric = mt.metric.Perplexity(None)
    mod.fit(it, num_epoch=3, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2},
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
            eval_metric=metric,
            batch_end_callback=mt.callback.Speedometer(BATCH, 1),
            epoch_end_callback=mt.callback.do_checkpoint(prefix))
    (_, ppl), = mod.score(it, mt.metric.Perplexity(None))
    _, jargs, _ = mx.model.load_checkpoint(prefix, 1)
    first = _module(mx, mx.sym.load(prefix + "-symbol.json"), mx.cpu(),
                    jargs, "sgd")
    (_, ppl1), = first.score(mx.io.NDArrayIter(
        data, (data + 1) % LM["vocab_size"], batch_size=BATCH),
        mx.metric.Perplexity(None))
    assert np.isfinite(ppl) and ppl < ppl1


# ---------------------------------------------------------------------------
# bf16 rounding op by op, and the Embedding gradient
# ---------------------------------------------------------------------------


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


@pytest.mark.parametrize("name,attrs,shapes", [
    ("FullyConnected", {"num_hidden": 48}, [(32, 64), (48, 64), (48,)]),
    ("LayerNorm", {}, [(32, 64), (64,), (64,)]),
    ("broadcast_add", {}, [(2, 16, 64), (1, 16, 64)]),
    ("Reshape", {"shape": (-1, 16, 2, 2, 16)}, [(32, 64)]),
], ids=["fc", "layernorm", "broadcast_add", "reshape"])
def test_bf16_ops_round_where_jax_ops_round(name, attrs, shapes):
    """One op at a time on identical bf16 inputs, the port's output is the
    JAX op's to the bit, and its input gradient is within one bf16 ulp (the
    float32 sums inside LayerNorm's vjp run in another order): each op
    rounds its output to bf16 once, in both packages.  (Whole-graph bf16
    gradients still differ, because XLA fuses ops and keeps the
    intermediates in float32.)"""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(8)
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    jop, op = jget_op(name), get_op(name)
    jin = [jnp.asarray(_bf16(a).float().numpy(), jnp.bfloat16)
           for a in arrays]
    jout, vjp = jax.vjp(lambda *xs: jop.apply(
        JOpContext(is_train=True), jop.parse_attrs(attrs), list(xs))[0][0],
        *jin)
    tin = [_bf16(a).requires_grad_(True) for a in arrays]
    (out,), _ = op.apply(OpContext(is_train=True), op.parse_attrs(attrs), tin)
    ct = rng.randn(*jout.shape).astype(np.float32)
    jgrad = vjp(jnp.asarray(_bf16(ct).float().numpy(), jnp.bfloat16))[0]
    grad, = torch.autograd.grad(out, tin[0], _bf16(ct))
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout, np.float32))
    got, ref = grad.float().numpy(), np.asarray(jgrad, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(ref))
                                   + 1e-30)) - 7)
    assert (np.abs(got - ref) <= ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gradient_with_repeated_ids_matches_jax_take(dtype):
    """Embedding's weight gradient with every id repeated many times, in a
    float32 and in a bf16 table, against the vjp of ``jnp.take``.  The port
    sums each id's rows in float32 in a fixed order and rounds once, so in
    bf16 it is the exactly rounded sum (XLA's scatter-add on the CPU rounds
    after every add: within 2e-2 of max|ref|); in float32 it agrees within
    1e-6 of max|ref|.  Two runs give the same bits."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    vocab, dim = 12, 8
    ids = rng.randint(0, vocab - 2, (4, 60)).astype(np.float32)  # 2 unused
    weight = rng.randn(vocab, dim).astype(np.float32)
    ct = rng.randn(4, 60, dim).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    op = get_op("Embedding")
    attrs = op.parse_attrs({"input_dim": vocab, "output_dim": dim})
    grads = []
    for _ in range(2):
        w = torch.from_numpy(weight).to(tdt).requires_grad_(True)
        (out,), _ = op.apply(OpContext(is_train=True), attrs,
                             [torch.from_numpy(ids), w])
        grads.append(torch.autograd.grad(out, w,
                                         torch.from_numpy(ct).to(tdt))[0])
    assert torch.equal(grads[0], grads[1]) and grads[0].dtype == tdt
    _, vjp = jax.vjp(lambda W: jnp.take(W, jnp.asarray(ids.astype(np.int32)),
                                        axis=0), jnp.asarray(weight, jdt))
    ref = np.asarray(vjp(jnp.asarray(ct, jdt))[0], np.float32)
    got = grads[0].float().numpy()
    assert not got[vocab - 2:].any()
    rows = torch.from_numpy(ct).to(tdt).double().numpy().reshape(-1, dim)
    exact = np.zeros((vocab, dim))
    np.add.at(exact, ids.astype(int).reshape(-1), rows)
    if dtype == "float32":
        assert _rel(got, ref) <= 1e-6
    else:
        # within half a bf16 ulp of the exact sum: rounded once
        half_ulp = 2.0 ** (np.floor(np.log2(np.abs(exact) + 1e-30)) - 8)
        assert (np.abs(got - exact) <= half_ulp).all()
        assert _rel(got, ref) <= 2e-2
        assert (np.abs(ref - exact) > half_ulp).any()  # the reference's is not
