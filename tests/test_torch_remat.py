"""Remat (``MXNET_BACKWARD_DO_MIRROR``) in the port against itself and
against the JAX package, on the CPU.

The port runs the whole differentiated forward under non-reentrant
``torch.utils.checkpoint`` where the JAX package wraps it in
``jax.checkpoint``.  Held here:

* remat on and off give the same bits (losses, parameters, aux states) in
  the port, on a 2-layer d=64 LM with dropout and on a small BatchNorm
  net, through the fused step and the two-phase ``forward_backward``: the
  recompute replays the forward's dropout draws from the executor's
  generator state, and aux is written once, from the first forward;
* the port with remat against the JAX package with remat: 3 adam steps of
  the LM in float32 within 1e-4 (relative; the parameters against the
  largest parameter), the limit of ``test_torch_train.py``;
* the ``fused_step`` autotune site scores both candidates and the step
  runs the winner's remat (a recorded remat-on winner makes the step run
  its forward twice);
* the cost model counts the recomputed forward (within 10% of one
  forward's count);
* remat under the data-parallel walk (2 CPU contexts) and the partitioned
  walk (data=1, model=2) gives the bits remat off gives.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.transformer import get_transformer_lm as jax_lm
from mxnet_tpu_torch import autotune
from mxnet_tpu_torch.models.transformer import get_transformer_lm as port_lm

atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")

LM = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=64, seq_len=16)
BATCH = 4
SHAPE = (BATCH, LM["seq_len"])
ADAM = {"learning_rate": 1e-3, "epsilon": 1e-4}
TOL = 1e-4
STEPS = 3


def _lm(pkg, dropout=False):
    """The LM; with ``dropout`` its positional embedding goes through a
    Dropout (composed onto the free variable, so both packages build the
    same graph)."""
    make = port_lm if pkg is mt else jax_lm
    with pkg.NameManager():
        net = make(**LM)
        if dropout:
            pos = pkg.sym.Variable("pos_embed_weight", shape=(
                1, LM["seq_len"], LM["hidden"]))
            pos = pkg.sym.Dropout(pos, p=0.3, name="pos_drop")
            net = net(pos_embed_weight=pos)
    return net


def _bn_net(pkg):
    with pkg.NameManager():
        x = pkg.sym.Variable("data")
        x = pkg.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                                name="conv")
        x = pkg.sym.BatchNorm(x, name="bn")
        x = pkg.sym.Activation(x, act_type="relu")
        x = pkg.sym.FullyConnected(pkg.sym.Flatten(x), num_hidden=3,
                                   name="fc")
        return pkg.sym.SoftmaxOutput(x, name="softmax")


def _params(net, shapes, seed=0):
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.randn(*shape).astype(np.float32) * 0.3
    return out


def _lm_batch(seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, LM["vocab_size"], SHAPE).astype(np.float32)
    return X, (X + 1) % LM["vocab_size"]


def _bn_batch(seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(BATCH, 2, 6, 6).astype(np.float32)
    return X, (np.arange(BATCH) % 3).astype(np.float32)


class _Runs:
    """Counts the plan's graph walks (a remat step walks it twice)."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = mt.executor._GraphPlan.run

        def run(plan, args, aux, is_train, device, *a, **k):
            if device.type != "meta":  # the cost model's walks not counted
                self.n += 1
            return orig(plan, args, aux, is_train, device, *a, **k)
        monkeypatch.setattr(mt.executor._GraphPlan, "run", run)


def _module(pkg, net, data_shape, label_shape, params, context=None,
            **bind):
    mod = pkg.mod.Module(net, context=context or pkg.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)], **bind)
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in params.items()},
                    aux_params=None, allow_missing=True,
                    initializer=pkg.init.Zero())
    mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
    return mod


def _train(pkg, mod, X, Y, route="fused", steps=STEPS):
    ctx = pkg.cpu()
    batch = pkg.io.DataBatch([pkg.nd.array(X, ctx)], [pkg.nd.array(Y, ctx)])
    outs = []
    for _ in range(steps):
        if route == "fused":
            mod.forward_backward(batch)
        else:  # the executor group's forward_backward, then the updater
            mod._exec_group.forward_backward(batch)
        mod.update()
        outs.append(np.asarray(mod.get_outputs()[0].asnumpy(), np.float32))
    args, aux = mod.get_params()
    return (outs, {k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _same_bits(a, b):
    outs_a, args_a, aux_a = a
    outs_b, args_b, aux_b = b
    for x, y in zip(outs_a, outs_b):
        np.testing.assert_array_equal(x, y)
    assert sorted(args_a) == sorted(args_b)
    for k in args_a:
        np.testing.assert_array_equal(args_a[k], args_b[k], err_msg=k)
    assert sorted(aux_a) == sorted(aux_b)
    for k in aux_a:
        np.testing.assert_array_equal(aux_a[k], aux_b[k], err_msg=k)


def _case(what):
    if what == "lm_dropout":
        net = _lm(mt, dropout=True)
        X, Y = _lm_batch()
        return net, SHAPE, SHAPE, _params(
            net, {"data": SHAPE, "softmax_label": SHAPE}), X, Y
    net = _bn_net(mt)
    X, Y = _bn_batch()
    shape = X.shape
    return net, shape, (BATCH,), _params(
        net, {"data": shape, "softmax_label": (BATCH,)}), X, Y


@pytest.mark.parametrize("route", ["fused", "two_phase"])
@pytest.mark.parametrize("what", ["lm_dropout", "bn"])
def test_remat_on_equals_off_bit_for_bit(what, route, monkeypatch):
    """Losses, parameters and aux states after 3 steps: the same bits
    with remat on and off.  Under remat each step walks the graph twice
    (the forward and its recompute); the aux states (BatchNorm's moving
    statistics) are written once, and the dropout masks of the recompute
    are the forward's."""
    net, dshape, lshape, params, X, Y = _case(what)
    runs = _Runs(monkeypatch)
    mt.random.seed(7)
    off = _train(mt, _module(mt, net, dshape, lshape, params), X, Y, route)
    walks_off = runs.n
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    mt.random.seed(7)
    on = _train(mt, _module(mt, net, dshape, lshape, params), X, Y, route)
    assert walks_off == STEPS
    assert runs.n - walks_off == 2 * STEPS
    _same_bits(on, off)
    if what == "bn":
        # the moving statistics moved: aux was written, once a step
        assert np.abs(off[2]["bn_moving_mean"]).max() > 0


def test_remat_dropout_mask_differs_without_replay(monkeypatch):
    """The replay matters: a recompute that draws on from the device
    generator (not restarted at the forward's state) gives other
    gradients, so the bit-for-bit test above can see a wrong replay."""
    net, dshape, lshape, params, X, Y = _case("lm_dropout")
    mt.random.seed(7)
    off = _train(mt, _module(mt, net, dshape, lshape, params), X, Y,
                 steps=1)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")

    class Unreplayed(torch.Generator):
        """A recompute's generator that ignores the forward's state."""

        def set_state(self, state):
            self.manual_seed(12345)

    monkeypatch.setattr(torch, "Generator", Unreplayed)
    mt.random.seed(7)
    broken = _train(mt, _module(mt, net, dshape, lshape, params), X, Y,
                    steps=1)
    diff = max(np.abs(broken[1][k] - off[1][k]).max() for k in off[1])
    assert diff > 0


def test_remat_matches_jax_mirror(monkeypatch):
    """3 adam steps of the LM (no dropout) with remat in both packages,
    from one numpy init: losses and parameters within 1e-4."""
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    tn, jn = _lm(mt), _lm(mx)
    params = _params(tn, {"data": SHAPE, "softmax_label": SHAPE})
    X, Y = _lm_batch()
    got = _train(mt, _module(mt, tn, SHAPE, SHAPE, params), X, Y)
    ref = _train(mx, _module(mx, jn, SHAPE, SHAPE, params), X, Y)
    for a, b in zip(got[0], ref[0]):
        assert np.abs(a - b).max() / np.abs(b).max() <= TOL
    scale = max(np.abs(v).max() for v in ref[1].values())
    for k in ref[1]:
        assert np.abs(got[1][k] - ref[1][k]).max() / scale <= TOL, k


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "at")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", d)
    monkeypatch.setenv("MXNET_AUTOTUNE", "record")
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    autotune.reset_for_tests()
    yield d
    autotune.reset_for_tests()


def test_fused_step_site_scores_both_and_step_runs_winner(tune_dir,
                                                          monkeypatch):
    """Record mode scores remat off and on by the roofline of the step's
    cost (on counts the recompute, so it scores higher and off wins); the
    step runs that winner.  A recorded remat-on winner, looked up in
    ``on`` mode, makes the next executor's step walk the graph twice."""
    net = _lm(mt)
    params = _params(net, {"data": SHAPE, "softmax_label": SHAPE})
    X, Y = _lm_batch()
    runs = _Runs(monkeypatch)
    mod = _module(mt, net, SHAPE, SHAPE, params)
    _train(mt, mod, X, Y, steps=1)
    assert runs.n == 1
    entries = [e for e in atdb.ls_entries(tune_dir)
               if e["site"] == "fused_step"]
    assert len(entries) == 1
    win = atdb.show_winner(entries[0]["path"])
    assert win["config"] == {"remat": 0, "donate": 0}
    scores = {c["remat"]: s for c, s in win["provenance"]["scores"]}
    assert sorted(scores) == [0, 1] and scores[1] > scores[0]
    ex = mod._exec_group.execs[0]
    (key,) = [k for k in ex._remat if k[0] == "fused"]
    assert ex._remat[key] is False

    # the same step key with remat recorded as the winner
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    autotune.db().put("fused_step", win["meta"]["key"],
                      {"remat": 1, "donate": 0}, {"objective": "test"})
    mod2 = _module(mt, net, SHAPE, SHAPE, params)
    before = runs.n
    _train(mt, mod2, X, Y, steps=1)
    assert runs.n - before == 2
    ex2 = mod2._exec_group.execs[0]
    assert ex2._remat[key] is True


def _fused_flops(ex):
    from mxnet_tpu_torch import hlo_analysis

    fn, abstract = ex._fused_introspect
    return hlo_analysis.lower_and_analyze(fn, abstract)[1]["flops"]


def test_cost_model_counts_the_recompute(monkeypatch):
    """The step monitor's count of a remat step: one more forward than
    the same step without remat, within 10% of one forward's count."""
    from mxnet_tpu_torch import hlo_analysis
    from mxnet_tpu_torch.hlo_analysis import TensorSpec

    net = _lm(mt)
    params = _params(net, {"data": SHAPE, "softmax_label": SHAPE})
    X, Y = _lm_batch()
    off = _module(mt, net, SHAPE, SHAPE, params)
    _train(mt, off, X, Y, steps=1)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    on = _module(mt, net, SHAPE, SHAPE, params)
    _train(mt, on, X, Y, steps=1)
    ex = off._exec_group.execs[0]
    f_off = _fused_flops(ex)
    f_on = _fused_flops(on._exec_group.execs[0])
    args, aux = ex._bound()

    def fwd(a, x):
        with torch.enable_grad():
            return ex._run(a, x, True, None, device=torch.device("meta"))

    spec = {k: TensorSpec(v.shape, v.dtype) for k, v in args.items()}
    aspec = {k: TensorSpec(v.shape, v.dtype) for k, v in aux.items()}
    f_fwd = hlo_analysis.lower_and_analyze(fwd, (spec, aspec))[1]["flops"]
    assert f_on > f_off
    assert abs((f_on - f_off) - f_fwd) <= 0.1 * f_fwd, (f_on, f_off, f_fwd)


@pytest.mark.parametrize("layout", ["data_parallel", "partitioned"])
def test_remat_under_the_walks(layout, monkeypatch):
    """The data-parallel walk over 2 CPU contexts and the partitioned walk
    (data=1, model=2, Megatron rules: their gathers and row sums run inside
    the recomputed forward) give the bits remat off gives."""
    net = _lm(mt)
    params = _params(net, {"data": SHAPE, "softmax_label": SHAPE})
    X, Y = _lm_batch()
    if layout == "data_parallel":
        def make():
            return _module(mt, net, SHAPE, SHAPE, params,
                           context=[mt.cpu(0), mt.cpu(1)])
    else:
        def make():
            mesh = mt.sharding.build_mesh("data=1,model=2",
                                          [mt.cpu(0), mt.cpu(1)])
            return _module(mt, net, SHAPE, SHAPE, params, mesh=mesh,
                           partition_rules="transformer_megatron")
    runs = _Runs(monkeypatch)
    off = _train(mt, make(), X, Y)
    walks_off = runs.n
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    on_mod = make()
    assert on_mod._exec_group.execs[0]._dp is not None
    on = _train(mt, on_mod, X, Y)
    assert runs.n - walks_off == 2 * walks_off
    _same_bits(on, off)
