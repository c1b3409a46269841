"""The port's cost model (``mxnet_tpu_torch.hlo_analysis``) against the
JAX package's XLA cost analysis (``mxnet_tpu.hlo_analysis``), on the CPU.

* Operations of one fused training step (forward, backward and the SGD
  update), the port counted on meta tensors, the JAX package by XLA: an
  MLP, LeNet and a small transformer LM agree within 5% (products
  dominate each).  Bytes are not compared: the eager plan has no fusion
  (a kept difference, ROADMAP.md C); they are only counted.
* Attention: XLA's count of the Pallas flash forward in interpret mode
  (the CPU's) is about one grid step's products, whatever the mask; the
  port counts K1's products over the visible (query, key) pairs, as
  PERF.md's bounds do.
* ``roofline_ms`` equal under the same peaks (defaults: the H100 SXM's,
  where the JAX package's are TPU v5e's), ``hlo_op_counts`` and
  ``bn_fusion_analysis`` equal on the same HLO text, the step monitor's
  flops and MFU from the fused step's first build.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import hlo_analysis, telemetry
from mxnet_tpu_torch.hlo_analysis import TensorSpec

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import hlo_analysis as jhlo
from mxnet_tpu import telemetry as jtelemetry


# bench.py (collected by tests/test_bench.py) sets MXNET_TELEMETRY=1 for the
# rest of the process, and a worker that imports the port after it starts
# the port's telemetry at import: excepthooks chained onto the session's,
# spans recorded.  Collection imports every file before any case runs, so
# this puts the port's telemetry off for the whole worker.
telemetry._reset_for_tests()


def _reset_both():
    """Both packages' telemetry off.  Each flight recorder chains onto the
    hook it finds and puts it back when it uninstalls, so the package whose
    hook is on top goes first."""
    top = getattr(threading.excepthook, "__module__", "") or ""
    first, second = (jtelemetry, telemetry) if top.startswith("mxnet_tpu.") \
        else (telemetry, jtelemetry)
    first._reset_for_tests()
    second._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    _reset_both()
    yield
    _reset_both()


def _mlp(S):
    h = S.sym.Variable("data")
    for i, n in enumerate((64, 32)):
        h = S.sym.FullyConnected(h, num_hidden=n, name="fc%d" % i)
        h = S.sym.Activation(h, act_type="relu")
    h = S.sym.FullyConnected(h, num_hidden=10, name="out")
    return S.sym.SoftmaxOutput(h, name="softmax"), (16, 100), 10


def _lenet(S):
    h = S.sym.Variable("data")
    for i, n in enumerate((20, 50)):
        h = S.sym.Convolution(h, kernel=(5, 5), num_filter=n, name="c%d" % i)
        h = S.sym.Activation(h, act_type="tanh")
        h = S.sym.Pooling(h, pool_type="max", kernel=(2, 2), stride=(2, 2))
    h = S.sym.Flatten(h)
    h = S.sym.Activation(S.sym.FullyConnected(h, num_hidden=500, name="f1"),
                         act_type="tanh")
    h = S.sym.FullyConnected(h, num_hidden=10, name="f2")
    return S.sym.SoftmaxOutput(h, name="softmax"), (8, 1, 28, 28), 10


LM = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=128, seq_len=128)


def _lm(S):
    if S is mx:
        from mxnet_tpu.models.transformer import get_transformer_lm
    else:
        from mxnet_tpu_torch.models.transformer import get_transformer_lm
    with S.NameManager():
        net = get_transformer_lm(**LM)
    return net, (2, LM["seq_len"]), LM["vocab_size"]


def _step_cost(S, build):
    """Cost of the fused step of ``build``'s net after one SGD step."""
    ctx = mt.cpu() if S is mt else None
    net, shape, classes = build(S)
    label = shape[:2] if build is _lm else shape[:1]
    mod = S.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", label)])
    S.random.seed(0)
    mod.init_params(initializer=S.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    if build is _lm:
        x = rng.randint(0, classes, shape).astype(np.float32)
        y = (x + 1) % classes
    else:
        x = rng.randn(*shape).astype(np.float32)
        y = rng.randint(0, classes, label).astype(np.float32)
    arr = (lambda a: S.nd.array(a, ctx)) if ctx else S.nd.array
    mod.forward_backward(S.io.DataBatch(data=[arr(x)], label=[arr(y)],
                                        pad=0))
    mod.update()
    return S.telemetry.fused_cost_analysis(mod._exec_group.execs[0])


@pytest.mark.parametrize("build", [_mlp, _lenet, _lm],
                         ids=["mlp", "lenet", "lm"])
def test_step_operations_match_xla(build):
    got = _step_cost(mt, build)
    want = _step_cost(mx, build)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)
    assert got["bytes_accessed"] > 0


@pytest.mark.parametrize("causal", [True, False])
def test_attention_counts_visible_pairs(causal):
    b, s, h, d = 2, 128, 2, 64
    spec = jax.ShapeDtypeStruct((b, s, h, d), jnp.float32)
    from mxnet_tpu.ops import attention as jatt
    from mxnet_tpu_torch.ops import attention as att

    _, xla = jhlo.lower_and_analyze(
        jax.jit(lambda q, k, v: jatt.flash_attention(q, k, v,
                                                     causal=causal)),
        (spec,) * 3)
    _, port = hlo_analysis.lower_and_analyze(
        lambda q, k, v: att.flash_attention(q, k, v, causal=causal),
        (TensorSpec((b, s, h, d), torch.float32),) * 3)
    pairs = s * (s + 1) // 2 if causal else s * s
    assert port["flops"] == 2 * 2 * d * pairs * b * h
    # XLA counts the interpret-mode kernel's loop body once: about one of
    # the b * h grid steps' products, masked or not
    full = 4 * b * h * s * s * d
    assert xla["flops"] < 0.3 * full


def test_roofline_and_peaks(monkeypatch):
    info = {"flops": 3e12, "bytes_accessed": 4e9}
    assert hlo_analysis.peak_flops() == 989e12
    assert hlo_analysis.hbm_bytes_per_s() == 3.35e12
    assert jhlo.peak_flops() == 197e12
    assert hlo_analysis.roofline_ms(info) == pytest.approx(
        max(3e12 / 989e12, 4e9 / 3.35e12) * 1e3)
    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_FLOPS", "1e14")
    monkeypatch.setenv("MXNET_TELEMETRY_HBM_GBS", "2000")
    for i in (info, {"flops": 1e9, "bytes_accessed": 8e9},
              {"flops": 0, "bytes_accessed": 0}, None, {}):
        assert hlo_analysis.roofline_ms(i) == jhlo.roofline_ms(i)
    assert hlo_analysis.cost_analysis(info) == info
    assert hlo_analysis.lower_and_analyze(None, ()) == (None, None)


def _conv_bn_hlo():
    def f(x, w, g, b):
        y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME")
        return jax.nn.relu(y * g[None, :, None, None] +
                           b[None, :, None, None])

    return jax.jit(f).lower(
        jnp.zeros((2, 3, 8, 8)), jnp.zeros((4, 3, 3, 3)), jnp.zeros(4),
        jnp.zeros(4)).compile().as_text()


def test_hlo_text_parsers_match():
    text = _conv_bn_hlo()
    assert hlo_analysis.hlo_op_counts(text) == jhlo.hlo_op_counts(text)
    some = {"convolution", "fusion", "multiply"}
    assert hlo_analysis.hlo_op_counts(text, some) == \
        jhlo.hlo_op_counts(text, some)
    assert hlo_analysis.bn_fusion_analysis(text) == \
        jhlo.bn_fusion_analysis(text)
    assert hlo_analysis.bn_fusion_analysis(text)["convs_total"] >= 1


def test_step_monitor_flops_and_mfu_from_the_first_build():
    telemetry.enable(trace=False)
    net, shape, _ = _mlp(mt)
    it = mt.io.NDArrayIter(np.random.RandomState(0).randn(
        64, 100).astype(np.float32), np.zeros(64, np.float32),
        batch_size=16, label_name="softmax_label")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.fit(it, num_epoch=1, optimizer="sgd")
    mon = telemetry.current_step_monitor()
    ex = mod._exec_group.execs[0]
    info = telemetry.fused_cost_analysis(ex)
    assert mon.c_compiles.value == 1  # one step key, one count
    assert mon.flops_per_step == info["flops"]
    expect = info["flops"] / mon.avg_step_s() / telemetry.peak_flops()
    assert mon.mfu() == pytest.approx(expect, rel=1e-6)
    rep = mon.report()
    assert rep["flops_per_step"] == info["flops"]
    assert rep["device_peak_bytes"] is None  # a CPU module: no card


def test_cost_model_walks_the_step_itself():
    """The step's count is ``Executor._fused`` itself on meta tensors (no
    second copy of the step): with the guardian on it adds the guard's
    pass, and counting changes no parameter, optimizer state or update
    count."""
    from mxnet_tpu_torch import guardian

    def step(guard):
        (guardian.enable if guard else guardian.disable)()
        try:
            net, shape, _ = _mlp(mt)
            mod = mt.mod.Module(net, context=mt.cpu())
            mod.bind(data_shapes=[("data", shape)],
                     label_shapes=[("softmax_label", shape[:1])])
            mt.random.seed(0)
            mod.init_params(initializer=mt.init.Xavier())
            mod.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": 1e-3})
            rng = np.random.RandomState(0)
            mod.forward_backward(mt.io.DataBatch(
                data=[mt.nd.array(rng.randn(*shape).astype(np.float32),
                                  mt.cpu())],
                label=[mt.nd.array(np.zeros(shape[0], np.float32),
                                   mt.cpu())], pad=0))
            mod.update()
            ex = mod._exec_group.execs[0]
            fn, _ = ex._fused_introspect
            assert fn.func == ex._fused
            opt = mod._optimizer
            states = mod._updater.states

            def snap():
                return ({k: v._data.clone() for k, v in ex.arg_dict.items()},
                        {i: [t._data.clone() for t in st]
                         for i, st in states.items()},
                        opt.num_update, dict(opt._index_update_count))

            before = snap()
            info = telemetry.fused_cost_analysis(ex)
            after = snap()
            assert all(torch.equal(before[0][k], after[0][k])
                       for k in before[0])
            assert all(torch.equal(a, b) for i in before[1]
                       for a, b in zip(before[1][i], after[1][i]))
            assert before[2:] == after[2:]
            return info
        finally:
            guardian.disable()

    plain, guarded = step(False), step(True)
    assert plain["flops"] < guarded["flops"] < 1.05 * plain["flops"]
    assert plain["bytes_accessed"] < guarded["bytes_accessed"]
