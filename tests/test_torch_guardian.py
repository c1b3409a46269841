"""The port's training guardian (``mxnet_tpu_torch.guardian``) against the
JAX package's, on the CPU.

* The ladder (skip -> re-warm -> rollback), the spike detector, the
  re-warm ramp and the last-good ring: both packages' ``Guardian`` fed the
  same observation sequences under a fake clock give the same actions,
  the same ``stats()`` and the same ring.
* The step guard on the small FC net of ``tests/test_guardian.py``, fused
  and eager: a poisoned step's parameters and optimizer states keep their
  bits, and both packages answer the same actions.
* ``Module.fit`` with a rollback: under SGD with momentum the replayed
  run equals an uninterrupted run bit for bit, fused and eager, and the
  eager rollback agrees with the JAX package's; under adam it does not
  equal an uninterrupted run, in either package, because
  ``Updater.get_states`` keeps only the states and the update counts
  (adam's bias correction) run on (a reference defect the port keeps,
  ROADMAP.md C), and the two packages' rolled-back adam runs agree with
  each other.  The JAX package's fused path cannot roll back at all (its
  snapshots share donated buffers; the port does not donate).
* With telemetry on, an anomaly event: the JAX package raises
  ``TypeError`` (its event passes ``kind=`` twice); the port logs it.
"""
import os
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faults, guardian, telemetry

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import guardian as jguardian
from mxnet_tpu import telemetry as jtelemetry

PKGS = {"port": (mt, guardian, faults, telemetry),
        "jax": (mx, jguardian, jfaults, jtelemetry)}


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
    for _, g, f, t in PKGS.values():
        g.disable()
        g.reset_stats()
    _reset_both()
    yield
    for _, g, f, t in PKGS.values():
        f.uninstall()
        g.disable()
        g.reset_stats()
    _reset_both()


def _fake_clock(start=100.0):
    state = {"t": start}

    def clock():
        state["t"] += 1.0
        return state["t"]

    return clock


def _both(**kw):
    return (guardian.Guardian(clock=_fake_clock(), **kw),
            jguardian.Guardian(clock=_fake_clock(), **kw))


# ---------------------------------------------------------------------------
# the ladder, side by side
# ---------------------------------------------------------------------------
def _sequence(seed, n=40):
    """Observations (finite, gnorm, loss): clean steps with a spread of
    norms, runs of non-finite steps and spikes of every kind."""
    rng = np.random.RandomState(seed)
    seq = []
    for _ in range(n):
        r = rng.rand()
        if r < 0.2:
            seq.append((False, None, None))
        elif r < 0.3:
            seq.append((True, float(rng.choice([np.inf, np.nan, 1e4])),
                        None))
        elif r < 0.4:
            seq.append((True, 1.0, float(rng.choice([np.nan, 500.0]))))
        else:
            seq.append((True, float(rng.uniform(0.5, 2.0)),
                        float(rng.uniform(1.0, 3.0))))
    return seq


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("knobs", [
    dict(skip_max=2, rewarm_steps=10, rewarm_factor=0.1, warmup=4,
         rollback_max=100),
    dict(skip_max=1, rewarm_steps=0, warmup=2, spike_mult=5.0,
         spike_window=4, rollback_max=100),
    dict(skip_max=0, rewarm_steps=3, rewarm_factor=0.25, warmup=3,
         rollback_max=100, snapshot_every=3, ring=2),
])
def test_ladder_matches_the_jax_package(seed, knobs):
    port, ref = _both(**knobs)
    got, want = [], []
    for finite, gnorm, loss in _sequence(seed):
        a = port.observe(finite=finite, gnorm=gnorm, loss=loss)
        b = ref.observe(finite=finite, gnorm=gnorm, loss=loss)
        got.append((a, port.lr_mult(), guardian.current_lr_mult()))
        want.append((b, ref.lr_mult(), jguardian.current_lr_mult()))
        for g, cap in ((port, {"s": len(got)}), (ref, {"s": len(want)})):
            g.offer_snapshot(lambda cap=cap: dict(cap))
        if a == "rollback":
            port.note_rollback(to_step=0)
            ref.note_rollback(to_step=0)
    assert got == want
    assert guardian.stats() == jguardian.stats()
    assert port.stats() == ref.stats()
    assert [a for a, _, _ in port.history] == [a for a, _, _ in ref.history]
    assert [s for s, _ in port._ring] == [s for s, _ in ref._ring]


def test_rollback_budget_and_ring_targets_match():
    for g, mod in ((guardian.Guardian(clock=_fake_clock(), rollback_max=1,
                                      ring=3, snapshot_every=1, warmup=2),
                    guardian),
                   (jguardian.Guardian(clock=_fake_clock(), rollback_max=1,
                                       ring=3, snapshot_every=1, warmup=2),
                    jguardian)):
        g.offer_snapshot(lambda: {"epoch": 0})
        g.observe(finite=True, gnorm=1.0)
        g.offer_snapshot(lambda: {"epoch": 1})
        assert g.rollback_target(lambda s: s["epoch"] == 0)[0] == 0
        assert g.rollback_target(lambda s: s["epoch"] == 9) is None
        g.note_rollback(to_step=0)
        with pytest.raises(mod.GuardianAbort):
            g.note_rollback(to_step=0)
    assert guardian.stats() == jguardian.stats()


def test_rewarm_scales_the_optimizers_lr_in_both_packages():
    got = []
    for pkg, g in ((mt, guardian), (mx, jguardian)):
        opt = pkg.optimizer.create("sgd", learning_rate=0.5)
        ladder = g.Guardian(clock=_fake_clock(), skip_max=0,
                            rewarm_steps=4, rewarm_factor=0.25, warmup=2)
        assert ladder.observe(finite=False) == "rewarm"
        got.append(opt._get_lr(0))
        ladder.observe(finite=True, gnorm=1.0)
        got.append(opt._get_lr(0))
        g.disable()
    assert got[:2] == got[2:]
    assert got[0] == pytest.approx(0.5 * 0.25)


# ---------------------------------------------------------------------------
# the step guard on the small FC net
# ---------------------------------------------------------------------------
def _small_module(pkg, fused, optimizer="sgd", params=None, init_opt=True):
    ctx = mt.cpu() if pkg is mt else None
    os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
    try:
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, name="fc1", num_hidden=8)
        net = pkg.sym.SoftmaxOutput(net, name="softmax")
        mod = pkg.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))])
        rng = np.random.RandomState(0)
        args = params or {
            "fc1_weight": rng.uniform(-0.5, 0.5, (8, 6)).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32)}
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx) if ctx else
                                    pkg.nd.array(v)
                                    for k, v in args.items()},
                        aux_params={}, force_init=True)
        if init_opt:
            mod.init_optimizer(optimizer=optimizer,
                               optimizer_params={"learning_rate": 0.1},
                               force_init=True)
    finally:
        os.environ.pop("MXNET_FUSED_STEP", None)
    return mod


def _step(pkg, mod, x):
    ctx = mt.cpu() if pkg is mt else None
    arr = (lambda a: pkg.nd.array(a, ctx)) if ctx else pkg.nd.array
    y = np.arange(4, dtype=np.float32) % 8
    mod.forward_backward(pkg.io.DataBatch(data=[arr(x)], label=[arr(y)],
                                          pad=0))
    mod.update()


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _states(mod):
    out = {}
    for idx, st in mod._updater.states.items():
        sts = st if isinstance(st, (list, tuple)) else [st]
        out[idx] = [s.asnumpy() for s in sts if s is not None]
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("fused", [True, False])
def test_step_guard_skips_a_poisoned_update(fused, optimizer):
    clean = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    poisoned = clean.copy()
    poisoned[0, 0] = np.nan  # NaN reaches every gradient
    actions = {}
    for name, (pkg, g, _, _) in PKGS.items():
        g.enable()
        mod = _small_module(pkg, fused, optimizer)
        assert mod._fused_ok == fused
        mod._guardian = g.Guardian(clock=_fake_clock(), skip_max=2,
                                   warmup=4)
        got = []
        _step(pkg, mod, clean)
        got.append(mod._guardian_action)
        before, st_before = _params(mod), _states(mod)
        _step(pkg, mod, poisoned)
        got.append(mod._guardian_action)
        after, st_after = _params(mod), _states(mod)
        for k in before:
            assert np.array_equal(before[k], after[k]), \
                "%s: %s changed across a skipped step" % (name, k)
        for k in st_before:
            for a, b in zip(st_before[k], st_after[k]):
                assert np.array_equal(a, b), \
                    "%s: state %s changed across a skipped step" % (name, k)
        _step(pkg, mod, clean)
        got.append(mod._guardian_action)
        final = _params(mod)
        assert any(not np.array_equal(before[k], final[k]) for k in before)
        actions[name] = (got, mod._optimizer.num_update, final)
        g.disable()
    assert actions["port"][0] == actions["jax"][0] == ["ok", "skip", "ok"]
    # the skipped step is counted in both packages
    assert actions["port"][1] == actions["jax"][1]
    for k in actions["port"][2]:
        np.testing.assert_allclose(actions["port"][2][k],
                                   actions["jax"][2][k], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["nan", "bitflip"])
def test_injected_gradient_fault_skipped_on_the_eager_path(kind):
    clean = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    got = {}
    for name, (pkg, g, f, _) in PKGS.items():
        g.enable()
        f.install(f.FaultPlan("guardian.grad:%s@#1" % kind, seed=0))
        mod = _small_module(pkg, fused=True)
        assert not mod._fused_ok, "a guardian.grad plan keeps the eager loop"
        mod._guardian = g.Guardian(clock=_fake_clock(), skip_max=2,
                                   warmup=4)
        before = _params(mod)
        _step(pkg, mod, clean)
        acts = [mod._guardian_action]
        assert all(np.array_equal(before[k], v)
                   for k, v in _params(mod).items())
        _step(pkg, mod, clean)
        acts.append(mod._guardian_action)
        got[name] = (acts, g.stats())
        f.uninstall()
        g.disable()
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["skip", "ok"]


def test_guard_off_leaves_the_step_unguarded():
    """Off, the fused step's key says so and no verdict is kept."""
    mod = _small_module(mt, fused=True)
    _step(mt, mod, np.ones((4, 6), np.float32))
    ex = mod._exec_group.execs[0]
    assert ex._guard_verdict is None
    assert all(k[-1] == ("guard", 0) for k in ex._fused_sites)
    guardian.enable()
    _step(mt, mod, np.ones((4, 6), np.float32))
    ok, gnorm = ex._guard_verdict
    assert ok and np.isfinite(gnorm) and gnorm > 0
    assert {k[-1] for k in ex._fused_sites} == {("guard", 0), ("guard", 1)}


def _poison(case):
    """(gradients, outputs) of one guard case, float32 unless named."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(*s).astype(np.float32) for s in ((5, 7), (7,), (3,))]
    outs = [rng.rand(4, 6).astype(np.float32), np.arange(4, dtype=np.int64)]
    dtypes = [None, None]
    if case == "nan output":
        outs[0][2, 3] = np.nan
    elif case == "inf bf16 output":
        outs[0][0, 0] = np.inf
        dtypes[0] = "bfloat16"
    elif case == "-inf output":
        outs[0][1, 1] = -np.inf
    elif case == "overflowing gradient":
        grads[0][1, 2] = 3e38  # finite; its square is not
    elif case == "nan gradient":
        grads[2][0] = np.nan
    return grads, outs, dtypes


@pytest.mark.parametrize("case", [
    "clean", "nan output", "inf bf16 output", "-inf output",
    "overflowing gradient", "nan gradient"])
def test_guard_check_holds_the_jax_rule(case):
    """``executor._guard_check`` against the JAX package's rule
    (``mxnet_tpu/executor.py``, the fused program's guard): every gradient
    and floating output finite and the float32 norm of the squares
    finite.  The port reads each output's largest |value|; an integer
    output is not checked."""
    import torch

    from mxnet_tpu_torch.executor import _guard_check

    grads, outs, dtypes = _poison(case)
    tg = [torch.from_numpy(g) for g in grads]
    to = [torch.from_numpy(o) if dt is None else
          torch.from_numpy(o).to(getattr(torch, dt))
          for o, dt in zip(outs, dtypes)]
    ok, gnorm = _guard_check(tg, to)
    with np.errstate(over="ignore", invalid="ignore"):
        sq = np.float32(sum(np.sum(np.square(g), dtype=np.float32)
                            for g in grads))
        want = bool(all(np.isfinite(g).all() for g in grads) and
                    np.isfinite(outs[0]).all() and np.isfinite(sq))
    assert ok is want
    assert ok is (case == "clean")
    if ok:
        assert gnorm == pytest.approx(float(np.sqrt(sq)), rel=1e-5)


def test_anomaly_event_with_telemetry_on():
    """The JAX package's anomaly event passes ``kind=`` to ``log_event``,
    whose first argument is the event's kind: it raises.  The port logs
    the anomaly's kind as ``anomaly``."""
    jtelemetry.enable(trace=False)
    with pytest.raises(TypeError):
        jguardian.Guardian(clock=_fake_clock()).observe(finite=False)
    telemetry.enable(trace=False)
    assert guardian.Guardian(clock=_fake_clock()).observe(
        finite=False) == "skip"
    ev = telemetry.events_of("guardian_anomaly")
    assert ev and ev[-1]["anomaly"] == "nonfinite"
    assert telemetry.events_of("guardian_action")[-1]["action"] == "skip"


# ---------------------------------------------------------------------------
# fit with a rollback
# ---------------------------------------------------------------------------
N_BATCH = 10


def _fit(pkg, g, optimizer, fused, poison_at=None, momentum=True):
    """``fit`` over 10 batches of 4 on the small net; with ``poison_at``
    the batch-end callback sets one weight to NaN once, so the steps after
    it are anomalies until the ladder rolls back."""
    ctx = mt.cpu() if pkg is mt else None
    rng = np.random.RandomState(3)
    X = rng.randn(N_BATCH * 4, 6).astype(np.float32)
    Y = (np.arange(N_BATCH * 4) % 8).astype(np.float32)
    it = pkg.io.NDArrayIter(X, Y, batch_size=4, label_name="softmax_label")
    mod = _small_module(pkg, fused, optimizer, init_opt=False)
    fired = []

    def poison(param):
        if poison_at is None or fired or param.nbatch != poison_at:
            return
        fired.append(param.nbatch)
        arg, aux = mod.get_params()
        w = arg["fc1_weight"].asnumpy().copy()
        w[0, 0] = np.nan
        # copies: the JAX package's fused step donates the bound buffers
        arg = {k: v.copy() for k, v in arg.items()}
        aux = {k: v.copy() for k, v in aux.items()}
        arg["fc1_weight"] = pkg.nd.array(w, ctx) if ctx else pkg.nd.array(w)
        mod.set_params(arg, aux)

    params = {"learning_rate": 0.1}
    if optimizer == "sgd" and momentum:
        params["momentum"] = 0.9
    os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
    try:
        mod.fit(it, num_epoch=1, optimizer=optimizer,
                optimizer_params=params, batch_end_callback=poison,
                force_init=False)
    finally:
        os.environ.pop("MXNET_FUSED_STEP", None)
    assert mod._fused_ok == fused
    return _params(mod), g.stats()


@pytest.fixture
def _ladder_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_GUARDIAN_SNAPSHOT_EVERY", "2")
    monkeypatch.setenv("MXNET_GUARDIAN_SKIP_MAX", "2")
    monkeypatch.setenv("MXNET_GUARDIAN_REWARM_STEPS", "50")
    monkeypatch.setenv("MXNET_TELEMETRY_POSTMORTEM_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("fused", [True, False])
def test_fit_rolls_back_and_replays_bitwise_under_sgd_momentum(fused,
                                                               _ladder_env):
    guardian.enable()
    telemetry.enable(trace=True)
    clean, st_clean = _fit(mt, guardian, "sgd", fused)
    assert st_clean["rollbacks"] == 0
    guardian.reset_stats()
    got, st = _fit(mt, guardian, "sgd", fused, poison_at=2)
    # batches 3-8 are anomalies: skip, skip, re-warm, skip, skip, rollback
    assert st["rollbacks"] == 1 and st["anomalies"] == 6
    assert st["rewarms"] == 1 and st["skips"] == 5
    for k in clean:
        assert np.array_equal(clean[k], got[k]), \
            "%s: the replay differs from the uninterrupted run" % k
    post = telemetry.flight_recorder.last_path()
    assert post and os.path.dirname(post) == str(_ladder_env)
    assert "guardian-rollback" in open(post).read()


def test_fit_rollback_matches_the_jax_package(_ladder_env):
    """Eager path: the JAX package's fused path cannot roll back (next
    test)."""
    got = {}
    for name, (pkg, g, _, _) in PKGS.items():
        g.enable()
        got[name] = _fit(pkg, g, "sgd", False, poison_at=2)
        g.disable()
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1]["rollbacks"] == 1
    for k in got["port"][0]:
        np.testing.assert_allclose(got["port"][0][k], got["jax"][0][k],
                                   rtol=1e-5, atol=1e-6)


def test_jax_fused_rollback_restores_donated_buffers(_ladder_env):
    """A reference defect the port does not share: the JAX package's ring
    snapshot copies share the parameters' jax arrays, which its fused step
    donates, so the first step after a fused-path rollback reads deleted
    buffers.  The port does not donate (test above: its fused path
    replays bit for bit)."""
    jguardian.enable()
    with pytest.raises(RuntimeError, match="deleted"):
        _fit(mx, jguardian, "sgd", True, poison_at=2)


@pytest.mark.parametrize("fused", [True, False])
def test_adam_replay_after_rollback_is_not_an_uninterrupted_run(
        fused, _ladder_env):
    """A reference defect, kept: the ring's updater snapshot holds adam's
    moments but not the update counts, which run on (the fused step counts
    the skipped steps too), so the replay's bias correction is not an
    uninterrupted run's.  The JAX package does so alike (on its eager
    path, the one that can roll back)."""
    got = {}
    for name, (pkg, g, _, _) in PKGS.items():
        if name == "jax" and fused:
            continue
        g.enable()
        clean, _ = _fit(pkg, g, "adam", fused)
        rolled, st = _fit(pkg, g, "adam", fused, poison_at=2)
        g.disable()
        assert st["rollbacks"] == 1
        assert any(not np.allclose(clean[k], rolled[k], rtol=1e-4,
                                   atol=1e-6) for k in clean), name
        got[name] = rolled
    if not fused:
        for k in got["port"]:
            np.testing.assert_allclose(got["port"][k], got["jax"][k],
                                       rtol=1e-5, atol=1e-6)
