"""The port's ``BucketingModule``, ``SequentialModule``, ``PythonLossModule``
and ``Monitor`` against the JAX package's, on the CPU, from the same seeded
numpy inputs (mirrors tests/test_module.py::test_bucketing_module_lm_
convergence).

Parameters after 3 SGD steps from one init are held within 1e-4 of the
largest |parameter|; the monitor's rows by step and name exactly, their
statistics within 1e-6.
"""
import logging
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-4
V, E, H = 16, 6, 8


def _close(got, ref, tol=TOL):
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() <= tol * scale


def _same_params(got, ref, tol=TOL):
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k].asnumpy(), ref[k].asnumpy(), tol)


def _sentences(seed=0, n=64):
    rng = np.random.RandomState(seed)
    return [[int(v) for v in rng.randint(1, V, size=rng.randint(3, 11))]
            for _ in range(n)]


def _lm_sym_gen(pkg, fused):
    if fused:
        cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                    prefix="lstm_")
    else:
        cell = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            cell.add(pkg.rnn.LSTMCell(H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=V, output_dim=E,
                                  name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, H))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=V, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _iter(pkg, sents, seed=1):
    random.seed(seed)
    np.random.seed(seed)
    return pkg.rnn.BucketSentenceIter(sents, 4, buckets=[5, 10],
                                      invalid_label=0)


def _init_args(pkg, mod, seed=5):
    rng = np.random.RandomState(seed)
    ex = mod._curr_module._exec_group.execs[0]
    return {n: pkg.nd.array(rng.uniform(-0.3, 0.3, ex.arg_dict[n].shape)
                            .astype(np.float32), pkg.cpu())
            for n in sorted(mod._curr_module._param_names)}


def _bucketing(pkg, fused=False, steps=3, **kw):
    it = _iter(pkg, _sentences())
    mod = pkg.mod.BucketingModule(_lm_sym_gen(pkg, fused),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu(), **kw)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_init_args(pkg, mod), aux_params={})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5, "wd": 1e-5})
    keys = []
    for k, batch in enumerate(it):
        if k == steps:
            break
        keys.append(batch.bucket_key)
        mod.forward_backward(batch)
        mod.update()
    return mod, keys, it


@pytest.mark.parametrize("fused", [False, True])
def test_bucketing_module_matches_jax(fused):
    """Both buckets, shared parameters, the same bucket order; parameters
    after 3 SGD steps within 1e-4, then the same score."""
    got, gkeys, git = _bucketing(mt, fused)
    ref, rkeys, rit = _bucketing(mx, fused)
    assert gkeys == rkeys and len(set(gkeys)) == 2
    assert sorted(got._buckets) == sorted(ref._buckets) == [5, 10]
    _same_params(got.get_params()[0], ref.get_params()[0])
    a, b = got._buckets[5], got._buckets[10]
    for name in a._param_names:
        assert a._exec_group.execs[0].arg_dict[name] is \
            b._exec_group.execs[0].arg_dict[name]
    assert a._updater is b._updater
    scores = [m.score(_iter(pkg, _sentences()),
                      pkg.metric.Perplexity(ignore_label=0))[0][1]
              for m, pkg in ((got, mt), (ref, mx))]
    _close(scores[0], scores[1])


def test_bucketing_module_fixed_params():
    """fixed_param_names keep their values through the steps in both
    packages, the others match; the output names and data shapes follow
    the current bucket."""
    out = {}
    for pkg in (mt, mx):
        mod, _, _ = _bucketing(pkg, fixed_param_names=["pred_weight"])
        args = mod.get_params()[0]
        out[pkg] = args
        assert mod.output_names == ["softmax_output"]
        assert mod.data_shapes[0].shape[0] == 4
    init = _init_args(mt, _bucketing(mt, steps=0)[0])
    np.testing.assert_array_equal(out[mt]["pred_weight"].asnumpy(),
                                  init["pred_weight"].asnumpy())
    _same_params(out[mt], out[mx])


def test_bucketing_module_refuses_shared_module():
    mod = mt.mod.BucketingModule(_lm_sym_gen(mt, False), default_bucket_key=10,
                                 context=mt.cpu())
    other = mt.mod.BucketingModule(_lm_sym_gen(mt, False),
                                   default_bucket_key=10, context=mt.cpu())
    with pytest.raises(AssertionError):
        mod.bind([("data", (4, 10))], [("softmax_label", (4, 10))],
                 shared_module=other)


def test_bucketing_module_lm_convergence():
    """BucketingModule.fit on a learnable Markov corpus: perplexity falls
    below 0.7x the untrained model's, with a module per bucket."""
    rng = np.random.RandomState(0)
    vocab = 16
    trans = np.zeros((vocab, vocab))
    for i in range(vocab):
        trans[i, rng.choice(vocab, size=2, replace=False)] = \
            rng.dirichlet(np.ones(2))
    sents = []
    for _ in range(160):
        s = [int(rng.randint(vocab))]
        for _ in range(rng.randint(4, 13) - 1):
            s.append(int(rng.choice(vocab, p=trans[s[-1]])))
        sents.append(s)
    train = mt.rnn.BucketSentenceIter(sents, 8, buckets=[6, 12],
                                      invalid_label=0)
    cell = mt.rnn.LSTMCell(num_hidden=32, prefix="lstm_")

    def sym_gen(seq_len):
        embed = mt.sym.Embedding(data=mt.sym.Variable("data"),
                                 input_dim=vocab, output_dim=16, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.FullyConnected(mt.sym.Reshape(outputs, shape=(-1, 32)),
                                     num_hidden=vocab, name="pred")
        label = mt.sym.Reshape(mt.sym.Variable("softmax_label"), shape=(-1,))
        return (mt.sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
                ("data",), ("softmax_label",))

    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=train.default_bucket_key,
                                 context=mt.cpu())

    def perplexity():
        m = mt.metric.Perplexity(ignore_label=0)
        mod.score(train, m)
        return m.get()[1]

    mod.bind(data_shapes=train.provide_data, label_shapes=train.provide_label)
    mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                               magnitude=2.34))
    before = perplexity()
    train.reset()
    mod.fit(train, num_epoch=8, optimizer="adam",
            optimizer_params={"learning_rate": 0.01})
    assert perplexity() < before * 0.7
    assert len(mod._buckets) == 2


# ---------------------------------------------------------------------------
# SequentialModule and PythonLossModule
# ---------------------------------------------------------------------------


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.uniform(-0.4, 0.4, (12, 10)),
            "fc1_bias": rng.uniform(-0.1, 0.1, 12),
            "fc2_weight": rng.uniform(-0.4, 0.4, (4, 12)),
            "fc2_bias": rng.uniform(-0.1, 0.1, 4)}


def _chain(pkg, python_loss):
    """fc1 + relu, then fc2 + softmax (auto-wired, takes the labels), or fc2
    alone followed by a PythonLossModule whose gradient is the softmax
    cross-entropy's, at batch 8."""
    S = pkg.sym
    m1 = pkg.mod.Module(S.Activation(S.FullyConnected(
        S.Variable("data"), num_hidden=12, name="fc1"), act_type="relu"),
        label_names=None, context=pkg.cpu())
    fc2 = S.FullyConnected(S.Variable("hidden"), num_hidden=4, name="fc2")
    seq = pkg.mod.SequentialModule()
    seq.add(m1)
    if not python_loss:
        seq.add(pkg.mod.Module(S.SoftmaxOutput(fc2, name="softmax"),
                               data_names=("hidden",), context=pkg.cpu()),
                take_labels=True, auto_wiring=True)
        return seq

    def grad_func(scores, labels):
        s = scores.asnumpy()
        p = np.exp(s - s.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1.0
        return p

    seq.add(pkg.mod.Module(fc2, data_names=("hidden",), label_names=None,
                           context=pkg.cpu()), auto_wiring=True)
    seq.add(pkg.mod.PythonLossModule(data_names=("fc2_output",),
                                     grad_func=grad_func),
            take_labels=True, auto_wiring=True)
    return seq


def _prerun(pkg, seq, init):
    """Bind each module of the chain as ``SequentialModule.bind`` would and
    run one forward, so each has its ``output_shapes``: a ``Module`` gives
    them only after a forward, in both packages (a kept reference defect,
    see test_sequential_module_binds_only_modules_that_ran)."""
    shapes = [("data", (8, 10))]
    for i, (module, meta) in enumerate(zip(seq._modules, seq._metas)):
        labels = [("softmax_label", (8,))] if meta.get("take_labels") \
            else None
        if meta.get("auto_wiring"):
            shapes = [(n, s) for n, (_, s) in zip(module.data_names, shapes)]
        module.bind(shapes, labels, for_training=True,
                    inputs_need_grad=i > 0)
        module.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                       for k, v in init.items()},
                           aux_params={}, allow_missing=True)
        module.forward(pkg.io.DataBatch(
            data=[pkg.nd.zeros(s, pkg.cpu()) for _, s in shapes],
            label=[pkg.nd.zeros((8,), pkg.cpu())] if labels else None))
        shapes = module.output_shapes


@pytest.mark.parametrize("python_loss", [False, True])
def test_sequential_module_matches_jax(python_loss):
    """The chain's parameters after 3 SGD steps within 1e-4, its outputs
    and accuracy the same."""
    rng = np.random.RandomState(1)
    X = rng.randn(3, 8, 10).astype(np.float32)
    Y = rng.randint(0, 4, (3, 8)).astype(np.float32)
    init = _mlp_params()
    got = {}
    for pkg in (mx, mt):
        seq = _chain(pkg, python_loss)
        _prerun(pkg, seq, init)
        seq.bind(data_shapes=[("data", (8, 10))],
                 label_shapes=[("softmax_label", (8,))])
        seq.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in init.items()},
                        aux_params={}, allow_missing=True)
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        metric = pkg.metric.Accuracy()
        for b in range(3):
            batch = pkg.io.DataBatch(data=[pkg.nd.array(X[b], pkg.cpu())],
                                     label=[pkg.nd.array(Y[b], pkg.cpu())])
            seq.forward_backward(batch)
            seq.update()
            seq.update_metric(metric, batch.label)
        assert seq.output_shapes[0][1] == (8, 4)
        got[pkg] = (seq.get_params()[0], seq.get_outputs()[0].asnumpy(),
                    metric.get())
    _same_params(got[mt][0], got[mx][0])
    _close(got[mt][1], got[mx][1])
    assert got[mt][2] == got[mx][2]
    assert not np.allclose(got[mt][0]["fc1_weight"].asnumpy(),
                           init["fc1_weight"])


@pytest.mark.parametrize("pkg", [mx, mt], ids=["jax", "torch"])
def test_sequential_module_binds_only_modules_that_ran(pkg):
    """``Module.output_shapes`` is empty until a forward ran, so a chain of
    fresh modules cannot pass its shapes on: bind fails in both
    packages."""
    seq = _chain(pkg, False)
    with pytest.raises(AssertionError):
        seq.bind(data_shapes=[("data", (8, 10))],
                 label_shapes=[("softmax_label", (8,))])


def test_python_loss_module_needs_grad_func():
    loss = mt.mod.PythonLossModule()
    loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
    loss.forward(mt.io.DataBatch(data=[mt.nd.zeros((2, 3), mt.cpu())],
                                 label=[mt.nd.zeros((2,), mt.cpu())]))
    assert loss.output_shapes == [("pyloss_output", (2, 3))]
    with pytest.raises(NotImplementedError):
        loss.backward()


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


def _mlp_module(pkg):
    S = pkg.sym
    with pkg.NameManager():
        net = S.SoftmaxOutput(S.FullyConnected(S.Activation(S.FullyConnected(
            S.Variable("data"), num_hidden=12, name="fc1"), act_type="relu",
            name="relu1"), num_hidden=4, name="fc2"), name="softmax")
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in _mlp_params().items()},
                    aux_params={})
    return mod


def _rows_close(got, ref):
    assert [(n, k) for n, k, _ in got] == [(n, k) for n, k, _ in ref]
    for (_, _, g), (_, _, r) in zip(got, ref):
        g, r = (np.array([float(v) for v in
                          s.replace("[", " ").replace("]", " ").split()])
                for s in (g, r))
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_monitor_matches_jax():
    """An explicit forward hands every node output to the monitor; toc adds
    the arguments.  Rows by step and name the JAX package's, sorted and
    filtered by pattern, statistics within 1e-6."""
    rng = np.random.RandomState(2)
    X = rng.randn(8, 10).astype(np.float32)
    Y = rng.randint(0, 4, 8).astype(np.float32)
    rows = {}
    for pkg in (mx, mt):
        mod = _mlp_module(pkg)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        mon = pkg.monitor.Monitor(1, pattern="fc.*|relu.*|softmax.*",
                                  sort=True)
        mod.install_monitor(mon)
        assert not mod._fused_ok
        batch = pkg.io.DataBatch(data=[pkg.nd.array(X, pkg.cpu())],
                                 label=[pkg.nd.array(Y, pkg.cpu())])
        got = []
        for _ in range(2):
            mon.tic()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            got += mon.toc()
        mon2 = pkg.monitor.Monitor(2, stat_func=lambda x: x * 1.0,
                                   pattern="fc2_bias")
        mon2.install(mod._exec_group.execs[0])
        for _ in range(3):
            mon2.tic()
            got += mon2.toc()
        rows[pkg] = got
    names = [k for _, k, _ in rows[mt]]
    assert "relu1_output" in names and "fc2_bias" in names
    assert "data" not in names and "fc1_weight" not in names
    _rows_close(rows[mt], rows[mx])


def test_fit_and_feedforward_take_the_monitor(caplog):
    """fit(monitor=) installs the monitor and ticks it every batch, and
    FeedForward.fit passes it on.  It logs no row in either package: the
    executor group sets the callback without ``Monitor.install``, so toc
    sees no arguments, and the step fit runs (forward_backward) hands no
    node outputs (a kept reference defect)."""
    rng = np.random.RandomState(3)
    X = rng.randn(16, 10).astype(np.float32)
    Y = rng.randint(0, 4, 16).astype(np.float32)
    logs = {}
    for pkg in (mx, mt):
        it = pkg.io.NDArrayIter(X, Y, batch_size=8)
        mod = _mlp_module(pkg)
        mon = pkg.monitor.Monitor(1, pattern="fc1_.*")
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.fit(it, num_epoch=1, monitor=mon,
                    optimizer_params={"learning_rate": 0.1})
        logs[pkg] = [r.getMessage().split()[:3] for r in caplog.records
                     if r.getMessage().startswith("Batch:")]
        assert mon.step == 2
    assert logs[mt] == logs[mx] == []
    ff = mt.model.FeedForward(_mlp_module(mt).symbol, ctx=mt.cpu(),
                              num_epoch=1, learning_rate=0.1)
    mon = mt.monitor.Monitor(1, pattern="fc2_weight")
    ff.fit(mt.io.NDArrayIter(X, Y, batch_size=8), monitor=mon)
    assert mon.step == 2
