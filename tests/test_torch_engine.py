"""The NaiveEngine (``MXNET_ENGINE_TYPE=NaiveEngine``) in the port; the
counterpart of ``tests/test_engine.py``, held against the JAX package.

The reference's dependency-engine harness (tests/cpp/
threaded_engine_test.cc:19-40) replays random read/write workloads on
every engine beside a serial oracle.  Here the default engine is the
device's asynchronous queue, and the NaiveEngine synchronizes after every
op (``nd._invoke``) and every node of the executor's plan, and bypasses the
compile cache.  Held:

* the imperative workload (in-place writes, read-write of one array)
  against a numpy serial oracle and the JAX package, under both engines,
  within the JAX test's 1e-5 relative / 1e-6 absolute;
* the executor's forward and backward of a random graph: the NaiveEngine
  gives the default engine's bits, and the JAX package's NaiveEngine
  oracle within its test's 1e-4 / 1e-5;
* no compile-cache entry is made under the NaiveEngine, with
  ``MXNET_COMPILE_CACHE_DIR`` set (the default engine makes some);
* an op that raises under the NaiveEngine names itself (the op for
  ``nd``, the node and its op for the executor).
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


def _imperative(pkg, seed, backend):
    """The JAX test's random op sequence on the nd path of ``pkg`` (or on
    numpy, the serial oracle); the final pool."""
    rng = np.random.RandomState(seed)
    init = [rng.randn(4, 5).astype(np.float32) for _ in range(4)]
    if backend == "nd":
        pool = [pkg.nd.array(a, pkg.cpu()) for a in init]
        dot, tanh = pkg.nd.dot, pkg.nd.tanh
    else:
        pool = [a.copy() for a in init]
        dot, tanh = np.dot, np.tanh
    for _ in range(30):
        op = rng.randint(6)
        i, j = rng.randint(len(pool)), rng.randint(len(pool))
        if op == 0:
            pool[i] = pool[i] + pool[j]
        elif op == 1:
            pool[i] = pool[i] * 0.5 + pool[j] * 0.25
        elif op == 2:
            pool[i][:] = pool[j]
        elif op == 3:
            pool[i] += pool[j]
        elif op == 4:
            pool[i] = dot(dot(pool[i], pool[j].T), pool[j])
        else:
            pool[i] = tanh(pool[j])
    return [a.asnumpy() if backend == "nd" else a for a in pool]


def _graph(pkg, seed):
    """Forward and backward of the JAX test's random small graph."""
    rng = np.random.RandomState(seed)
    with pkg.NameManager():
        net = pkg.sym.Variable("data")
        for k in range(rng.randint(2, 4)):
            h = int(rng.randint(3, 8))
            net = pkg.sym.FullyConnected(net, num_hidden=h, name="fc%d" % k)
            act = ["relu", "tanh", "sigmoid"][rng.randint(3)]
            net = pkg.sym.Activation(net, act_type=act)
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            net, num_hidden=3, name="fco"), name="softmax")
    shapes = {"data": (5, 6), "softmax_label": (5,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    r2 = np.random.RandomState(seed + 1)
    ctx = pkg.cpu()
    args = {name: pkg.nd.array(r2.randn(*shp).astype(np.float32) * 0.4, ctx)
            for name, shp in zip(net.list_arguments(), arg_shapes)}
    args["softmax_label"] = pkg.nd.array(
        (np.arange(5) % 3).astype(np.float32), ctx)
    grads = {n: pkg.nd.zeros(s, ctx) for n, s in zip(net.list_arguments(),
                                                     arg_shapes)
             if n not in shapes}
    ex = net.bind(ctx, args, args_grad=grads)
    ex.forward(is_train=True)
    ex.backward()
    out = {"out": ex.outputs[0].asnumpy()}
    out.update({k: v.asnumpy() for k, v in ex.grad_dict.items()})
    return out, ex


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engines_match_serial_numpy_oracle(seed, monkeypatch):
    oracle = _imperative(None, seed, "np")
    ref = _imperative(mx, seed, "nd")
    for engine in (None, "NaiveEngine"):
        if engine:
            monkeypatch.setenv("MXNET_ENGINE_TYPE", engine)
        got = _imperative(mt, seed, "nd")
        for a, b, r in zip(got, oracle, ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_executor_naive_matches_default_and_jax_oracle(seed, monkeypatch):
    fast, ex_fast = _graph(mt, seed)
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    slow, ex_slow = _graph(mt, seed)
    oracle, _ = _graph(mx, seed)
    assert not ex_fast._naive and ex_slow._naive
    assert fast.keys() == slow.keys() == oracle.keys()
    for k in fast:
        np.testing.assert_array_equal(fast[k], slow[k], err_msg=k)
        np.testing.assert_allclose(slow[k], oracle[k], rtol=1e-4, atol=1e-5,
                                   err_msg="engine/oracle divergence at %s"
                                   % k)


def _train_small(tmp_path, monkeypatch, engine):
    from mxnet_tpu_torch import compile_cache

    d = str(tmp_path / ("cache_%s" % engine))
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", d)
    if engine == "naive":
        monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    else:
        monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    compile_cache.reset_stats()
    rng = np.random.RandomState(0)
    X = rng.randn(8, 6).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32)
    with mt.NameManager():
        net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=2, name="fc"),
            name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mt.random.seed(0)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                            [mt.nd.array(Y, mt.cpu())])
    for _ in range(2):
        mod.forward_backward(batch)
        mod.update()
    mod.forward(batch, is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    args, _ = mod.get_params()
    files = [f for _, _, fs in os.walk(d) for f in fs] \
        if os.path.isdir(d) else []
    stats = compile_cache.stats()
    compile_cache.reset_stats()
    return out, {k: v.asnumpy() for k, v in args.items()}, files, stats


def test_naive_engine_makes_no_cache_entry(tmp_path, monkeypatch):
    """The same steps and inference forward: the default engine writes
    compile-cache entries, the NaiveEngine writes none and counts no
    lookup, and both give the same bits."""
    out, args, files, stats = _train_small(tmp_path, monkeypatch, "default")
    n_out, n_args, n_files, n_stats = _train_small(tmp_path, monkeypatch,
                                                   "naive")
    assert files and stats["stores"] > 0
    assert n_files == [] and n_stats["stores"] == 0
    assert n_stats["hits"] == 0 and n_stats["misses"] == 0
    np.testing.assert_array_equal(n_out, out)
    for k in args:
        np.testing.assert_array_equal(n_args[k], args[k])


def test_naive_engine_errors_name_the_op(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    a = mt.nd.array(np.ones((2, 3), np.float32), mt.cpu())
    b = mt.nd.array(np.ones((4, 5), np.float32), mt.cpu())
    with pytest.raises(MXNetError, match="op dot"):
        mt.nd.dot(a, b)

    class Boom(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise ValueError("boom")

    @mt.operator.register("engine_boom")
    class BoomProp(mt.operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, in_shape, []

        def create_operator(self, ctx, shapes, dtypes):
            return Boom()

    net = mt.sym.Custom(mt.sym.Variable("data"), op_type="engine_boom",
                        name="kaboom")
    ex = net.bind(mt.cpu(), {"data": a})
    with pytest.raises(MXNetError, match="node kaboom \\(op Custom\\)"):
        ex.forward()
