"""The port's async kvstore comm engine (``mxnet_tpu_torch.comm_engine``)
against the JAX package's on the cases of tests/test_comm_engine.py:
priority among ready ops, per-key FIFO, scoped waits, failures raised at
the barrier, the read guard, the env gate, training through the async
store bit-identical to the synchronous loop, ``backward_param_order``,
the bucketed wire over ``dist_async`` (values, bucket metrics, per-key
order across buckets, a bucket replayed whole after a dropped ACK, and
``maybe_async`` coalescing small keys), and the sparse plane bound to the
engine's chains."""

import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import comm_engine as jce
from mxnet_tpu_torch import comm_engine as tce

ENGINES = [jce, tce]
IDS = ["jax", "port"]


@pytest.mark.parametrize("ce", ENGINES, ids=IDS)
def test_engine_priority_ordering(ce):
    eng = ce.CommEngine(num_threads=1)
    try:
        order = []
        gate = threading.Event()
        eng.submit(lambda: gate.wait(5), ["gate"])  # parks the one worker
        eng.submit(lambda: order.append("low"), ["a"], priority=-5)
        eng.submit(lambda: order.append("mid"), ["b"], priority=0)
        eng.submit(lambda: order.append("high"), ["c"], priority=9)
        gate.set()
        eng.wait_all()
        assert order == ["high", "mid", "low"]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ce", ENGINES, ids=IDS)
def test_engine_per_key_fifo_beats_priority(ce):
    eng = ce.CommEngine(num_threads=4)
    try:
        order = []
        for i in range(30):
            eng.submit(lambda i=i: order.append(i), ["k"], priority=i % 7)
        eng.wait_all()
        assert order == list(range(30))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ce", ENGINES, ids=IDS)
def test_engine_wait_scoped_to_keys(ce):
    eng = ce.CommEngine(num_threads=2)
    try:
        gate = threading.Event()
        done = []
        eng.submit(lambda: (gate.wait(5), done.append("slow")), ["s"])
        eng.submit(lambda: done.append("fast"), ["f"])
        eng.wait(["f"])  # must NOT require the parked op to finish
        assert "fast" in done
        gate.set()
        eng.wait_all()
        assert done == ["fast", "slow"]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ce,pkg", list(zip(ENGINES, [mx, mt])), ids=IDS)
def test_engine_failure_raises_at_barrier_then_recovers(ce, pkg):
    eng = ce.CommEngine(num_threads=2)
    try:
        def boom():
            raise ValueError("kaput")
        eng.submit(boom, ["x"], label="comm.test")
        with pytest.raises(pkg.MXNetError, match="kaput"):
            eng.wait_all()
        eng.submit(lambda: None, ["x"])
        eng.wait_all()  # the engine stays usable after a surfaced failure
    finally:
        eng.shutdown()


@pytest.mark.parametrize("ce,pkg", list(zip(ENGINES, [mx, mt])), ids=IDS)
def test_read_guard_resolves_pending_pull(monkeypatch, ce, pkg):
    """Reading a pulled-into NDArray blocks until the pull lands."""
    kv = ce.make_async(pkg.kv.create("local"), num_threads=2, bucket_bytes=0)
    try:
        kv.init(3, pkg.nd.ones((4,), pkg.cpu()) * 5)
        inner, orig = kv.inner, kv.inner.pull

        def slow_pull(*a, **kw):
            time.sleep(0.2)  # the read happens mid-flight
            return orig(*a, **kw)

        monkeypatch.setattr(inner, "pull", slow_pull)
        out = pkg.nd.zeros((4,), pkg.cpu())
        kv.pull(3, out)
        np.testing.assert_array_equal(out.asnumpy(), np.full(4, 5.0))
        stats = kv.comm_stats()
        assert stats["pulls"] == 1
        assert stats["wait_calls"] >= 1
    finally:
        kv.close()


@pytest.mark.parametrize("ce,pkg", list(zip(ENGINES, [mx, mt])), ids=IDS)
def test_maybe_async_env_gate(monkeypatch, ce, pkg):
    kv = pkg.kv.create("local")
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "0")
    assert ce.maybe_async(kv) is kv
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "1")
    wrapped = ce.maybe_async(kv)
    try:
        assert isinstance(wrapped, ce.AsyncKVStore)
        assert ce.maybe_async(wrapped) is wrapped  # idempotent
        assert ce.maybe_async(None) is None
    finally:
        wrapped.close()


def test_sparse_plane_rides_the_engines_chains():
    """``sparse_plane()`` is built once and bound to the engine: a push
    waits behind a parked op on its ("sparse", key) chain, a pull observes
    it, and the rows equal the JAX package's plane's on the same pushes."""
    got = {}
    for ce, pkg in zip(ENGINES, [mx, mt]):
        with pkg.cpu():
            kv = ce.make_async(pkg.kv.create("dist_async"), num_threads=2)
        try:
            plane = kv.sparse_plane()
            assert kv.sparse_plane() is plane
            assert plane._engine is kv._engine and plane.rank == 0
            plane.init_table("emb", num_rows=50, row_shape=(3,),
                             init=("uniform", 0.1))
            gate = threading.Event()
            kv._engine.submit(lambda: gate.wait(5), [("sparse", "emb")])
            plane.push_rows("emb", [4, 9, 4],
                            np.ones((3, 3), np.float32))
            assert kv._engine.outstanding() == 2  # queued behind the gate
            gate.set()
            got[pkg] = plane.pull_rows("emb", np.array([4, 9, 11]))
            assert plane.table_info()[0]["emb"]["rows"] == 3
        finally:
            kv.close()
    assert got[mt].tobytes() == got[mx].tobytes()


# ---------------------------------------------------------------------------
# async vs sync training
# ---------------------------------------------------------------------------
def _mlp(pkg, k=3):
    sym = pkg.sym
    with pkg.NameManager():
        data = sym.Variable("data")
        net = sym.FullyConnected(data=data, num_hidden=16, name="fc1")
        net = sym.Activation(data=net, act_type="relu")
        net = sym.FullyConnected(data=net, num_hidden=k, name="fc2")
        return sym.SoftmaxOutput(data=net, name="softmax")


def _init(seed=5):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.randn(2, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(2, np.float32)}


def _train_weights(monkeypatch, pkg, async_on):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "1" if async_on else "0")
    rng = np.random.RandomState(11)
    X = rng.randn(120, 10).astype(np.float32)
    y = (rng.randn(120) > 0).astype(np.float32)
    train = pkg.io.NDArrayIter(X, y, batch_size=30, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg, 2), label_names=("softmax_label",),
                         context=pkg.cpu())
    # a KVStore instance keeps update_on_kvstore=True, so the update path
    # really goes push -> store updater -> pull
    kv = pkg.kv.create("local")
    mod.fit(train, num_epoch=3, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            arg_params={k: pkg.nd.array(v, pkg.cpu())
                        for k, v in _init().items()}, aux_params={})
    assert mod._update_on_kvstore
    assert isinstance(mod._kvstore, tce.AsyncKVStore if pkg is mt
                      else jce.AsyncKVStore) == async_on
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in sorted(args.items())}


def test_async_training_bit_identical_to_sync(monkeypatch):
    """Per-key FIFO plus the forward's wait make the async schedule
    numerically invisible; and the port trains as the JAX package does."""
    sync_w = _train_weights(monkeypatch, mt, async_on=False)
    async_w = _train_weights(monkeypatch, mt, async_on=True)
    assert sync_w.keys() == async_w.keys()
    for name in sync_w:
        assert np.array_equal(sync_w[name], async_w[name]), \
            "weights diverged for %s" % name
    jax_w = _train_weights(monkeypatch, mx, async_on=True)
    scale = max(np.abs(w).max() for w in jax_w.values())
    for name in jax_w:
        np.testing.assert_allclose(async_w[name], jax_w[name], rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("pkg", [mx, mt], ids=IDS)
def test_module_backward_param_order(pkg):
    mod = pkg.mod.Module(_mlp(pkg), label_names=("softmax_label",),
                         context=pkg.cpu())
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params()
    n = len(mod._exec_group.param_names)
    assert mod._exec_group.backward_param_order() == \
        list(range(n - 1, -1, -1))


def test_updates_launch_on_the_submitters_stream(monkeypatch):
    """A worker runs each op inside the stream scope captured at submit
    (here no CUDA array: an empty scope), so a CPU store never touches
    torch.cuda."""
    import torch

    called = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: called.append(a))
    kv = tce.make_async(mt.kv.create("local"))
    try:
        kv.init(0, mt.nd.ones((3,), mt.cpu()))
        kv.push(0, mt.nd.ones((3,), mt.cpu()) * 2)
        out = mt.nd.zeros((3,), mt.cpu())
        kv.pull(0, out)
        kv.wait_all()
        np.testing.assert_array_equal(out.asnumpy(), np.full(3, 2.0))
    finally:
        kv.close()
    assert called == []


# ---------------------------------------------------------------------------
# gradient bucketing over dist_async (the bucketed wire)
# ---------------------------------------------------------------------------
def _dist_async(pkg):
    with pkg.cpu():
        return pkg.kv.create("dist_async")


def _nd(pkg, x):
    return pkg.nd.array(np.asarray(x, np.float32), pkg.cpu())


@pytest.mark.parametrize("ce,pkg", list(zip(ENGINES, [mx, mt])), ids=IDS)
def test_bucketed_push_pull_values_and_metrics(ce, pkg):
    kv = ce.make_async(_dist_async(pkg), num_threads=4, bucket_bytes=1 << 16)
    try:
        n = 40
        for i in range(n):
            kv.init(i, pkg.nd.zeros((8,), pkg.cpu()))
        for i in range(n):
            kv.push(i, _nd(pkg, np.full(8, float(i))))
        outs = [pkg.nd.zeros((8,), pkg.cpu()) for _ in range(n)]
        for i in range(n):
            kv.pull(i, outs[i])
        kv.wait_all()
        for i in range(n):
            np.testing.assert_array_equal(outs[i].asnumpy(),
                                          np.full(8, float(i)))
        stats = kv.comm_stats()
        assert stats["pushes"] == n and stats["pulls"] == n
        assert stats["bucket_flushes"] >= 2  # a push and a pull bucket
        assert stats["bucket_keys"] >= 2 * n - 2
        assert 0.0 < stats["bucket_fill_ratio"] <= 1.0
        assert stats["bytes_pushed"] == stats["bytes_pulled"] == n * 8 * 4
        assert stats["queue_depth"] == 0 and stats["inflight_peak"] >= 1
        if pkg is mt:
            assert kv.inner.wire["push_items"] == n
            assert "mxtpu_comm_inflight_rpcs 0" in \
                kv.metrics.render_prometheus()
    finally:
        kv.close()


@pytest.mark.parametrize("ce,pkg", list(zip(ENGINES, [mx, mt])), ids=IDS)
def test_bucket_keeps_per_key_order_across_buckets(ce, pkg):
    """push(k); pull(k); push(k); pull(k) with every op buffered: each pull
    sees the pushes before it (the opposing bucket is flushed first)."""
    kv = ce.make_async(_dist_async(pkg), num_threads=4, bucket_bytes=1 << 20)
    try:
        kv.init(0, pkg.nd.zeros((4,), pkg.cpu()))
        kv.init(1, pkg.nd.zeros((4,), pkg.cpu()))
        a, b = (pkg.nd.zeros((4,), pkg.cpu()) for _ in range(2))
        kv.push(0, _nd(pkg, np.full(4, 3.0)))
        kv.push(1, _nd(pkg, np.full(4, 1.0)))
        kv.pull(0, a)
        kv.push(0, _nd(pkg, np.full(4, 2.0)))
        kv.pull(0, b)
        kv.wait_all()
        np.testing.assert_array_equal(a.asnumpy(), np.full(4, 3.0))
        np.testing.assert_array_equal(b.asnumpy(), np.full(4, 5.0))
    finally:
        kv.close()


@pytest.mark.parametrize("ce,pkg,faults", [
    (jce, mx, __import__("mxnet_tpu.faults").faults),
    (tce, mt, mt.faults)], ids=IDS)
def test_bucketed_push_survives_socket_loss(monkeypatch, ce, pkg, faults):
    """A bucket rides one idempotency token: a dropped ACK replays the
    fused envelope and every inner push applies once."""
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "40")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "20")
    with faults.inject("kv.client.recv:drop=1@#4") as plan:
        kv = ce.make_async(_dist_async(pkg), num_threads=2,
                           bucket_bytes=1 << 16)
        try:
            n = 20
            for i in range(n):
                kv.init(i, pkg.nd.zeros((8,), pkg.cpu()))
            for i in range(n):
                kv.push(i, _nd(pkg, np.full(8, float(i))))
            outs = [pkg.nd.zeros((8,), pkg.cpu()) for _ in range(n)]
            for i in range(n):
                kv.pull(i, outs[i])
            kv.wait_all()
            for i in range(n):
                np.testing.assert_array_equal(outs[i].asnumpy(),
                                              np.full(8, float(i)))
            assert kv.inner._server.applied_pushes == n
            assert plan.events == [("kv.client.recv", "drop", 4)]
        finally:
            kv.close()


def test_maybe_async_over_dist_async_buckets_small_keys(monkeypatch):
    """Module's policy hook wraps dist_async so that keys under the bucket
    size ride push_multi/pull_multi; a key over it goes alone."""
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "1")
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "256")
    kv = tce.maybe_async(_dist_async(mt))
    calls = []
    inner = kv.inner
    for name in ("push", "pull", "push_multi", "pull_multi"):
        real = getattr(inner, name)
        setattr(inner, name, lambda *a, _n=name, _r=real, **k:
                (calls.append(_n), _r(*a, **k))[1])
    try:
        for i in range(4):
            kv.init(i, mt.nd.zeros((8,), mt.cpu()))
        kv.init("big", mt.nd.zeros((100,), mt.cpu()))
        for i in range(4):
            kv.push(i, mt.nd.ones((8,), mt.cpu()))
        kv.push("big", mt.nd.ones((100,), mt.cpu()))
        outs = [mt.nd.zeros((8,), mt.cpu()) for _ in range(4)]
        for i in range(4):
            kv.pull(i, outs[i])
        kv.wait_all()
        assert sorted(calls) == ["pull_multi", "push", "push_multi"]
        stats = kv.comm_stats()
        assert stats["bucket_flushes"] == 2 and stats["bucket_keys"] == 8
        for o in outs:
            np.testing.assert_array_equal(o.asnumpy(), np.ones(8))
    finally:
        kv.close()
