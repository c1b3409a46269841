"""The port's ``dist_async`` store (``mxnet_tpu_torch.kvstore.
DistAsyncKVStore``) against the JAX package's (tests/test_kvstore_server.py,
tests/test_comm_engine.py): key placement, the range split over two
servers, fp16 wire compression's residual streams, the fused
``push_multi``/``pull_multi``, a push of values on several devices merged
before the wire, recovery bring-up, and ``Module`` over ``dist_async``
with the in-process server: three SGD-momentum steps of an MLP within
1e-5 of the largest parameter of the JAX package's (the tolerance of
tests/test_torch_optimizer.py), and the refusal under a multi-process
group.  Bitwise unless stated."""

import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import kvstore_server as jkvs
from mxnet_tpu_torch import kvstore_server as tkvs

WAIT = 20


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "40")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "20")
    for name in ("DMLC_PS_ROOT_URI", "DMLC_SERVER_URIS", "DMLC_IS_RECOVERY",
                 "DMLC_WORKER_ID", "DMLC_NUM_WORKER", "DMLC_NUM_SERVER",
                 "MXNET_KVSTORE_ELASTIC", "MXNET_KVSTORE_ELASTIC_JOIN",
                 "MXNET_KVSTORE_COMPRESS", "MXNET_KVSTORE_SYNC",
                 "MXNET_KVSTORE_BIGARRAY_BOUND"):
        monkeypatch.delenv(name, raising=False)


def start(kvs, **kw):
    if kvs is tkvs:
        kw.setdefault("ctx", mt.cpu())
    return kvs.start_server(**kw)


def fleet(monkeypatch, kvs, n, bound=None):
    """``n`` in-process servers of ``kvs`` and the env that points a
    worker at them."""
    servers = [start(kvs, num_workers=1) for _ in range(n)]
    monkeypatch.setenv("DMLC_SERVER_URIS", ",".join(
        "%s:%d" % s.addr for s in servers))
    if bound is not None:
        monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", str(bound))
    return servers


def stop_all(servers):
    for s in servers:
        s.stop()


def nd(pkg, x, ctx=None):
    return pkg.nd.array(np.asarray(x, np.float32), ctx or pkg.cpu())


def test_create_dist_async_in_process():
    with mt.cpu():
        kv = mt.kv.create("dist_async")
    try:
        assert isinstance(kv, mt.kvstore.DistAsyncKVStore)
        assert kv.type == "dist_async" and kv.rank == 0 and \
            kv.num_workers == 1
        assert kv._server.ctx == mt.cpu()
        kv.init(9, mt.nd.ones((2, 3), mt.cpu()))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1))
        kv.push(9, [mt.nd.ones((2, 3), mt.cpu())])
        out = mt.nd.zeros((2, 3), mt.cpu())
        kv.pull(9, out=out)
        np.testing.assert_allclose(out.asnumpy(), np.full((2, 3), 0.9),
                                   rtol=1e-6)
        assert kv.get_num_dead_node() == 0
        assert kv.membership()["ranks"] == []
        assert kv.wire == {"push_items": 1, "push_bytes": 24,
                           "pull_bytes": 24}
    finally:
        kv.close()


def test_key_placement_matches_jax(monkeypatch):
    servers = fleet(monkeypatch, tkvs, 3)
    try:
        jkv, tkv = mx.kv.create("dist_async"), mt.kv.create("dist_async")
        keys = list(range(40)) + ["w", "fc1_weight", "layer0_qkv_weight"]
        assert [tkv._server_for(k) for k in keys] == \
            [jkv._server_for(k) for k in keys]
        assert len({tkv._server_for(k) for k in keys}) == 3
        for n in (1, 2, 3, 10, 1000, 1000001, 65536000):
            assert tkv._ranges(n) == jkv._ranges(n)
        assert tkv._is_sharded(10 ** 6) and not tkv._is_sharded(10 ** 6 - 1)
        jkv.close()
        tkv.close()
    finally:
        stop_all(servers)


def range_split_run(monkeypatch, kvs, pkg):
    servers = fleet(monkeypatch, kvs, 2, bound=100)
    try:
        kv = pkg.kv.create("dist_async")
        big = np.arange(251, dtype=np.float32).reshape(251) * 0.5
        kv.init("big", nd(pkg, big))
        kv.init("small", nd(pkg, np.ones(4)))
        held = [s.store["big"].copy() for s in servers]
        holders = [i for i, s in enumerate(servers) if "small" in s.store]
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5,
                                           momentum=0.9))
        rng = np.random.RandomState(1)
        outs = []
        for _ in range(3):
            kv.push("big", nd(pkg, rng.randn(251)))
            kv.push("small", nd(pkg, rng.randn(4)))
            out, out_s = nd(pkg, np.zeros(251)), nd(pkg, np.zeros(4))
            kv.pull("big", out=out)
            kv.pull("small", out=out_s)
            outs += [out.asnumpy(), out_s.asnumpy()]
        kv.close()
        return held, holders, outs, [s.applied_pushes for s in servers]
    finally:
        stop_all(servers)


def test_range_split_over_two_servers_matches_jax(monkeypatch):
    ref = range_split_run(monkeypatch, jkvs, mx)
    got = range_split_run(monkeypatch, tkvs, mt)
    assert [h.size for h in got[0]] == [126, 125]
    assert got[1] == ref[1] and len(got[1]) == 1
    for a, b in zip(ref[0] + ref[2], got[0] + got[2]):
        assert a.tobytes() == b.tobytes()
    assert got[3] == ref[3]


def test_fp16_residual_streams_match_jax(monkeypatch):
    """Five pushes of a range-split key and a small one: what goes on the
    wire and the residual carried per (key, range start) are the JAX
    package's bits, and the servers integrate the decompressed pushes; the
    path a tensor on the card takes gives the same bits."""
    monkeypatch.setenv("MXNET_KVSTORE_COMPRESS", "fp16")
    rng = np.random.RandomState(3)
    pushes = [rng.randn(300).astype(np.float32) * 10 ** (i - 2)
              for i in range(5)]
    got = {}
    for name, kvs, pkg in (("jax", jkvs, mx), ("port", tkvs, mt)):
        servers = fleet(monkeypatch, kvs, 2, bound=200)
        try:
            kv = pkg.kv.create("dist_async")
            kv.init("g", nd(pkg, np.zeros(300)))
            kv.init("s", nd(pkg, np.zeros(5)))
            streams = []
            for p in pushes:
                kv.push("g", nd(pkg, p))
                kv.push("s", nd(pkg, p[:5]))
                streams.append([kv._residuals[k].copy() for k in
                                sorted(kv._residuals, key=str)])
            out = nd(pkg, np.zeros(300))
            kv.pull("g", out=out)
            got[name] = (streams, out.asnumpy(),
                         [s.store["g"].copy() for s in servers])
            kv.close()
        finally:
            stop_all(servers)
    for a, b in zip(got["jax"][0], got["port"][0]):
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert got["port"][1].tobytes() == got["jax"][1].tobytes()
    # the integral of the wire stream is the true sum within one fp16 step
    np.testing.assert_allclose(got["port"][1], np.sum(pushes, axis=0),
                               rtol=0, atol=np.abs(pushes[-1]).max() / 512)
    # the tensor path (taken on the card) gives the host path's bits
    import torch

    host = mt.kvstore.DistAsyncKVStore.__new__(mt.kvstore.DistAsyncKVStore)
    dev = mt.kvstore.DistAsyncKVStore.__new__(mt.kvstore.DistAsyncKVStore)
    for kv in (host, dev):
        kv._compress, kv._residuals = "fp16", {}
    for p in pushes:
        a = host._wire("k", p)
        b = dev._wire("k", torch.from_numpy(p.copy()))
        assert a.dtype == b.dtype == np.float16 and \
            a.tobytes() == b.tobytes()
        assert host._residuals["k"].tobytes() == \
            dev._residuals["k"].numpy().tobytes()


def test_push_multi_pull_multi_match_jax():
    shapes = [(3,), (2, 4), (5,), (1,)]
    got = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        with pkg.cpu():
            kv = pkg.kv.create("dist_async")
        try:
            for i, s in enumerate(shapes):
                kv.init(i, pkg.nd.zeros(s, pkg.cpu()))
            kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.25))
            kv.push_multi([(i, [nd(pkg, np.full(s, i + 1.5))])
                           for i, s in enumerate(shapes)])
            outs = [pkg.nd.zeros(s, pkg.cpu()) for s in shapes]
            kv.pull_multi([(i, [outs[i]]) for i in range(len(shapes))])
            got[name] = [o.asnumpy() for o in outs]
            if pkg is mt:
                assert kv.wire["push_items"] == len(shapes)
        finally:
            kv.close()
    for a, b in zip(got["jax"], got["port"]):
        assert a.tobytes() == b.tobytes()


def test_to_device_one_copy_then_split():
    import torch

    hosts = [np.arange(6, dtype=np.float32).reshape(2, 3),
             np.ones(4, np.float32)]
    moved = mt.kvstore.DistAsyncKVStore._to_device(hosts,
                                                   torch.device("cpu"))
    assert [tuple(m.shape) for m in moved] == [(2, 3), (4,)]
    assert moved[0].untyped_storage().data_ptr() == \
        moved[1].untyped_storage().data_ptr()  # one buffer, split
    for m, h in zip(moved, hosts):
        np.testing.assert_array_equal(m.numpy(), h)


def test_push_of_several_devices_is_merged_before_the_wire():
    with mt.cpu():
        kv = mt.kv.create("dist_async")
    try:
        kv.init(1, mt.nd.zeros((4, 4), mt.cpu()))
        kv.push(1, [mt.nd.ones((4, 4), mt.cpu(0)),
                    mt.nd.ones((4, 4), mt.cpu(1)) * 2])
        out = mt.nd.zeros((4, 4), mt.cpu())
        kv.pull(1, out)
        np.testing.assert_array_equal(out.asnumpy(), np.full((4, 4), 3.0))
        assert kv.wire["push_items"] == 1 and kv.wire["push_bytes"] == 64
    finally:
        kv.close()


def test_recovery_worker_skips_startup_barriers(monkeypatch):
    """A relaunched worker's init and set_optimizer do not wait at the
    startup barrier, do not clobber the trained value, and keep the live
    updater; its recovery flag survives bring-up pulls and expires at its
    first push (a later set_optimizer installs)."""
    srv = start(tkvs, num_workers=2)
    try:
        live, live2 = (tkvs.ServerClient(*srv.addr) for _ in range(2))
        t = threading.Thread(target=live2.barrier, kwargs={"rank": 0})
        t.start()
        live.barrier(rank=1)
        t.join(WAIT)
        live.init("w", np.zeros((4,), np.float32))
        live.set_optimizer(mt.optimizer.SGD(learning_rate=0.5))
        live.push("w", np.full((4,), -2.0, np.float32))
        updater = srv.updater
        monkeypatch.setenv("DMLC_PS_ROOT_URI", srv.addr[0])
        monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(srv.addr[1]))
        monkeypatch.setenv("DMLC_NUM_WORKER", "2")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        monkeypatch.setenv("DMLC_IS_RECOVERY", "1")
        kv = mt.kv.create("dist_async")
        done = {}

        def rejoin():
            kv.init("w", mt.nd.zeros((4,), mt.cpu()))
            out = mt.nd.zeros((4,), mt.cpu())
            kv.pull("w", out=out)
            done["recovery"] = kv._is_recovery
            kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1))
            done["w"] = out.asnumpy()

        t = threading.Thread(target=rejoin)
        t.start()
        t.join(WAIT)
        assert not t.is_alive(), "the recovery worker waited at a barrier"
        np.testing.assert_array_equal(done["w"], np.full((4,), 1.0))
        assert done["recovery"] and srv.updater is updater
        kv.push("w", mt.nd.ones((4,), mt.cpu()))
        assert not kv._is_recovery
        t = threading.Thread(target=live.barrier, kwargs={"rank": 1})
        t.start()  # a barrier a later set_optimizer meets
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.01))
        t.join(WAIT)
        assert srv.updater is not updater
        kv.close()
        live.close()
        live2.close()
    finally:
        srv.stop()


def test_unsupported_compression_raises(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_COMPRESS", "int8")
    with pytest.raises(mt.MXNetError, match="only 'fp16'"):
        with mt.cpu():
            mt.kv.create("dist_async")


# ---------------------------------------------------------------------------
# Module over dist_async
# ---------------------------------------------------------------------------
def mlp(pkg):
    with pkg.NameManager():
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data=data, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(data=net, act_type="relu")
        net = pkg.sym.FullyConnected(data=net, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def mlp_init():
    rng = np.random.RandomState(5)
    return {"fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.randn(3, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}


def module_steps(pkg, monkeypatch, async_engine):
    monkeypatch.setenv("MXNET_KVSTORE_ASYNC", "1" if async_engine else "0")
    rng = np.random.RandomState(11)
    X = rng.randn(24, 10).astype(np.float32)
    Y = rng.randint(0, 3, 24).astype(np.float32)
    mod = pkg.mod.Module(mlp(pkg), label_names=("softmax_label",),
                         context=pkg.cpu())
    mod.bind(data_shapes=[("data", (24, 10))],
             label_shapes=[("softmax_label", (24,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in mlp_init().items()},
                    aux_params={})
    with pkg.cpu():
        mod.init_optimizer(kvstore="dist_async", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-3})
    assert mod._update_on_kvstore
    batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                             [pkg.nd.array(Y, pkg.cpu())])
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
    args, _ = mod.get_params()
    kv = mod._kvstore
    out = {k: v.asnumpy() for k, v in args.items()}
    kv.close()
    return out, kv


def test_module_over_dist_async_matches_jax(monkeypatch):
    ref, _ = module_steps(mx, monkeypatch, True)
    got, kv = module_steps(mt, monkeypatch, True)
    plain, _ = module_steps(mt, monkeypatch, False)
    scale = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
        assert got[k].tobytes() == plain[k].tobytes(), k
        assert not np.allclose(got[k], mlp_init()[k]), k
    # the engine bucketed the small keys through push_multi/pull_multi
    stats = kv.comm_stats()
    assert stats["bucket_flushes"] >= 2 and stats["bucket_keys"] >= 8


def test_sync_rounds_barrier_between_pushes_and_pulls(monkeypatch):
    """Under MXNET_KVSTORE_SYNC=1 Module's update waits at a barrier after
    its pushes, so its pulls read the weights of the round it pushed to."""
    monkeypatch.setenv("MXNET_KVSTORE_SYNC", "1")
    calls = []
    with mt.cpu():
        kv = mt.kv.create("dist_async")
    try:
        assert kv.sync_rounds
        kv.init(0, mt.nd.zeros((2,), mt.cpu()))
        real = kv._barrier
        kv._barrier = lambda: (calls.append("barrier"), real())
        push, pull = kv.push, kv.pull
        kv.push = lambda *a, **k: (calls.append("push"), push(*a, **k))
        kv.pull = lambda *a, **k: (calls.append("pull"), pull(*a, **k))
        w, g = mt.nd.zeros((2,), mt.cpu()), mt.nd.ones((2,), mt.cpu())
        mt.model._update_params_on_kvstore([w], [g], kv)
        assert calls == ["push", "barrier", "pull"]
        np.testing.assert_array_equal(w.asnumpy(), np.ones(2))
    finally:
        kv.close()


def test_dist_async_under_a_process_group_raises(monkeypatch):
    """The JAX package's refusal: a multi-process group sums the
    gradients inside the step, and the server needs each worker's own."""
    monkeypatch.setattr(mt.kvstore_dist, "_world", lambda: 2)
    mod = mt.mod.Module(mlp(mt), label_names=("softmax_label",),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    assert mod._exec_group._multiprocess
    mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in mlp_init().items()},
                    aux_params={})
    with pytest.raises(mt.MXNetError, match="dist_mesh=False"):
        with mt.cpu():
            mod.init_optimizer(kvstore="dist_async")
