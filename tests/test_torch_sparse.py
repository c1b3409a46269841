"""The port's sparse plane (``mxnet_tpu_torch.sparse``, the servers' row
plane) against the JAX package's (tests/test_sparse.py), case by case on
the same seeded numpy inputs:

* ``RowSparseArray``/``row_merge`` and ``embedding_row_sparse_grad``
  (bitwise, and the port's sparse gradient bitwise its dense Embedding
  gradient);
* the row commands: a dropped ACK applied once, ``row % num_servers``
  sharding, lazy rows byte-equal to the JAX server's for every init kind,
  the updaters bit-exact with the JAX package's, ``from_dense_optimizer``,
  the v4 snapshot round trip, the sync rounds' shrink renormalisation;
* ``SparseEmbeddingModule`` against a dense ``Module`` (bitwise, within the
  port), a small DLRM against the JAX package's (float32 tolerance below),
  and two port server processes with one SIGKILLed and restarted from its
  snapshot (bitwise against an uninterrupted run);
* ``python -m mxnet_tpu_torch.tools.kvstore_admin`` against the JAX tool
  on one port fleet, and each package refusing the other's sparse updater
  and snapshot.

Run as a script (``test_torch_sparse.py HOST PORT SNAPSHOT``) this file is
a port server process of the kill test; it imports no JAX then."""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import mxnet_tpu_torch as _mt
    from mxnet_tpu_torch import kvstore_server as _kvs

    _kvs.KVStoreServer(sys.argv[1], int(sys.argv[2]), num_workers=1,
                       snapshot_path=sys.argv[3], snapshot_interval=0,
                       ctx=_mt.cpu()).serve_forever()
    sys.exit(0)

import importlib.util  # noqa: E402
import json  # noqa: E402
import pickle  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import tracemalloc  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu import kvstore_server as jkvs  # noqa: E402
from mxnet_tpu import sparse as jsparse  # noqa: E402
from mxnet_tpu.io import DataBatch as JBatch  # noqa: E402
from mxnet_tpu.ops.indexing import \
    embedding_row_sparse_grad as j_rsg  # noqa: E402
from mxnet_tpu.sparse import updaters as jupd  # noqa: E402
from mxnet_tpu.sparse.plane import SparseParamPlane as JPlane  # noqa: E402
from mxnet_tpu_torch import faults as tfaults  # noqa: E402
from mxnet_tpu_torch import kvstore_server as tkvs  # noqa: E402
from mxnet_tpu_torch import sparse as tsparse  # noqa: E402
from mxnet_tpu_torch.io import DataBatch as TBatch  # noqa: E402
from mxnet_tpu_torch.ops.indexing import \
    embedding_row_sparse_grad as t_rsg  # noqa: E402
from mxnet_tpu_torch.sparse import updaters as tupd  # noqa: E402
from mxnet_tpu_torch.sparse.plane import \
    SparseParamPlane as TPlane  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 30  # seconds: the bound of every wait on a process


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "40")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "20")
    for name in ("DMLC_PS_ROOT_URI", "DMLC_SERVER_URIS", "DMLC_IS_RECOVERY",
                 "MXNET_KVSTORE_ELASTIC", "MXNET_KVSTORE_COMPRESS",
                 "MXNET_KVSTORE_SYNC", "DMLC_ROLE"):
        monkeypatch.delenv(name, raising=False)


def fleet(kvs, n, **kw):
    """``n`` in-process servers of ``kvs`` (the port's on the CPU), their
    clients and a plane over them."""
    if kvs is tkvs:
        kw.setdefault("ctx", mt.cpu())
    srvs = [kvs.start_server(port=0, **kw) for _ in range(n)]
    clients = [kvs.ServerClient(*s.addr) for s in srvs]
    plane = (TPlane if kvs is tkvs else JPlane)(clients)
    return srvs, clients, plane


def stop(clients):
    for c in clients:
        try:
            c.stop_server()
        except Exception:
            pass
        c.close()


PKGS = {"jax": (jkvs, jupd), "port": (tkvs, tupd)}


def both(case):
    """``case(kvs, upd)`` through each package; returns {name: result}."""
    return {name: case(*side) for name, side in PKGS.items()}


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# row-sparse values and the Embedding gradient
# ---------------------------------------------------------------------------
def test_row_sparse_array_roundtrip_and_merge_match_jax():
    dense = np.zeros((10, 3), np.float32)
    dense[2], dense[7] = 1.0, 2.0
    for pkg in (jsparse, tsparse):
        rs = pkg.RowSparseArray.from_dense(dense)
        assert rs.stype == "row_sparse" and rs.nnz == 2
        assert same_bytes(rs.to_dense(), dense)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, 64)
    vals = rng.randn(64, 5).astype(np.float32)
    ji, jv = jsparse.row_merge(ids, vals)
    ti, tv = tsparse.row_merge(ids, vals)
    assert same_bytes(ji, ti) and same_bytes(jv, tv)
    a = tsparse.RowSparseArray([7, 2, 7], np.ones((3, 3), np.float32),
                               (10, 3))
    b = jsparse.RowSparseArray([7, 2, 7], np.ones((3, 3), np.float32),
                               (10, 3))
    assert same_bytes(a.indices, b.indices) and same_bytes(a.values,
                                                           b.values)
    assert same_bytes((a + a).values, (b + b).values)
    with pytest.raises(IndexError):
        tsparse.RowSparseArray([10], np.ones((1, 3), np.float32), (10, 3))


def test_embedding_grad_is_o_touched_rows_and_matches_jax():
    vocab, dim = 1_000_000, 8
    ids = np.array([[5, 999_999, 5, 123_456]], np.int64)
    og = np.random.RandomState(0).randn(1, 4, dim).astype(np.float32)
    tracemalloc.start()
    g = t_rsg(ids, og, vocab)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert g.shape == (vocab, dim) and g.values.shape[0] == 3
    assert peak < 2 << 20, "grad path allocated %d bytes" % peak
    j = j_rsg(ids, og, vocab)
    assert same_bytes(g.indices, j.indices) and same_bytes(g.values,
                                                           j.values)


def test_embedding_grad_matches_the_ports_dense_gradient_bit_exact():
    vocab, dim = 10, 4
    # each id at most twice: a 2-term sum is order-independent
    idx = np.array([1.0, 3.0, 1.0, 7.0, 5.0, 3.0], np.float32)
    weight = np.random.RandomState(1).randn(vocab, dim).astype(np.float32)
    og = np.random.RandomState(2).randn(6, dim).astype(np.float32)
    with mt.cpu():
        s = mt.sym.Embedding(data=mt.sym.Variable("data"),
                             weight=mt.sym.Variable("weight"),
                             input_dim=vocab, output_dim=dim)
        gbuf = mt.nd.zeros((vocab, dim))
        exe = s.bind(mt.cpu(), {"data": mt.nd.array(idx),
                                "weight": mt.nd.array(weight)},
                     args_grad={"weight": gbuf},
                     grad_req={"weight": "write", "data": "null"})
        exe.forward(is_train=True)
        exe.backward([mt.nd.array(og)])
    dense_g = gbuf.asnumpy()
    sparse_g = t_rsg(idx, og, vocab)
    assert sparse_g.to_dense().tobytes() == dense_g.tobytes()
    assert sparse_g.to_dense().tobytes() == \
        j_rsg(idx, og, vocab).to_dense().tobytes()


# ---------------------------------------------------------------------------
# the row commands
# ---------------------------------------------------------------------------
def test_push_rows_replay_exactly_once():
    """A push_rows whose ACK is dropped is replayed under its token and
    applied once."""
    srv = tkvs.start_server(num_workers=1, ctx=mt.cpu())
    try:
        ids = np.array([3, 9], np.int64)
        vals = np.full((2, 4), 5.0, np.float32)
        # client recv #1 is the init_table ACK, #2 the push_rows ACK
        with tfaults.inject("kv.client.recv:drop=1@#2") as plan:
            with tkvs.ServerClient(*srv.addr) as c:
                c.init_table("t", {"num_rows": 100, "row_shape": (4,),
                                   "init": ("zeros",)})
                c.push_rows("t", ids, vals)
                out = c.pull_rows("t", ids)
            assert plan.events == [("kv.client.recv", "drop", 2)]
        assert same_bytes(out, vals)
        assert srv.applied_row_pushes == 1
    finally:
        srv.stop()


def test_two_server_sharding_matches_jax():
    """Row r lives on server r % 2; each shard holds its half, pulls
    reassemble, and both packages' fleets answer alike."""
    ids = np.arange(100, dtype=np.int64)
    vals = np.stack([np.full(2, float(i), np.float32) for i in ids])

    def case(kvs, upd):
        _srvs, clients, plane = fleet(kvs, 2)
        try:
            plane.init_table("emb", num_rows=1000, row_shape=(2,),
                             init=("zeros",))
            plane.push_rows("emb", ids, vals)
            plane.wait("emb")
            got = plane.pull_rows("emb", ids)
            infos = plane.table_info()
            return got, [(i["emb"]["rows"], i["emb"]["misplaced"])
                         for i in infos]
        finally:
            stop(clients)

    got = both(case)
    assert same_bytes(got["port"][0], vals)
    assert same_bytes(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1] == [(50, 0), (50, 0)]


@pytest.mark.parametrize("init", [("zeros",), ("constant", 0.25),
                                  ("uniform", 0.1), ("normal", 0.02),
                                  ("uniform",), ("normal",)])
def test_lazy_rows_byte_equal_to_the_jax_server(init):
    """Untouched rows come from a generator seeded by (key, row) only:
    byte-equal to the JAX server's, for one and two servers, in any pull
    order, and stable on a second pull."""
    ids = np.array([7, 3, 11, 0, 123456], np.int64)

    def case(kvs, upd, n):
        _srvs, clients, plane = fleet(kvs, n)
        try:
            plane.init_table(("emb", 1), num_rows=200000, row_shape=(3, 5),
                             init=init)
            first = plane.pull_rows(("emb", 1), ids)
            again = plane.pull_rows(("emb", 1), ids[::-1])
            return first, again
        finally:
            stop(clients)

    ref, ref_again = case(jkvs, jupd, 1)
    assert same_bytes(ref_again, ref[::-1])
    for n in (1, 2):
        got, again = case(tkvs, tupd, n)
        assert same_bytes(got, ref), n
        assert same_bytes(again, ref[::-1])
    if init[0] in ("uniform", "normal"):
        assert ref.std() > 0


def _updater_pairs():
    return [(jupd.SparseSGD(learning_rate=0.5, momentum=0.9),
             tupd.SparseSGD(learning_rate=0.5, momentum=0.9)),
            (jupd.SparseSGD(learning_rate=0.3, wd=0.01, rescale_grad=0.5),
             tupd.SparseSGD(learning_rate=0.3, wd=0.01, rescale_grad=0.5)),
            (jupd.SparseAdaGrad(learning_rate=0.5, eps=1e-7, wd=0.001),
             tupd.SparseAdaGrad(learning_rate=0.5, eps=1e-7, wd=0.001)),
            (jupd.get_sparse_updater("adagrad", learning_rate=0.1),
             tupd.get_sparse_updater("adagrad", learning_rate=0.1))]


@pytest.mark.parametrize("pair", range(4))
def test_updaters_bit_exact_with_jax(pair):
    """The same pushes through each package's fleet and updater: the same
    rows, bit for bit; and update_rows alone on the same arrays."""
    jup, tup = _updater_pairs()[pair]
    rng = np.random.RandomState(3 + pair)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    ids = np.array([1, 5, 9], np.int64)

    def case(kvs, upd):
        _srvs, clients, plane = fleet(kvs, 2)
        try:
            plane.init_table("t", num_rows=20, row_shape=(4,),
                             init=("uniform", 0.05))
            plane.set_sparse_optimizer(jup if kvs is jkvs else tup)
            for g in grads:
                plane.push_rows("t", ids, g)
            plane.wait("t")
            return plane.pull_rows("t", ids), plane.table_info()
        finally:
            stop(clients)

    got = both(case)
    assert same_bytes(got["port"][0], got["jax"][0])
    assert [i["t"]["state_rows"] for i in got["port"][1]] == \
        [i["t"]["state_rows"] for i in got["jax"][1]]
    w = rng.randn(3, 4).astype(np.float32)
    sj = np.abs(rng.randn(3, 4)).astype(np.float32)
    wt, st = w.copy(), sj.copy()
    shape = tup.state_shape((4,))
    assert shape == jup.state_shape((4,))
    jup.update_rows(w, grads[0], sj if shape else None)
    tup.update_rows(wt, grads[0], st if shape else None)
    assert same_bytes(w, wt) and same_bytes(sj, st)


def test_from_dense_optimizer_maps_the_ports_optimizers():
    cases = [("SGD", dict(learning_rate=0.25, wd=0.01, momentum=0.9,
                          rescale_grad=0.125)),
             ("AdaGrad", dict(learning_rate=0.1, wd=0.002,
                              rescale_grad=0.5)),
             ("NAG", dict(learning_rate=0.2, momentum=0.9)),
             ("Adam", dict(learning_rate=0.01))]
    for name, kw in cases:
        t = tupd.from_dense_optimizer(getattr(mt.optimizer, name)(**kw))
        j = jupd.from_dense_optimizer(getattr(mx.optimizer, name)(**kw))
        assert type(t).__name__ == type(j).__name__
        assert vars(t) == vars(j), name
    upd = tupd.from_dense_optimizer(mt.optimizer.SGD(
        learning_rate=0.25, wd=0.01, momentum=0.9, rescale_grad=0.125))
    assert isinstance(upd, tupd.SparseSGD)
    assert (upd.lr, upd.wd, upd.momentum, upd.rescale_grad) == \
        (0.25, 0.01, 0.9, 0.125)
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        tupd.get_sparse_updater("lamb")


def test_snapshot_v4_roundtrip_restores_tables_bit_exact(tmp_path):
    snap = str(tmp_path / "kv.snap")
    ids = np.array([2, 3, 8], np.int64)
    g = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    srv1 = tkvs.start_server(port=0, snapshot_path=snap,
                             snapshot_interval=0, ctx=mt.cpu())
    c1 = tkvs.ServerClient(*srv1.addr)
    c1.init_table("t", {"num_rows": 100, "row_shape": (4,),
                        "init": ("uniform", 0.05)})
    c1.set_sparse_optimizer(tupd.SparseAdaGrad(learning_rate=0.1))
    c1.push_rows("t", ids, g)
    before = c1.pull_rows("t", ids)
    assert c1.snapshot() == snap
    with open(snap, "rb") as f:
        state = pickle.load(f)
    assert state["version"] == 4 and state["applied_row_pushes"] == 1
    assert set(state["tables"]["t"]["rows"]) == {2, 3, 8}
    srv2 = tkvs.start_server(port=0, snapshot_path=snap,
                             snapshot_interval=0, ctx=mt.cpu())
    c2 = tkvs.ServerClient(*srv2.addr)
    try:
        assert srv2.restored
        assert srv2.applied_row_pushes == srv1.applied_row_pushes == 1
        assert same_bytes(c2.pull_rows("t", ids), before)
        c1.push_rows("t", ids, g)
        c2.push_rows("t", ids, g)
        assert same_bytes(c1.pull_rows("t", ids), c2.pull_rows("t", ids))
        info = c2.table_info()["t"]
        assert info["rows"] == 3 and info["state_rows"] == 3
        assert c2.stats()["applied_row_pushes"] == 2
    finally:
        stop([c1, c2])


def test_sync_sparse_rounds_shrink_renormalizes_as_jax():
    """Sparse pushes merge per round like dense ones; a 2-of-3 round after
    a leave applies num_workers/len(round) times the merged rows, and a
    departed rank's push is discarded; both packages alike."""
    ids = np.array([0, 1, 2], np.int64)
    ones = np.ones((3, 2), np.float32)

    def case(kvs, upd):
        kw = {"ctx": mt.cpu()} if kvs is tkvs else {}
        srv = kvs.start_server(num_workers=3, sync_mode=True, **kw)
        out = []
        try:
            clients = [kvs.ServerClient(*srv.addr) for _ in range(3)]
            for r, c in enumerate(clients):
                c.join(r)
            clients[0].init_table("t", {"num_rows": 10, "row_shape": (2,),
                                        "init": ("zeros",)})
            for r in (0, 1, 2):
                clients[r].push_rows("t", ids, ones, rank=r)
            out.append(clients[0].pull_rows("t", ids))
            clients[2].leave(2)
            for r in (0, 1):
                clients[r].push_rows("t", ids, ones, rank=r)
            out.append(clients[0].pull_rows("t", ids))
            clients[2].push_rows("t", ids,
                                 np.full((3, 2), 100.0, np.float32), rank=2)
            for r in (0, 1):
                clients[r].push_rows("t", ids, ones, rank=r)
            out.append(clients[0].pull_rows("t", ids))
            out.append(dict(srv.round_sizes))
            for c in clients:
                c.close()
            return out
        finally:
            srv.stop()

    got = both(case)
    for want, a, b in zip((3.0, 6.0, 9.0), got["port"], got["jax"]):
        assert same_bytes(a, np.full((3, 2), want, np.float32))
        assert same_bytes(a, b)
    assert got["port"][3] == got["jax"][3] == {3: 1, 2: 2}


def test_eviction_scrubs_a_pending_sparse_round():
    """A member's partial contribution leaves with it: evicting the rank a
    round waits on flushes the survivors' rows, renormalized."""
    srv = tkvs.start_server(num_workers=2, sync_mode=True, ctx=mt.cpu())
    try:
        a, b = (tkvs.ServerClient(*srv.addr) for _ in range(2))
        a.join(0)
        b.join(1)
        a.init_table("t", {"num_rows": 4, "row_shape": (2,),
                           "init": ("zeros",)})
        a.push_rows("t", [1], np.ones((1, 2), np.float32), rank=0)
        assert same_bytes(a.pull_rows("t", [1]), np.zeros((1, 2),
                                                          np.float32))
        a.evict(1)
        assert same_bytes(a.pull_rows("t", [1]),
                          np.full((1, 2), 2.0, np.float32))
        a.close()
        b.close()
    finally:
        srv.stop()


def test_push_rows_nack_on_non_finite_rows():
    srv = tkvs.start_server(num_workers=1, ctx=mt.cpu())
    try:
        with tkvs.ServerClient(*srv.addr) as c:
            c.init_table("t", {"num_rows": 4, "row_shape": (2,),
                               "init": ("zeros",)})
            bad = np.array([[1.0, np.nan]], np.float32)
            with pytest.raises(tkvs.NonFiniteGradientError):
                c.push_rows("t", [2], bad)
            assert same_bytes(c.pull_rows("t", [2]),
                              np.zeros((1, 2), np.float32))
            with pytest.raises(mt.MXNetError, match="uninitialized table"):
                c.pull_rows("nope", [0])
        assert srv.applied_row_pushes == 0 and srv.rejected_pushes == 1
    finally:
        srv.stop()


def test_row_plane_counts_its_rows_on_the_telemetry_registry():
    from mxnet_tpu_torch import telemetry

    was = telemetry.enabled()
    telemetry.enable(trace=False)
    try:
        srv = tkvs.start_server(num_workers=1, ctx=mt.cpu())
        try:
            m = tkvs._srv_metrics()
            p0 = m["sparse_pushed"].value
            q0 = m["sparse_pulled"].value
            with tkvs.ServerClient(*srv.addr) as c:
                c.init_table("gauged", {"num_rows": 9, "row_shape": (2,)})
                c.push_rows("gauged", [1, 2, 3], np.ones((3, 2), np.float32))
                c.pull_rows("gauged", [1, 4])
            assert m["sparse_pushed"].value - p0 == 3
            assert m["sparse_pulled"].value - q0 == 2
            rows, nbytes = m["table_gauges"]["gauged"]
            assert rows.name == "mxtpu_kvsrv_table_rows_gauged"
            assert nbytes.name == "mxtpu_kvsrv_table_bytes_gauged"
            assert rows.value == 4 and nbytes.value == 4 * 2 * 4
        finally:
            srv.stop()
    finally:
        if not was:
            telemetry.disable()


# ---------------------------------------------------------------------------
# SparseEmbeddingModule
# ---------------------------------------------------------------------------
def _embed_net(pkg, input_dim, dim=4):
    s = pkg.sym
    emb = s.Embedding(data=s.Variable("ids"), input_dim=input_dim,
                      output_dim=dim, name="embed")
    fc = s.FullyConnected(data=s.sum(emb, axis=1), num_hidden=1, name="fc")
    return s.LinearRegressionOutput(data=fc, label=s.Variable("y"),
                                    name="out")


def _servers_env(monkeypatch, srvs):
    monkeypatch.setenv("DMLC_SERVER_URIS",
                       ",".join("%s:%d" % s.addr for s in srvs))
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")


@pytest.mark.parametrize("coalesce", ["1", "0"])
def test_sparse_module_matches_dense_module_bit_exact(monkeypatch, coalesce):
    """k steps of SparseEmbeddingModule over 2 servers land on the rows and
    dense parameters of a plain Module holding the full weight, bit for
    bit (both eager: the list update of one array per call), with the
    slots' pushes in one envelope per server or one RPC each."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    monkeypatch.setenv("MXNET_KVSTORE_SPARSE_COALESCE", coalesce)
    vocab, dim, bag, batch, steps = 32, 4, 4, 4, 3
    rng = np.random.RandomState(7)
    batches = [(rng.choice(vocab, size=batch * bag, replace=False)
                .reshape(batch, bag).astype(np.float32),
                rng.randn(batch, 1).astype(np.float32))
               for _ in range(steps)]
    opt_params = (("learning_rate", 0.05), ("wd", 0.0), ("momentum", 0.0))
    with mt.cpu():
        dmod = mt.mod.Module(_embed_net(mt, vocab), data_names=["ids"],
                             label_names=["y"])
        dmod.bind(data_shapes=[("ids", (batch, bag))],
                  label_shapes=[("y", (batch, 1))])
        dmod.init_params(initializer=mt.init.Uniform(0.01))
        dargs = {k: v.asnumpy() for k, v in dmod.get_params()[0].items()}
        dargs["embed_weight"][:] = 0.0
        dmod.set_params({k: mt.nd.array(v) for k, v in dargs.items()}, {})
        dmod.init_optimizer(kvstore=None, optimizer="sgd",
                            optimizer_params=opt_params)
        srvs = [tkvs.start_server(port=0) for _ in range(2)]
        _servers_env(monkeypatch, srvs)
        try:
            slots = {"slot": {"data": "ids", "weight": "embed_weight",
                              "num_rows": vocab, "capacity": vocab,
                              "init": ("zeros",)}}
            smod = tsparse.SparseEmbeddingModule(
                _embed_net(mt, vocab), sparse_slots=slots,
                data_names=["ids"], label_names=["y"])
            smod.bind(data_shapes=[("ids", (batch, bag))],
                      label_shapes=[("y", (batch, 1))])
            smod.init_params(arg_params={k: mt.nd.array(v)
                                         for k, v in dargs.items()},
                             aux_params={})
            smod.init_optimizer(kvstore="dist_async", optimizer="sgd",
                                optimizer_params=opt_params)
            assert smod._sparse_param_indices() == (
                smod._param_names.index("embed_weight"),)
            for ids, y in batches:
                for m in (dmod, smod):
                    m.forward_backward(TBatch([mt.nd.array(ids)],
                                              [mt.nd.array(y)]))
                    m.update()
            smod.sparse_plane.wait()
            table = smod.sparse_plane.pull_rows(
                "embed_weight", np.arange(vocab, dtype=np.int64))
            dp, sp = dmod.get_params()[0], smod.get_params()[0]
            assert table.tobytes() == dp["embed_weight"].asnumpy().tobytes()
            assert dp["fc_weight"].asnumpy().tobytes() == \
                sp["fc_weight"].asnumpy().tobytes()
            step = smod.sparse_stats()["step"]
            assert step["pulled_bytes"] == step["pushed_bytes"] == \
                batch * bag * dim * 4
            # the dense store never saw the table
            for s in srvs:
                assert smod._param_names.index("embed_weight") not in \
                    s.store
            assert sum(s.applied_row_pushes for s in srvs) == steps * 2
        finally:
            for s in srvs:
                s.stop()


def test_default_context_sparse_module_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    slots = {"slot": {"data": "ids", "weight": "embed_weight",
                      "num_rows": 1000, "capacity": 8}}
    mod = tsparse.SparseEmbeddingModule(_embed_net(mt, 8), sparse_slots=slots,
                                        data_names=["ids"],
                                        label_names=["y"])
    with pytest.raises(mt.MXNetError):
        mod.bind(data_shapes=[("ids", (2, 4))], label_shapes=[("y", (2, 1))])


def _dlrm_batches(steps, batch, bag, vocab, dense_dim, seed=11):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        dense = rng.randn(batch, dense_dim).astype(np.float32)
        s0 = rng.choice(vocab, size=batch * bag, replace=False)
        s1 = rng.choice(vocab, size=batch * bag, replace=False)
        y = rng.randint(0, 2, size=(batch, 1)).astype(np.float32)
        out.append((dense, s0.reshape(batch, bag).astype(np.float32),
                    s1.reshape(batch, bag).astype(np.float32), y))
    return out


DLRM = dict(num_slots=2, vocab_sizes=[40_000, 40_000], embed_dim=16,
            capacity=128, bag_len=4, dense_dim=8, bottom_hidden=(16, 8),
            top_hidden=(16, 8))
DLRM_BATCH = 8
DLRM_SHAPES = dict(data_shapes=[("dense", (DLRM_BATCH, 8)),
                                ("slot0_indices", (DLRM_BATCH, 4)),
                                ("slot1_indices", (DLRM_BATCH, 4))],
                   label_shapes=[("ctr_label", (DLRM_BATCH, 1))])
DLRM_KEYS = ("slot0_embed_weight", "slot1_embed_weight")
# the small DLRM, port against JAX: float32 through the same graph, where
# XLA's CPU products and torch's sum in another order (a few ulps a step);
# 3 SGD steps at lr 0.05 keep the rows and outputs within 1e-5 of their
# largest |value|
DLRM_TOL = 1e-5


def _dlrm_module(pkg, sparse_pkg, arg_params):
    sym, slots = pkg.models.get_dlrm(**DLRM)
    mod = sparse_pkg.SparseEmbeddingModule(
        sym, sparse_slots=slots,
        data_names=["dense", "slot0_indices", "slot1_indices"],
        label_names=["ctr_label"])
    mod.bind(**DLRM_SHAPES)
    if arg_params is None:
        mod.init_params(initializer=pkg.init.Uniform(0.01))
    else:
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in arg_params.items()},
                        aux_params={})
    mod.init_optimizer(kvstore="dist_async", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.05),
                                         ("wd", 0.0)))
    return mod


def _dlrm_train(pkg, sparse_pkg, batch_cls, arg_params, batches, probe,
                after_step=None):
    """Train the small DLRM; returns (touched rows per table, probe
    outputs, the module's sparse stats, its table_info)."""
    mod = _dlrm_module(pkg, sparse_pkg, arg_params)
    touched = set()
    for step, (dense, s0, s1, y) in enumerate(batches):
        touched.update(np.unique(s0).astype(int))
        touched.update(np.unique(s1).astype(int))
        mod.forward_backward(batch_cls(
            [pkg.nd.array(dense), pkg.nd.array(s0), pkg.nd.array(s1)],
            [pkg.nd.array(y)]))
        mod.update()
        if after_step is not None:
            after_step(step, mod)
    mod.sparse_plane.wait()
    infos = mod.sparse_plane.table_info()
    ids = np.array(sorted(touched), np.int64)
    rows = [mod.sparse_plane.pull_rows(k, ids) for k in DLRM_KEYS]
    mod.forward(batch_cls([pkg.nd.array(probe[0]), pkg.nd.array(probe[1]),
                           pkg.nd.array(probe[2])], [pkg.nd.array(probe[3])]),
                is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    return rows, out, mod.sparse_stats(), infos


def _dlrm_init():
    with mt.cpu():
        sym, _ = mt.models.get_dlrm(**DLRM)
        shapes = dict(DLRM_SHAPES["data_shapes"]
                      + DLRM_SHAPES["label_shapes"])
        arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(5)
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def test_small_dlrm_three_steps_port_against_jax(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    vocab, bag, dense_dim = 40_000, 4, 8
    batches = _dlrm_batches(3, DLRM_BATCH, bag, vocab, dense_dim)
    probe = _dlrm_batches(1, DLRM_BATCH, bag, vocab, dense_dim, seed=99)[0]
    init = _dlrm_init()
    got = {}
    jsrvs = [jkvs.start_server(port=0) for _ in range(2)]
    _servers_env(monkeypatch, jsrvs)
    try:
        got["jax"] = _dlrm_train(mx, jsparse, JBatch, init, batches, probe)
    finally:
        for s in jsrvs:
            s.stop()
    with mt.cpu():
        tsrvs = [tkvs.start_server(port=0) for _ in range(2)]
        _servers_env(monkeypatch, tsrvs)
        try:
            got["port"] = _dlrm_train(mt, tsparse, TBatch, init, batches,
                                      probe)
        finally:
            for s in tsrvs:
                s.stop()
    (jrows, jout, jstats, jinfo), (trows, tout, tstats, tinfo) = \
        got["jax"], got["port"]
    for a, b in zip(trows, jrows):
        assert np.abs(a - b).max() <= DLRM_TOL * np.abs(b).max()
    assert np.abs(tout - jout).max() <= DLRM_TOL * np.abs(jout).max()
    assert tstats["slots"] == jstats["slots"]
    assert [{k: (v["rows"], v["misplaced"]) for k, v in i.items()}
            for i in tinfo] == \
        [{k: (v["rows"], v["misplaced"]) for k, v in i.items()}
         for i in jinfo]
    for i in tinfo:
        for k in DLRM_KEYS:
            assert 0 < i[k]["rows"] < 3 * DLRM_BATCH * bag * 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _server_process(port, snap):
    env = dict(os.environ)
    env.pop("DMLC_ROLE", None)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "127.0.0.1", str(port), snap], env=env,
                            cwd=ROOT)


def _wait_listening(port):
    deadline = time.monotonic() + WAIT
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


@pytest.mark.chaos
def test_dlrm_two_server_kill_restart_bit_identical(tmp_path, monkeypatch):
    """Two port server processes; after step 3 of 5 both shards snapshot,
    server 1 is SIGKILLed and restarted from its snapshot: the touched rows
    and a probe batch's outputs equal an uninterrupted run's bit for bit,
    and no shard holds a whole table."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "400")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "10")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "100")
    vocab, bag, dense_dim, steps, kill_after = 40_000, 4, 8, 5, 3
    batches = _dlrm_batches(steps, DLRM_BATCH, bag, vocab, dense_dim)
    probe = _dlrm_batches(1, DLRM_BATCH, bag, vocab, dense_dim, seed=99)[0]
    init = _dlrm_init()
    runs = {}
    procs = {}
    for tag in ("clean", "kill"):
        ports = [_free_port(), _free_port()]
        snaps = [str(tmp_path / ("%s-%d.snap" % (tag, i))) for i in range(2)]
        procs[tag] = [_server_process(p, s) for p, s in zip(ports, snaps)]
        runs[tag] = (ports, snaps)
    try:
        got = {}
        for tag, (ports, snaps) in runs.items():
            for p in ports:
                _wait_listening(p)
            monkeypatch.setenv("DMLC_SERVER_URIS", ",".join(
                "127.0.0.1:%d" % p for p in ports))
            monkeypatch.setenv("DMLC_NUM_WORKER", "1")

            def after(step, mod, tag=tag, ports=ports, snaps=snaps):
                if tag != "kill" or step + 1 != kill_after:
                    return
                mod.sparse_plane.wait()
                mod._kvstore.wait_all()
                for port, snap in zip(ports, snaps):
                    with tkvs.ServerClient("127.0.0.1", port) as adm:
                        assert adm.snapshot() == snap
                victim = procs[tag][1]
                victim.kill()
                victim.wait(timeout=WAIT)
                procs[tag][1] = _server_process(ports[1], snaps[1])

            with mt.cpu():
                got[tag] = _dlrm_train(mt, tsparse, TBatch, init, batches,
                                       probe, after_step=after)
        (crows, cout, cstats, cinfo), (krows, kout, _s, kinfo) = \
            got["clean"], got["kill"]
        assert [r.tobytes() for r in krows] == [r.tobytes() for r in crows]
        assert kout.tobytes() == cout.tobytes()
        for infos in (cinfo, kinfo):
            for k in DLRM_KEYS:
                rows = [i[k]["rows"] for i in infos]
                assert all(0 < r < sum(rows) for r in rows), (k, rows)
                assert all(i[k]["misplaced"] == 0 for i in infos)
        for s in cstats["slots"].values():
            assert s["logical_bytes"] >= 10 * s["resident_bytes"]
    finally:
        for tag, (ports, _snaps) in runs.items():
            for port in ports:
                try:
                    with tkvs.ServerClient("127.0.0.1", port) as adm:
                        adm.stop_server()
                except Exception:
                    pass
            for p in procs[tag]:
                try:
                    p.wait(timeout=WAIT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


# ---------------------------------------------------------------------------
# the admin tool, and foreign updaters and snapshots
# ---------------------------------------------------------------------------
def _jax_admin():
    spec = importlib.util.spec_from_file_location(
        "jax_kvstore_admin", os.path.join(ROOT, "tools", "kvstore_admin.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kvstore_admin_json_equals_the_jax_tools(tmp_path, capsys):
    from mxnet_tpu_torch.tools import kvstore_admin as tadmin

    jadmin = _jax_admin()
    prefix = str(tmp_path / "kv.snap")
    srvs = [tkvs.start_server(port=0, snapshot_path=p, snapshot_interval=0,
                              ctx=mt.cpu())
            for p in (prefix, prefix + ".1")]
    clients = [tkvs.ServerClient(*s.addr) for s in srvs]
    plane = TPlane(clients)
    try:
        plane.init_table("emb", num_rows=1000, row_shape=(3,),
                         init=("uniform", 0.1))
        plane.set_sparse_optimizer(tupd.SparseAdaGrad(learning_rate=0.1))
        plane.push_rows("emb", np.arange(10),
                        np.ones((10, 3), np.float32))
        for c in clients:
            c.snapshot()
        servers = ",".join("%s:%d" % s.addr for s in srvs)
        argvs = [["table-ls", "--servers", servers, "--json"],
                 ["table-ls", "--servers", servers],
                 ["table-verify", "--servers", servers, "--snapshot", prefix,
                  "--expect-rows", "5", "--json"],
                 ["table-verify", "--servers", servers, "--expect-rows",
                  "11", "--json"]]
        outs = []
        for argv in argvs:
            got = []
            for tool in (tadmin, jadmin):
                rc = tool.main(list(argv))
                got.append((rc, capsys.readouterr().out))
            assert got[0] == got[1], argv
            outs.append(got[0])
        assert json.loads(outs[0][1])[0]["tables"]["emb"]["rows"] == 5
        assert outs[2][0] == 0 and json.loads(outs[2][1])["ok"]
        assert outs[3][0] == 1
        # a row pushed to the wrong shard is misplaced: exit 1 in both
        clients[0].push_rows("emb", [1], np.ones((1, 3), np.float32))
        rcs = [tool.main(["table-verify", "--servers", servers])
               for tool in (tadmin, jadmin)]
        assert rcs == [1, 1]
        out = capsys.readouterr().out
        assert out.count("misplaced rows") == 2
        res = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.kvstore_admin",
             "table-ls", "--servers", servers, "--json"], cwd=ROOT,
            capture_output=True, text=True, timeout=WAIT)
        assert res.returncode == 0
        assert json.loads(res.stdout)[0]["tables"]["emb"]["rows"] == 6
    finally:
        stop(clients)


def test_each_package_refuses_the_others_sparse_updater():
    srv = tkvs.start_server(num_workers=1, ctx=mt.cpu())
    jsrv = jkvs.start_server(num_workers=1)
    try:
        with jkvs.ServerClient(*srv.addr) as j:
            j.init_table("t", {"num_rows": 8, "row_shape": (2,)})
            j.push_rows("t", [3], np.ones((1, 2), np.float32))
            with pytest.raises(mx.base.MXNetError, match="mxnet_tpu_torch"):
                j.set_sparse_optimizer(jupd.SparseSGD(learning_rate=0.1))
            # every other row command talks across the packages
            assert same_bytes(j.pull_rows("t", [3]),
                              np.ones((1, 2), np.float32))
            assert j.table_info()["t"]["rows"] == 1
        assert srv.sparse_updater is None
        with tkvs.ServerClient(*jsrv.addr) as c:
            c.init_table("t", {"num_rows": 8, "row_shape": (2,)})
            with pytest.raises(mt.MXNetError, match="UnpicklingError"):
                c.set_sparse_optimizer(tupd.SparseSGD(learning_rate=0.1))
        assert jsrv.sparse_updater is None
    finally:
        srv.stop()
        jsrv.stop()


def test_each_package_refuses_the_others_sparse_snapshot(tmp_path):
    jsnap, tsnap = str(tmp_path / "jax.snap"), str(tmp_path / "port.snap")
    for kvs, upd, snap in ((jkvs, jupd, jsnap), (tkvs, tupd, tsnap)):
        kw = {"ctx": mt.cpu()} if kvs is tkvs else {}
        srv = kvs.start_server(port=0, snapshot_path=snap,
                               snapshot_interval=0, **kw)
        with kvs.ServerClient(*srv.addr) as c:
            c.init_table("t", {"num_rows": 8, "row_shape": (2,)})
            c.set_sparse_optimizer(upd.SparseSGD(learning_rate=0.1))
            c.push_rows("t", [1], np.ones((1, 2), np.float32))
        srv.stop()
    with pytest.raises(mt.MXNetError, match="another package"):
        tkvs.KVStoreServer(port=0, snapshot_path=jsnap, snapshot_interval=0,
                           ctx=mt.cpu())
    # the JAX server cannot unpickle the port's tagged updater: it starts
    # cold, as on any snapshot it cannot read
    jsrv = jkvs.KVStoreServer(port=0, snapshot_path=tsnap,
                              snapshot_interval=0)
    try:
        assert not jsrv.restored and jsrv.tables == {}
    finally:
        jsrv.snapshot_path = None
        jsrv._server.server_close()
    own = tkvs.KVStoreServer(port=0, snapshot_path=tsnap,
                             snapshot_interval=0, ctx=mt.cpu())
    try:
        assert own.restored and set(own.tables["t"]["rows"]) == {1}
        assert isinstance(own.sparse_updater, tupd.SparseSGD)
    finally:
        own.snapshot_path = None
        own._server.server_close()
