"""Elastic membership and numeric containment of the port's parameter
server against the JAX package's (tests/test_elastic.py): the kvstore
shrinks and grows instead of dying.

Each case runs the same command sequence through each package's own server
and clients, bitwise: join/leave generations, renormalized rounds after a
shrink and ``round_sizes``, a mid-run join, a parked barrier re-formed
around an evicted member, the membership in a snapshot, the NACK of a
non-finite push and the NACK limit's eviction, the preemption handler.
Membership changes go through the leave/evict RPCs and events, never
through heartbeat timing.  Then the churn invariant of
tests/elastic_churn_worker.py over three in-process workers: one preempted
after step 3 (its handler leaves), a joiner entering at step 6, and the
final weight exactly ``steps * num_workers * grad``."""

import signal
import socket
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import comm_engine as jce
from mxnet_tpu import kvstore_server as jkvs
from mxnet_tpu_torch import comm_engine as tce
from mxnet_tpu_torch import kvstore_server as tkvs

SIDES = {"jax": (jkvs, mx), "port": (tkvs, mt)}
WAIT = 20


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "40")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "20")
    for name in ("DMLC_PS_ROOT_URI", "DMLC_SERVER_URIS", "DMLC_IS_RECOVERY",
                 "MXNET_KVSTORE_ELASTIC_JOIN", "MXNET_KVSTORE_COMPRESS",
                 "MXNET_KVSTORE_SYNC"):
        monkeypatch.delenv(name, raising=False)


def start(kvs, **kw):
    if kvs is tkvs:
        kw.setdefault("ctx", mt.cpu())
    return kvs.start_server(**kw)


def both(case):
    got = {name: case(*side) for name, side in SIDES.items()}
    ref, port = got["jax"], got["port"]
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (a, b)
        else:
            assert a == b, got
    return port


def join_all(kvs, srv, ranks):
    clients = {}
    for r in ranks:
        c = kvs.ServerClient(*srv.addr)
        c.join(r)
        clients[r] = c
    return clients


def close_all(clients):
    for c in clients.values():
        c.close()


def test_join_leave_generations():
    def case(kvs, pkg):
        srv = start(kvs, num_workers=3, sync_mode=True)
        try:
            cs = join_all(kvs, srv, [0, 1, 2])
            out = [cs[0].membership()]
            cs[1].join(1)  # a re-join of a live rank: no generation bump
            out.append(cs[0].membership())
            out.append(cs[2].leave(2))
            out.append(cs[2].leave(2))  # idempotent
            out.append(cs[0].membership())
            close_all(cs)
            return out
        finally:
            srv.stop()

    out = both(case)
    assert out[0] == {"gen": 3, "ranks": [0, 1, 2], "num_workers": 3}
    assert out[4] == {"gen": 4, "ranks": [0, 1], "num_workers": 3}


def test_shrink_renormalizes_rounds():
    """A 2-of-3 round applies num_workers/len(round) times its sum; a push
    from the departed rank is discarded."""
    def case(kvs, pkg):
        srv = start(kvs, num_workers=3, sync_mode=True)
        try:
            cs = join_all(kvs, srv, [0, 1, 2])
            cs[0].init(0, np.zeros(4, np.float32))
            g = np.array([1.0, 0.1, -3.0, 7.0], np.float32)
            for r in (0, 1, 2):
                cs[r].push(0, g * (r + 1), rank=r)
            out = [cs[0].pull(0)]
            cs[1].push(0, g, rank=1)  # a partial round: rank 2 then leaves
            cs[2].leave(2)
            cs[0].push(0, g, rank=0)
            out.append(cs[0].pull(0))
            cs[2].push(0, np.full(4, 100.0, np.float32), rank=2)
            for r in (0, 1):
                cs[r].push(0, g, rank=r)
            out += [cs[0].pull(0), dict(srv.round_sizes),
                    srv.applied_pushes]
            close_all(cs)
            return out
        finally:
            srv.stop()

    out = both(case)
    assert out[3] == {3: 1, 2: 2}


def test_midrun_join_counts_the_full_round():
    def case(kvs, pkg):
        srv = start(kvs, num_workers=3, sync_mode=True)
        try:
            cs = join_all(kvs, srv, [0, 1])
            cs[0].init(0, np.zeros(4, np.float32))
            joiner = kvs.ServerClient(*srv.addr)
            out = [joiner.join(5)]
            for r in (0, 1):
                cs[r].push(0, np.ones(4, np.float32), rank=r)
            out.append(cs[0].pull(0))  # 2 of 3 live: no flush
            joiner.push(0, np.ones(4, np.float32), rank=5)
            out += [cs[0].pull(0), dict(srv.round_sizes)]
            joiner.close()
            close_all(cs)
            return out
        finally:
            srv.stop()

    out = both(case)
    assert out[0]["ranks"] == [0, 1, 5] and out[3] == {3: 1}


def test_barrier_reforms_around_an_evicted_member():
    """A survivor parked at a barrier is released when the missing member
    is evicted (the evict RPC), and the membership says so."""
    def case(kvs, pkg):
        srv = start(kvs, num_workers=2, sync_mode=True)
        try:
            cs = join_all(kvs, srv, [0, 1])
            admin = kvs.ServerClient(*srv.addr)
            parked = threading.Thread(target=cs[0].barrier,
                                      kwargs={"rank": 0})
            parked.start()
            deadline = time.monotonic() + WAIT
            while not srv._barrier_ranks and time.monotonic() < deadline:
                time.sleep(0.01)
            out = [parked.is_alive(), admin.evict(1)]
            parked.join(WAIT)
            out += [parked.is_alive(), admin.membership(), srv._barrier_gen]
            admin.close()
            close_all(cs)
            return out
        finally:
            srv.stop()

    out = both(case)
    assert out[0] and not out[2] and out[3]["ranks"] == [0]


def test_snapshot_roundtrips_membership(tmp_path):
    def case(kvs, pkg):
        snap = str(tmp_path / ("%s.snap" % pkg.__name__))
        srv = start(kvs, num_workers=3, sync_mode=True, snapshot_path=snap)
        cs = join_all(kvs, srv, [0, 1])
        cs[0].snapshot()
        close_all(cs)
        srv.stop()
        srv2 = start(kvs, num_workers=3, sync_mode=True, snapshot_path=snap,
                     evict_timeout=30.0)
        try:
            return [srv2.restored, sorted(srv2._members), srv2._mgen,
                    srv2._stale_members(5.0)]
        finally:
            srv2.stop()

    assert both(case) == [True, [0, 1], 2, []]


def test_nonfinite_push_is_nacked_and_the_limit_evicts(monkeypatch):
    """A NaN/Inf push gets a typed NACK and leaves the store bitwise as it
    was, in a plain push and inside a bucket; at the NACK limit the rank is
    evicted and the survivors' round flushes."""
    monkeypatch.setenv("MXNET_KVSTORE_NACK_LIMIT", "2")

    def case(kvs, pkg):
        srv = start(kvs, num_workers=2, sync_mode=True)
        try:
            cs = join_all(kvs, srv, [0, 1])
            w0 = np.array([0.5, -1.25, 3.0], np.float32)
            cs[0].init("w", w0)
            cs[0].push("w", np.ones(3, np.float32), rank=0)
            bad = np.array([1.0, np.nan, 2.0], np.float32)
            with pytest.raises(kvs.NonFiniteGradientError,
                               match="non-finite"):
                cs[1].push("w", bad, rank=1)
            out = [cs[0].pull("w"), srv.rejected_pushes,
                   sorted(srv._members)]
            with pytest.raises(kvs.NonFiniteGradientError):
                cs[1].multi([("push", "w",
                              np.array([np.inf, 0, 0], np.float32), 1)])
            out += [cs[0].pull("w"), dict(srv.rejects_by_rank),
                    sorted(srv._members), dict(srv.round_sizes)]
            close_all(cs)
            return out
        finally:
            srv.stop()

    out = both(case)
    assert out[0].tobytes() == np.array([0.5, -1.25, 3.0],
                                        np.float32).tobytes()
    assert out[5] == [0]   # evicted at the second rejection
    assert out[6] == {1: 1}  # rank 0's push flushed alone, renormalized


def test_retry_deadline_raises_a_typed_error(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "100000")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_DEADLINE", "0.4")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here
    t0 = time.monotonic()
    with pytest.raises(tkvs.KVStoreConnectionError, match="unreachable"):
        tkvs.ServerClient("127.0.0.1", port)
    assert time.monotonic() - t0 < 5
    assert issubclass(tkvs.KVStoreConnectionError, ConnectionError)


@pytest.mark.parametrize("pkg,ce", [(mx, jce), (mt, tce)],
                         ids=["jax", "port"])
def test_preemption_handler_drains_checkpoints_leaves(monkeypatch, pkg, ce):
    """SIGTERM's path: drain the comm engine (the pending push lands),
    run the checkpoint hook, leave the membership; idempotent."""
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
    with pkg.cpu():
        kv = ce.make_async(pkg.kv.create("dist_async"))
    try:
        assert kv.membership()["ranks"] == [0]
        kv.init(0, pkg.nd.zeros((3,), pkg.cpu()))
        calls = []
        kv.push(0, pkg.nd.ones((3,), pkg.cpu()))
        handler = pkg.kvstore.install_preemption_handler(
            kv, checkpoint_fn=lambda: calls.append(
                kv.inner._server.store[0].copy()), exit_process=False)
        handler(signal.SIGTERM, None)
        assert len(calls) == 1 and np.array_equal(calls[0], np.ones(3))
        assert kv.membership()["ranks"] == []
        handler(signal.SIGTERM, None)
        assert len(calls) == 1
    finally:
        kv.close()


def churn_worker(kv, rank, steps, start_step, gate, gate_step, preempt,
                 results):
    """tests/elastic_churn_worker.py's loop: a constant gradient each step,
    then a barrier; the preempted rank's handler runs after its step 3.
    A survivor reports reaching ``gate_step`` and waits there for the
    joiner (``gate``: (reached event, open event))."""
    grad = mt.nd.ones((4,), mt.cpu())
    for it in range(start_step, steps):
        if gate is not None and it == gate_step:
            gate[0].set()
            assert gate[1].wait(WAIT)
        kv.push("w", grad)
        kv._barrier()
        if preempt is not None and it == 3:
            preempt(signal.SIGTERM, None)
            results[rank] = "left"
            return
    out = mt.nd.zeros((4,), mt.cpu())
    deadline = time.monotonic() + WAIT
    while True:
        kv.pull("w", out)
        if out.asnumpy()[0] >= steps * 3 or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    results[rank] = out.asnumpy()


def test_churn_invariant_with_a_preempted_rank_and_a_joiner(monkeypatch):
    steps, gate_step = 10, 6
    srv = start(tkvs, num_workers=3, sync_mode=True)
    host, port = srv.addr
    monkeypatch.setenv("DMLC_PS_ROOT_URI", host)
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(port))
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
    try:
        stores = []
        for r in range(3):
            monkeypatch.setenv("DMLC_WORKER_ID", str(r))
            stores.append(mt.kv.create("dist_async"))
        for kv in stores[1:]:
            threading.Thread(target=kv.init,
                             args=("w", mt.nd.zeros((4,), mt.cpu()))).start()
        stores[0].init("w", mt.nd.zeros((4,), mt.cpu()))
        handler = mt.kvstore.install_preemption_handler(
            stores[2], exit_process=False)
        gates = [(threading.Event(), threading.Event()) for _ in range(2)]
        results = {}
        threads = [threading.Thread(target=churn_worker, args=(
            stores[r], r, steps, 0, gates[r] if r < 2 else None, gate_step,
            handler if r == 2 else None, results)) for r in range(3)]
        for t in threads:
            t.start()
        threads[2].join(WAIT)
        assert results.get(2) == "left"
        # the joiner enters once the survivors wait at the gate: a join
        # in the middle of a round would make it a 3-member round
        assert all(g[0].wait(WAIT) for g in gates)
        monkeypatch.setenv("MXNET_KVSTORE_ELASTIC_JOIN", "1")
        joiner = mt.kv.create("dist_async")  # rank 2 again, mid-run
        joiner.init("w", mt.nd.zeros((4,), mt.cpu()))  # no barrier wait
        assert joiner.membership()["ranks"] == [0, 1, 2]
        for g in gates:
            g[1].set()
        jt = threading.Thread(target=churn_worker, args=(
            joiner, "joiner", steps, gate_step, None, None, None, results))
        jt.start()
        for t in threads[:2] + [jt]:
            t.join(WAIT)
            assert not t.is_alive()
        for r in (0, 1, "joiner"):
            np.testing.assert_array_equal(results[r], np.full(4, 30.0))
        assert srv.round_sizes == {3: 8, 2: 2}
        for kv in stores + [joiner]:
            kv.close()
    finally:
        srv.stop()
