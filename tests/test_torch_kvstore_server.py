"""The port's parameter server (``mxnet_tpu_torch.kvstore_server``) against
the JAX package's (tests/test_kvstore_server.py, tests/test_chaos.py):

* the wire in both directions — a port client against a JAX server and a
  JAX client against a port server exchange the dense commands with no
  optimizer shipped, ending in the same store and membership as a JAX
  pair; the version mismatch and the non-contiguous fallback;
* command sequences each package runs through its own server and client:
  async accumulation, SGD-momentum and adam updaters per push (1e-6
  relative, the update ops' tolerance of tests/test_torch_optimizer.py),
  sync per-worker rounds, a recovery worker's barriers, ``set_optimizer``
  recovery, an error reply that keeps the connection, a dropped ACK
  applied once, the sparse row commands across the packages, the
  snapshot round-trip and a server killed with SIGKILL and restarted
  from its snapshot;
* the ``DMLC_ROLE=server`` bootstrap in one subprocess.

Every other comparison is bitwise.  Servers run in-process on threads,
but for the bootstrap and the kill-restart."""

import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import faults as jfaults
from mxnet_tpu import kvstore_server as jkvs
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import kvstore_server as tkvs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jkvs, mx, jfaults), "port": (tkvs, mt, tfaults)}
WAIT = 20  # seconds: the bound of every wait on a thread or socket


@pytest.fixture(autouse=True)
def _fast_retries(monkeypatch):
    """Tight retry/backoff so a dropped connection resolves at once."""
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "40")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "20")
    for name in ("DMLC_PS_ROOT_URI", "DMLC_SERVER_URIS", "DMLC_IS_RECOVERY",
                 "MXNET_KVSTORE_ELASTIC", "MXNET_KVSTORE_COMPRESS"):
        monkeypatch.delenv(name, raising=False)


def start(kvs, **kw):
    """A server of ``kvs`` on a background thread; the port's updater on
    the CPU."""
    if kvs is tkvs:
        kw.setdefault("ctx", mt.cpu())
    return kvs.start_server(**kw)


def same(a, b):
    """Bitwise equality of two results (arrays by dtype, shape and bytes,
    containers item by item)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == b.tobytes()
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def both(case):
    """Run ``case(kvs, pkg, faults)`` with each package's server and
    client; the results must be bitwise equal.  Returns the port's."""
    got = {name: case(*side) for name, side in SIDES.items()}
    assert same(got["jax"], got["port"]), got
    return got["port"]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [(tkvs, jkvs), (jkvs, tkvs),
                                     (tkvs, tkvs)], ids=["port-jax",
                                                         "jax-port",
                                                         "port-port"])
def test_wire_noncontiguous_falls_back_inband_across_packages(src, dst):
    a, b = socket.socketpair()
    a.settimeout(WAIT)
    b.settimeout(WAIT)
    try:
        arr = np.arange(24, dtype=np.float32).reshape(4, 6).T
        assert not arr.flags.c_contiguous
        src._send_msg(a, {"cmd": "push", "value": arr})
        msg = dst._recv_msg(b)
        np.testing.assert_array_equal(msg["value"], arr)
        # contiguous arrays take the out-of-band path
        src._send_msg(a, ("req", "c", 1, ("push", 3, np.ones(8, np.float16),
                                          0)))
        got = dst._recv_msg(b)
        assert got[:3] == ("req", "c", 1) and got[3][:2] == ("push", 3)
        assert same(got[3][2], np.ones(8, np.float16))
    finally:
        a.close()
        b.close()


def test_wire_constants_and_version_mismatch():
    assert tkvs._WIRE_VERSION == jkvs._WIRE_VERSION == 2
    assert tkvs._HDR.format == jkvs._HDR.format == "<QI"
    assert tkvs._LEN.format == jkvs._LEN.format == "<Q"
    a, b = socket.socketpair()
    b.settimeout(WAIT)
    try:
        a.sendall(bytes([tkvs._WIRE_VERSION + 1]) + b"\x00" * tkvs._HDR.size)
        with pytest.raises(ConnectionError, match="wire version mismatch"):
            tkvs._recv_msg(b)
    finally:
        a.close()
        b.close()


def dense_session(client_kvs, server_kvs):
    """Every dense command but set_optimizer, a client of one package
    against a server of the other; returns what the clients saw."""
    srv = start(server_kvs, num_workers=2, sync_mode=True)
    out = []
    try:
        host, port = srv.addr
        with client_kvs.ServerClient(host, port) as c0, \
                client_kvs.ServerClient(host, port) as c1:
            out.append(c0.join(0))
            out.append(c1.join(1))
            c0.init("w", np.zeros((2, 3), np.float32))
            c0.init(7, np.arange(4, dtype=np.float32))
            c0.push("w", np.full((2, 3), 1.5, np.float32), rank=0)
            out.append(c1.pull("w"))  # the round waits on rank 1
            c1.push("w", np.full((2, 3), 0.25, np.float32), rank=1)
            out.append(c0.pull("w"))
            out.append(c0.multi([("push", 7, np.ones(4, np.float32), 0),
                                 ("pull", "w")]))
            out.append(c1.multi([("push", 7, np.ones(4, np.float32), 1),
                                 ("pull", 7)]))
            t = threading.Thread(target=c1.barrier, kwargs={"rank": 1})
            t.start()
            c0.barrier(rank=0)
            t.join(WAIT)
            assert not t.is_alive()
            out.append(c0.membership())
            out.append(c0.dead_nodes())
            out.append(c1.leave(1))
            out.append(c0.membership())
    finally:
        srv.stop()
    return out


def test_dense_commands_cross_the_packages_both_ways():
    ref = dense_session(jkvs, jkvs)
    assert same(ref[3], np.full((2, 3), 1.75, np.float32))
    assert same(ref[5][1], np.arange(4, dtype=np.float32) + 2)
    for client, server in ((tkvs, jkvs), (jkvs, tkvs), (tkvs, tkvs)):
        assert same(dense_session(client, server), ref), (client, server)


# ---------------------------------------------------------------------------
# the server on each package's command sequences
# ---------------------------------------------------------------------------
def test_async_accumulate_matches_jax():
    def case(kvs, pkg, faults):
        srv = start(kvs, num_workers=2)
        try:
            c1 = kvs.ServerClient(*srv.addr)
            c2 = kvs.ServerClient(*srv.addr)
            c1.init(3, np.zeros((2, 2), np.float32))
            c1.push(3, np.full((2, 2), 1.0, np.float32))
            c2.push(3, np.full((2, 2), 2.0, np.float32))
            out = [c1.pull(3), srv.applied_pushes]
            c1.close()
            c2.close()
            return out
        finally:
            srv.stop()

    out = both(case)
    assert same(out[0], np.full((2, 2), 3.0, np.float32))


OPTS = {"sgd-momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-3}),
        "adam": ("adam", {"learning_rate": 0.05, "epsilon": 1e-4,
                          "wd": 1e-3})}


@pytest.mark.parametrize("which", sorted(OPTS))
def test_updater_per_push_matches_jax(which):
    """Each push runs the shipped optimizer at once (kvstore_dist_server.h
    async branch), its states carried from push to push."""
    name, params = OPTS[which]
    rng = np.random.RandomState(4)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(4)]

    def run(kvs, pkg):
        srv = start(kvs, num_workers=1)
        try:
            with kvs.ServerClient(*srv.addr) as c:
                c.init("w", w0)
                c.set_optimizer(pkg.optimizer.create(name, **params))
                out = []
                for g in grads:
                    c.push("w", g)
                    out.append(c.pull("w"))
                return out
        finally:
            srv.stop()

    ref, got = run(jkvs, mx), run(tkvs, mt)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)
    assert not np.allclose(got[-1], w0)


def test_sync_per_worker_rounds_match_jax():
    def case(kvs, pkg, faults):
        srv = start(kvs, num_workers=2, sync_mode=True)
        try:
            with kvs.ServerClient(*srv.addr) as c:
                c.init(0, np.zeros((3,), np.float32))
                out = []
                c.push(0, np.full((3,), 1.0, np.float32), rank=0)
                c.push(0, np.full((3,), 10.0, np.float32), rank=0)
                out.append(c.pull(0))  # round 1 waits on worker 1
                c.push(0, np.full((3,), 2.0, np.float32), rank=1)
                out.append(c.pull(0))
                c.push(0, np.full((3,), 20.0, np.float32), rank=1)
                out.append(c.pull(0))
                out.append(dict(srv.round_sizes))
                return out
        finally:
            srv.stop()

    out = both(case)
    assert same(out[2], np.full((3,), 33.0, np.float32))
    assert out[3] == {2: 2}


def test_recovery_worker_skips_startup_barriers_matches_jax():
    """A recovered rank skips a barrier once the job passed startup and
    nobody is parked, and joins one that a peer is parked at."""
    def case(kvs, pkg, faults):
        srv = start(kvs, num_workers=2)
        try:
            a = kvs.ServerClient(*srv.addr)
            b = kvs.ServerClient(*srv.addr)
            out = []
            # before startup a recovery barrier must join (it releases a)
            t = threading.Thread(target=a.barrier, kwargs={"rank": 0})
            t.start()
            b.barrier(rank=1, is_recovery=True)
            t.join(WAIT)
            out.append(t.is_alive())
            # past startup, nobody parked: returns at once
            t0 = time.monotonic()
            b.barrier(rank=1, is_recovery=True)
            out.append(time.monotonic() - t0 < 2.0)
            # rank 0 parks: the recovered rank joins and releases it
            released = []
            t = threading.Thread(target=lambda: (a.barrier(rank=0),
                                                 released.append(1)))
            t.start()
            deadline = time.monotonic() + WAIT
            while not srv._barrier_ranks and time.monotonic() < deadline:
                time.sleep(0.01)
            out.append(bool(released))
            b.barrier(rank=1, is_recovery=True)
            t.join(WAIT)
            out.append(bool(released))
            out.append(srv._barrier_gen)
            a.close()
            b.close()
            return out
        finally:
            srv.stop()

    assert both(case) == [False, True, False, True, 2]


def test_set_optimizer_recovery_keeps_the_live_updater():
    for kvs, pkg, _ in SIDES.values():
        srv = start(kvs, num_workers=1)
        try:
            with kvs.ServerClient(*srv.addr) as c:
                c.init("w", np.ones((2,), np.float32))
                c.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5))
                first = srv.updater
                c.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1),
                                is_recovery=True)
                assert srv.updater is first
                srv.updater = None
                c.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1),
                                is_recovery=True)
                assert srv.updater is not None
                assert srv.updater.optimizer.lr == 0.1
        finally:
            srv.stop()


def test_error_reply_keeps_the_connection():
    def case(kvs, pkg, faults):
        srv = start(kvs, num_workers=1)
        try:
            with kvs.ServerClient(*srv.addr) as c:
                with pytest.raises(pkg.MXNetError,
                                   match="kvstore server error"):
                    c._rpc("set_optimizer", b"not-a-pickle")
                with pytest.raises(pkg.MXNetError,
                                   match="uninitialized key"):
                    c.pull("nope")
                c.init(1, np.ones((2,), np.float32))
                return [c.pull(1)]
        finally:
            srv.stop()

    both(case)


def test_dropped_ack_is_applied_exactly_once():
    """The ACK of a push is dropped after the server applied it; the
    replay under the same token answers from the dedup window."""
    def case(kvs, pkg, faults):
        srv = start(kvs, num_workers=1)
        try:
            with faults.inject("kv.client.recv:drop=1@#2") as plan:
                with kvs.ServerClient(*srv.addr) as c:
                    c.init(0, np.full(4, 10.0, np.float32))
                    c.push(0, np.full(4, 5.0, np.float32))
                    out = c.pull(0)
                events = list(plan.events)
            return [out, srv.applied_pushes, events]
        finally:
            srv.stop()

    out = both(case)
    assert same(out[0], np.full(4, 15.0, np.float32)) and out[1] == 1


def test_dedup_window_floor_and_stale_token(monkeypatch):
    """A window of 2: completed tokens fall off, the floor rises, and a
    token at or below it is refused as stale."""
    monkeypatch.setenv("MXNET_KVSTORE_DEDUP_WINDOW", "2")

    def case(kvs, pkg, faults):
        srv = start(kvs, num_workers=1)
        try:
            out = []
            for seq in (1, 2, 3, 4):
                out.append(srv._serve_one("c", seq, ("heartbeat", 0)))
            out.append(srv._dedup["c"]["floor"])
            out.append(srv._serve_one("c", 4, ("heartbeat", 0)))
            out.append(srv._serve_one("c", 1, ("heartbeat", 0)))
            return out
        finally:
            srv.stop()

    out = both(case)
    assert out[4] == 2 and out[6][0] == "err" and "stale" in out[6][1]


def test_sparse_commands_across_the_packages():
    """The row commands on the JAX wire: a JAX client against a port
    server and a port client against a JAX server declare, push, pull and
    audit a table alike; the connection lives on for dense commands."""
    ids = np.array([5, 2, 5], np.int64)
    vals = np.arange(9, dtype=np.float32).reshape(3, 3)

    def case(kvs, pkg, faults):
        other = jkvs if kvs is tkvs else tkvs
        srv = start(kvs, num_workers=1)
        try:
            with other.ServerClient(*srv.addr) as c:
                c.init_table("emb", {"num_rows": 10, "row_shape": (3,),
                                     "init": ("normal", 0.1)})
                before = c.pull_rows("emb", [7])
                c.push_rows("emb", ids, vals)
                rows = c.pull_rows("emb", [2, 5, 7])
                info = c.table_info("emb")["emb"]
                c.init(0, np.ones(2, np.float32))
                dense = c.pull(0)
            return (before, rows, dense, info["rows"], info["misplaced"],
                    srv.applied_row_pushes)
        finally:
            srv.stop()

    before, rows, dense, n_rows, misplaced, applied = both(case)
    assert same(rows[2:], before)  # row 7: touched by no push
    assert np.std(before) > 0 and same(dense, np.ones(2, np.float32))
    assert (n_rows, misplaced, applied) == (3, 0, 1)


def test_stats_command_and_server_context():
    srv = start(tkvs, num_workers=1)
    try:
        with tkvs.ServerClient(*srv.addr) as c:
            c.init(0, np.ones(2, np.float32))
            c.set_optimizer(mt.optimizer.SGD(learning_rate=0.5))
            c.push(0, np.ones(2, np.float32))
            st = c.stats()
        assert st["applied_pushes"] == 1 and st["ctx"] == "cpu(0)"
        assert st["update_seconds"] > 0 and st["keys"] == 1
        assert srv.updater.states == {} or all(
            s is None or s.context == mt.cpu()
            for s in srv.updater.states.values())
    finally:
        srv.stop()


def test_rpcs_counted_and_timed_per_command(monkeypatch):
    monkeypatch.setattr(mt.telemetry, "_ENABLED", True)
    monkeypatch.setattr(tkvs, "_TELEM", None)
    monkeypatch.setattr(mt.telemetry, "_registry", None)
    srv = start(tkvs, num_workers=2)
    try:
        with tkvs.ServerClient(*srv.addr) as c:
            c.join(0)
            c.join(1)
            c.membership()
            c.evict(1)
            c.leave(0)
            c.init("k", np.zeros(2, np.float32))
            c.multi([("push", "k", np.ones(2, np.float32), 0),
                     ("pull", "k")])
        text = mt.telemetry.render_prometheus()
        for cmd, n in (("join", 2), ("membership", 1), ("evict", 1),
                       ("leave", 1), ("init", 1), ("multi", 1)):
            assert 'mxtpu_kvsrv_rpc_total{cmd="%s"} %d' % (cmd, n) in text
            assert "mxtpu_kvsrv_rpc_%s_ms_count %d" % (cmd, n) in text
        assert 'mxtpu_kvsrv_rpc_total{cmd="push"} 1' in text
        assert "mxtpu_kvsrv_joins_total 2" in text
        assert "mxtpu_kvsrv_evictions_total 1" in text
    finally:
        srv.stop()


def test_client_close_idempotent_and_reconnects_through_socket_loss():
    srv = start(tkvs, num_workers=1)
    try:
        with tkvs.ServerClient(*srv.addr) as c:
            c.init(2, np.full(3, 4.0, np.float32))
            c.start_heartbeat(0, interval=0.05)
            hb = c._hb_thread
            c._sock.shutdown(socket.SHUT_RDWR)
            c._sock.close()
            assert same(c.pull(2), np.full(3, 4.0, np.float32))
        assert c._closed and c._hb_thread is None and not hb.is_alive()
        c.close()
        c.close()
        with pytest.raises(ConnectionError, match="closed"):
            c.pull(2)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# durability
# ---------------------------------------------------------------------------
def test_snapshot_restores_store_updater_rounds_and_dedup(tmp_path):
    """A snapshot taken mid-run restores the store, the updater with its
    momentum, a pending sync round, the barrier generation and the dedup
    window; a restored server reaches the uninterrupted server's weights
    bit for bit.  A torn snapshot (CRC mismatch) starts cold."""
    grads = [np.full(4, v, np.float32) for v in (1.0, -0.5, 2.0)]

    def run(snap, restart):
        srv = start(tkvs, num_workers=2, sync_mode=True, snapshot_path=snap,
                    snapshot_interval=0)
        c = tkvs.ServerClient(*srv.addr)
        c.init("w", np.ones(4, np.float32))
        c.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        c.push("w", grads[0], rank=0)
        c.push("w", grads[1], rank=1)
        c.push("w", grads[2], rank=0)  # a pending round
        if restart:
            c.snapshot()
            srv.stop()
            srv = start(tkvs, num_workers=2, sync_mode=True,
                        snapshot_path=snap, snapshot_interval=0)
            assert srv.restored and srv._merge["w"][0].keys() == {0}
            assert srv._dedup[c._cid]["window"]
            c.close()
            c = tkvs.ServerClient(*srv.addr)
        c.push("w", grads[1], rank=1)
        out = c.pull("w"), dict(srv.round_sizes), srv.applied_pushes
        c.close()
        srv.stop()
        return out

    ref = run(str(tmp_path / "a.snap"), False)
    got = run(str(tmp_path / "b.snap"), True)
    assert same(got[0], ref[0]) and got[2] == ref[2] == 4
    with open(str(tmp_path / "b.snap"), "rb") as f:
        state = pickle.load(f)
    assert state["version"] == 4 and state["tables"] == {} and \
        state["sparse_updater"] is None
    with open(str(tmp_path / "b.snap"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff")
    srv = start(tkvs, num_workers=2, snapshot_path=str(tmp_path / "b.snap"),
                snapshot_interval=0)
    try:
        assert not srv.restored and srv.store == {}
    finally:
        srv.snapshot_path = None  # keep the torn file as it is
        srv.stop()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def server_process(port, **env):
    env = dict(os.environ, DMLC_ROLE="server", DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), MXNET_KVSTORE_SERVER_CTX="cpu",
               **env)
    return subprocess.Popen([sys.executable, "-c", "import mxnet_tpu_torch"],
                            env=env, cwd=ROOT)


def connect(port):
    deadline = time.monotonic() + 60
    while True:
        try:
            return tkvs.ServerClient("127.0.0.1", port)
        except ConnectionError:
            if time.monotonic() > deadline:
                raise


def test_server_role_bootstrap_subprocess(monkeypatch):
    """``DMLC_ROLE=server python -c 'import mxnet_tpu_torch'`` serves; two
    workers (a JAX client and a port client) push, the sum lands, and a
    stop command ends the process with exit code 0."""
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "400")
    port = free_port()
    server = server_process(port, DMLC_NUM_WORKER="2")
    try:
        with connect(port) as c:
            c.init(7, np.zeros((4,), np.float32))
            with jkvs.ServerClient("127.0.0.1", port) as j:
                j.push(7, np.full((4,), 1.0, np.float32))
            c.push(7, np.full((4,), 2.0, np.float32))
            assert same(c.pull(7), np.full((4,), 3.0, np.float32))
            assert c.stats()["ctx"] == "cpu(0)"
            c.stop_server()
        assert server.wait(timeout=WAIT) == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()


def test_server_killed_and_restarted_from_its_snapshot(tmp_path,
                                                       monkeypatch):
    """SIGKILL the server process after a snapshot, start it again on the
    same port and snapshot path: the client rides out the outage (its
    in-flight push replayed) and the job ends on the uninterrupted run's
    weights, momentum included, bit for bit."""
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "400")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "50")
    rng = np.random.RandomState(0)
    w0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in range(4)]

    ref_srv = start(tkvs, num_workers=1)
    try:
        with tkvs.ServerClient(*ref_srv.addr) as c:
            c.init("w", w0)
            c.set_optimizer(mt.optimizer.SGD(learning_rate=0.1,
                                             momentum=0.9))
            for g in grads:
                c.push("w", g)
            ref = c.pull("w")
    finally:
        ref_srv.stop()

    port = free_port()
    snap = str(tmp_path / "kv.snap")
    env = dict(MXNET_KVSTORE_SNAPSHOT_PATH=snap,
               MXNET_KVSTORE_SNAPSHOT_INTERVAL="0")
    server = server_process(port, **env)
    try:
        with connect(port) as c:
            c.init("w", w0)
            c.set_optimizer(mt.optimizer.SGD(learning_rate=0.1,
                                             momentum=0.9))
            for g in grads[:2]:
                c.push("w", g)
            c.snapshot()
            server.send_signal(signal.SIGKILL)
            server.wait(timeout=WAIT)
            pushed = threading.Thread(target=c.push, args=("w", grads[2]))
            pushed.start()  # in flight while no server listens
            server = server_process(port, **env)
            pushed.join(60)
            assert not pushed.is_alive()
            c.push("w", grads[3])
            got = c.pull("w")
            assert c.stats()["restored"]
            c.stop_server()
        server.wait(timeout=WAIT)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert same(got, ref)


def test_ndarray_pickles_as_the_jax_state_dict():
    """A snapshot pickles the updater's states: an NDArray's state is the
    JAX package's dict (host data, context), restored onto its context;
    bfloat16 comes back as bfloat16, and an updater round-trips."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jstate = mx.nd.array(x).__getstate__()
    tstate = mt.nd.array(x, mt.cpu(0)).__getstate__()
    assert set(jstate) == set(tstate) == {"data", "ctx_type", "ctx_id",
                                          "writable"}
    assert same(jstate["data"], tstate["data"])
    back = pickle.loads(pickle.dumps(mt.nd.array(x, mt.cpu(1))))
    assert back.context == mt.cpu(1) and same(back.asnumpy(), x)
    bf = pickle.loads(pickle.dumps(mt.nd.array(x, mt.cpu(), dtype="bfloat16")))
    assert bf.dtype == "bfloat16"
    upd = mt.optimizer.get_updater(mt.optimizer.create(
        "adam", learning_rate=0.1))
    w = mt.nd.array(x, mt.cpu())
    upd(0, mt.nd.array(np.ones_like(x), mt.cpu()), w)
    upd2 = pickle.loads(pickle.dumps(upd))
    assert all(same(a.asnumpy(), b.asnumpy()) for a, b in
               zip(upd.states[0], upd2.states[0]))
    w2 = mt.nd.array(w.asnumpy(), mt.cpu())
    for u, arr in ((upd, w), (upd2, w2)):
        u(0, mt.nd.array(np.ones_like(x), mt.cpu()), arr)
    assert same(w.asnumpy(), w2.asnumpy())
