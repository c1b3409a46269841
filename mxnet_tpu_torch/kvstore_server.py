"""Host-side parameter service — the ``dist_async`` control/data plane,
counterpart of ``mxnet_tpu/kvstore_server.py``.

What a server buys over the collective ``dist_sync`` store is the
reference's *asynchronous* PS semantics (kvstore_dist_server.h:87-260: the
updater runs on every push, workers never wait for each other) plus the
coordination plane (barriers, optimizer shipping, cooperative stop,
elastic membership).  Messages travel over TCP as length-prefixed pickles
(ps-lite/ZeroMQ in the reference), in the JAX package's wire format, so a
worker of either package talks to a server of either package on the dense
commands.  Every value on the wire is a numpy array or a plain Python
object, never a tensor.

The store lives on the host as numpy arrays and pushes of a sync round
merge there with numpy, so a round of two workers is bitwise independent
of arrival order.  The updater (``set_optimizer``) runs on the server's
context: ``gpu(0)`` unless the server is built with another.  The context
is explicit because the default context is thread-local and the request
threads never see a ``with`` scope of the thread that built the server.

Bootstrap parity with python/mxnet/kvstore_server.py:11-58: importing
``mxnet_tpu_torch`` in a process whose ``DMLC_ROLE=server`` serves and
exits when a stop command arrives.

While telemetry is on, a client stamps a trace context into each request
envelope (its 5th field, as the JAX client does) and opens a
``kv.client.<cmd>`` span that starts a flow; the server's handler span
``kv.rpc.<cmd>`` carries the same trace id and finishes the flow, so a
merged fleet trace links them.  A membership eviction leaves a flight-
recorder postmortem.

The sparse row plane (``init_table``, ``push_rows``, ``pull_rows``,
``table_info``, ``set_sparse_optimizer``; ``sparse/`` on the worker) keeps
each embedding table sharded by ``row % num_servers`` as numpy rows on the
host, materialised on first touch from a generator seeded by (key, row),
with the server-placed optimizer's state beside each row.  Its commands
are the JAX package's on the wire, but for ``set_sparse_optimizer``: an
updater travels as this package's pickle behind a package tag, and a
server of either package refuses the other's.  Snapshots hold this
package's classes (the dense updater pickles the port's optimizer, the
sparse one carries the tag), so neither package restores the other's.

.. warning:: **Trust model** — same as the reference's ps-lite: the wire
   format is unauthenticated pickles, so any peer that can connect to the
   server port gets arbitrary code execution in the server process.
   Deploy only on a trusted, isolated network.  The default bind address
   is 127.0.0.1.
"""
from __future__ import annotations

import logging
import os
import pickle
import random
import re
import socket
import socketserver
import struct
import sys
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

# bound at module import, on the importing thread (under the DMLC_ROLE=server
# bootstrap the request threads run while that thread is still inside the
# package import: see _init_kvstore_server_module)
from . import faults
from . import ndarray as nd
from . import optimizer as opt
from . import profiler as _prof
from . import telemetry as _telemetry
from .base import MXNetError
from .base import env as _env
from .base import register_env
from .context import Context, current_context
from .filesystem import atomic_write, verify_crc_sidecar
from .sparse.array import row_merge
from .sparse.updaters import _SparseOptimizer
from .telemetry import tracer

__all__ = ["KVStoreServer", "start_server", "ServerClient",
           "KVStoreConnectionError", "NonFiniteGradientError"]

register_env("MXNET_KVSTORE_RETRY_MAX", 10, int,
             "Max reconnect/replay attempts per kvstore client RPC.")
register_env("MXNET_KVSTORE_RETRY_DEADLINE", 0, float,
             "Overall wall-clock cap in seconds on a client RPC's "
             "reconnect/replay loop; 0 disables.  Once exceeded the RPC "
             "fails with KVStoreConnectionError.")
register_env("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", 60, float,
             "Seconds of heartbeat silence before a rank counts as dead — "
             "the shared default for the dead_nodes RPC and the barrier "
             "dead-peer release.")
register_env("MXNET_KVSTORE_EVICT_TIMEOUT", 0, float,
             "Elastic membership: seconds of heartbeat silence before a "
             "joined rank is evicted from the live set.  0 disables "
             "eviction.")
register_env("MXNET_KVSTORE_RETRY_INITIAL_MS", 50, float,
             "First retry backoff in ms (doubles per attempt).")
register_env("MXNET_KVSTORE_RETRY_MAX_MS", 2000, float,
             "Backoff ceiling in ms.")
register_env("MXNET_KVSTORE_RETRY_JITTER", 0.2, float,
             "Multiplicative backoff jitter fraction.")
register_env("MXNET_KVSTORE_SNAPSHOT_PATH", "", str,
             "Durable snapshot file for the kvstore server; empty "
             "disables journaling.")
register_env("MXNET_KVSTORE_SNAPSHOT_INTERVAL", 30, float,
             "Seconds between periodic server snapshots; <= 0 snapshots "
             "only on demand and clean stop.")
register_env("MXNET_KVSTORE_DEDUP_WINDOW", 4096, int,
             "Completed idempotency records kept per client for replay "
             "matching on the pipelined transport.")
register_env("MXNET_TELEMETRY_STRAGGLER_MULT", 4.0, float,
             "Flag a rank as a straggler when its sync-round merge "
             "latency exceeds this multiple of the round median "
             "(<= 0 disables detection).")
register_env("MXNET_TELEMETRY_STRAGGLER_MIN_MS", 50.0, float,
             "Minimum absolute sync-round latency (ms) before a rank can "
             "be flagged as a straggler.")
register_env("MXNET_KVSTORE_REJECT_NONFINITE", 1, int,
             "Server-side numeric containment: reject gradient pushes "
             "carrying NaN/Inf with a typed NACK.  0 disables the scan.")
register_env("MXNET_KVSTORE_NACK_LIMIT", 0, int,
             "Non-finite push rejections tolerated per rank before the "
             "server evicts it from the elastic membership.  0 never "
             "evicts — pushes are still NACKed.")
register_env("MXNET_KVSTORE_SERVER_CTX", "gpu(0)", str,
             "Context the updater of a DMLC_ROLE=server process runs on: "
             "'gpu(N)' or 'cpu'.")

# the package tag before a pickled sparse updater, on the wire and in a
# snapshot: each package's server refuses the other's updater (the JAX
# server cannot unpickle a tagged one; this one refuses an untagged one)
_UPDATER_TAG = b"mxnet_tpu_torch.sparse:"


# -- retry/backoff knobs -----------------------------------------------------
# A worker-side RPC that hits a dead connection reconnects with exponential
# backoff + jitter and REPLAYS the request under the same idempotency token;
# the server deduplicates, so a push whose ACK was lost is applied exactly
# once (the reference's ps-lite resender solved the same dropped-ACK
# double-apply).
def _retry_conf():
    return {
        "retries": int(os.environ.get("MXNET_KVSTORE_RETRY_MAX", "10")),
        "initial": float(os.environ.get("MXNET_KVSTORE_RETRY_INITIAL_MS",
                                        "50")) / 1e3,
        "cap": float(os.environ.get("MXNET_KVSTORE_RETRY_MAX_MS",
                                    "2000")) / 1e3,
        "jitter": float(os.environ.get("MXNET_KVSTORE_RETRY_JITTER", "0.2")),
        "deadline": float(os.environ.get("MXNET_KVSTORE_RETRY_DEADLINE",
                                         "0")),
    }


def _hb_timeout_default():
    """The one heartbeat-staleness default shared by the ``dead_nodes``
    RPC and the barrier dead-peer release, so eviction and barrier-abort
    agree on who is dead.  ``MXNET_KVSTORE_DEAD_TIMEOUT`` is honored as a
    legacy alias."""
    v = os.environ.get("MXNET_KVSTORE_HEARTBEAT_TIMEOUT")
    if v is None:
        v = os.environ.get("MXNET_KVSTORE_DEAD_TIMEOUT")
    return float(v) if v is not None else 60.0


class KVStoreConnectionError(ConnectionError):
    """A kvstore client RPC gave up: the per-attempt retry budget or the
    ``MXNET_KVSTORE_RETRY_DEADLINE`` wall-clock cap was exhausted.
    Subclasses ConnectionError, so transport handlers still catch it."""


class NonFiniteGradientError(MXNetError):
    """The server NACKed this client's gradient push: it carried NaN/Inf
    values and was never applied to the parameter plane.  Not a
    ConnectionError — retrying the same payload cannot succeed."""


def _backoff_sleep(attempt, conf):
    """Exponential backoff with multiplicative jitter (decorrelates a
    worker fleet hammering a restarting server)."""
    base = min(conf["cap"], conf["initial"] * (2 ** attempt))
    time.sleep(base * (1.0 + conf["jitter"] * random.random()))


# wire: 1 version byte, <payload_len, n_bufs> header, n_bufs buffer lengths,
# pickled metadata, then the raw array buffers out of band (pickle protocol
# 5 buffer_callback): array bytes go from the caller's memory to one
# sendall each, with no pickle-side copy.  The version byte turns a
# mixed-version pair into a clear error instead of an unpickling failure
# mid-stream.  Version 2 is the JAX package's current one (it added the
# sparse plane's commands).
_WIRE_VERSION = 2
_HDR = struct.Struct("<QI")
_LEN = struct.Struct("<Q")


def _nodelay(sock):
    """Small request/reply frames: without TCP_NODELAY the Nagle +
    delayed-ACK interaction adds ~40ms to every per-key round trip."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    return sock


def _widen(arr, dtype):
    """``arr`` as ``dtype``; float16 to float32 through torch's vectorized
    conversion (the same exact values as numpy's, several times faster)."""
    if arr.dtype == np.float16 and dtype == np.float32:
        return torch.from_numpy(np.ascontiguousarray(arr)).float().numpy()
    return np.asarray(arr, dtype=dtype)


def _send_msg(sock, obj, op=None):
    if op is not None:
        faults.fire(op)
    bufs = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    try:
        raws = [b.raw() for b in bufs]
    except BufferError:
        # a non-contiguous ndarray reached the wire (a sliced or transposed
        # view exposes no flat buffer): in-band pickling copies it
        payload = pickle.dumps(obj, protocol=5)
        raws = []
    head = bytes([_WIRE_VERSION]) + _HDR.pack(len(payload), len(raws))
    lens = b"".join(_LEN.pack(r.nbytes) for r in raws)
    sock.sendall(head + lens + payload)  # small metadata: one copy
    for r in raws:                       # array bytes: no copy
        sock.sendall(r)


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return buf


def _recv_msg(sock, op=None):
    if op is not None:
        faults.fire(op)
    ver = _recv_exact(sock, 1)[0]
    if ver != _WIRE_VERSION:
        raise ConnectionError(
            "kvstore wire version mismatch: peer sent %d, this process "
            "speaks %d — worker and server run incompatible builds"
            % (ver, _WIRE_VERSION))
    n, nbuf = _HDR.unpack(_recv_exact(sock, _HDR.size))
    lens = []
    if nbuf:
        raw = _recv_exact(sock, _LEN.size * nbuf)
        lens = [_LEN.unpack_from(raw, i * _LEN.size)[0]
                for i in range(nbuf)]
    payload = _recv_exact(sock, n)
    bufs = [_recv_exact(sock, ln) for ln in lens]
    return pickle.loads(payload, buffers=bufs)


# -- telemetry instruments (global registry; created on first enabled use)
_TELEM = None


def _srv_metrics():
    global _TELEM
    if _TELEM is None:
        reg = _telemetry.registry()
        _TELEM = {
            "rpc_ms": reg.histogram(
                "mxtpu_kvsrv_rpc_ms",
                "Server-side RPC dispatch latency (ms).",
                start=0.05, factor=4.0, count=10),
            "rpc_total": reg.labeled_counter(
                "mxtpu_kvsrv_rpc_total", "cmd", "RPCs dispatched."),
            "dedup": reg.counter(
                "mxtpu_kvsrv_dedup_replays_total",
                "Idempotency replays answered from the dedup window."),
            "snap_ms": reg.gauge(
                "mxtpu_kvsrv_snapshot_ms",
                "Duration of the last durable snapshot (ms)."),
            "snaps": reg.counter(
                "mxtpu_kvsrv_snapshots_total", "Durable snapshots written."),
            "members": reg.gauge(
                "mxtpu_kvsrv_members",
                "Live ranks in the elastic membership table."),
            "joins": reg.counter(
                "mxtpu_kvsrv_joins_total", "Membership join RPCs admitted."),
            "leaves": reg.counter(
                "mxtpu_kvsrv_leaves_total", "Graceful membership leaves."),
            "evictions": reg.counter(
                "mxtpu_kvsrv_evictions_total",
                "Ranks evicted for heartbeat staleness (or by the evict "
                "RPC)."),
            "stragglers": reg.labeled_counter(
                "mxtpu_kvsrv_stragglers_total", "rank",
                "Sync-round contributions slower than "
                "MXNET_TELEMETRY_STRAGGLER_MULT x the round median."),
            "round_skew": reg.gauge(
                "mxtpu_kvsrv_round_skew_ms",
                "Last sync-merge round's max-minus-median contribution "
                "wait (ms)."),
            "rejected": reg.labeled_counter(
                "mxtpu_kvsrv_rejected_pushes_total", "rank",
                "Gradient pushes NACKed for carrying non-finite values "
                "(never applied to the store)."),
            "sparse_pushed": reg.counter(
                "mxtpu_kvsrv_sparse_rows_pushed_total",
                "Row-sparse gradient rows received via push_rows."),
            "sparse_pulled": reg.counter(
                "mxtpu_kvsrv_sparse_rows_pulled_total",
                "Embedding-table rows served via pull_rows."),
            # per-command latency and per-rank round-wait histograms,
            # created lazily as commands and ranks appear; per-table row
            # and byte gauges likewise as tables are initialized
            "rpc_cmd_ms": {},
            "rank_wait_ms": {},
            "table_gauges": {},
        }
    return _TELEM


def _cmd_hist(m, cmd):
    h = m["rpc_cmd_ms"].get(cmd)
    if h is None:
        h = _telemetry.registry().histogram(
            "mxtpu_kvsrv_rpc_%s_ms" % cmd,
            "Server-side %r RPC dispatch latency (ms)." % cmd,
            start=0.05, factor=4.0, count=10)
        m["rpc_cmd_ms"][cmd] = h
    return h


def _rank_wait_hist(m, rank):
    h = m["rank_wait_ms"].get(rank)
    if h is None:
        h = _telemetry.registry().histogram(
            "mxtpu_kvsrv_round_wait_rank%s_ms" % rank,
            "Rank %s's sync-merge contribution wait behind the round's "
            "first arrival (ms)." % rank,
            start=0.5, factor=4.0, count=10)
        m["rank_wait_ms"][rank] = h
    return h


def _register_table_gauges(server, key):
    """Per-key callback gauges over a sharded table's local shard: its row
    count and resident bytes, read at scrape time from the live dicts."""
    if not _telemetry.enabled():
        return
    m = _srv_metrics()
    if key in m["table_gauges"]:
        return
    safe = re.sub(r"[^A-Za-z0-9_]", "_", str(key))
    reg = _telemetry.registry()

    def _rows(server=server, key=key):
        tbl = server.tables.get(key)
        return len(tbl["rows"]) if tbl else 0

    def _bytes(server=server, key=key):
        tbl = server.tables.get(key)
        if not tbl:
            return 0
        return sum(v.nbytes for v in tbl["rows"].values()) + \
            sum(v.nbytes for v in tbl["state"].values())

    m["table_gauges"][key] = (
        reg.gauge("mxtpu_kvsrv_table_rows_%s" % safe,
                  "Rows resident in this server's shard of table %r."
                  % (key,), fn=_rows),
        reg.gauge("mxtpu_kvsrv_table_bytes_%s" % safe,
                  "Bytes resident in this server's shard of table %r "
                  "(rows + optimizer state)." % (key,), fn=_bytes),
    )


def _load_sparse_updater(blob):
    """A sparse updater from its tagged pickle; an untagged pickle (the JAX
    package's client or snapshot) or any other class raises MXNetError."""
    blob = bytes(blob)
    if not blob.startswith(_UPDATER_TAG):
        raise MXNetError(
            "sparse updater not written by mxnet_tpu_torch (a JAX package "
            "client or snapshot?): this server runs only "
            "mxnet_tpu_torch.sparse updaters")
    upd = pickle.loads(blob[len(_UPDATER_TAG):])
    if not isinstance(upd, _SparseOptimizer):
        raise MXNetError("sparse updater %s.%s is not an "
                         "mxnet_tpu_torch.sparse updater"
                         % (type(upd).__module__, type(upd).__name__))
    return upd


def _dump_sparse_updater(upd):
    return _UPDATER_TAG + pickle.dumps(upd, pickle.HIGHEST_PROTOCOL)


class KVStoreServer:
    """Parameter server: a per-key store plus an updater applied on every
    push (async mode, kvstore_dist_server.h:198-206) or once per round of
    one push per worker (sync mode, :164-179).

    Crash tolerance:

    * requests may arrive in an idempotency envelope
      ``("req", client_id, seq, inner[, trace_ctx])``; the server keeps a
      window of completed (seq, reply) per client and replays the recorded
      reply for a retried seq instead of dispatching it again — a push
      whose ACK was lost on the wire is applied exactly once.
    * with ``snapshot_path`` set (or ``MXNET_KVSTORE_SNAPSHOT_PATH``), the
      server state — store, updater (with its live optimizer states),
      barrier generation, sync-merge rounds, dedup records, membership —
      is written to an atomic CRC-checked snapshot every
      ``snapshot_interval`` seconds, on clean stop, and on the ``snapshot``
      command; a restarted server restores it.

    Elastic membership: once workers ``join`` the live-rank table,
    barriers and sync-merge rounds are sized by the current membership
    instead of the static ``num_workers``; a ``leave`` (preemption), an
    ``evict`` or a stale heartbeat (``MXNET_KVSTORE_EVICT_TIMEOUT``)
    shrinks the job and renormalizes the merged gradient by the live
    count; a mid-run ``join`` grows it back.

    ``ctx`` is where the updater runs (default: the constructing thread's
    current context).
    """

    def __init__(self, host="127.0.0.1", port=0, num_workers=1,
                 sync_mode=False, snapshot_path=None, snapshot_interval=None,
                 evict_timeout=None, ctx=None):
        self.num_workers = num_workers
        self.sync_mode = sync_mode
        self.ctx = Context(ctx) if ctx is not None else current_context()
        self.store: Dict[object, np.ndarray] = {}
        self.updater = None
        self._lock = threading.Lock()
        self._barrier_ranks = set()
        self._barrier_gen = 0
        self._barrier_cv = threading.Condition()
        self._merge: Dict[object, list] = {}
        # the sparse row plane: per-key sharded embedding tables, each
        # {"meta": {...}, "rows": {row_id: ndarray}, "state": {row_id:
        # ndarray}}.  This server holds only the rows with row_id %
        # num_servers == server_index, materialized on first touch, with
        # the server-placed optimizer's state beside them.  _sparse_merge
        # mirrors _merge for sync-mode rounds: {rank: (ids, vals)} each
        self.tables: Dict[object, dict] = {}
        self.sparse_updater = None
        self._sparse_merge: Dict[object, list] = {}
        self.applied_row_pushes = 0  # distinct (non-replayed) push_rows
        # seconds spent gathering and updating rows, read by stats
        self.sparse_seconds = 0.0
        # re-seeded for each lazy row (under _lock): the same bytes as a
        # new RandomState(seed) per row at a fraction of its cost
        self._row_rng = np.random.RandomState(0)
        # telemetry-only shadow of _merge: per-round {rank: arrival ts}
        # for straggler detection, kept apart so timestamps never reach
        # the snapshot
        self._merge_ts: Dict[object, list] = {}
        self._stop = threading.Event()
        # elastic membership: the live-rank set replaces the static
        # num_workers in barriers and sync-merge rounds once workers join;
        # _mgen is bumped on every join/leave/evict.  Lock ordering:
        # membership is guarded by _lock and mutated only while holding
        # _barrier_cv first (_barrier_cv -> _lock)
        self._members: set = set()
        self._mgen = 0
        self._evict_timeout = float(
            evict_timeout if evict_timeout is not None
            else os.environ.get("MXNET_KVSTORE_EVICT_TIMEOUT", "0"))
        # liveness: rank -> monotonic time of its last heartbeat
        self._heartbeats: Dict[int, float] = {}
        # idempotency records: client_id -> {"floor", "window"}, window an
        # OrderedDict seq -> {"done", "reply"}; "floor" rises as done
        # entries are evicted, and a retried seq at or below it is stale
        self._dedup: Dict[str, dict] = {}
        self._dedup_cv = threading.Condition()
        self.applied_pushes = 0  # distinct (non-replayed) push applications
        self.rejected_pushes = 0
        self.rejects_by_rank: Dict[int, int] = {}
        # contribution-count histogram of flushed sync-merge rounds
        # ({3: 40, 2: 7} = 40 full rounds, 7 renormalized 2-worker rounds)
        self.round_sizes: Dict[int, int] = {}
        # seconds spent in the updater (host -> device, update, device ->
        # host), read by the stats command
        self.update_seconds = 0.0
        self.restored = False
        self.snapshot_path = snapshot_path if snapshot_path is not None \
            else (os.environ.get("MXNET_KVSTORE_SNAPSHOT_PATH") or None)
        self._snap_interval = float(
            snapshot_interval if snapshot_interval is not None
            else os.environ.get("MXNET_KVSTORE_SNAPSHOT_INTERVAL", "30"))
        if self.snapshot_path:
            self.restored = self._restore_snapshot()
        server_self = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                _nodelay(self.request)

            def handle(self):
                # pipelined connections: enveloped requests are answered
                # as ("rsp", seq, reply) so the client's reader thread can
                # match replies to in-flight tokens out of order; a bare
                # message gets a bare reply.  The send lock serializes the
                # main loop and parked barrier threads on this socket
                send_lock = threading.Lock()
                sock = self.request

                def respond(wrapped, seq, reply):
                    out = ("rsp", seq, reply) if wrapped else reply
                    with send_lock:
                        _send_msg(sock, out, op="kv.server.send")

                try:
                    while True:
                        msg = _recv_msg(sock, op="kv.server.recv")
                        if isinstance(msg, tuple) and msg and \
                                msg[0] == "req":
                            # slot 4: the trace context of a telemetry-
                            # enabled client
                            cid, seq, inner = msg[1], msg[2], msg[3]
                            ctx = msg[4] if len(msg) > 4 else None
                            wrapped = True
                        else:
                            cid, seq, inner, ctx = None, None, msg, None
                            wrapped = False
                        if wrapped and inner[0] == "barrier":
                            # a barrier parks; serve it off-thread so the
                            # pipelined requests behind it keep flowing
                            def run(cid=cid, seq=seq, inner=inner, ctx=ctx):
                                try:
                                    respond(True, seq, server_self.
                                            _serve_one(cid, seq, inner, ctx))
                                except (ConnectionError, OSError):
                                    pass

                            threading.Thread(target=run, daemon=True).start()
                            continue
                        reply = server_self._serve_one(cid, seq, inner, ctx)
                        respond(wrapped, seq, reply)
                        if inner[0] == "stop":
                            break
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.addr = self._server.server_address
        self._snap_thread = None
        if self.snapshot_path and self._snap_interval > 0:
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, name="kvsrv-snapshot",
                daemon=True)
            self._snap_thread.start()
        self._evict_thread = None
        if self._evict_timeout > 0:
            self._evict_thread = threading.Thread(
                target=self._evictor_loop, name="kvsrv-evictor", daemon=True)
            self._evict_thread.start()

    # -- idempotent request admission --------------------------------------
    def _serve_one(self, cid, seq, msg, ctx=None):
        """Dispatch one request, deduplicating retries by (cid, seq).  A
        replayed token returns the recorded reply (waiting out a still-
        running original, e.g. a barrier whose connection died while
        parked) without running the command again.  ``ctx`` is the
        envelope's trace context, if any."""
        if cid is None:
            return self._dispatch_timed(msg, ctx)
        with self._dedup_cv:
            rec = self._dedup.setdefault(
                cid, {"floor": 0, "window": OrderedDict()})
            ent = rec["window"].get(seq)
            if ent is not None:
                if _telemetry.enabled():
                    _srv_metrics()["dedup"].inc()
                while not ent["done"]:
                    self._dedup_cv.wait(0.1)
                return ent["reply"]
            if seq <= rec["floor"]:
                return ("err", "stale request token %s <= %s (client %s)"
                        % (seq, rec["floor"], cid))
            ent = {"done": False, "reply": None}
            rec["window"][seq] = ent
        reply = self._dispatch_timed(msg, ctx)
        with self._dedup_cv:
            if rec["window"].get(seq) is ent:
                ent["reply"] = reply
                ent["done"] = True
                self._evict_dedup_locked(rec)
                self._dedup_cv.notify_all()
        return reply

    @staticmethod
    def _evict_dedup_locked(rec):
        """Trim a client's dedup window to MXNET_KVSTORE_DEDUP_WINDOW done
        entries, raising the stale floor past what falls off.  A pending
        entry stops eviction — its token must stay replayable."""
        limit = max(1, int(os.environ.get("MXNET_KVSTORE_DEDUP_WINDOW",
                                          "4096")))
        win = rec["window"]
        while len(win) > limit:
            s, e = next(iter(win.items()))
            if not e["done"]:
                break
            del win[s]
            if s > rec["floor"]:
                rec["floor"] = s

    def _dispatch_safe(self, msg):
        try:
            return self._dispatch(msg)
        except Exception as e:  # keep serving; tell the client
            return ("err", "%s: %s" % (type(e).__name__, e))

    def _dispatch_timed(self, msg, ctx=None):
        """_dispatch_safe plus telemetry (off: one bool read): the RPC
        latency histograms, overall and per command, the per-command
        counter, and a span on the merged trace carrying the envelope's
        trace context, so the handler span shares the client span's trace
        id."""
        if not _telemetry.enabled():
            return self._dispatch_safe(msg)
        cmd = msg[0] if isinstance(msg, tuple) and msg else "?"
        m = _srv_metrics()
        args = None
        if ctx:
            trace = ctx.get("trace")
            args = {"trace": trace,
                    "src": "%s%s" % (ctx.get("role", "?"),
                                     ctx.get("rank", "?"))}
            if trace is not None:
                # finish the flow the client started: the merged fleet
                # trace draws the arrow client span -> this handler span
                tracer.flow_event("kv.rpc", "f", trace)
        t0 = time.perf_counter()
        with _prof.Frame("kv.rpc.%s" % cmd, "kvserver", args=args):
            reply = self._dispatch_safe(msg)
        dur_ms = (time.perf_counter() - t0) * 1e3
        m["rpc_ms"].observe(dur_ms)
        _cmd_hist(m, cmd).observe(dur_ms)
        m["rpc_total"].inc(cmd)
        return reply

    # -- message dispatch --------------------------------------------------
    def _dispatch(self, msg):
        cmd = msg[0]
        if cmd == "init":
            _, key, arr = msg
            with self._lock:
                self.store.setdefault(key, np.array(arr))
            return ("ok",)
        if cmd == "multi":
            # a fused bucket of inner commands: one envelope is one dedup
            # record, so exactly-once replay covers the whole bucket.  The
            # inner commands bypass _dispatch_timed, so count them here
            if _telemetry.enabled():
                counts = _srv_metrics()["rpc_total"]
                for im in msg[1]:
                    counts.inc(im[0] if isinstance(im, tuple) and im
                               else "?")
            return ("ok", [self._dispatch_safe(m) for m in msg[1]])
        if cmd == "push":
            key, arr = msg[1], msg[2]
            rank = msg[3] if len(msg) > 3 else 0
            nack = self._reject_nonfinite("push", key, arr, rank)
            if nack is not None:
                return nack
            with self._lock:
                if self.sync_mode and self._members \
                        and rank not in self._members:
                    # an evicted or departed rank's in-flight push: ack it
                    # (the client would retry an error) but keep it out of
                    # the survivors' rounds
                    return ("ok",)
                stored = self.store.get(key)
                if stored is not None and \
                        np.asarray(arr).dtype != stored.dtype:
                    # fp16 wire compression: merge and update at the
                    # stored precision
                    arr = _widen(np.asarray(arr), stored.dtype)
                self.applied_pushes += 1
                if self.sync_mode:
                    # per-worker rounds: a fast worker's next push must not
                    # count toward the current round
                    rounds = self._merge.setdefault(key, [])
                    placed_at = None
                    for i, rnd in enumerate(rounds):
                        if rank not in rnd:
                            rnd[rank] = np.asarray(arr)
                            placed_at = i
                            break
                    if placed_at is None:
                        rounds.append({rank: np.asarray(arr)})
                        placed_at = len(rounds) - 1
                    if _telemetry.enabled():
                        tss = self._merge_ts.setdefault(key, [])
                        while len(tss) <= placed_at:
                            tss.append({})
                        tss[placed_at][rank] = time.monotonic()
                    self._flush_rounds_locked(key)
                else:
                    self._apply(key, np.asarray(arr))
            return ("ok",)
        if cmd == "pull":
            _, key = msg
            with self._lock:
                if key not in self.store:
                    return ("err", "uninitialized key %r" % (key,))
                return ("ok", self.store[key])
        if cmd == "set_optimizer":
            is_recovery = bool(msg[2]) if len(msg) > 2 else False
            optimizer = pickle.loads(msg[1])
            with self._lock:
                # a rejoining rank 0 re-ships the optimizer it launched
                # with; installing it fresh would reset live optimizer
                # states mid-training — keep the installed updater
                if not (is_recovery and self.updater is not None):
                    self.updater = opt.get_updater(optimizer)
            return ("ok",)
        # -- the sparse row plane (wire v2) ----------------------------
        if cmd == "init_table":
            _, key, meta = msg
            meta = dict(meta)
            meta.setdefault("num_servers", 1)
            meta.setdefault("server_index", 0)
            meta.setdefault("init", ("zeros",))
            meta.setdefault("dtype", "float32")
            with self._lock:
                if key not in self.tables:
                    self.tables[key] = {"meta": meta, "rows": {},
                                        "state": {}}
            _register_table_gauges(self, key)
            return ("ok",)
        if cmd == "push_rows":
            faults.fire("kv.server.push_rows")
            key, row_ids, values = msg[1], msg[2], msg[3]
            rank = msg[4] if len(msg) > 4 else 0
            nack = self._reject_nonfinite("push_rows", key, values, rank)
            if nack is not None:
                return nack
            with self._lock:
                if key not in self.tables:
                    return ("err", "uninitialized table %r" % (key,))
                if self.sync_mode and self._members \
                        and rank not in self._members:
                    # an evicted or departed rank's in-flight push: ack it
                    # but keep it out of the survivors' rounds
                    return ("ok",)
                ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
                vals = np.asarray(values)
                self.applied_row_pushes += 1
                if _telemetry.enabled():
                    _srv_metrics()["sparse_pushed"].inc(ids.shape[0])
                if self.sync_mode:
                    # per-worker rounds, as on the dense path
                    rounds = self._sparse_merge.setdefault(key, [])
                    for rnd in rounds:
                        if rank not in rnd:
                            rnd[rank] = (ids, vals)
                            break
                    else:
                        rounds.append({rank: (ids, vals)})
                    self._flush_sparse_rounds_locked(key)
                else:
                    # duplicate ids summed first: the write-back is per row
                    ids, vals = row_merge(ids, vals)
                    self._apply_rows_locked(key, ids, vals)
            return ("ok",)
        if cmd == "pull_rows":
            faults.fire("kv.server.pull_rows")
            _, key, row_ids = msg
            with self._lock:
                if key not in self.tables:
                    return ("err", "uninitialized table %r" % (key,))
                ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
                out = self._gather_rows_locked(key, ids)
                if _telemetry.enabled():
                    _srv_metrics()["sparse_pulled"].inc(ids.shape[0])
                return ("ok", out)
        if cmd == "table_info":
            want = msg[1] if len(msg) > 1 else None
            with self._lock:
                info = {}
                for key, tbl in self.tables.items():
                    if want is not None and key != want:
                        continue
                    meta = tbl["meta"]
                    ns = int(meta.get("num_servers", 1))
                    si = int(meta.get("server_index", 0))
                    misplaced = sum(1 for r in tbl["rows"]
                                    if int(r) % ns != si)
                    info[key] = {
                        "rows": len(tbl["rows"]),
                        "state_rows": len(tbl["state"]),
                        "bytes": (sum(v.nbytes
                                      for v in tbl["rows"].values())
                                  + sum(v.nbytes
                                        for v in tbl["state"].values())),
                        "misplaced": misplaced,
                        "meta": dict(meta),
                    }
                return ("ok", info)
        if cmd == "set_sparse_optimizer":
            is_recovery = bool(msg[2]) if len(msg) > 2 else False
            updater = _load_sparse_updater(msg[1])
            with self._lock:
                # a rejoining rank 0 must not reset live optimizer state
                if not (is_recovery and self.sparse_updater is not None):
                    self.sparse_updater = updater
            return ("ok",)
        if cmd == "heartbeat":
            rank = int(msg[1])
            with self._lock:
                self._heartbeats[rank] = time.monotonic()
            return ("ok",)
        if cmd == "dead_nodes":
            timeout_s = (float(msg[1])
                         if len(msg) > 1 and msg[1] is not None
                         else _hb_timeout_default())
            return ("ok", self._dead_nodes(timeout_s))
        if cmd == "join":
            # admit the rank into the live set, bump the generation,
            # baseline its heartbeat, and hand back the fleet view so a
            # mid-run joiner can align
            rank = int(msg[1])
            with self._barrier_cv:
                with self._lock:
                    fresh = rank not in self._members
                    self._members.add(rank)
                    self._heartbeats[rank] = time.monotonic()
                    if fresh:
                        self._mgen += 1
                    gen = self._mgen
                    ranks = sorted(self._members)
                self._barrier_cv.notify_all()
            if fresh:
                self._note_membership("join", rank, gen, ranks)
                logging.info("kvstore membership: rank %d joined (gen %d, "
                             "live %s)", rank, gen, ranks)
            return ("ok", {"gen": gen, "ranks": ranks,
                           "num_workers": self.num_workers})
        if cmd == "leave":
            # graceful preemption exit: drop the rank now so survivors'
            # barriers and rounds re-form without waiting for eviction
            with self._barrier_cv:
                gen = self._evict_members_locked([int(msg[1])], "leave")
            return ("ok", gen)
        if cmd == "evict":
            with self._barrier_cv:
                gen = self._evict_members_locked([int(msg[1])], "evict rpc")
            return ("ok", gen)
        if cmd == "membership":
            with self._lock:
                return ("ok", {"gen": self._mgen,
                               "ranks": sorted(self._members),
                               "num_workers": self.num_workers})
        if cmd == "barrier":
            return self._barrier(msg)
        if cmd == "snapshot":
            # a durable snapshot now (workers quiesce at a barrier, rank 0
            # snapshots, and the job is then kill-safe to that point)
            path = self.snapshot()
            if path is None:
                return ("err", "server has no snapshot_path configured")
            return ("ok", path)
        if cmd == "stats":
            with self._lock:
                return ("ok", {"applied_pushes": self.applied_pushes,
                               "rejected_pushes": self.rejected_pushes,
                               "round_sizes": dict(self.round_sizes),
                               "update_seconds": self.update_seconds,
                               "ctx": str(self.ctx),
                               "device_peak_bytes": self._device_peak(),
                               "keys": len(self.store),
                               "applied_row_pushes": self.applied_row_pushes,
                               "sparse_seconds": self.sparse_seconds,
                               "tables": len(self.tables),
                               "restored": self.restored})
        if cmd == "stop":
            self._stop.set()
            try:
                self.snapshot()
            except Exception as e:
                logging.warning("kvstore snapshot on stop failed: %s", e)
            threading.Thread(target=self._server.shutdown,
                             daemon=True).start()
            return ("ok",)
        return ("err", "unknown command %r" % (cmd,))

    def _device_peak(self):
        """Peak device memory of this process on the server's card (0 on
        the CPU)."""
        if self.ctx.device_type != "gpu":
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated(self.ctx.device_id))

    def _barrier(self, msg):
        rank = int(msg[1]) if len(msg) > 1 else 0
        is_recovery = bool(msg[2]) if len(msg) > 2 else False
        timeout = float(os.environ.get("MXNET_KVSTORE_BARRIER_TIMEOUT",
                                       "600"))
        hb_timeout = _hb_timeout_default()
        deadline = time.monotonic() + timeout
        with self._barrier_cv:
            # rejoin semantics (reference kvstore_dist.h:35-38): a
            # recovered worker skips a barrier only when the job has
            # passed startup (a generation completed) and no peers are
            # parked at one — if they are, it must join and release them.
            # Arrivals are tracked per rank so a worker that crashed after
            # arriving cannot count twice
            if (is_recovery and self._barrier_gen > 0
                    and not self._barrier_ranks):
                return ("ok",)
            gen = self._barrier_gen
            self._barrier_ranks.add(rank)
            if self._try_release_barrier_locked():
                return ("ok",)
            # wake periodically: a dead peer (stale heartbeat) releases the
            # barrier — by eviction (elastic: the barrier re-forms around
            # the survivors) or by abort (static: the callers see the
            # failure) — instead of hanging to the timeout
            while True:
                released = self._barrier_cv.wait_for(
                    lambda: self._barrier_gen != gen,
                    timeout=min(1.0, max(deadline - time.monotonic(),
                                         0.01)))
                if released:
                    return ("ok",)
                if self._evict_timeout > 0 and self._members:
                    stale = self._stale_members(self._evict_timeout)
                    if stale:
                        self._evict_members_locked(stale, "stale heartbeat")
                        if self._barrier_gen != gen:
                            return ("ok",)
                else:
                    dead = self._dead_nodes(hb_timeout)
                    if dead:
                        if self._barrier_gen == gen:
                            self._barrier_ranks.discard(rank)
                        return ("err",
                                "barrier aborted: dead workers %s" % dead)
                if time.monotonic() >= deadline:
                    if self._barrier_gen == gen:
                        self._barrier_ranks.discard(rank)
                    return ("err",
                            "barrier timed out after %.0fs" % timeout)

    def _dead_nodes(self, timeout_s):
        """Ranks whose last heartbeat is older than ``timeout_s`` (only
        ranks that have heartbeated are tracked)."""
        now = time.monotonic()
        with self._lock:
            return sorted(r for r, t in self._heartbeats.items()
                          if now - t > timeout_s)

    # -- elastic membership ------------------------------------------------
    def _round_complete_locked(self, rnd):
        """A sync-merge round is ready when every live member contributed;
        before any member joined (a static launch) it counts
        ``num_workers`` contributions.  Caller holds ``_lock``."""
        if self._members:
            return self._members <= set(rnd)
        return len(rnd) >= self.num_workers

    def _flush_rounds_locked(self, key):
        """Apply every leading complete merge round for ``key`` (caller
        holds ``_lock``).  When the live set has shrunk below the nominal
        worker count, the merged gradient is renormalized by
        ``num_workers / len(round)``: workers scale by ``1/num_workers``
        of the launch-time fleet, so without the correction a shrink would
        silently shrink the effective learning rate too."""
        rounds = self._merge.get(key)
        while rounds and self._round_complete_locked(rounds[0]):
            rnd = rounds.pop(0)
            tss = self._merge_ts.get(key)
            self._note_round_latency(key, tss.pop(0) if tss else None)
            self.round_sizes[len(rnd)] = self.round_sizes.get(len(rnd), 0) + 1
            vals = list(rnd.values())
            # two contributions: one add, the bits of np.sum's, without
            # stacking a copy of both
            merged = vals[0] + vals[1] if len(vals) == 2 else \
                np.sum(vals, axis=0)
            if self._members and len(rnd) != self.num_workers:
                merged = np.asarray(
                    merged * (float(self.num_workers) / len(rnd)),
                    dtype=merged.dtype)
            self._apply(key, merged)

    def _note_round_latency(self, key, tsr):
        """Straggler detection over one completed sync-merge round (caller
        holds ``_lock``): per-rank round-wait histograms, the round's
        max-minus-median skew gauge, and a ``straggler`` event plus a
        rank-labeled counter when a rank's wait exceeds
        ``MXNET_TELEMETRY_STRAGGLER_MULT`` times the round median (and
        ``..._MIN_MS``)."""
        if tsr is None or len(tsr) < 2 or not _telemetry.enabled():
            return
        import statistics

        t0 = min(tsr.values())
        lats = {r: (t - t0) * 1e3 for r, t in tsr.items()}
        med = statistics.median(lats.values())
        m = _srv_metrics()
        for r, lat in lats.items():
            _rank_wait_hist(m, r).observe(lat)
        m["round_skew"].set(max(lats.values()) - med)
        mult = _env("MXNET_TELEMETRY_STRAGGLER_MULT", 4.0, float)
        if mult <= 0:
            return
        min_ms = _env("MXNET_TELEMETRY_STRAGGLER_MIN_MS", 50.0, float)
        for r, lat in sorted(lats.items()):
            if lat >= min_ms and lat > mult * max(med, 1e-9):
                m["stragglers"].inc(str(r))
                _telemetry.log_event(
                    "straggler", key=str(key), rank=r,
                    lat_ms=round(lat, 3), median_ms=round(med, 3),
                    mult=mult, round_size=len(tsr))

    def _reject_nonfinite(self, cmd, key, values, rank):
        """Numeric containment: a gradient push carrying NaN/Inf gets a
        typed NACK and never touches the store or the merge rounds.  Runs
        inside the dedup-recorded dispatch, so a retried push replays the
        same NACK without counting twice.  Returns the NACK, or None to
        admit the push."""
        if _env("MXNET_KVSTORE_REJECT_NONFINITE", 1, int) == 0:
            return None
        a = np.asarray(values)
        if not np.issubdtype(a.dtype, np.floating) or \
                bool(np.all(np.isfinite(a))):
            return None
        with self._lock:
            self.rejected_pushes += 1
            n = self.rejects_by_rank.get(rank, 0) + 1
            self.rejects_by_rank[rank] = n
        if _telemetry.enabled():
            _srv_metrics()["rejected"].inc(str(rank))
            _telemetry.log_event("kv_nack", cmd=cmd, key=str(key),
                                 rank=rank, count=n)
        limit = _env("MXNET_KVSTORE_NACK_LIMIT", 0, int)
        if limit > 0 and n >= limit:
            self._flag_poisoned(rank, n)
        return ("nack", "nonfinite",
                "%s from rank %s to key %r carries non-finite values "
                "(rejection %d for this rank)" % (cmd, rank, key, n))

    def _flag_poisoned(self, rank, n):
        """A rank crossed MXNET_KVSTORE_NACK_LIMIT rejections: count it as
        a straggler and, if it holds elastic membership, evict it like a
        heartbeat-dead rank."""
        if _telemetry.enabled():
            _srv_metrics()["stragglers"].inc(str(rank))
            _telemetry.log_event("poisoned_worker", rank=rank,
                                 rejections=n)
        with self._lock:
            member = bool(self._members) and rank in self._members
        if member:
            with self._barrier_cv:
                self._evict_members_locked(
                    [rank], "poisoned (%d non-finite pushes)" % n)

    def _try_release_barrier_locked(self):
        """Release the parked barrier if every required rank arrived
        (caller holds ``_barrier_cv``): the live membership in elastic
        mode, else ``num_workers`` arrivals."""
        with self._lock:
            members = set(self._members)
        if members:
            ready = members <= self._barrier_ranks
        else:
            ready = len(self._barrier_ranks) >= self.num_workers
        if ready:
            self._barrier_ranks = set()
            self._barrier_gen += 1
            self._barrier_cv.notify_all()
        return ready

    def _stale_members(self, timeout_s):
        """Live members whose heartbeat is older than ``timeout_s``; one
        without a record yet is re-baselined to now."""
        now = time.monotonic()
        with self._lock:
            out = []
            for r in sorted(self._members):
                t = self._heartbeats.get(r)
                if t is None:
                    self._heartbeats[r] = now
                elif now - t > timeout_s:
                    out.append(r)
            return out

    def _evict_members_locked(self, ranks, reason):
        """Remove ``ranks`` from the live membership (caller holds
        ``_barrier_cv``): bump the generation, discard their partial
        merge-round contributions, flush the rounds the smaller set now
        completes, and re-form a parked barrier around the survivors.
        Returns the membership generation."""
        with self._lock:
            gone = [r for r in ranks if r in self._members]
            for r in gone:
                self._members.discard(r)
                self._heartbeats.pop(r, None)
            if gone:
                self._mgen += 1
                for rounds in self._merge.values():
                    for rnd in rounds:
                        for r in gone:
                            rnd.pop(r, None)
                for rounds in self._sparse_merge.values():
                    for rnd in rounds:
                        for r in gone:
                            rnd.pop(r, None)
                for tss in self._merge_ts.values():
                    for tsr in tss:
                        for r in gone:
                            tsr.pop(r, None)
                for key in list(self._merge):
                    self._flush_rounds_locked(key)
                for key in list(self._sparse_merge):
                    self._flush_sparse_rounds_locked(key)
            gen = self._mgen
            ranks_now = sorted(self._members)
        if gone:
            self._barrier_ranks -= set(gone)
            if self._barrier_ranks:
                self._try_release_barrier_locked()
            self._barrier_cv.notify_all()
            for r in gone:
                self._note_membership(
                    "leave" if reason == "leave" else "evict",
                    r, gen, ranks_now, reason=reason)
            logging.info("kvstore membership: %s — rank(s) %s removed "
                         "(gen %d, live %s)", reason, gone, gen, ranks_now)
            if reason != "leave" and _telemetry.enabled():
                # an eviction is a death the victim could not report: the
                # server's flight recorder keeps the evidence (round state,
                # membership events, recent spans)
                _telemetry.flight_recorder.dump(
                    "evict:%s" % reason,
                    extra={"evicted": gone, "gen": gen,
                           "live": ranks_now})
        return gen

    def _note_membership(self, kind, rank, gen, ranks, reason=None):
        if not _telemetry.enabled():
            return
        m = _srv_metrics()
        m["members"].set(len(ranks))
        if kind == "join":
            m["joins"].inc()
        elif kind == "leave":
            m["leaves"].inc()
        else:
            m["evictions"].inc()
        fields = {"change": kind, "rank": rank, "gen": gen,
                  "live": list(ranks)}
        if reason:
            fields["reason"] = reason
        _telemetry.log_event("kvsrv_membership", **fields)

    def _evictor_loop(self):
        """Background stale-member eviction, also when no barrier is
        parked (async mode, or sync workers waiting on a round)."""
        poll = max(0.05, min(1.0, self._evict_timeout / 4.0))
        while not self._stop.wait(poll):
            try:
                faults.fire("kv.server.evict")
                with self._barrier_cv:
                    stale = self._stale_members(self._evict_timeout)
                    if stale:
                        self._evict_members_locked(stale, "stale heartbeat")
            except Exception as e:
                logging.warning("kvstore evictor: %s", e)

    def _apply(self, key, grad):
        """Run the updater on the server's context (reference DataHandle:
        updater_(key, recved, &stored)); without one, accumulate like the
        reference default."""
        if key not in self.store:
            self.store[key] = np.array(grad)
            return
        if self.updater is None:
            self.store[key] = self.store[key] + grad
            return
        t0 = time.perf_counter()
        weight = self._on_ctx(self.store[key], copy=True)
        self.updater(key, self._on_ctx(grad, copy=False), weight)
        # a new array each update: a pull may still be sending the old one
        x = weight._data.detach()
        self.store[key] = x.cpu().numpy() if x.is_cuda else \
            x.numpy().copy()
        self.update_seconds += time.perf_counter() - t0

    def _on_ctx(self, arr, copy):
        """A host array as an NDArray on the server's context: one copy to
        the card (float32 goes straight from the host buffer; other dtypes
        take ``nd.array``'s rules); on the CPU a view unless ``copy``."""
        if arr.dtype != np.float32:
            return nd.array(arr, ctx=self.ctx)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.ctx.device_type == "gpu":
            t = t.to(self.ctx.torch_device())
        elif copy:
            t = t.clone()
        return nd.NDArray(t, self.ctx)

    # -- sparse tables ------------------------------------------------------
    def _row_init(self, meta, key, row_ids):
        """Materialize absent rows as one (len(row_ids), *row_shape) block
        (caller holds ``_lock``).  Each row's seed is a function of (key,
        row_id) only, the JAX package's ``crc32("%r:%d")``, and its draws
        are the JAX server's ``uniform``/``standard_normal`` bits:
        resharding or a restart reproduces the same bytes, and so does the
        JAX server.  The draws are taken per row, then scaled and cast for
        the block at once, which rounds alike."""
        shape = tuple(meta.get("row_shape", ()))
        dtype = np.dtype(meta.get("dtype", "float32"))
        spec = tuple(meta.get("init", ("zeros",)))
        kind = spec[0]
        n = len(row_ids)
        if kind == "zeros":
            return np.zeros((n,) + shape, dtype=dtype)
        if kind == "constant":
            return np.full((n,) + shape, spec[1], dtype=dtype)
        if kind not in ("uniform", "normal"):
            raise ValueError("unknown sparse init spec %r" % (spec,))
        draws = np.empty((n,) + shape, dtype=np.float64)
        prefix = zlib.crc32(("%r:" % (key,)).encode())
        rng = self._row_rng
        for i, r in enumerate(row_ids):
            rng.seed(zlib.crc32(b"%d" % r, prefix))
            draws[i] = (rng.random_sample(shape) if kind == "uniform"
                        else rng.standard_normal(size=shape))
        scale = float(spec[1]) if len(spec) > 1 else 0.01
        if kind == "uniform":
            # RandomState.uniform(low, high): low + (high - low) * u
            return ((-scale) + (scale - (-scale)) * draws).astype(dtype)
        return (draws * scale).astype(dtype)

    def _gather_rows_locked(self, key, ids):
        """The requested rows stacked into one (n, *row_shape) array,
        absent rows materialized (caller holds ``_lock``)."""
        t0 = time.perf_counter()
        tbl = self.tables[key]
        rows, meta = tbl["rows"], tbl["meta"]
        out = np.empty((ids.shape[0],) + tuple(meta.get("row_shape", ())),
                       dtype=np.dtype(meta.get("dtype", "float32")))
        idl = ids.tolist()
        got = [rows.get(r) for r in idl]
        miss = [i for i, row in enumerate(got) if row is None]
        if miss:
            fresh = self._row_init(meta, key, [idl[i] for i in miss])
            for i, row in zip(miss, fresh):
                # a repeated id materializes once
                got[i] = rows.setdefault(idl[i], row)
        for i, row in enumerate(got):
            out[i] = row
        self.sparse_seconds += time.perf_counter() - t0
        return out

    def _apply_rows_locked(self, key, ids, vals):
        """Apply a merged row-sparse gradient block to this shard: the
        server-placed updater over the touched rows (their optimizer state
        materialized as zeros on first touch), or an accumulation when no
        updater is installed (caller holds ``_lock``)."""
        tbl = self.tables[key]
        meta = tbl["meta"]
        weight = self._gather_rows_locked(key, ids)
        t0 = time.perf_counter()
        if vals.dtype != weight.dtype:
            # fp16 wire compression: the update runs at the stored dtype
            vals = np.asarray(vals, dtype=weight.dtype)
        upd = self.sparse_updater
        rid = ids.tolist()
        if upd is None:
            weight += vals
        else:
            sshape = upd.state_shape(tuple(meta.get("row_shape", ())))
            if sshape is None:
                upd.update_rows(weight, vals, None)
            else:
                state_rows = tbl["state"]
                states = np.empty((ids.shape[0],) + tuple(sshape),
                                  dtype=weight.dtype)
                for i, r in enumerate(rid):
                    s = state_rows.get(r)
                    states[i] = 0 if s is None else s
                upd.update_rows(weight, vals, states)
                state_rows.update(zip(rid, states))
        tbl["rows"].update(zip(rid, weight))
        self.sparse_seconds += time.perf_counter() - t0

    def _flush_sparse_rounds_locked(self, key):
        """Sparse twin of ``_flush_rounds_locked`` (caller holds
        ``_lock``): pop every leading complete round, concatenate its
        contributions, sum duplicate row ids, renormalize by
        ``num_workers / len(round)`` when the live set has shrunk, and
        apply the merged block."""
        rounds = self._sparse_merge.get(key)
        while rounds and self._round_complete_locked(rounds[0]):
            rnd = rounds.pop(0)
            faults.fire("sparse.merge")
            self.round_sizes[len(rnd)] = self.round_sizes.get(len(rnd), 0) + 1
            ids = np.concatenate([c[0] for c in rnd.values()])
            vals = np.concatenate([c[1] for c in rnd.values()])
            ids, vals = row_merge(ids, vals)
            if self._members and len(rnd) != self.num_workers:
                vals = np.asarray(
                    vals * (float(self.num_workers) / len(rnd)),
                    dtype=vals.dtype)
            self._apply_rows_locked(key, ids, vals)

    # -- durable snapshots --------------------------------------------------
    # Version 4 of the JAX package's format: v2 dedup windows, v3 the
    # membership table ("members", "mgen"), v4 the sparse plane (the tables
    # with their rows, optimizer state and meta, the sparse updater behind
    # the package tag, pending sparse rounds, applied_row_pushes).  The
    # "package" key marks the port's; sparse state without it (the JAX
    # package's) is refused.
    _SNAP_VERSION = 4

    def snapshot(self):
        """Write the server state to ``snapshot_path`` atomically (temp +
        fsync + replace, CRC32 sidecar).  Returns the path, or None when
        no snapshot path is configured."""
        if not self.snapshot_path:
            return None
        snap_t0 = time.perf_counter()
        with self._lock:
            store = dict(self.store)
            merge = {k: [dict(rnd) for rnd in rounds]
                     for k, rounds in self._merge.items()}
            updater_bytes = (pickle.dumps(self.updater,
                                          pickle.HIGHEST_PROTOCOL)
                             if self.updater is not None else None)
            applied = self.applied_pushes
            members = sorted(self._members)
            mgen = self._mgen
            tables = {k: {"meta": dict(t["meta"]),
                          "rows": dict(t["rows"]),
                          "state": dict(t["state"])}
                      for k, t in self.tables.items()}
            sparse_merge = {k: [dict(rnd) for rnd in rounds]
                            for k, rounds in self._sparse_merge.items()}
            sparse_updater_bytes = (
                _dump_sparse_updater(self.sparse_updater)
                if self.sparse_updater is not None else None)
            applied_rows = self.applied_row_pushes
        with self._dedup_cv:
            dedup = {cid: {"floor": rec["floor"],
                           "window": {s: e["reply"]
                                      for s, e in rec["window"].items()
                                      if e["done"]}}
                     for cid, rec in self._dedup.items()}
        state = {
            "version": self._SNAP_VERSION,
            "store": store,
            "merge": merge,
            "updater": updater_bytes,
            "barrier_gen": self._barrier_gen,
            "dedup": dedup,
            "applied_pushes": applied,
            "num_workers": self.num_workers,
            "sync_mode": self.sync_mode,
            "members": members,
            "mgen": mgen,
            "tables": tables,
            "sparse_merge": sparse_merge,
            "sparse_updater": sparse_updater_bytes,
            "applied_row_pushes": applied_rows,
            "package": "mxnet_tpu_torch",
        }
        payload = pickle.dumps(state, pickle.HIGHEST_PROTOCOL)
        atomic_write(self.snapshot_path, lambda f: f.write(payload),
                     checksum=True, op="kvsnap.write")
        if _telemetry.enabled():
            ms = (time.perf_counter() - snap_t0) * 1e3
            m = _srv_metrics()
            m["snap_ms"].set(ms)
            m["snaps"].inc()
            _telemetry.log_event("kvsrv_snapshot", ms=round(ms, 3),
                                 bytes=len(payload))
        return self.snapshot_path

    def _restore_snapshot(self):
        """Load ``snapshot_path`` if present and intact; a missing, torn or
        CRC-mismatched snapshot is skipped (cold start) rather than
        crashing the restart loop."""
        path = self.snapshot_path
        if not path or not os.path.exists(path):
            return False
        if verify_crc_sidecar(path) is False:
            logging.warning("kvstore snapshot %s fails its CRC sidecar; "
                            "starting cold", path)
            return False
        try:
            with open(path, "rb") as f:
                state = pickle.load(f)
            if state.get("version") not in (1, 2, 3, self._SNAP_VERSION):
                raise ValueError("snapshot version %r"
                                 % (state.get("version"),))
            updater = (pickle.loads(state["updater"])
                       if state.get("updater") is not None else None)
        except Exception as e:
            logging.warning("kvstore snapshot %s is unreadable (%s); "
                            "starting cold", path, e)
            return False
        if state.get("package") != "mxnet_tpu_torch" and (
                state.get("tables") or state.get("sparse_updater")):
            raise MXNetError(
                "kvstore snapshot %s holds sparse tables written by another "
                "package (the JAX package's?): mxnet_tpu_torch restores only "
                "its own" % path)
        sparse_updater = (_load_sparse_updater(state["sparse_updater"])
                          if state.get("sparse_updater") is not None
                          else None)
        with self._lock:
            self.store = dict(state.get("store", {}))
            self._merge = {k: [dict(rnd) for rnd in rounds]
                           for k, rounds in state.get("merge", {}).items()}
            self.updater = updater
            self.applied_pushes = int(state.get("applied_pushes", 0))
            self.tables = {k: {"meta": dict(t["meta"]),
                               "rows": dict(t["rows"]),
                               "state": dict(t["state"])}
                           for k, t in state.get("tables", {}).items()}
            self._sparse_merge = {
                k: [dict(rnd) for rnd in rounds]
                for k, rounds in state.get("sparse_merge", {}).items()}
            self.sparse_updater = sparse_updater
            self.applied_row_pushes = int(
                state.get("applied_row_pushes", 0))
            self._members = set(state.get("members", []))
            self._mgen = int(state.get("mgen", 0))
            now = time.monotonic()
            for r in self._members:
                # restored members get a fresh heartbeat baseline: the
                # eviction clock restarts with the server
                self._heartbeats[r] = now
        with self._barrier_cv:
            self._barrier_gen = int(state.get("barrier_gen", 0))
        with self._dedup_cv:
            self._dedup = self._load_dedup(state.get("dedup", {}),
                                           state.get("version"))
        for key in self.tables:
            _register_table_gauges(self, key)
        logging.info("kvstore server restored %d keys (barrier gen %d) "
                     "from %s", len(self.store), self._barrier_gen, path)
        return True

    @staticmethod
    def _load_dedup(raw, version):
        """Rebuild live dedup records from a snapshot; v1 snapshots hold a
        single {"seq", "done", "reply"} record per client."""
        out = {}
        for cid, rec in raw.items():
            if version == 1 or "window" not in rec:
                win = OrderedDict()
                win[rec["seq"]] = {"done": True, "reply": rec["reply"]}
                out[cid] = {"floor": rec["seq"] - 1, "window": win}
                continue
            win = OrderedDict()
            for s in sorted(rec["window"]):
                win[s] = {"done": True, "reply": rec["window"][s]}
            out[cid] = {"floor": int(rec.get("floor", 0)), "window": win}
        return out

    def _snapshot_loop(self):
        while not self._stop.wait(self._snap_interval):
            try:
                self.snapshot()
            except Exception as e:
                logging.warning("periodic kvstore snapshot failed: %s", e)

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self):
        self._server.serve_forever(poll_interval=0.05)

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self):
        self._stop.set()
        try:
            self.snapshot()
        except Exception as e:
            logging.warning("kvstore snapshot on stop failed: %s", e)
        self._server.shutdown()
        self._server.server_close()


class ServerClient:
    """Worker-side connection to a KVStoreServer (the ps::KVWorker role).

    Pipelined crash-tolerant transport: a request is sent as soon as it is
    submitted — many can be in flight — and a reader thread matches
    ``("rsp", seq, reply)`` frames to their waiters by idempotency token.
    On a connection failure the reader reconnects with exponential backoff
    and jitter (``MXNET_KVSTORE_RETRY_*``) and replays every in-flight
    envelope under its original token, which the server deduplicates: a
    push whose ACK was lost is applied exactly once, and a server kill and
    restart from its snapshot is ridden out within the retry budget.

    Usable as a context manager; ``close()`` is idempotent and joins the
    heartbeat and reader threads.
    """

    def __init__(self, host, port):
        self._addr = (host, port)
        self._cid = uuid.uuid4().hex  # idempotency namespace for this client
        self._seq = 0
        self._sock = None
        self._closed = False
        self._hb_stop = None
        self._hb_thread = None
        # _state_cv guards _seq/_inflight/_closed; _send_lock serializes
        # socket writes and reconnects.  Ordering: _send_lock may be taken
        # first and _state_cv inside it, never the reverse
        self._state_cv = threading.Condition()
        self._inflight: "OrderedDict[int, dict]" = OrderedDict()
        self.max_inflight = 0
        self._send_lock = threading.Lock()
        self._connect(_retry_conf())
        self._reader = threading.Thread(target=self._reader_loop,
                                        daemon=True, name="kvclient-reader")
        self._reader.start()

    # -- transport ---------------------------------------------------------
    @staticmethod
    def _deadline_hit(t0, conf):
        """MXNET_KVSTORE_RETRY_DEADLINE: wall-clock cap on one reconnect/
        replay loop (0 disables)."""
        return conf["deadline"] > 0 and \
            time.monotonic() - t0 >= conf["deadline"]

    def _connect(self, conf):
        last = None
        t0 = time.monotonic()
        for attempt in range(conf["retries"] + 1):
            try:
                faults.fire("kv.client.connect")
                self._sock = _nodelay(
                    socket.create_connection(self._addr, timeout=120))
                return
            except OSError as e:
                last = e
                self._sock = None
                if attempt >= conf["retries"] or \
                        self._deadline_hit(t0, conf):
                    break
                _backoff_sleep(attempt, conf)
        raise KVStoreConnectionError(
            "kvstore server %s:%d unreachable after %d attempts (%.1fs): %s"
            % (self._addr[0], self._addr[1], attempt + 1,
               time.monotonic() - t0, last))

    def _kill_sock_locked(self):
        """Drop the socket (caller holds _send_lock); shutdown() first:
        close() alone does not reliably wake a reader parked in recv."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _submit(self, msg, retries=None, ctx=None):
        """Register an in-flight entry and send its envelope; returns the
        entry whose ``event`` fires when the reply (or failure) lands.
        Non-blocking beyond the socket write: the pipelining primitive.
        ``ctx`` (telemetry on only) rides as the envelope's 5th field, so
        a replay carries the same trace id."""
        with self._state_cv:
            if self._closed:
                raise ConnectionError("ServerClient is closed")
            self._seq += 1
            seq = self._seq
            env = ("req", self._cid, seq, msg) if ctx is None \
                else ("req", self._cid, seq, msg, ctx)
            ent = {"seq": seq, "env": env,
                   "event": threading.Event(), "reply": None, "exc": None,
                   "retries": retries, "replays": 0}
            self._inflight[seq] = ent
            if len(self._inflight) > self.max_inflight:
                self.max_inflight = len(self._inflight)
            self._state_cv.notify_all()  # wake the reader
        with self._send_lock:
            if self._sock is not None:
                try:
                    _send_msg(self._sock, ent["env"], op="kv.client.send")
                except (ConnectionError, OSError, EOFError):
                    # the reader notices the dead socket and replays
                    self._kill_sock_locked()
        return ent

    def _reader_loop(self):
        """Single reader: waits for work, receives reply frames, matches
        them to in-flight entries by seq.  A transport failure goes to
        _recover(), which reconnects and replays every live token."""
        while True:
            with self._state_cv:
                while not self._inflight and not self._closed:
                    self._state_cv.wait()
                if self._closed:
                    return
                sock = self._sock
            if sock is None:
                self._recover(None)
                continue
            try:
                reply = _recv_msg(sock, op="kv.client.recv")
            except (ConnectionError, OSError, EOFError):
                self._recover(sock)
                continue
            if isinstance(reply, tuple) and len(reply) == 3 \
                    and reply[0] == "rsp":
                with self._state_cv:
                    ent = self._inflight.pop(reply[1], None)
                if ent is not None:
                    ent["reply"] = reply[2]
                    ent["event"].set()
                # an unknown seq is a duplicate answer from a replay race
                # (the original and the replay both answered): dropped

    def _recover(self, failed):
        """Reconnect after a transport failure and replay every in-flight
        envelope in seq order under its original token."""
        conf = _retry_conf()
        t0 = time.monotonic()
        with self._send_lock:
            if failed is not None and self._sock is not None \
                    and self._sock is not failed:
                return  # socket already replaced
            self._kill_sock_locked()
            last = None
            for attempt in range(conf["retries"] + 1):
                with self._state_cv:
                    if self._closed or not self._inflight:
                        return
                if self._deadline_hit(t0, conf):
                    last = ("retry deadline %.1fs exceeded"
                            % conf["deadline"]) if last is None else last
                    break
                try:
                    faults.fire("kv.client.connect")
                    sock = _nodelay(
                        socket.create_connection(self._addr, timeout=120))
                except OSError as e:
                    last = e
                    if attempt < conf["retries"]:
                        _backoff_sleep(attempt, conf)
                    continue
                with self._state_cv:
                    ents = sorted(self._inflight.values(),
                                  key=lambda e: e["seq"])
                sent_all = True
                for ent in ents:
                    limit = ent["retries"] if ent["retries"] is not None \
                        else conf["retries"]
                    ent["replays"] += 1
                    if ent["replays"] > limit:
                        # e.g. stop_server(retries=1): once the server
                        # acked and exited, replaying into a dead address
                        # helps nobody
                        self._fail_entry(ent, KVStoreConnectionError(
                            "kvstore rpc %r to %s:%d failed after %d "
                            "attempts" % (ent["env"][3][0], self._addr[0],
                                          self._addr[1], limit + 1)))
                        continue
                    try:
                        _send_msg(sock, ent["env"], op="kv.client.send")
                    except (ConnectionError, OSError, EOFError) as e:
                        last = e
                        sent_all = False
                        try:
                            sock.close()
                        except OSError:
                            pass
                        break
                if not sent_all:
                    if attempt < conf["retries"]:
                        _backoff_sleep(attempt, conf)
                    continue
                self._sock = sock
                return
            # budget (or retry deadline) exhausted: fail every waiter
            with self._state_cv:
                ents = list(self._inflight.values())
            for ent in ents:
                self._fail_entry(ent, KVStoreConnectionError(
                    "kvstore rpc %r to %s:%d gave up after %d attempts "
                    "(%.1fs): %s"
                    % (ent["env"][3][0], self._addr[0], self._addr[1],
                       attempt + 1, time.monotonic() - t0, last)))

    def _fail_entry(self, ent, exc):
        with self._state_cv:
            self._inflight.pop(ent["seq"], None)
        ent["exc"] = exc
        ent["event"].set()

    def _rpc(self, *msg, **kw):
        if self._closed:
            raise ConnectionError("ServerClient is closed")
        if not _telemetry.enabled():
            # hot path: one bool read, the 4-element envelope, no spans
            ent = self._submit(msg, retries=kw.get("retries"))
            ent["event"].wait()
        else:
            # distributed tracing: a trace context in the envelope, a
            # client span (the whole round trip) carrying the same trace
            # id, and a flow the server's handler span finishes
            ctx = _telemetry.distributed.new_trace_ctx(self._cid[:8])
            with _prof.Frame("kv.client.%s" % msg[0], "kvclient",
                             args={"trace": ctx["trace"]}):
                tracer.flow_event("kv.rpc", "s", ctx["trace"])
                ent = self._submit(msg, retries=kw.get("retries"), ctx=ctx)
                ent["event"].wait()
        if ent["exc"] is not None:
            raise ent["exc"]
        return _unwrap(ent["reply"])

    # -- liveness ----------------------------------------------------------
    def start_heartbeat(self, rank, interval=5.0):
        """Publish liveness for ``rank`` every ``interval`` seconds on a
        daemon thread, over a connection of its own: the RPC socket can sit
        in a long barrier, and a worker parked at a barrier must not go
        heartbeat-silent.  The loop reconnects after failures, so beats
        resume once a killed server restarts."""
        if self._hb_stop is not None:
            return
        self._hb_stop = threading.Event()
        stop = self._hb_stop
        addr = self._addr
        self.heartbeat(rank)  # immediate first beat on the main socket

        def loop():
            sock = None
            while not stop.wait(interval):
                try:
                    if sock is None:
                        sock = _nodelay(
                            socket.create_connection(addr, timeout=30))
                    _send_msg(sock, ("heartbeat", rank))
                    reply = _recv_msg(sock)
                    if reply[0] != "ok":
                        return
                except Exception:
                    # connection gone: drop it and retry next tick
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                        sock = None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

        self._hb_thread = threading.Thread(target=loop, daemon=True,
                                           name="kvclient-heartbeat")
        self._hb_thread.start()

    def heartbeat(self, rank):
        self._rpc("heartbeat", rank)

    def dead_nodes(self, timeout_s=None):
        """None asks the server for its own MXNET_KVSTORE_HEARTBEAT_TIMEOUT
        default, so callers and the barrier release agree on who is dead."""
        return self._rpc("dead_nodes", timeout_s)

    # -- elastic membership -------------------------------------------------
    def join(self, rank):
        """Enter the live membership table; returns ``{gen, ranks,
        num_workers}`` so a mid-run joiner can align with the fleet."""
        return self._rpc("join", rank)

    def leave(self, rank):
        """Graceful preemption exit: the server drops this rank from
        barriers and rounds now (one retry only — a leaving worker must
        not burn the backoff budget on a dead server)."""
        return self._rpc("leave", rank, retries=1)

    def evict(self, rank):
        """Remove another rank from the live set."""
        return self._rpc("evict", rank)

    def membership(self):
        return self._rpc("membership")

    # -- RPC surface -------------------------------------------------------
    def init(self, key, arr):
        self._rpc("init", key, np.asarray(arr))

    def push(self, key, arr, rank=0):
        self._rpc("push", key, np.asarray(arr), rank)

    def pull(self, key):
        return self._rpc("pull", key)

    def multi(self, msgs):
        """One fused round trip over many inner commands: the bucket rides
        a single idempotency token, so crash replay applies it exactly
        once.  Returns the inner payloads in order; the first inner error
        raises."""
        return [_unwrap(r) for r in self._rpc("multi", list(msgs))]

    def set_optimizer(self, optimizer, is_recovery=False):
        self._rpc("set_optimizer",
                  pickle.dumps(optimizer, pickle.HIGHEST_PROTOCOL),
                  int(is_recovery))

    def barrier(self, rank=0, is_recovery=False):
        self._rpc("barrier", rank, int(is_recovery))

    # -- the sparse row plane (wire v2) -----------------------------------
    def init_table(self, key, meta):
        """Declare a sharded embedding table on this server: ``meta``
        carries row_shape/dtype/init/num_servers/server_index/num_rows.
        Idempotent: every worker declares every table."""
        self._rpc("init_table", key, dict(meta))

    def push_rows(self, key, row_ids, values, rank=0):
        """Push a row-sparse gradient block (ids must be this shard's)."""
        self._rpc("push_rows", key,
                  np.asarray(row_ids, dtype=np.int64), np.asarray(values),
                  rank)

    def pull_rows(self, key, row_ids):
        """Fetch rows by id; absent rows materialize deterministically."""
        return self._rpc("pull_rows", key,
                         np.asarray(row_ids, dtype=np.int64))

    def table_info(self, key=None):
        """Shard audit: per-table row and byte counts, misplaced rows and
        meta for this server (the kvstore_admin surface)."""
        return self._rpc("table_info", key)

    def set_sparse_optimizer(self, updater, is_recovery=False):
        """Install a server-placed sparse updater (``sparse.updaters``):
        this package's pickle behind its package tag, which a JAX server
        cannot load and a port server requires."""
        self._rpc("set_sparse_optimizer", _dump_sparse_updater(updater),
                  int(is_recovery))

    def snapshot(self):
        """Force a durable server snapshot now; returns its path."""
        return self._rpc("snapshot")

    def stats(self):
        """The server's counters: applied and rejected pushes, round sizes,
        seconds in the updater, its context and the process's peak device
        memory (a command of this package's server only)."""
        return self._rpc("stats")

    def stop_server(self):
        # a single retry: once the server acks and exits, replaying into a
        # dead address would burn the whole backoff budget
        self._rpc("stop", retries=1)

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Idempotent teardown: stop and join the heartbeat and reader
        threads, close the socket, fail any remaining in-flight waiters."""
        with self._state_cv:
            if self._closed:
                return
            self._closed = True
            self._state_cv.notify_all()
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        with self._send_lock:
            self._kill_sock_locked()
        reader = getattr(self, "_reader", None)
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=5)
        with self._state_cv:
            ents = list(self._inflight.values())
            self._inflight.clear()
        for ent in ents:
            ent["exc"] = ConnectionError("ServerClient is closed")
            ent["event"].set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _unwrap(reply):
    """A reply's payload; a NACK raises NonFiniteGradientError (retrying
    the same payload cannot succeed), any other non-ok reply MXNetError."""
    if reply[0] == "nack":
        raise NonFiniteGradientError(
            "kvstore server rejected push: %s"
            % (reply[2] if len(reply) > 2 else reply[1],))
    if reply[0] != "ok":
        raise MXNetError("kvstore server error: %s" % (reply[1],))
    return reply[1] if len(reply) > 1 else None


def start_server(host="127.0.0.1", port=0, num_workers=1, sync_mode=False,
                 snapshot_path=None, snapshot_interval=None,
                 evict_timeout=None, ctx=None):
    """Start a server in this process (background thread); returns it.
    ``ctx`` is where its updater runs (default: this thread's current
    context)."""
    srv = KVStoreServer(host, port, num_workers, sync_mode,
                        snapshot_path=snapshot_path,
                        snapshot_interval=snapshot_interval,
                        evict_timeout=evict_timeout, ctx=ctx)
    srv.start_background()
    return srv


def _parse_ctx(text):
    """'gpu', 'gpu(1)', 'cpu' or 'cpu(0)' as a Context."""
    name, _, rest = text.strip().partition("(")
    dev_id = int(rest.rstrip(")") or 0) if rest else 0
    return Context(name.strip(), dev_id)


def _init_kvstore_server_module():
    """Reference bootstrap (python/mxnet/kvstore_server.py:11-58): a
    process launched with DMLC_ROLE=server serves, then exits."""
    if os.environ.get("DMLC_ROLE", "") != "server":
        return
    # address: DMLC_SERVER_URIS ("h1:p1,h2:p2", the launcher's assignment)
    # wins; otherwise server i listens on DMLC_PS_ROOT_URI : root_port + i
    server_id = int(os.environ.get("DMLC_SERVER_ID", "0"))
    uris = os.environ.get("DMLC_SERVER_URIS")
    if uris:
        entry = uris.split(",")[server_id]
        host, _, p = entry.rpartition(":")
        port = int(p)
    else:
        host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")) + server_id
    num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    sync = os.environ.get("MXNET_KVSTORE_SYNC", "0") == "1"
    # each server of a fleet journals to its own snapshot file: the env var
    # names the shared prefix, the id keeps them apart
    snap = os.environ.get("MXNET_KVSTORE_SNAPSHOT_PATH") or None
    if snap and server_id:
        snap = "%s.%d" % (snap, server_id)
    ctx = _parse_ctx(os.environ.get("MXNET_KVSTORE_SERVER_CTX", "gpu(0)"))
    srv = KVStoreServer(host, port, num_workers, sync_mode=sync,
                        snapshot_path=snap, ctx=ctx)
    # this runs as the package's last import step, inside the import: the
    # package is complete, so mark it so — else a request thread that
    # imports (unpickling an optimizer, a function-level import in the
    # update) waits forever on the import lock this thread holds
    spec = getattr(sys.modules.get(__package__), "__spec__", None)
    if spec is not None:
        spec._initializing = False
    srv.serve_forever()
    raise SystemExit(0)
