"""KVStore — parameter synchronization, counterpart of
``mxnet_tpu/kvstore.py``.

``local`` and ``device`` (and the ``local_*`` aliases) keep one stored
array per key in one process.  Push semantics are the reference's
(kvstore_local.h:50-95): the values pushed for one key are summed on the
first value's device; with an updater installed the update runs on push
and pull returns the stored weight; without one the store holds the last
push's sum.  Pulling into an array on another device copies onto that
array's device.  ``dist_sync``/``dist_device_sync``/``dist`` are
``kvstore_dist.DistSyncKVStore`` over ``torch.distributed``; ``rank`` and
``num_workers`` come from its process group.  ``dist_async`` is
``DistAsyncKVStore``, a worker of the parameter server
(``kvstore_server.py``): keys placed on a fleet of servers, big arrays
range-split across them, optional fp16 wire compression, elastic
membership, and ``install_preemption_handler`` for a clean exit on
SIGTERM.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .base import MXNetError, register_env
from .ndarray import NDArray
from . import ndarray as nd
from . import optimizer as opt

__all__ = ["KVStore", "DistAsyncKVStore", "create",
           "install_preemption_handler", "NonFiniteGradientError"]


def __getattr__(name):
    # the typed NACK of a non-finite push, re-exported here because workers
    # catch it around push()
    if name == "NonFiniteGradientError":
        from .kvstore_server import NonFiniteGradientError

        return NonFiniteGradientError
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


register_env("MXNET_KVSTORE_COMPRESS", "", str,
             "Wire compression for dist_async push payloads: 'fp16' halves "
             "gradient bytes with per-key error-feedback residuals; empty "
             "disables.")
register_env("MXNET_KVSTORE_ELASTIC", 0, int,
             "Elastic membership for dist_async: workers join the servers' "
             "live-rank tables, barriers and sync rounds size themselves by "
             "the current membership, and Module installs the preemption "
             "handler.")
register_env("MXNET_KVSTORE_ELASTIC_JOIN", 0, int,
             "Set on a respawned worker: this process is a mid-run joiner — "
             "it skips startup barriers, pulls the current parameters and "
             "aligns with the fleet at the next barrier.")
register_env("MXNET_KVSTORE_DRAIN_TIMEOUT", 30, float,
             "Seconds the preemption handler waits for in-flight comm-engine "
             "ops to drain before checkpointing and leaving.")
register_env("MXNET_KVSTORE_BIGARRAY_BOUND", 1000 * 1000, int,
             "Arrays with at least this many elements are range-split "
             "across the dist_async server fleet.")
register_env("MXNET_KVSTORE_SYNC", 0, int,
             "1: the dist_async servers merge one push per worker per round "
             "before updating (a DMLC_ROLE=server process reads it), and a "
             "worker's Module waits at a barrier between its pushes and "
             "its pulls.")


def _key_list(key):
    return (key if isinstance(key, (list, tuple)) else [key]), \
        not isinstance(key, (list, tuple))


def _val_list(value, nkeys):
    if isinstance(value, (list, tuple)) and nkeys == 1 and \
            not isinstance(value[0], (list, tuple)):
        return [list(value)]
    if nkeys == 1:
        return [value if isinstance(value, list) else [value]]
    out = []
    for v in value:
        out.append(v if isinstance(v, list) else [v])
    return out


def _as_nd(v) -> NDArray:
    return v if isinstance(v, NDArray) else nd.array(v)


def _merge(vlist):
    """The sum of one key's pushed values, on the first value's device."""
    merged = vlist[0]
    if len(vlist) > 1:
        acc = vlist[0]._data
        for v in vlist[1:]:
            acc = acc + v._data.to(acc.device)
        merged = NDArray(acc, vlist[0].context)
    return merged


class KVStore:
    """Single-process key-value store (reference kvstore.h:26-286 'local' /
    'device')."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store: Dict[Union[int, str], NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None

    # -- identity ----------------------------------------------------------
    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        if "dist" in self._type:
            from .kvstore_dist import _rank

            return _rank()
        return 0

    @property
    def num_workers(self) -> int:
        if "dist" in self._type:
            from .kvstore_dist import _world

            return _world()
        return 1

    # -- data plane --------------------------------------------------------
    def init(self, key, value):
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, v in zip(keys, vals):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            self._store[k] = _as_nd(v[0]).copy()

    def _reduce(self, merged: NDArray) -> NDArray:
        """The sum over workers of a locally merged push (one worker
        here)."""
        return merged

    def push(self, key, value, priority=0):
        """Sum pushed values per key; run the updater on the sum if one is
        installed (reference KVStoreLocal::Push, kvstore_local.h:50)."""
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("push to uninitialized key %s" % str(k))
            merged = self._reduce(_merge([_as_nd(v) for v in vlist]))
            stored = self._store[k]
            if merged.context != stored.context:
                merged = merged.as_in_context(stored.context)
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                # no updater: the store holds the merged sum of this push
                # (reference KVStoreLocal::Push CopyFromTo(merged, &local))
                stored._set(merged._data.clone())

    def pull(self, key, out=None, priority=0):
        keys, _ = _key_list(key)
        outs = _val_list(out, len(keys))
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("pull of uninitialized key %s" % str(k))
            src = self._store[k]._data
            for o in olist:
                # keep the destination's device and dtype: a pull copies
                # into the array, wherever it lives
                with torch.no_grad():
                    o._data.copy_(src)

    # -- synchronization ---------------------------------------------------
    def wait(self, keys=None):
        """Block until outstanding ops on ``keys`` (all, when None) have
        completed.  Synchronous flavors finish every push/pull before
        returning, so this is a no-op; ``comm_engine.AsyncKVStore``
        overrides it with a real barrier."""

    def wait_all(self):
        """Block until every outstanding op has completed (no-op here)."""

    def drain(self, timeout=None):
        """Finish outstanding async work (no-op for synchronous stores).
        Returns True once everything completed."""
        return True

    # -- control plane -----------------------------------------------------
    def set_optimizer(self, optimizer):
        """Install an optimizer as the store-side updater."""
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    def _barrier(self):
        pass

    def _send_command_to_servers(self, head, body):
        pass

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def _flat_view(o):
    """A flat view of a destination NDArray's one dense, contiguous tensor
    (None for an array stored as pieces)."""
    x = o._data
    if not hasattr(x, "is_contiguous") or not x.is_contiguous():
        return None
    return x.view(-1)


class DistAsyncKVStore(KVStore):
    """``dist_async`` over the parameter service (``kvstore_server.py``):
    every push goes to the servers, whose updater applies it at once (or
    once per round of one push per worker on a sync-mode server); no
    worker waits for another (reference kvstore_dist_server.h:198-206
    async branch + the kvstore_dist.h worker).

    Servers: ``DMLC_SERVER_URIS`` ("h1:p1,h2:p2"), else
    ``DMLC_NUM_SERVER`` of them on ``DMLC_PS_ROOT_URI`` at
    ``DMLC_PS_ROOT_PORT`` + i; without either, a server in this process
    (its updater on this thread's current context).  Small keys live on
    one server chosen by crc32; arrays of at least
    ``MXNET_KVSTORE_BIGARRAY_BOUND`` elements are range-split evenly
    across the fleet.  ``wire`` counts what went over the wire: push
    items (a range-split key once per server), bytes pushed and pulled."""

    def __init__(self, kv_type="dist_async"):
        import threading

        super().__init__(kv_type)
        from . import kvstore_server as kvs

        host = os.environ.get("DMLC_PS_ROOT_URI")
        uris = os.environ.get("DMLC_SERVER_URIS")
        if host or uris:
            port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
            self._server = None
            if uris:
                addrs = [(h, int(p)) for h, p in
                         (u.rsplit(":", 1) for u in uris.split(","))]
            else:
                n_srv = max(1, int(os.environ.get("DMLC_NUM_SERVER",
                                                  "1") or "1"))
                addrs = [(host, port + i) for i in range(n_srv)]
        else:
            # a launch without a launcher: the service runs in-process
            self._server = kvs.start_server(
                num_workers=int(os.environ.get("DMLC_NUM_WORKER", "1")))
            addrs = [self._server.addr]
        self._clients = [kvs.ServerClient(h, p) for h, p in addrs]
        self._client = self._clients[0]
        self._bigarray_bound = int(
            os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND", str(1000 * 1000)))
        self._rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
        self._num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        #: the servers merge per-worker rounds: Module waits at a barrier
        #: between its pushes and its pulls, so a pull sees the round
        self.sync_rounds = os.environ.get("MXNET_KVSTORE_SYNC", "0") == "1"
        # rejoin semantics (reference kvstore_dist.h:35-38 IsRecovery): a
        # relaunched worker must not wait at startup barriers (its peers
        # are mid-training); server init is setdefault, so re-init cannot
        # clobber trained weights.  The flag covers bring-up only: it
        # expires at the first push, so a later set_optimizer (an LR drop)
        # installs instead of being dropped as a recovery re-ship
        self._is_recovery = (
            os.environ.get("DMLC_IS_RECOVERY", "") == "1"
            or int(os.environ.get("MXNET_AUTORESUME_ATTEMPT", "0") or 0) > 0)
        self._pool = None  # lazy; lives for the store's lifetime
        comp = os.environ.get("MXNET_KVSTORE_COMPRESS", "").lower()
        if comp in ("none", "0"):
            comp = ""
        if comp not in ("", "fp16"):
            raise MXNetError(
                "unsupported MXNET_KVSTORE_COMPRESS %r (only 'fp16')"
                % comp)
        self._compress = comp
        self._residuals: Dict[object, np.ndarray] = {}
        self.wire = {"push_items": 0, "push_bytes": 0, "pull_bytes": 0}
        self._wire_lock = threading.Lock()
        # elastic membership: join every server's live-rank table; a
        # mid-run joiner also rides the recovery bring-up (pull current
        # parameters, align at the next barrier)
        self._elastic = os.environ.get("MXNET_KVSTORE_ELASTIC", "0") == "1"
        self._left = False
        if os.environ.get("MXNET_KVSTORE_ELASTIC_JOIN", "0") == "1":
            self._is_recovery = True
        hb_interval = float(os.environ.get(
            "MXNET_KVSTORE_HEARTBEAT_INTERVAL", "5"))
        if self._elastic:
            for c in self._clients:
                c.join(self._rank)
                # heartbeat every server: each keeps its own eviction clock
                c.start_heartbeat(self._rank, interval=hb_interval)
        else:
            self._client.start_heartbeat(self._rank, interval=hb_interval)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def _count(self, **n):
        with self._wire_lock:
            for k, v in n.items():
                self.wire[k] += v

    # -- key placement (reference kvstore_dist.h:264-302) -----------------
    def _server_for(self, key):
        """Stable small-key placement (crc32, not hash(): the builtin is
        salted per process, so workers would disagree)."""
        import zlib

        return zlib.crc32(str(key).encode()) % len(self._clients)

    def _ranges(self, n):
        """Even contiguous [lo, hi) element ranges, one per server."""
        ns = len(self._clients)
        base, rem = divmod(n, ns)
        bounds = [0]
        for i in range(ns):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return list(zip(bounds[:-1], bounds[1:]))

    def _is_sharded(self, n_elements):
        return (len(self._clients) > 1
                and n_elements >= self._bigarray_bound)

    def _client_pool(self):
        """One long-lived thread pool for concurrent per-server RPCs."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(len(self._clients))
        return self._pool

    def init(self, key, value):
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, v in zip(keys, vals):
            if self._rank == 0:
                arr = v[0].asnumpy() if isinstance(v[0], NDArray) else \
                    np.asarray(v[0])
                if self._is_sharded(arr.size):
                    flat = arr.reshape(-1)
                    for cid, (lo, hi) in enumerate(self._ranges(arr.size)):
                        self._clients[cid].init(k, flat[lo:hi])
                else:
                    self._clients[self._server_for(k)].init(k, arr)
        # the server decides whether a recovered worker may skip
        self._client.barrier(rank=self._rank,
                             is_recovery=self._is_recovery)

    @staticmethod
    def _merge_vals(vlist):
        """Sum a key's values on their device: a float32 tensor on the
        card, or a host array (values on the CPU or not NDArrays)."""
        if not isinstance(vlist[0], NDArray):
            merged = np.asarray(vlist[0])
            for v in vlist[1:]:
                merged = merged + np.asarray(v)
            return merged
        merged = vlist[0]
        if len(vlist) > 1:
            acc = vlist[0]._data
            for v in vlist[1:]:
                acc = acc + v._data.to(acc.device)
            merged = NDArray(acc, vlist[0].context)
        x = merged._data
        if not getattr(x, "is_cuda", False):
            return merged.asnumpy()
        merged.wait_to_read()
        x = x.detach()
        return x if x.dtype == torch.float32 else x.float()

    def _compress_out(self, rkey, arr):
        """fp16 wire compression with error feedback: the residual r_t =
        (g_t + r_{t-1}) - fp16(g_t + r_{t-1}) is added to the next push of
        the same key, so quantization error never accumulates."""
        if self._compress != "fp16" or arr.dtype.kind != "f" \
                or arr.dtype == np.float16:
            return arr
        prev = self._residuals.get(rkey)
        acc = arr + prev if prev is not None else arr
        sent = acc.astype(np.float16)
        self._residuals[rkey] = acc - sent.astype(arr.dtype)
        return sent

    def _wire(self, rkey, x):
        """What goes on the wire for one value (a whole key or one range
        of it): ``_compress_out`` of a host array; a tensor on the card is
        compressed there, with the same bits (IEEE add and subtract, fp16
        rounding to nearest even) and its residual kept there, and copied
        off the card once, at the size it is sent."""
        if not torch.is_tensor(x):
            return self._compress_out(rkey, x)
        if self._compress == "fp16":
            prev = self._residuals.get(rkey)
            acc = x + prev if prev is not None else x
            sent = acc.half()
            self._residuals[rkey] = acc - sent.float()
            x = sent
        return x.cpu().numpy()

    def _outgoing(self, k, vlist):
        """[(server index, array)] of one key's push: the merged value
        whole to its server, or each range of it to its server (residuals
        kept per key and range start, one error-feedback stream per
        server)."""
        x = self._merge_vals(vlist)
        n = x.numel() if torch.is_tensor(x) else x.size
        if not self._is_sharded(n):
            return [(self._server_for(k), self._wire(k, x))]
        flat = x.reshape(-1)
        return [(cid, self._wire((k, lo), flat[lo:hi]))
                for cid, (lo, hi) in enumerate(self._ranges(n))]

    def push(self, key, value, priority=0):
        self._is_recovery = False  # training traffic: bring-up is over
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            self._send_parts(k, self._outgoing(k, vlist))

    def _send_parts(self, k, parts):
        if len(parts) == 1:
            cid, arr = parts[0]
            self._clients[cid].push(k, arr, rank=self._rank)
        else:
            list(self._client_pool().map(
                lambda p: self._clients[p[0]].push(k, p[1],
                                                   rank=self._rank),
                parts))
        self._count(push_items=len(parts),
                    push_bytes=sum(p[1].nbytes for p in parts))

    def push_multi(self, pairs):
        """Fused push of many ``(key, vlist)`` pairs: merge and compress
        per key, group by owning server, then one ``multi`` RPC per server
        (concurrent across the fleet); a range-split key goes alone.  The
        envelope's idempotency token covers the whole bucket."""
        self._is_recovery = False
        groups: Dict[int, list] = {}
        big = []
        for k, vlist in pairs:
            parts = self._outgoing(k, vlist)
            if len(parts) > 1:
                big.append((k, parts))
                continue
            cid, arr = parts[0]
            groups.setdefault(cid, []).append(("push", k, arr, self._rank))
        items = list(groups.items())
        if len(items) == 1:
            self._clients[items[0][0]].multi(items[0][1])
        elif items:
            list(self._client_pool().map(
                lambda it: self._clients[it[0]].multi(it[1]), items))
        msgs = [m for _, ms in items for m in ms]
        self._count(push_items=len(msgs),
                    push_bytes=sum(m[2].nbytes for m in msgs))
        for k, parts in big:
            self._send_parts(k, parts)

    @staticmethod
    def _write_out(arr, olist):
        """Write a pulled host array into the destination NDArrays, in
        place and in their dtype; a destination stored as pieces keeps
        its pieces (``NDArray.__setitem__``)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        for o in olist:
            o[:] = host

    def pull(self, key, out=None, priority=0):
        # pull must not clear _is_recovery: Module's bring-up interleaves
        # init and pull per parameter before set_optimizer runs
        keys, _ = _key_list(key)
        outs = _val_list(out, len(keys))
        for k, olist in zip(keys, outs):
            want = olist[0]
            if not self._is_sharded(int(np.prod(want.shape))):
                arr = np.asarray(self._clients[self._server_for(k)].pull(k))
                self._count(pull_bytes=arr.nbytes)
                self._write_out(arr, olist)
                continue
            # concurrent per-server pulls: latency is the slowest server's,
            # not the sum
            parts = [np.asarray(p).reshape(-1) for p in
                     self._client_pool().map(lambda c: c.pull(k),
                                             self._clients)]
            self._count(pull_bytes=sum(p.nbytes for p in parts))
            if all(_flat_view(o) is not None for o in olist):
                # each range straight into its slice of each destination:
                # no host concatenation
                self._write_ranges(parts, olist)
            else:
                self._write_out(np.concatenate(parts).reshape(want.shape),
                                olist)

    def _write_ranges(self, parts, olist):
        n = sum(p.size for p in parts)
        with torch.no_grad():
            for o in olist:
                flat = _flat_view(o)
                for (lo, hi), p in zip(self._ranges(n), parts):
                    flat[lo:hi].copy_(torch.from_numpy(p))

    def pull_multi(self, pairs):
        """Fused pull of many ``(key, olist)`` pairs: one ``multi`` RPC per
        owning server (concurrent across the fleet), then one copy to each
        destination device for the group (``_to_device``) and a write of
        each destination; a range-split key goes alone."""
        small, big = [], []
        for k, olist in pairs:
            if self._is_sharded(int(np.prod(olist[0].shape))):
                big.append((k, olist))
            else:
                small.append((k, olist))
        groups: Dict[int, list] = {}
        for i, (k, _) in enumerate(small):
            groups.setdefault(self._server_for(k), []).append(i)

        def fetch(item):
            cid, idxs = item
            replies = self._clients[cid].multi(
                [("pull", small[i][0]) for i in idxs])
            return list(zip(idxs, replies))

        items = list(groups.items())
        if len(items) == 1:
            results = fetch(items[0])
        elif items:
            results = [r for rs in self._client_pool().map(fetch, items)
                       for r in rs]
        else:
            results = []
        by_device: Dict[object, list] = {}
        for i, arr in results:
            arr = np.asarray(arr)
            self._count(pull_bytes=arr.nbytes)
            for o in small[i][1]:
                by_device.setdefault(o.context.torch_device(), []).append(
                    (o, arr))
        for device, pairs_d in by_device.items():
            moved = self._to_device([a for _, a in pairs_d], device)
            for (o, _), data in zip(pairs_d, moved):
                o[:] = data
        for k, olist in big:
            self.pull(k, olist)

    @staticmethod
    def _to_device(hosts, device):
        """Host arrays as tensors on ``device`` with one copy for a group
        of one dtype: concatenate flat, copy once, split on the device."""
        if not hosts:
            return []
        dt = hosts[0].dtype
        if len(hosts) == 1 or any(h.dtype != dt for h in hosts):
            return [torch.from_numpy(np.ascontiguousarray(h)).to(device)
                    for h in hosts]
        flats = [np.ascontiguousarray(h).reshape(-1) for h in hosts]
        big = torch.from_numpy(np.concatenate(flats)).to(device)
        return [p.view(h.shape) for p, h in
                zip(torch.split(big, [f.size for f in flats]), hosts)]

    def get_num_dead_node(self, node_id=0, timeout=None):
        """Count workers whose heartbeat went stale (reference
        kvstore_dist.h:151-160).  ``timeout=None`` uses the server's own
        ``MXNET_KVSTORE_HEARTBEAT_TIMEOUT`` default."""
        try:
            return len(self._client.dead_nodes(
                None if timeout is None else float(timeout)))
        except Exception:
            # server unreachable: from this worker's view the service
            # itself is dead
            return 1

    # -- elastic membership -------------------------------------------------
    def membership(self):
        """Live membership view ``{gen, ranks, num_workers}``."""
        return self._client.membership()

    def leave(self):
        """Graceful preemption exit: drop this rank from every server's
        live set so the survivors' barriers and rounds re-form at once.
        Idempotent; failures are logged, not raised."""
        if self._left:
            return
        self._left = True
        for c in self._clients:
            try:
                c.leave(self._rank)
            except Exception as e:
                logging.warning("kvstore leave(rank=%d) failed: %s",
                                self._rank, e)

    def close(self):
        """Tear down the client sockets and any in-process server."""
        try:
            if self._elastic:
                self.leave()
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
            for c in self._clients:
                c.close()
        finally:
            if self._server is not None:
                self._server.stop()
                self._server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_optimizer(self, optimizer):
        """Ship the pickled optimizer to every server (reference
        kvstore.py:232-255 _send_command_to_servers)."""
        if self._rank == 0:
            # the recovery flag travels with the command: a server keeps
            # its live updater (optimizer states) when one is installed
            for c in self._clients:
                c.set_optimizer(optimizer, is_recovery=self._is_recovery)
        self._client.barrier(rank=self._rank,
                             is_recovery=self._is_recovery)

    def _barrier(self):
        self._client.barrier(rank=self._rank,
                             is_recovery=self._is_recovery)

    def _send_command_to_servers(self, head, body):
        if head == "stop":
            for c in self._clients:
                c.stop_server()

    def save_optimizer_states(self, fname):
        raise MXNetError("Cannot save states for distributed training")

    def load_optimizer_states(self, fname):
        raise MXNetError("Cannot load states for distributed training")


def install_preemption_handler(kv, checkpoint_fn=None, sig=None,
                               drain_timeout=None, exit_process=True):
    """Install the elastic preemption path on ``sig`` (default SIGTERM):
    drain in-flight comm-engine ops (bounded by
    ``MXNET_KVSTORE_DRAIN_TIMEOUT``), run ``checkpoint_fn`` if given, send
    the ``leave`` RPC so the surviving fleet re-forms at once, and exit 0 —
    a clean preemption must not look like a crash to a restarting
    launcher.  Returns the handler; the signal is hooked only from the
    main thread (``signal.signal``'s constraint)."""
    import signal as _signal
    import threading

    if sig is None:
        sig = _signal.SIGTERM
    if drain_timeout is None:
        drain_timeout = float(os.environ.get(
            "MXNET_KVSTORE_DRAIN_TIMEOUT", "30"))
    fired = threading.Event()

    def handler(signum=None, frame=None):
        if fired.is_set():
            return
        fired.set()
        logging.info("preemption signal: draining comm ops "
                     "(%.0fs budget), checkpointing, leaving", drain_timeout)
        try:
            kv.drain(drain_timeout)
        except Exception as e:
            logging.warning("preemption drain failed: %s", e)
        if checkpoint_fn is not None:
            try:
                checkpoint_fn()
            except Exception as e:
                logging.warning("preemption checkpoint failed: %s", e)
        leave = getattr(kv, "leave", None)
        if leave is not None:
            try:
                leave()
            except Exception as e:
                logging.warning("preemption leave failed: %s", e)
        try:
            # flight recorder: the postmortem is the only record of this
            # process's final state once we _exit (no atexit hooks run)
            from . import telemetry as _tm

            _tm.flight_recorder.dump("preemption-sigterm")
        except Exception:
            pass
        if exit_process:
            os._exit(0)

    if threading.current_thread() is threading.main_thread():
        try:
            _signal.signal(sig, handler)
        except (ValueError, OSError):
            pass
    return handler


def create(name="local") -> KVStore:
    """Create a KVStore (reference KVStore::Create, kvstore.cc:17-45).
    'local'/'device' and the 'local_*' aliases → in-process aggregation;
    'dist_sync'/'dist_device_sync'/'dist' → the synchronous multi-process
    store over ``torch.distributed``; 'dist_async' → the parameter server
    (``kvstore_server.py``), updater applied on every push."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name not in ("local", "local_update_cpu", "local_allreduce_cpu",
                    "local_allreduce_device", "device", "dist_sync",
                    "dist_device_sync", "dist_async", "dist"):
        raise MXNetError("unknown KVStore type %s" % name)
    if name == "dist_async":
        return DistAsyncKVStore(name)
    if name in ("dist_sync", "dist_device_sync", "dist"):
        from .kvstore_dist import DistSyncKVStore

        return DistSyncKVStore(name)
    return KVStore(name)
