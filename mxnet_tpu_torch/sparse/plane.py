"""Worker-side sparse parameter plane, counterpart of
``mxnet_tpu/sparse/plane.py`` (docs/how_to/sparse.md).

``SparseParamPlane`` routes row-sparse traffic to the sharded embedding
tables on the kvstore servers: rows are owned by server
``row_id % num_servers`` (every worker and server agree on that function,
so there is no directory service), pulls gather the touched rows across
shards concurrently, and pushes ride the comm engine's per-key FIFO
chains so they pipeline and coalesce exactly like dense gradient pushes
— a pull for a key always observes every push for that key submitted
before it.

The worker never holds a full table: per step it moves O(touched rows)
bytes, and the optimizer state never leaves the servers.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..base import register_env
from .array import row_merge

register_env("MXNET_KVSTORE_SPARSE_COALESCE", 1, int,
             "Coalesce multi-slot row-sparse pushes into one fused "
             "envelope per server (one idempotency token per server per "
             "step); 0 sends one RPC per (slot, server).")
register_env("MXNET_KVSTORE_SPARSE_CAPACITY", 2048, int,
             "Default worker-side row capacity for a row_sparse embedding "
             "slot: the bound executor holds at most this many touched "
             "rows per batch instead of the full table.")

__all__ = ["SparseParamPlane", "default_capacity"]


def default_capacity():
    return int(os.environ.get("MXNET_KVSTORE_SPARSE_CAPACITY", "2048"))


def _unwrap(kv):
    """Accept an AsyncKVStore (engine + dist store), a bare
    DistAsyncKVStore, or a plain list of ServerClient.  The port's
    ``AsyncKVStore`` exposes ``inner`` and ``_engine`` (the
    ``CommEngine``), and ``DistAsyncKVStore`` its ``_clients`` and the
    ``rank`` property over ``_rank``."""
    engine = None
    if isinstance(kv, (list, tuple)):
        return list(kv), 0, None
    inner = getattr(kv, "inner", kv)
    engine = getattr(kv, "_engine", None)
    clients = getattr(inner, "_clients", None)
    if clients is None:
        raise ValueError(
            "sparse plane needs a dist kvstore (ServerClient transport); "
            "got %r" % (type(kv).__name__,))
    return list(clients), int(getattr(inner, "rank", 0)), engine


class SparseParamPlane(object):
    def __init__(self, kv_or_clients, rank=None):
        self._clients, kv_rank, self._engine = _unwrap(kv_or_clients)
        self.rank = kv_rank if rank is None else int(rank)
        self.num_servers = len(self._clients)
        self._pool = None
        self._pool_lock = threading.Lock()
        self._metas = {}
        # bench/acceptance instrumentation: bytes moved by the last
        # pull/push and the peak single-transfer size — the worker-side
        # resident footprint of the sparse plane
        self.last_pull_bytes = 0
        self.peak_transfer_bytes = 0

    # -- helpers ------------------------------------------------------------
    def _map(self, fn, items):
        items = list(items)
        if len(items) <= 1:
            return [fn(it) for it in items]
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_servers,
                    thread_name_prefix="sparse-plane")
        return list(self._pool.map(fn, items))

    def _note(self, nbytes):
        if nbytes > self.peak_transfer_bytes:
            self.peak_transfer_bytes = nbytes

    def _wait_key(self, key):
        if self._engine is not None:
            self._engine.wait([("sparse", key)])

    # -- control plane ------------------------------------------------------
    def init_table(self, key, num_rows, row_shape, dtype="float32",
                   init=("zeros",)):
        """Declare a sharded table on every server.  Idempotent."""
        if np.isscalar(row_shape):
            row_shape = (int(row_shape),)
        meta = {"num_rows": int(num_rows), "row_shape": tuple(row_shape),
                "dtype": str(dtype), "init": tuple(init),
                "num_servers": self.num_servers}
        self._metas[key] = meta

        def one(i):
            m = dict(meta)
            m["server_index"] = i
            self._clients[i].init_table(key, m)

        self._map(one, range(self.num_servers))
        return meta

    def set_sparse_optimizer(self, updater, is_recovery=False):
        self._map(lambda c: c.set_sparse_optimizer(updater, is_recovery),
                  self._clients)

    def table_info(self):
        """Merged per-server audit: [{key: info}, ...] indexed by server."""
        return self._map(lambda c: c.table_info(), self._clients)

    # -- data plane ---------------------------------------------------------
    def pull_rows(self, key, row_ids, out=None):
        """Gather rows by id across shards, returned in input order.
        Waits the key's engine chain first so the pull observes every
        previously submitted push for that key."""
        self._wait_key(key)
        ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        ns = self.num_servers
        if ns == 1:
            block = self._clients[0].pull_rows(key, ids)
            got = np.asarray(block)
        else:
            owner = ids % ns
            shards = [np.flatnonzero(owner == s) for s in range(ns)]
            parts = self._map(
                lambda s: (self._clients[s].pull_rows(key, ids[shards[s]])
                           if shards[s].size else None),
                range(ns))
            first = next(p for p in parts if p is not None)
            got = np.empty((ids.shape[0],) + first.shape[1:],
                           dtype=first.dtype)
            for s, p in enumerate(parts):
                if p is not None:
                    got[shards[s]] = p
        self.last_pull_bytes = got.nbytes
        self._note(got.nbytes)
        if out is not None:
            out[:got.shape[0]] = got
            return out
        return got

    def _shard(self, ids, vals):
        """Merge duplicates then split by owning server; yields
        (server, ids, vals) for non-empty shards."""
        ids, vals = row_merge(ids, vals)
        ns = self.num_servers
        if ns == 1:
            yield 0, ids, vals
            return
        owner = ids % ns
        for s in range(ns):
            sel = np.flatnonzero(owner == s)
            if sel.size:
                yield s, ids[sel], vals[sel]

    def push_rows(self, key, row_ids, values, priority=0):
        """Push a row-sparse gradient: worker-side duplicate merge, then
        one push_rows per owning server.  With an engine the push is
        submitted asynchronously under the key's FIFO chain (pipelining
        with compute, like dense pushes); without one it is synchronous."""
        ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        vals = np.asarray(values)
        self._note(vals.nbytes)

        def do_push():
            self._map(lambda part: self._clients[part[0]].push_rows(
                key, part[1], part[2], rank=self.rank),
                self._shard(ids, vals))

        if self._engine is None:
            do_push()
        else:
            self._engine.submit(do_push, [("sparse", key)],
                                priority=priority,
                                label="push_rows:%s" % (key,))

    def push_rows_multi(self, triples, priority=0):
        """Coalesced multi-slot push: all (key, ids, vals) triples fuse
        into ONE ``multi`` envelope per server — one idempotency token
        per server per step, so crash-replay applies the whole step's
        sparse traffic exactly once per server.  Falls back to per-key
        pushes when MXNET_KVSTORE_SPARSE_COALESCE=0."""
        triples = [(k, np.asarray(i, dtype=np.int64).reshape(-1),
                    np.asarray(v)) for k, i, v in triples]
        if not triples:
            return
        if os.environ.get("MXNET_KVSTORE_SPARSE_COALESCE", "1") == "0":
            for k, i, v in triples:
                self.push_rows(k, i, v, priority=priority)
            return
        per_server = {}
        for key, ids, vals in triples:
            self._note(vals.nbytes)
            for s, sids, svals in self._shard(ids, vals):
                per_server.setdefault(s, []).append(
                    ("push_rows", key, sids, svals, self.rank))

        def do_push():
            self._map(lambda item: self._clients[item[0]].multi(item[1]),
                      per_server.items())

        keys = [("sparse", k) for k, _i, _v in triples]
        if self._engine is None:
            do_push()
        else:
            self._engine.submit(do_push, keys, priority=priority,
                                label="push_rows_multi:%d" % len(triples))

    def wait(self, key=None):
        """Barrier over sparse traffic: one key's chain, or everything."""
        if self._engine is None:
            return
        if key is not None:
            self._engine.wait([("sparse", key)])
        else:
            self._engine.wait([("sparse", k) for k in self._metas])
