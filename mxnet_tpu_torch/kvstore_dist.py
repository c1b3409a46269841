"""``dist_sync`` / ``dist_device_sync`` — synchronous multi-process data
parallelism over ``torch.distributed``; counterpart of
``mxnet_tpu/kvstore_dist.py``.

There is no server: every worker takes part in a collective sum, after
which each applies the same deterministic update to its replica — the
reference server's merge-until-NumWorkers then update
(kvstore_dist_server.h:164-200), minus the server.

Worker bring-up follows the reference's environment contract
(tools/launch.py + the dmlc tracker): ``DMLC_NUM_WORKER``,
``DMLC_WORKER_ID``, ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` name the
rendezvous (``tcp://URI:PORT``).  The backend is NCCL when CUDA is present
and every rank owns a card of its own (``DMLC_NUM_WORKER`` at most the
number of cards; rank r then works on ``gpu(r)``), else gloo, which
all-reduces CUDA tensors through the host.  The choice and its reason
are printed.  A single
worker degrades to local semantics without a process group.
"""
from __future__ import annotations

import atexit
import logging
import os
import sys
import threading
import time
from typing import Dict

from .base import MXNetError, register_env
from .kvstore import KVStore, _key_list, _val_list
from .ndarray import NDArray
from . import ndarray as nd

__all__ = ["DistSyncKVStore", "ensure_distributed_initialized",
           "choose_backend", "allreduce_sum_", "all_gather_rows"]

register_env("MXNET_KVSTORE_HEARTBEAT_INTERVAL", 5, float,
             "Seconds between a dist_sync worker's liveness beats.")
register_env("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", 60, float,
             "Seconds without a beat after which get_num_dead_node counts "
             "a worker dead.")

#: the backend ``ensure_distributed_initialized`` took (None before)
BACKEND = None


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return _dist().get_rank() if _initialized() else 0


def _world() -> int:
    return _dist().get_world_size() if _initialized() else 1


def choose_backend(num_workers: int):
    """(backend, reason) for ``num_workers`` ranks on this machine."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards and num_workers <= cards:
        return "nccl", "%d workers on %d cards: a card per rank" % (
            num_workers, cards)
    if cards:
        return "gloo", ("%d workers on %d card(s): NCCL refuses two ranks "
                        "on one device" % (num_workers, cards))
    return "gloo", "no CUDA device"


def ensure_distributed_initialized():
    """Bring up the default process group from the DMLC environment
    contract (no-op for a single worker or when already connected)."""
    global BACKEND
    num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if num_workers <= 1 or _initialized():
        return
    dist = _dist()
    addr = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = os.environ.get("DMLC_PS_ROOT_PORT", "9360")
    worker_id = int(os.environ.get("DMLC_WORKER_ID", "0"))
    backend, reason = choose_backend(num_workers)
    if backend == "nccl":
        import torch

        torch.cuda.set_device(worker_id)
    try:
        dist.init_process_group(backend, init_method="tcp://%s:%s"
                                % (addr, port), world_size=num_workers,
                                rank=worker_id)
    except RuntimeError as e:
        raise MXNetError("dist_sync bring-up failed (rendezvous %s:%s, "
                         "backend %s): %s" % (addr, port, backend, e))
    BACKEND = backend
    print("kvstore dist_sync: rank %d/%d, backend %s (%s)"
          % (worker_id, num_workers, backend, reason), file=sys.stderr,
          flush=True)


def allreduce_sum_(tensors):
    """Sum every tensor across the workers, in place, as one collective
    over a flat buffer per device and dtype (nothing without a group)."""
    import torch

    if not _initialized() or _world() == 1:
        return
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _dist().all_reduce(flat)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def all_gather_rows(x):
    """Every worker's ``x`` (one shape on each) concatenated along axis 0
    in rank order (``x`` itself without a group).  Through gloo the rows
    travel through the host, bfloat16 widened to float32 on the way."""
    import torch

    if not _initialized() or _world() == 1:
        return x
    wire = x.detach()
    if BACKEND != "nccl":
        wire = wire.cpu()
        if wire.dtype == torch.bfloat16:
            wire = wire.to(torch.float32)
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(_world())]
    _dist().all_gather(parts, wire)
    return torch.cat(parts).to(x.device, x.dtype)


def _stop_heartbeat():
    """Stop and join the liveness beat before the interpreter tears down.
    A beat left inside the store's C++ client at shutdown aborts the
    process (``terminate called without an active exception``), and the
    store's host, rank 0, may already have left after the last barrier."""
    hb = DistSyncKVStore._hb_thread
    if hb is None:
        return
    t, stop = hb
    stop.set()
    t.join(timeout=30)
    DistSyncKVStore._hb_thread = None


class DistSyncKVStore(KVStore):
    """Synchronous multi-worker store: ``init`` takes rank 0's value
    (broadcast), ``push`` sums the local values, then across all workers
    (all-reduce), then the updater — installed identically on every worker
    by ``set_optimizer`` — applies the same update to each replica."""

    def __init__(self, kv_type="dist_sync"):
        ensure_distributed_initialized()
        super().__init__(kv_type)
        self._start_heartbeat()

    # -- collective helpers ------------------------------------------------
    def _reduce(self, merged: NDArray) -> NDArray:
        if _world() == 1:
            return merged
        out = merged._data.clone()
        _dist().all_reduce(out)
        return NDArray(out, merged.context)

    @staticmethod
    def _broadcast0(data):
        if _world() == 1:
            return data
        out = data.clone()
        _dist().broadcast(out, src=0)
        return out

    # -- data plane --------------------------------------------------------
    def init(self, key, value):
        """Rank 0's value wins and is broadcast so every worker starts from
        identical parameters (the reference inits only from rank 0,
        kvstore_dist.h:64-82)."""
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, v in zip(keys, vals):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            src = v[0] if isinstance(v[0], NDArray) else nd.array(v[0])
            self._store[k] = NDArray(self._broadcast0(src._data),
                                     src.context)

    # -- control plane -----------------------------------------------------
    def _barrier(self):
        if _world() > 1:
            _dist().barrier()

    # -- liveness ----------------------------------------------------------
    _hb_thread = None
    _hb_seen: Dict[int, tuple] = {}

    @staticmethod
    def _store_client():
        """The process group's key-value store (the rendezvous's, the
        Postoffice analogue), or None."""
        if not _initialized():
            return None
        try:
            from torch.distributed import distributed_c10d

            return distributed_c10d._get_default_store()
        except Exception:
            return None

    def _start_heartbeat(self):
        """Publish this worker's liveness into the group's store so peers
        can count dead nodes (reference: ps-lite node heartbeats behind
        GetDeadNodes, kvstore_dist.h:151-160)."""
        if DistSyncKVStore._hb_thread is not None:
            return
        store = self._store_client()
        if store is None:
            return
        rank = self.rank
        interval = float(os.environ.get("MXNET_KVSTORE_HEARTBEAT_INTERVAL",
                                        "5"))
        seq = [0]

        def beat_once():
            # a sequence number, not a timestamp: staleness is judged on
            # the reader's own monotonic clock
            seq[0] += 1
            store.set("mxtt_hb/%d" % rank, str(seq[0]))

        def loop(stop):
            while not stop.wait(interval):
                try:
                    beat_once()
                except Exception:
                    return

        try:
            beat_once()
        except Exception as e:
            logging.warning("dist_sync heartbeat disabled: %s", e)
            return
        stop = threading.Event()
        t = threading.Thread(target=loop, args=(stop,), daemon=True,
                             name="kv-heartbeat")
        t.start()
        DistSyncKVStore._hb_thread = (t, stop)
        atexit.register(_stop_heartbeat)

    def get_num_dead_node(self, node_id=0, timeout=None):
        """Count workers whose heartbeat counter has stopped advancing for
        ``timeout`` seconds of the caller's monotonic clock.  The first
        observation of a rank sets its baseline, so detection needs two
        calls at least ``timeout`` apart (reference kvstore_dist.h:151-160).
        """
        if timeout is None:
            timeout = float(os.environ.get("MXNET_KVSTORE_HEARTBEAT_TIMEOUT",
                                           "60"))
        if _world() == 1:
            return 0
        store = self._store_client()
        if store is None:
            return 0
        dead = 0
        now = time.monotonic()
        for r in range(self.num_workers):
            if r == self.rank:
                continue
            key = "mxtt_hb/%d" % r
            try:
                if not store.check([key]):
                    continue  # never beat: not tracked (the launcher's job)
                raw = store.get(key)
            except Exception:
                continue
            prev = DistSyncKVStore._hb_seen.get(r)
            if prev is None or prev[0] != raw:
                DistSyncKVStore._hb_seen[r] = (raw, now)
                continue
            if now - prev[1] > timeout:
                dead += 1
        return dead
