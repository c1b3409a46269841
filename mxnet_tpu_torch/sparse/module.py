"""SparseEmbeddingModule — Module with per-slot ``stype='row_sparse'``
embedding params routed through the sparse parameter plane, counterpart of
``mxnet_tpu/sparse/module.py``.

The routing is structural: each row_sparse slot's Embedding weight is bound
at shape ``(capacity, dim)`` — capacity = the most distinct rows one batch
can touch, not the vocabulary.  Per batch the module

1. uniquifies the slot's raw ids and remaps them to local positions
   ``[0, n_uniq)`` (np.unique's inverse),
2. pulls only the touched rows from the server shards and writes them into
   the bound weight buffer on the module's device (one host-to-device copy
   per slot; the rows past ``n_uniq`` zeroed),
3. runs the normal forward/backward — the weight gradient is the
   ``(capacity, dim)`` buffer, O(touched) not O(vocab),
4. brings ``grad[:n_uniq]`` to the host and pushes it back under the
   original row ids (coalesced across slots into one envelope per server),
   where the server-placed optimizer applies it.

Dense params keep the stock Module path.  The full table never exists on
the worker: resident bytes are O(capacity), and the logical table can be
far larger than the card's memory.  The remapped ids stay below the
capacity, so the port's out-of-range clip in ``Embedding`` never fires.
The route reads a slot's ids before the executor casts them: feed ids of a
vocabulary past 2^24 rows as integers (an int32 NDArray or numpy array),
since float32 rounds them, in both packages.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..module.module import Module
from .plane import SparseParamPlane, default_capacity
from .updaters import from_dense_optimizer

__all__ = ["SparseEmbeddingModule"]


class SparseEmbeddingModule(Module):
    """``sparse_slots`` maps a slot name to its routing config::

        {"slot0": {"data": "slot0_indices",   # index input (a data name)
                   "weight": "slot0_weight",  # the Embedding weight param
                   "num_rows": 10_000_000,    # logical vocabulary
                   "capacity": 4096,          # bound rows (optional)
                   "init": ("uniform", 0.01)  # server row init (optional)
                   }}

    The symbol must bind each slot's Embedding with
    ``input_dim=capacity`` (``models.get_dlrm`` builds the symbol and this
    config together)."""

    def __init__(self, symbol, sparse_slots, **kwargs):
        super().__init__(symbol, **kwargs)
        self._slots = {}
        for name, cfg in dict(sparse_slots).items():
            slot = {"name": name, "data": cfg["data"],
                    "weight": cfg["weight"],
                    "num_rows": int(cfg["num_rows"]),
                    "capacity": int(cfg.get("capacity",
                                            default_capacity())),
                    "init": tuple(cfg.get("init", ("uniform", 0.01))),
                    "uniq": None}
            if slot["weight"] not in self._param_names:
                raise MXNetError("row_sparse slot %r: weight %r is not a "
                                 "parameter of the symbol"
                                 % (name, slot["weight"]))
            if slot["data"] not in self._data_names:
                raise MXNetError("row_sparse slot %r: data %r is not a "
                                 "data input" % (name, slot["data"]))
            self._slots[name] = slot
        self._plane = None
        # the last step's host seconds by stage and bytes moved
        self._step = {}

    # -- routing hooks ------------------------------------------------------
    def _sparse_param_indices(self):
        weights = {s["weight"] for s in self._slots.values()}
        return tuple(i for i, n in enumerate(self._param_names)
                     if n in weights)

    def _decide_fused(self):
        # the per-batch id remap and row pull/push are eager
        return False

    @property
    def sparse_plane(self):
        return self._plane

    # -- optimizer ----------------------------------------------------------
    def init_optimizer(self, kvstore="dist_async", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        super().init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        kv = self._kvstore
        if kv is None or "dist" not in kv.type:
            raise MXNetError(
                "SparseEmbeddingModule needs a dist kvstore: the sharded "
                "embedding tables live on the parameter servers")
        if hasattr(kv, "sparse_plane"):
            self._plane = kv.sparse_plane()  # comm-engine FIFO chains
        else:
            self._plane = SparseParamPlane(kv)
        for slot in self._slots.values():
            i = self._param_names.index(slot["weight"])
            cap, dim = self._exec_group.param_arrays[i].shape
            if cap != slot["capacity"]:
                raise MXNetError(
                    "slot %r: symbol binds weight rows %d but capacity "
                    "is %d — build the symbol with input_dim=capacity"
                    % (slot["name"], cap, slot["capacity"]))
            slot["param_index"] = i
            slot["dim"] = int(dim)
            slot["data_index"] = self._exec_group.data_names.index(
                slot["data"])
            slot["key"] = slot["weight"]
            self._plane.init_table(slot["key"], num_rows=slot["num_rows"],
                                   row_shape=(dim,), init=slot["init"])
        # the server-placed optimizer: the dense slots' hyperparameters
        # (the 1/batch rescale included); its state never leaves the servers
        self._plane.set_sparse_optimizer(
            from_dense_optimizer(self._optimizer))

    # -- per-batch routing --------------------------------------------------
    def _route_sparse(self, data_batch):
        """Uniquify and remap each slot's ids, write the touched rows into
        the bound weight buffers, and return a shallow-copied batch whose
        index inputs hold local positions."""
        if self._plane is None or not self._slots:
            return data_batch
        batch = copy.copy(data_batch)
        data = list(batch.data)
        step = self._step = dict.fromkeys(
            ("unique_s", "pull_s", "copy_s", "to_host_s", "push_s"), 0.0)
        step["pulled_bytes"] = step["pushed_bytes"] = 0
        for slot in self._slots.values():
            t0 = time.perf_counter()
            di = slot["data_index"]
            raw = data[di]
            ids_np = (raw.asnumpy() if isinstance(raw, nd.NDArray)
                      else np.asarray(raw))
            ids = ids_np.astype(np.int64)
            uniq, inverse = np.unique(ids.reshape(-1), return_inverse=True)
            if uniq.size > slot["capacity"]:
                raise MXNetError(
                    "slot %r: batch touches %d distinct rows > capacity "
                    "%d — raise the slot capacity (or "
                    "MXNET_KVSTORE_SPARSE_CAPACITY)"
                    % (slot["name"], uniq.size, slot["capacity"]))
            t1 = time.perf_counter()
            rows = self._plane.pull_rows(slot["key"], uniq)
            t2 = time.perf_counter()
            weight = self._exec_group.param_arrays[slot["param_index"]]
            with torch.no_grad():
                w = weight._data
                w[:uniq.size].copy_(torch.from_numpy(rows))
                w[uniq.size:].zero_()
            data[di] = nd.array(
                inverse.reshape(ids.shape).astype(ids_np.dtype),
                ctx=self._context[0])
            slot["uniq"] = uniq
            t3 = time.perf_counter()
            step["unique_s"] += t1 - t0
            step["pull_s"] += t2 - t1
            step["copy_s"] += t3 - t2
            step["pulled_bytes"] += rows.nbytes
        batch.data = data
        return batch

    def forward(self, data_batch, is_train=None):
        super().forward(self._route_sparse(data_batch), is_train)

    def forward_backward(self, data_batch):
        super().forward_backward(self._route_sparse(data_batch))

    def update(self):
        """Push each slot's touched-row gradient to the servers (one
        coalesced envelope per server), then run the stock dense update
        with the sparse gradients masked out of the kvstore loop."""
        eg = self._exec_group
        pending = []
        t0 = time.perf_counter()
        if self._plane is not None:
            for slot in self._slots.values():
                uniq = slot.get("uniq")
                if uniq is None or "param_index" not in slot:
                    continue
                g = eg.grad_arrays[slot["param_index"]]
                if g is None:
                    continue
                # a copy: the push runs later, on the comm engine
                grad = g._data[:uniq.size].detach().to(
                    "cpu", copy=True).numpy()
                pending.append((slot["key"], uniq, grad))
                slot["uniq"] = None
            t1 = time.perf_counter()
            if pending:
                self._plane.push_rows_multi(pending)
            if self._step:
                self._step["to_host_s"] = t1 - t0
                self._step["push_s"] = time.perf_counter() - t1
                self._step["pushed_bytes"] = sum(g.nbytes
                                                 for _k, _i, g in pending)
        saved = {}
        for slot in self._slots.values():
            i = slot.get("param_index")
            if i is not None and eg.grad_arrays[i] is not None:
                saved[i] = eg.grad_arrays[i]
                eg.grad_arrays[i] = None
        try:
            super().update()
        finally:
            for i, g in saved.items():
                eg.grad_arrays[i] = g

    # -- observability ------------------------------------------------------
    def sparse_stats(self):
        """Worker-side plane counters: per-slot resident bytes (the bound
        capacity buffers), logical table bytes, the plane's transfer peaks,
        and the last step's host seconds by stage (ids uniquified, rows
        pulled, rows copied to the device; gradient rows brought to the
        host, push submitted) with the bytes it pulled and pushed."""
        out = {"slots": {}, "plane": None, "step": dict(self._step)}
        for slot in self._slots.values():
            dim = slot.get("dim")
            if dim is None:
                continue
            itemsize = 4  # float32 tables
            out["slots"][slot["name"]] = {
                "resident_bytes": slot["capacity"] * dim * itemsize,
                "logical_bytes": slot["num_rows"] * dim * itemsize,
                "capacity": slot["capacity"],
                "num_rows": slot["num_rows"],
            }
        if self._plane is not None:
            out["plane"] = {
                "peak_transfer_bytes": self._plane.peak_transfer_bytes,
                "last_pull_bytes": self._plane.last_pull_bytes,
                "num_servers": self._plane.num_servers,
            }
        return out
