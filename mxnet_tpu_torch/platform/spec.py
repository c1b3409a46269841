"""ModelSpec — one registered model and its estimated device footprint
(counterpart of ``mxnet_tpu/platform/spec.py``).

The planner never loads a model to decide where it fits: placement runs
off *estimates* that are cheap to compute from what is already on disk
(the checkpoint's param file size, the same ``.params`` bytes in both
packages), what the spec declares (a generator spec implies a paged KV
pool of known geometry), and what past runs measured.  A live server's
compile-cache entries refine the executable guess (``ModelManager.
_observe_exec_bytes``: the bytes its CUDA graphs' pool and static buffers
took on the card, where the JAX package reads XLA's cost analysis); until
one has reported, the estimate is ``MXNET_PLATFORM_EXEC_OVERHEAD``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..base import MXNetError, env, register_env

__all__ = ["ModelSpec", "SLO_RANK"]

register_env("MXNET_PLATFORM_EXEC_OVERHEAD", 0.25, float,
             "Executable-footprint estimate as a fraction of a model's "
             "param bytes, used by the placement planner until a "
             "measurement is observed (ModelSpec.observe_exec_bytes, fed "
             "by the compile cache's CUDA graph bytes).")

# placement priority by SLO class: interactive models evict last,
# batch models evict first, generators sit between (their KV pool makes
# fault-in costlier than a pure classifier's)
SLO_RANK = {"interactive": 0, "generate": 1, "batch": 2}


class ModelSpec:
    """One model the platform may serve.

    Parameters
    ----------
    name : str
        Platform-unique model name (the routing key in request paths).
    prefix, epoch : str, int
        ``save_checkpoint`` prefix/epoch this model loads from; an AOT
        bundle beside it (``prefix-NNNN.aot/``) is attached at fault-in.
    input_shapes : dict
        ``{input: shape}`` including the batch axis, as for
        :class:`~mxnet_tpu_torch.serving.server.InferenceServer`.
    tenant : str
        Owning tenant (quota accounting + telemetry label).
    slo : str
        SLO class: ``interactive`` / ``batch`` / ``generate``.
    weight : float
        Fair-share weight for this model's tenant traffic.
    generator_spec : dict, optional
        DecodeEngine kwargs for generate-capable models; implies a
        KV-pool footprint.
    param_bytes : int, optional
        Explicit param footprint; default derives from the checkpoint
        file size on disk.
    server_kwargs : dict, optional
        Extra ``InferenceServer.from_checkpoint`` kwargs (buckets,
        max_queue, ...).
    replicas : int
        Desired replica count (default 1).  The planner spreads a
        model's replicas across failure domains, so losing one host
        degrades capacity instead of availability; each replica costs
        one full footprint.
    """

    __slots__ = ("name", "prefix", "epoch", "input_shapes", "tenant",
                 "slo", "weight", "generator_spec", "server_kwargs",
                 "replicas", "_param_bytes", "_measured_exec_bytes")

    def __init__(self, name: str, prefix: str, epoch: int,
                 input_shapes: Dict[str, Sequence[int]],
                 tenant: str = "default", slo: str = "interactive",
                 weight: float = 1.0,
                 generator_spec: Optional[dict] = None,
                 param_bytes: Optional[int] = None,
                 server_kwargs: Optional[dict] = None,
                 replicas: int = 1):
        if not name or "/" in name:
            raise MXNetError("model name must be non-empty and slash-free, "
                             "got %r" % (name,))
        if slo not in SLO_RANK:
            raise MXNetError("unknown SLO class %r (one of %s)"
                             % (slo, sorted(SLO_RANK)))
        if int(replicas) < 1:
            raise MXNetError("replicas must be >= 1, got %r" % (replicas,))
        self.name = name
        self.prefix = prefix
        self.epoch = int(epoch)
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self.tenant = tenant
        self.slo = slo
        self.weight = float(weight)
        self.generator_spec = dict(generator_spec) if generator_spec else None
        self.server_kwargs = dict(server_kwargs) if server_kwargs else {}
        self.replicas = int(replicas)
        self._param_bytes = None if param_bytes is None else int(param_bytes)
        self._measured_exec_bytes = None

    # -- footprint ---------------------------------------------------------
    def param_footprint(self) -> int:
        """Param bytes: explicit > checkpoint file size > 0 (a spec whose
        checkpoint is not on disk yet still registers; the planner just
        sees it as weightless until it materializes)."""
        if self._param_bytes is not None:
            return self._param_bytes
        path = "%s-%04d.params" % (self.prefix, self.epoch)
        try:
            return os.path.getsize(path)
        except OSError:
            return 0

    def kv_footprint(self) -> int:
        """Paged-KV-pool bytes a generate-capable model pins: K and V
        pages across layers at the spec's (or default) pool geometry."""
        gs = self.generator_spec
        if not gs:
            return 0
        num_layers = int(gs.get("num_layers", 4))
        num_heads = int(gs.get("num_heads", 8))
        hidden = int(gs.get("hidden", 512))
        head_dim = hidden // num_heads
        page_size = int(gs.get("page_size")
                        or env("MXNET_GEN_PAGE_SIZE", 16, int))
        num_pages = int(gs.get("num_pages")
                        or env("MXNET_GEN_NUM_PAGES", 128, int))
        dtype_size = np.dtype(gs.get("dtype", np.float32)).itemsize
        return (2 * num_layers * num_pages * page_size
                * num_heads * head_dim * dtype_size)

    def exec_footprint(self) -> int:
        """Executable bytes: the live-run measurement when one exists,
        else the ``MXNET_PLATFORM_EXEC_OVERHEAD`` fraction of params."""
        if self._measured_exec_bytes is not None:
            return self._measured_exec_bytes
        frac = env("MXNET_PLATFORM_EXEC_OVERHEAD", 0.25, float)
        return int(self.param_footprint() * frac)

    def observe_exec_bytes(self, nbytes: int):
        """Refine the executable estimate from a measurement (the
        manager feeds the compile cache's graph bytes here)."""
        self._measured_exec_bytes = int(nbytes)

    def footprint(self) -> dict:
        p, k, e = (self.param_footprint(), self.kv_footprint(),
                   self.exec_footprint())
        return {"param_bytes": p, "kv_bytes": k, "exec_bytes": e,
                "total": p + k + e}

    def slo_rank(self) -> int:
        return SLO_RANK[self.slo]

    def describe(self) -> dict:
        d = self.footprint()
        d.update(name=self.name, tenant=self.tenant, slo=self.slo,
                 weight=self.weight, prefix=self.prefix, epoch=self.epoch,
                 generate=self.generator_spec is not None,
                 replicas=self.replicas)
        return d

    def __repr__(self):
        return ("ModelSpec(%r, tenant=%r, slo=%r, total_bytes=%d)"
                % (self.name, self.tenant, self.slo,
                   self.footprint()["total"]))
