"""PlacementPlanner — bin-pack models onto the device pool by demand
(counterpart of ``mxnet_tpu/platform/planner.py``).

The planner answers one question every replan tick: *which models
deserve to be resident right now, and where?*  Inputs are the
registered :class:`~mxnet_tpu_torch.platform.spec.ModelSpec` footprints, a
demand estimate per model (the manager's request-rate EWMA), and the
current placement.  Output is a :class:`PlacementPlan` plus the action
list (page-out / fault-in / migrate) that reconciles reality to it.

The packing itself is first-fit-decreasing — the classic bin-packing
heuristic: score models by ``demand x weight`` (SLO rank breaks ties:
interactive beats generate beats batch), walk them best-first, place
each on the device with the most free bytes that still fits it.
Models that fit nowhere are planned *paged* — they live as checkpoints
on disk until demand earns them a slot.  Sticky placement: a model
already resident on a device that still fits stays there (a replan must
not churn placements for equal-score shuffles — migrations cost warm
fault-ins).  Packing runs in two passes — a first copy of every model,
then the extra replicas — so capacity pressure (a dead host) sheds
redundancy before it sheds any model's availability.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import faults
from .. import telemetry as _telemetry
from ..base import MXNetError, env, register_env

__all__ = ["DevicePool", "PlacementPlan", "PlacementPlanner"]

register_env("MXNET_PLATFORM_DEVICE_BYTES", 16 << 30, int,
             "Per-device memory budget (bytes) the placement planner "
             "packs model footprints against when the pool does not "
             "declare one explicitly.")
register_env("MXNET_PLATFORM_DEVICES_PER_HOST", 0, int,
             "Devices per failure domain (host) for the placement "
             "planner's replica spreading and the health plane's "
             "domain grouping; 0 means all devices share one host.")


class DevicePool:
    """The memory budget the planner packs against: N devices of B
    bytes, grouped into failure domains of ``devices_per_host`` devices
    (host = domain: device ``d`` lives in domain ``d //
    devices_per_host``).  Defaults to the visible CUDA card count
    (``torch.cuda.device_count()``; without CUDA an explicit
    ``num_devices`` is required — the CPU is never counted), the
    ``MXNET_PLATFORM_DEVICE_BYTES`` budget, and one domain holding
    everything — tests pass tiny explicit pools to simulate '10 models,
    room for 4' or '2 hosts x 2 devices'.  A device index is bookkeeping:
    every replica runs on its manager's context."""

    def __init__(self, num_devices: Optional[int] = None,
                 bytes_per_device: Optional[int] = None,
                 devices_per_host: Optional[int] = None):
        if num_devices is None:
            import torch

            num_devices = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if num_devices < 1:
                raise MXNetError(
                    "DevicePool() counts CUDA cards and found none; pass "
                    "num_devices= to plan over an explicit pool")
        self.num_devices = int(num_devices)
        if self.num_devices < 1:
            raise MXNetError("device pool needs >= 1 device")
        self.bytes_per_device = (
            env("MXNET_PLATFORM_DEVICE_BYTES", 16 << 30, int)
            if bytes_per_device is None else int(bytes_per_device))
        if devices_per_host is None:
            devices_per_host = env("MXNET_PLATFORM_DEVICES_PER_HOST", 0,
                                   int) or self.num_devices
        self.devices_per_host = int(devices_per_host)
        if self.devices_per_host < 1:
            raise MXNetError("devices_per_host must be >= 1")

    def total_bytes(self) -> int:
        return self.num_devices * self.bytes_per_device

    def domain_of(self, device: int) -> int:
        """The failure domain (host index) a device belongs to."""
        return int(device) // self.devices_per_host

    @property
    def num_domains(self) -> int:
        return (self.num_devices + self.devices_per_host - 1) \
            // self.devices_per_host

    def devices_in(self, domain: int) -> List[int]:
        lo = int(domain) * self.devices_per_host
        return list(range(lo, min(lo + self.devices_per_host,
                                  self.num_devices)))

    def describe(self) -> dict:
        return {"num_devices": self.num_devices,
                "bytes_per_device": self.bytes_per_device,
                "devices_per_host": self.devices_per_host,
                "num_domains": self.num_domains}


class PlacementPlan:
    """One planner output: ``resident`` maps model name -> primary
    device id, ``paged`` lists the models living on disk, ``actions``
    is the reconciliation the manager actuates (in order: page-outs free
    the memory the fault-ins then claim).  ``replica_devices`` is the
    full per-replica placement (``name -> {replica_index: device}``);
    for single-replica models it is just ``{0: resident[name]}``."""

    __slots__ = ("resident", "paged", "actions", "free_bytes",
                 "replica_devices")

    def __init__(self, resident: Dict[str, int], paged: List[str],
                 actions: List[dict], free_bytes: Dict[int, int],
                 replica_devices: Optional[Dict[str, Dict[int, int]]] = None):
        self.resident = resident
        self.paged = paged
        self.actions = actions
        self.free_bytes = free_bytes
        self.replica_devices = ({n: {0: d} for n, d in resident.items()}
                                if replica_devices is None
                                else replica_devices)

    def describe(self) -> dict:
        return {"resident": dict(self.resident), "paged": list(self.paged),
                "actions": [dict(a) for a in self.actions],
                "free_bytes": dict(self.free_bytes),
                "replica_devices": {n: dict(v) for n, v
                                    in self.replica_devices.items()}}


class PlacementPlanner:
    """First-fit-decreasing packer with sticky placement."""

    def __init__(self, pool: DevicePool):
        self.pool = pool
        self._lock = threading.Lock()

    def plan(self, specs: Dict[str, object], demand: Dict[str, float],
             current: Optional[Dict[str, int]] = None,
             alive_devices=None,
             current_replicas: Optional[Dict[str, Dict[int, int]]] = None
             ) -> PlacementPlan:
        """Pack ``specs`` (name -> ModelSpec) onto the pool.

        ``demand`` is requests/s per model (missing == 0); ``current``
        is the live placement (name -> primary device) used both for
        stickiness and to derive the page-out/fault-in/migrate action
        diff.  ``alive_devices`` (from the health plane) restricts
        packing to surviving capacity — dead devices hold nothing, and
        replicas stuck on them migrate.  ``current_replicas`` is the
        full per-replica placement for multi-replica models (``name ->
        {replica_index: device}``); replicas of one model spread across
        failure domains when capacity allows.
        """
        faults.fire("platform.plan")
        current = dict(current or {})
        olds_by_model: Dict[str, Dict[int, int]] = {
            n: dict(v) for n, v in (current_replicas or {}).items()}
        for name, dev in current.items():
            olds_by_model.setdefault(name, {0: dev})
        with self._lock:
            order = sorted(
                specs.values(),
                key=lambda s: (-(demand.get(s.name, 0.0) * s.weight),
                               s.slo_rank(), s.name))
            devices = (range(self.pool.num_devices) if alive_devices is None
                       else sorted({int(d) for d in alive_devices
                                    if 0 <= int(d) < self.pool.num_devices}))
            free = {d: self.pool.bytes_per_device for d in devices}
            resident: Dict[str, int] = {}
            replica_devices: Dict[str, Dict[int, int]] = {}
            paged: List[str] = []
            jobs = []
            for spec in order:
                need = spec.footprint()["total"]
                if need > self.pool.bytes_per_device:
                    raise MXNetError(
                        "model %r (%d bytes) cannot fit any device "
                        "(%d bytes)" % (spec.name, need,
                                        self.pool.bytes_per_device))
                olds = olds_by_model.get(spec.name, {})
                # surviving replica indices first: after a host loss the
                # live copy keeps its seat and the dead index becomes
                # the expendable extra
                idxs = sorted(range(getattr(spec, "replicas", 1)),
                              key=lambda i: (i not in olds, i))
                jobs.append((spec, need, olds, idxs,
                             {}))  # type: ignore[var-annotated]
            # two passes: a first copy of every model, then the extra
            # replicas — under capacity pressure a model must lose
            # redundancy before any other model loses availability
            for lo, hi in ((0, 1), (1, None)):
                for spec, need, olds, idxs, placed in jobs:
                    for i in idxs[lo:hi]:
                        # sticky: keep the current device while it still
                        # fits (and is alive — dead devices are not in
                        # free)
                        dev = olds.get(i)
                        if dev is not None and dev in free and \
                                free[dev] >= need:
                            free[dev] -= need
                            placed[i] = dev
                            continue
                        if not free:
                            continue
                        # best fit on the most-free device, preferring a
                        # failure domain this model does not occupy yet —
                        # losing one host must degrade capacity, not
                        # availability
                        used_doms = {self.pool.domain_of(d)
                                     for d in placed.values()}
                        cand = max(free, key=lambda d: (
                            self.pool.domain_of(d) not in used_doms,
                            free[d], -d))
                        if free[cand] >= need:
                            free[cand] -= need
                            placed[i] = cand
            for spec, _need, _olds, _idxs, placed in jobs:
                if placed:
                    resident[spec.name] = placed[min(placed)]
                    replica_devices[spec.name] = placed
                else:
                    paged.append(spec.name)

        actions = []
        for name in sorted(olds_by_model):
            if name in resident:
                continue
            olds = olds_by_model[name]
            multi = len(olds) > 1
            for i in sorted(olds):
                act = {"op": "page_out", "model": name, "device": olds[i]}
                if multi or i != 0:
                    act["replica"] = i
                actions.append(act)
        for name in sorted(resident):
            placed = replica_devices[name]
            olds = olds_by_model.get(name, {})
            spec = specs.get(name)
            multi = max(len(placed), len(olds),
                        getattr(spec, "replicas", 1) if spec else 1) > 1
            for i in sorted(set(olds) | set(placed)):
                old, new = olds.get(i), placed.get(i)
                act = None
                if old is None and new is not None:
                    act = {"op": "fault_in", "model": name, "device": new}
                elif new is None and old is not None:
                    act = {"op": "page_out", "model": name, "device": old}
                elif old != new:
                    act = {"op": "migrate", "model": name, "src": old,
                           "dst": new}
                if act is not None:
                    if multi or i != 0:
                        act["replica"] = i
                    actions.append(act)
        plan = PlacementPlan(resident, paged, actions, free,
                             replica_devices)
        _telemetry.log_event(
            "platform_plan", resident=len(resident), paged=len(paged),
            actions=len(actions), alive=len(free))
        return plan
