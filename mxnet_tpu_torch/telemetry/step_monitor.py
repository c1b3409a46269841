"""StepMonitor — per-step wall time, data-wait, throughput, memory
watermarks, achieved model-MFU, and a recompile detector; counterpart of
``mxnet_tpu/telemetry/step_monitor.py``.

The MFU path: the fused step records ``_fused_introspect = (fn,
abstract_args)`` on the first build of each step key, and
:func:`lower_and_analyze` counts that program's operations on meta
tensors (``hlo_analysis``: the eager plan's cost model, where the JAX
package reads XLA's cost analysis of the compiled program).  The count
runs once per step key, never on the per-step path.

The recompile detector fingerprints the batch signature (name, shape,
dtype of every input) feeding the step.  A new shape builds a new step
(in the JAX package a retrace and recompile; here new plans, new
compile-cache entries and new kernel shapes), so the first signature per
monitor is warmup and any NEW signature after it warns once with the
offending shape diff and bumps ``mxtpu_recompiles_total``.

Device memory is the card's ``torch.cuda.max_memory_allocated`` for a
module on a CUDA context; a CPU module records none.
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

from ..base import env
from ..hlo_analysis import lower_and_analyze, peak_flops

__all__ = ["StepMonitor", "RecompileWarning", "peak_flops",
           "lower_and_analyze", "fused_cost_analysis"]


class RecompileWarning(UserWarning):
    """The fused train step recompiled after warmup (shape change)."""


def fused_cost_analysis(executor):
    """Cost count of an executor's last-built fused step, or None.

    A count the executor already carries (``_fused_cost_info``) is used
    as is; otherwise the step recorded on its first build
    (``_fused_introspect``) is counted on meta tensors."""
    info = getattr(executor, "_fused_cost_info", None)
    if info and info.get("flops"):
        return info
    fn, abstract = getattr(executor, "_fused_introspect", (None, None))
    _, info = lower_and_analyze(fn, abstract)
    return info


def _batch_signature(data_batch):
    """Hashable fingerprint of the arrays feeding one step."""
    sig = []
    for kind, arrs in (("data", data_batch.data or []),
                       ("label", getattr(data_batch, "label", None) or [])):
        for i, a in enumerate(arrs):
            sig.append(("%s%d" % (kind, i), tuple(a.shape), str(a.dtype)))
    return tuple(sig)


def _sig_diff(old, new):
    """Human-readable shape diff between two batch signatures."""
    old_d = {name: (shape, dt) for name, shape, dt in old}
    new_d = {name: (shape, dt) for name, shape, dt in new}
    parts = []
    for name in sorted(set(old_d) | set(new_d)):
        o, n = old_d.get(name), new_d.get(name)
        if o == n:
            continue
        if o is None:
            parts.append("%s: (new)->%s %s" % (name, n[0], n[1]))
        elif n is None:
            parts.append("%s: %s %s->(gone)" % (name, o[0], o[1]))
        else:
            parts.append("%s: %s->%s" % (
                name, o[0], n[0]) + ("" if o[1] == n[1]
                                     else " [%s->%s]" % (o[1], n[1])))
    return ", ".join(parts)


class StepMonitor:
    """Per-Module training-step telemetry.  Created lazily by Module when
    ``MXNET_TELEMETRY`` is on; the telemetry-off step path never touches
    this class."""

    def __init__(self, telemetry_mod, device=None):
        self._tm = telemetry_mod
        # the torch device the monitored module computes on: its memory
        # watermark is read only for a CUDA device
        self._device = device
        reg = telemetry_mod.registry()
        self.c_steps = reg.counter("mxtpu_steps_total",
                                   "Training steps completed.")
        self.c_samples = reg.counter("mxtpu_samples_total",
                                     "Training samples consumed.")
        self.c_data_wait_ms = reg.counter(
            "mxtpu_data_wait_ms_total",
            "Milliseconds the train loop blocked waiting for input batches.")
        self.h_step_ms = reg.histogram("mxtpu_step_time_ms",
                                       "Per-step wall time (ms).",
                                       start=0.25, factor=2.0, count=20)
        self.c_compiles = reg.counter("mxtpu_fused_compiles_total",
                                      "Fused-step executable builds.")
        self.c_recompiles = reg.counter(
            "mxtpu_recompiles_total",
            "Post-warmup step recompiles (shape changes).")
        self.g_last_ms = reg.gauge("mxtpu_step_last_ms",
                                   "Most recent step wall time (ms).")
        self.g_mfu = reg.gauge("mxtpu_step_mfu",
                               "Achieved model FLOP utilization [0,1].")
        self.g_mem_peak = reg.gauge(
            "mxtpu_device_peak_bytes",
            "Device memory high-watermark (bytes): "
            "torch.cuda.max_memory_allocated of the module's card.")
        self._t0 = None
        self._first_t0 = None
        self._last_end = None
        self._steps = 0
        self._samples = 0
        self._step_ms_total = 0.0
        self._data_wait_ms = 0.0
        self._flops_per_step = None
        self._mem_supported = True
        self._sigs = None  # recompile detector state: {sig}, last sig
        self._last_sig = None
        self._mesh_axes = None  # {axis_name: size} when training on a mesh
        telemetry_mod._set_current_monitor(self)

    def note_mesh(self, mesh):
        """Record the device-mesh layout the module trains on (surfaces in
        ``telemetry.summary()`` / BENCH records, next to the byte gauges,
        so a run's parallel layout is part of its record)."""
        if mesh is None:
            self._mesh_axes = None
            return
        self._mesh_axes = {str(name): int(mesh.shape[name])
                           for name in mesh.axis_names}
        self._tm.log_event("mesh", axes=self._mesh_axes)

    # -- per-step hooks (Module.forward_backward / update / fit) ----------
    def note_data_wait(self, seconds):
        ms = seconds * 1e3
        self._data_wait_ms += ms
        self.c_data_wait_ms.inc(ms)

    def note_batch(self, data_batch):
        """Recompile detection: fingerprint this step's input signature."""
        sig = _batch_signature(data_batch)
        if self._sigs is None:  # warmup: the first signature is expected
            self._sigs = {sig}
            self._last_sig = sig
            return
        if sig in self._sigs:
            self._last_sig = sig
            return
        diff = _sig_diff(self._last_sig, sig)
        self._sigs.add(sig)
        self._last_sig = sig
        self.c_recompiles.inc()
        self._tm.log_event("recompile", diff=diff, step=self._steps)
        warnings.warn(
            "training step input shapes changed after warmup — the fused "
            "step recompiles (%s)" % diff, RecompileWarning, stacklevel=3)

    def step_begin(self):
        self._t0 = time.perf_counter()
        if self._first_t0 is None:
            self._first_t0 = self._t0

    def step_end(self, batch_size):
        now = time.perf_counter()
        dur_ms = (now - self._t0) * 1e3 if self._t0 is not None else 0.0
        self._t0 = None
        self._last_end = now
        self._steps += 1
        self._samples += int(batch_size or 0)
        self._step_ms_total += dur_ms
        self.c_steps.inc()
        if batch_size:
            self.c_samples.inc(int(batch_size))
        self.h_step_ms.observe(dur_ms)
        self.g_last_ms.set(dur_ms)
        if self._steps % 10 == 1:
            self._sample_memory()
        self._tm.log_event("step", n=self._steps, dur_ms=round(dur_ms, 3),
                           data_wait_ms=round(self._data_wait_ms, 3))

    def note_compile(self, executor):
        """First build of a step key: one cost count per new step."""
        self.c_compiles.inc()
        if not env("MXNET_TELEMETRY_MFU", 1, int):
            return
        try:
            info = fused_cost_analysis(executor)
        except Exception:
            info = None
        if info and info.get("flops"):
            self._flops_per_step = float(info["flops"])
            self._tm.log_event("compile", flops=self._flops_per_step,
                               bytes_accessed=info.get("bytes_accessed"))

    # -- derived ----------------------------------------------------------
    def _sample_memory(self):
        if not self._mem_supported:
            return
        dev = self._device
        if dev is None or getattr(dev, "type", None) != "cuda":
            self._mem_supported = False
            return
        import torch

        peak = torch.cuda.max_memory_allocated(dev)
        if peak:
            self.g_mem_peak.set_max(int(peak))

    @property
    def data_wait_ms_total(self):
        return self._data_wait_ms

    @property
    def flops_per_step(self):
        return self._flops_per_step

    def avg_step_s(self) -> Optional[float]:
        """Steady-state seconds per step: wall clock over all steps (the
        same quantity perf_probe times), not just host dispatch."""
        if self._steps < 1 or self._first_t0 is None:
            return None
        wall = self._last_end - self._first_t0
        if wall <= 0:
            return None
        return wall / self._steps

    def mfu(self) -> Optional[float]:
        step_s = self.avg_step_s()
        if not step_s or not self._flops_per_step:
            return None
        v = self._flops_per_step / step_s / peak_flops()
        self.g_mfu.set(v)
        return v

    def report(self) -> dict:
        self._sample_memory()  # the watermark as of this report
        step_s = self.avg_step_s()
        rep = {
            "steps": self._steps,
            "avg_step_ms": round(step_s * 1e3, 3) if step_s else None,
            "dispatch_ms_avg": round(self._step_ms_total / self._steps, 3)
            if self._steps else None,
            "data_wait_ms_total": round(self._data_wait_ms, 3),
            "data_wait_frac": round(
                self._data_wait_ms / (step_s * 1e3 * self._steps), 4)
            if step_s else None,
            "samples_per_sec": round(self._samples / (step_s * self._steps),
                                     1) if step_s and self._samples else None,
            "flops_per_step": self._flops_per_step,
            "mfu": self.mfu(),
            "recompiles": self.c_recompiles.value,
            "device_peak_bytes": self.g_mem_peak.value or None,
        }
        if self._mesh_axes:
            rep["mesh"] = dict(self._mesh_axes)
        mfu = rep["mfu"]
        if mfu is not None:
            rep["mfu"] = round(mfu, 4)
        # cluster health: when a colocated kvstore server flagged slow
        # ranks this process's summary names them (per-rank counts)
        stragglers = self._straggler_counts()
        if stragglers:
            rep["stragglers"] = stragglers
        return rep

    @staticmethod
    def _straggler_counts():
        from .. import telemetry as _tm

        reg = _tm._registry  # only if the global registry already exists
        if reg is None:
            return None
        c = reg.get("mxtpu_kvsrv_stragglers_total")
        if c is None or not getattr(c, "value", 0):
            return None
        return {str(k): v for k, v in c.snapshot().items()}
