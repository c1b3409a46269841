"""mxnet_tpu_torch.guardian — numeric-anomaly detection and self-healing
training; counterpart of ``mxnet_tpu/guardian.py``.

Every *crash* mode in this stack is survivable (kvstore kill -9, elastic
churn, serving failover), but a silently-wrong step — a NaN/Inf
gradient, a loss/grad-norm spike, a bit-flipped tensor from flaky
hardware — poisons the parameters and every replica that pulls them.
This module is the training-side half of the answer (the fleet-side half
is the kvstore server's non-finite push NACK):

* **Detection.**  The fused train step (``Executor.fused_step`` with the
  guard on) reduces finiteness over every gradient and floating output,
  plus the float32 global grad-norm, on the device (``torch._foreach_norm``)
  and reads that verdict once on the host before the list update, which a
  non-finite verdict skips: parameters, optimizer state and aux state keep
  their bits.  The unfused path checks host-visible gradients directly.
  A rolling-median spike detector (``MXNET_GUARDIAN_SPIKE_MULT`` × the
  median of the last ``MXNET_GUARDIAN_SPIKE_WINDOW`` observations)
  catches huge-but-finite corruption (the classic exponent bit-flip).

* **Graded response.**  ``Guardian.observe`` walks a ladder:
  *skip-batch* (the fused guard already skipped non-finite updates),
  then *LR re-warm* (ramp from ``MXNET_GUARDIAN_REWARM_FACTOR``
  back to 1.0 over ``MXNET_GUARDIAN_REWARM_STEPS`` applied steps), then
  *rollback* to the last-good snapshot.  More than
  ``MXNET_GUARDIAN_ROLLBACK_MAX`` rollbacks raises
  :class:`GuardianAbort` — at that point the corruption is not
  transient and a human should look.

* **Last-good ring.**  ``Module.fit`` offers a snapshot every
  ``MXNET_GUARDIAN_SNAPSHOT_EVERY`` batches; the guardian keeps the
  newest ``MXNET_GUARDIAN_RING`` of them.  A snapshot captures params,
  optimizer/updater state, the framework PRNG stream
  (``mx.random.get_state``) and the data-iterator position
  (``DataIter.state_dict``), so rollback-and-replay is bit-deterministic:
  the replayed steps see the same batches, the same stochastic schedule,
  and (the injected fault having already fired) clean gradients.

Cost model: mirrors ``faults``/``telemetry`` — disabled (the default),
every hook is one module-global read.  Activate with
``MXNET_GUARDIAN=1`` or :func:`enable`.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

from .base import MXNetError, env, register_env

__all__ = ["Guardian", "GuardianAbort", "enable", "disable", "enabled",
           "current_lr_mult", "stats", "reset_stats"]

register_env("MXNET_GUARDIAN", 0, int,
             "Master switch for the training guardian (fused-step "
             "numeric guard, spike detector, graded skip/re-warm/"
             "rollback response). Off: every hook is one global read.")
register_env("MXNET_GUARDIAN_SPIKE_MULT", 10.0, float,
             "A monitored scalar (grad-norm, loss) above this multiple "
             "of its rolling median counts as an anomaly.")
register_env("MXNET_GUARDIAN_SPIKE_WINDOW", 32, int,
             "Rolling-median window (in applied steps) for the spike "
             "detector.")
register_env("MXNET_GUARDIAN_WARMUP", 8, int,
             "Applied steps of history before the spike detector arms "
             "(non-finite detection is armed from step one).")
register_env("MXNET_GUARDIAN_SKIP_MAX", 2, int,
             "Consecutive anomalous steps answered by skip-batch before "
             "the ladder escalates.")
register_env("MXNET_GUARDIAN_REWARM_STEPS", 50, int,
             "LR re-warm ramp length in applied steps; 0 removes the "
             "re-warm rung (skip escalates straight to rollback).")
register_env("MXNET_GUARDIAN_REWARM_FACTOR", 0.1, float,
             "LR multiplier at the start of a re-warm ramp.")
register_env("MXNET_GUARDIAN_ROLLBACK_MAX", 2, int,
             "Rollbacks per fit before the guardian gives up and raises "
             "GuardianAbort.")
register_env("MXNET_GUARDIAN_RING", 2, int,
             "Last-good snapshots kept in the in-memory retention ring.")
register_env("MXNET_GUARDIAN_SNAPSHOT_EVERY", 50, int,
             "Batches between last-good ring snapshots in Module.fit.")

# the single hot-path gate (faults' plan-is-None idiom)
_ACTIVE = bool(env("MXNET_GUARDIAN", 0, int))

#: the Guardian currently steering the learning rate (re-warm ramp);
#: optimizer._get_lr consults this — one global read when no ramp is live
_governor: Optional["Guardian"] = None

_stats_lock = threading.Lock()
_STATS = {"anomalies": 0, "skips": 0, "rewarms": 0, "rollbacks": 0,
          "snapshots": 0}


class GuardianAbort(MXNetError):
    """Raised when the rollback budget is exhausted: the anomaly is not
    transient (bad data shard, diverged hypers, sick chip) and another
    automatic replay would loop forever."""


def enable() -> None:
    global _ACTIVE
    _ACTIVE = True


def disable() -> None:
    global _ACTIVE, _governor
    _ACTIVE = False
    _governor = None


def enabled() -> bool:
    return _ACTIVE


def current_lr_mult() -> float:
    """The live re-warm LR multiplier (1.0 when no ramp is active)."""
    g = _governor
    return 1.0 if g is None else g.lr_mult()


def stats() -> dict:
    """Process-wide guardian counters (a run's record embeds them; chaos
    scenarios assert on them)."""
    with _stats_lock:
        return dict(_STATS)


def reset_stats() -> None:
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key, n=1):
    with _stats_lock:
        _STATS[key] += n


def _telemetry_anomaly(kind, step, value):
    from . import telemetry as _tm

    if not _tm.enabled():
        return
    _tm.labeled_counter("mxtpu_guardian_anomalies_total", "kind",
                        "Numeric anomalies the guardian detected.").inc(kind)
    # the anomaly's kind rides as "anomaly": "kind" names the event (the
    # JAX package passes kind= here and raises TypeError instead of
    # logging; ROADMAP.md C)
    _tm.log_event("guardian_anomaly", anomaly=kind, step=step, value=value)


def _telemetry_action(action, step):
    from . import telemetry as _tm

    if not _tm.enabled():
        return
    _tm.counter("mxtpu_guardian_%ss_total" % action,
                "Guardian %s responses." % action).inc()
    _tm.log_event("guardian_action", action=action, step=step)


class Guardian:
    """One training run's anomaly detector + response policy.

    ``observe(finite, gnorm, loss)`` is called once per step and returns
    the action the caller must take: ``"ok"`` (apply/continue),
    ``"skip"`` (do not apply this batch), ``"rewarm"`` (skip AND a fresh
    LR ramp just started), or ``"rollback"`` (restore
    :meth:`rollback_target` and replay).  The ladder escalates with
    *consecutive* anomalies and resets on any clean step.

    ``clock`` is injectable for tests (fake-clock unit tests drive the
    ladder without sleeping); it only feeds timestamps in events/stats,
    never decisions — determinism of the response sequence is part of
    the replay contract.
    """

    def __init__(self, clock: Callable[[], float] = None,
                 spike_mult: Optional[float] = None,
                 spike_window: Optional[int] = None,
                 warmup: Optional[int] = None,
                 skip_max: Optional[int] = None,
                 rewarm_steps: Optional[int] = None,
                 rewarm_factor: Optional[float] = None,
                 rollback_max: Optional[int] = None,
                 ring: Optional[int] = None,
                 snapshot_every: Optional[int] = None):
        import time

        def _knob(val, name, typ):
            return typ(env(name)) if val is None else typ(val)

        self.clock = clock or time.monotonic
        self.spike_mult = _knob(spike_mult, "MXNET_GUARDIAN_SPIKE_MULT",
                                float)
        self.spike_window = _knob(spike_window,
                                  "MXNET_GUARDIAN_SPIKE_WINDOW", int)
        self.warmup = _knob(warmup, "MXNET_GUARDIAN_WARMUP", int)
        self.skip_max = _knob(skip_max, "MXNET_GUARDIAN_SKIP_MAX", int)
        self.rewarm_steps = _knob(rewarm_steps,
                                  "MXNET_GUARDIAN_REWARM_STEPS", int)
        self.rewarm_factor = _knob(rewarm_factor,
                                   "MXNET_GUARDIAN_REWARM_FACTOR", float)
        self.rollback_max = _knob(rollback_max,
                                  "MXNET_GUARDIAN_ROLLBACK_MAX", int)
        self.ring_size = max(1, _knob(ring, "MXNET_GUARDIAN_RING", int))
        self.snapshot_every = _knob(snapshot_every,
                                    "MXNET_GUARDIAN_SNAPSHOT_EVERY", int)

        self._gnorms: deque = deque(maxlen=max(1, self.spike_window))
        self._losses: deque = deque(maxlen=max(1, self.spike_window))
        self._consec = 0
        self._step = 0
        self._rewarm_left = 0
        self._rollbacks = 0
        self._last_snap_step: Optional[int] = None
        self._ring: List[Tuple[int, dict]] = []  # (step, snapshot)
        self.history: List[Tuple[str, int, float]] = []  # (action, step, ts)

    # -- spike machinery ---------------------------------------------------
    @staticmethod
    def _median(window) -> Optional[float]:
        if not window:
            return None
        vals = sorted(window)
        mid = len(vals) // 2
        return vals[mid] if len(vals) % 2 else \
            0.5 * (vals[mid - 1] + vals[mid])

    def _spiked(self, window, value) -> bool:
        if value is None or len(window) < max(1, self.warmup):
            return False
        med = self._median(window)
        # only a positive median gives the multiplicative test meaning
        # (losses can legitimately be <= 0 — e.g. log-likelihoods)
        return med is not None and med > 0 and value > self.spike_mult * med

    # -- the ladder --------------------------------------------------------
    def observe(self, finite: bool = True, gnorm: Optional[float] = None,
                loss: Optional[float] = None) -> str:
        """Feed one step's verdicts; -> "ok" | "skip" | "rewarm" |
        "rollback" (the caller acts on it — see class docstring)."""
        import math

        self._step += 1
        kind = None
        if not finite or \
                (gnorm is not None and not math.isfinite(gnorm)) or \
                (loss is not None and not math.isfinite(loss)):
            kind = "nonfinite"
        elif self._spiked(self._gnorms, gnorm):
            kind = "grad_spike"
        elif self._spiked(self._losses, loss):
            kind = "loss_spike"

        if kind is None:
            if gnorm is not None:
                self._gnorms.append(gnorm)
            if loss is not None:
                self._losses.append(loss)
            self._consec = 0
            if self._rewarm_left > 0:
                self._rewarm_left -= 1
                if self._rewarm_left == 0:
                    self._set_governor(False)
            return "ok"

        self._consec += 1
        _bump("anomalies")
        _telemetry_anomaly(kind, self._step,
                           gnorm if kind != "loss_spike" else loss)
        if self._consec <= self.skip_max:
            action = "skip"
        elif self.rewarm_steps > 0 and \
                self._consec <= 2 * self.skip_max + 1:
            if self._consec == self.skip_max + 1:
                self._rewarm_left = self.rewarm_steps
                self._set_governor(True)
                action = "rewarm"
            else:
                action = "skip"  # give the fresh ramp a chance
        else:
            action = "rollback"
        if action == "skip":
            _bump("skips")
        elif action == "rewarm":
            _bump("rewarms")
            _bump("skips")  # the anomalous batch itself is still skipped
        _telemetry_action(action, self._step)
        self.history.append((action, self._step, self.clock()))
        return action

    def lr_mult(self) -> float:
        """Re-warm ramp multiplier: rewarm_factor right after the
        trigger, back to 1.0 once rewarm_steps clean steps applied."""
        if self._rewarm_left <= 0 or self.rewarm_steps <= 0:
            return 1.0
        frac = 1.0 - self._rewarm_left / float(self.rewarm_steps)
        return self.rewarm_factor + (1.0 - self.rewarm_factor) * frac

    def _set_governor(self, on: bool) -> None:
        global _governor
        _governor = self if on else (None if _governor is self else
                                     _governor)

    # -- last-good retention ring ------------------------------------------
    def snapshot_due(self) -> bool:
        """True on the steps Module.fit should capture a ring snapshot
        (step 0 — before any update — always qualifies, so a rollback
        target exists from the first batch)."""
        return (self._step % max(1, self.snapshot_every)) == 0

    def offer_snapshot(self, capture: Callable[[], dict],
                       force: bool = False) -> bool:
        """Capture-and-retain when a snapshot is due; ``capture`` is
        only invoked if so (it copies params — not free).  ``force``
        overrides the cadence (fit forces one at each epoch start so a
        rollback target always exists inside the current epoch); never
        while anomalies are live, and at most one snapshot per observed
        step — a caller whose path never feeds :meth:`observe` gets
        exactly one snapshot, not one per batch."""
        if self._consec != 0:
            return False
        if self._step == self._last_snap_step and self._ring:
            return False
        if not (force or self.snapshot_due()):
            return False
        self._last_snap_step = self._step
        self._ring.append((self._step, capture()))
        del self._ring[:-self.ring_size]
        _bump("snapshots")
        return True

    def rollback_target(self, match: Optional[Callable[[dict], bool]]
                        = None) -> Optional[Tuple[int, dict]]:
        """Newest retained (step, snapshot) whose snapshot satisfies
        ``match`` (fit restricts to the current epoch — replaying across
        an epoch boundary would re-apply the previous epoch's tail), or
        None (fit then falls back to aborting)."""
        for step, snap in reversed(self._ring):
            if match is None or match(snap):
                return (step, snap)
        return None

    def note_rollback(self, to_step: Optional[int] = None) -> None:
        """Account one rollback: counters, anomaly event, flight-recorder
        postmortem (the evidence of WHY we rolled back — the last spans,
        events and metric values before the anomaly).  Raises
        :class:`GuardianAbort` past the budget."""
        self._rollbacks += 1
        self._consec = 0
        self._rewarm_left = 0
        self._set_governor(False)
        _bump("rollbacks")
        from . import telemetry as _tm

        if _tm.enabled():
            _tm.log_event("guardian_rollback", step=self._step,
                          to_step=to_step, count=self._rollbacks)
            _tm.flight_recorder.dump("guardian-rollback",
                                     extra={"step": self._step,
                                            "to_step": to_step})
        if self._rollbacks > self.rollback_max:
            raise GuardianAbort(
                "guardian rolled back %d times (budget %d): the anomaly "
                "is not transient — inspect the flight-recorder "
                "postmortem and the data/hardware under this run"
                % (self._rollbacks, self.rollback_max))

    # the detector state (median windows, consecutive count) is NOT
    # rolled back with the params: the anomalies it saw were real, and
    # the rollback budget must keep counting across replays

    def stats(self) -> dict:
        return {"step": self._step, "rollbacks": self._rollbacks,
                "ring": [s for s, _ in self._ring],
                "consecutive_anomalies": self._consec,
                "rewarm_left": self._rewarm_left,
                "lr_mult": self.lr_mult()}
