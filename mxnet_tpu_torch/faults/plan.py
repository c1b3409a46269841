"""FaultPlan — the deterministic decision engine behind
``mxnet_tpu_torch.faults`` (counterpart of ``mxnet_tpu/faults/plan.py``).

A plan is a list of rules, each binding an *operation glob* to a fault
kind.  Instrumented code names every I/O site with a dotted operation
string (``kv.client.send``, ``ckpt.write``, ...) and calls
:func:`mxnet_tpu_torch.faults.fire` there; the plan decides — reproducibly,
from a seed — whether that particular call fails, stalls, or kills the
process.

Spec grammar (one string, env-var friendly)::

    spec    := rule (";" rule)*
    rule    := op_glob ":" action ("," action)*
    action  := kind "=" rate ["@" param]
             | kind ["@" param]          # rate-less shorthand, rate = 1

* ``op_glob`` — fnmatch pattern over operation names (``kv.client.*``).
* ``kind`` — one of ``drop`` (raise :class:`InjectedConnectionError`),
  ``ioerr`` (raise :class:`InjectedIOError`), ``delay`` (sleep),
  ``partial`` (torn file write — consumed by
  a file writer), ``kill``
  (``os._exit(137)``, a hard crash no ``finally`` can intercept),
  ``nan``/``bitflip`` (tensor corruption — consumed by
  :meth:`FaultPlan.corrupt` at instrumented tensor sites like
  ``guardian.grad``).
* ``rate`` — probability in [0, 1] drawn from the rule's own seeded
  stream, so unrelated rules never perturb each other's decisions.
* ``param`` — kind-specific: delay duration (``10ms``/``0.25s``/bare
  seconds), partial-write fraction kept, bitflip bit index, or — for
  any kind — ``#N`` to fire exactly on the N-th matching call
  (deterministic count trigger; rate is ignored).

Examples::

    kv.client.*:drop=0.3                 # 30% of worker wire ops drop
    kv.client.recv:drop=1@#2             # drop exactly the 2nd ACK read
    ckpt.write:partial=1@0.5             # every save tears at 50%
    kv.server.recv:kill=1@#40;*:delay=0.05@5ms
    guardian.grad:bitflip@#1             # flip a bit in the 1st guarded
                                         # gradient (rate-less shorthand)

Determinism contract: each rule owns a ``random.Random`` seeded from
``(seed, rule_index)`` and a call counter, so the decision for the N-th
call matching a rule depends only on (spec, seed, N) — not on wall time,
thread scheduling of *other* operations, or process layout.  The same
seed therefore replays the same faults (``tools/chaos_run.py``).
"""
from __future__ import annotations

import fnmatch
import os
import random
import threading
from typing import List, Optional, Tuple

__all__ = ["FaultPlan", "Rule", "InjectedConnectionError", "InjectedIOError",
           "parse_spec"]

_KINDS = ("drop", "ioerr", "delay", "partial", "kill", "nan", "bitflip")

# kinds that are inert in fire() and polled by the instrumented tensor
# site via FaultPlan.corrupt (the 'partial' pattern, but for arrays)
_CORRUPT_KINDS = ("nan", "bitflip")


class InjectedConnectionError(ConnectionResetError):
    """A connection drop injected by the active fault plan.

    Subclasses :class:`ConnectionResetError` so the code under test takes
    exactly the path a real peer reset would take."""


class InjectedIOError(OSError):
    """A file-I/O failure injected by the active fault plan."""


class Rule:
    __slots__ = ("op", "kind", "rate", "param", "nth")

    def __init__(self, op: str, kind: str, rate: float,
                 param: Optional[float] = None, nth: Optional[int] = None):
        if kind not in _KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, "/".join(_KINDS)))
        self.op = op
        self.kind = kind
        self.rate = float(rate)
        self.param = param
        self.nth = nth  # exact call index trigger ('#N'), 1-based

    def __repr__(self):
        extra = "@#%d" % self.nth if self.nth is not None else (
            "@%g" % self.param if self.param is not None else "")
        return "%s:%s=%g%s" % (self.op, self.kind, self.rate, extra)


def _parse_param(kind: str, raw: str) -> Tuple[Optional[float], Optional[int]]:
    """-> (param, nth).  '#N' is the deterministic count trigger; delay
    params accept ms/s suffixes and normalize to seconds."""
    if raw.startswith("#"):
        return None, int(raw[1:])
    if kind == "delay":
        if raw.endswith("ms"):
            return float(raw[:-2]) / 1e3, None
        if raw.endswith("s"):
            return float(raw[:-1]), None
        return float(raw), None
    return float(raw), None


def parse_spec(spec: str) -> List[Rule]:
    rules: List[Rule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        op, sep, actions = chunk.partition(":")
        if not sep:
            raise ValueError(
                "bad fault rule %r: expected 'op_glob:kind=rate[@param]'"
                % chunk)
        for action in actions.split(","):
            action = action.strip()
            kind, sep, rest = action.partition("=")
            if not sep:
                # rate-less shorthand 'kind[@param]' — rate defaults to 1
                # (reads naturally with '#N' count triggers:
                # 'guardian.grad:bitflip@#1')
                kind, _, param_s = action.partition("@")
                rate_s = "1"
            else:
                rate_s, _, param_s = rest.partition("@")
            param, nth = _parse_param(kind.strip(), param_s) if param_s \
                else (None, None)
            rules.append(Rule(op.strip(), kind.strip(), float(rate_s),
                              param, nth))
    return rules


class FaultPlan:
    """Seeded fault schedule over operation names (see module docstring).

    Thread-safe: rule streams/counters are guarded by one lock; the
    decision for the N-th call matching a rule is a pure function of
    (spec, seed, N).
    """

    def __init__(self, spec, seed: int = 0):
        if isinstance(spec, str):
            self.spec = spec
            self.rules = parse_spec(spec)
        else:  # pre-built rule list
            self.rules = list(spec)
            self.spec = ";".join(repr(r) for r in self.rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        # per-rule independent streams: interleaved calls to other ops
        # must not shift this rule's decision sequence
        self._rngs = [random.Random((self.seed + 1) * 1000003 + i)
                      for i in range(len(self.rules))]
        self._counts = [0] * len(self.rules)
        self.events: List[Tuple[str, str, int]] = []  # (op, kind, call_no)

    def __repr__(self):
        return "FaultPlan(seed=%d, %r)" % (self.seed, self.spec)

    # -- decisions ---------------------------------------------------------
    def _decide(self, op: str):
        """-> list of (Rule, call_no) that fire for this call of ``op``."""
        fired = []
        with self._lock:
            for i, rule in enumerate(self.rules):
                if not fnmatch.fnmatchcase(op, rule.op):
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                if rule.nth is not None:
                    hit = (n == rule.nth)
                else:
                    # always draw, even at rate 0/1: the stream position
                    # stays aligned with the call count
                    hit = self._rngs[i].random() < rule.rate
                if hit:
                    self.events.append((op, rule.kind, n))
                    fired.append((rule, n))
        return fired

    @staticmethod
    def _note_injected(op, kind, call_no):
        """Telemetry counter + event per injected fault (no-op when off)."""
        from .. import telemetry as _tm

        if not _tm.enabled():
            return
        _tm.labeled_counter("mxtpu_faults_injected_total", "kind",
                            "Faults injected by the active plan.").inc(kind)
        _tm.log_event("fault_injected", op=op, fault=kind, call_no=call_no)

    def fire(self, op: str) -> None:
        """Evaluate all rules for one operation; may sleep, raise, or kill
        the process.  ``partial`` rules never fire here — they are polled
        by the file writer via :meth:`partial_fraction`."""
        import time

        for rule, n in self._decide(op):
            self._note_injected(op, rule.kind, n)
            if rule.kind == "delay":
                time.sleep(rule.param if rule.param is not None else 0.01)
            elif rule.kind == "drop":
                raise InjectedConnectionError(
                    "injected connection drop at %s (call #%d, seed %d)"
                    % (op, n, self.seed))
            elif rule.kind == "ioerr":
                raise InjectedIOError(
                    "injected I/O error at %s (call #%d, seed %d)"
                    % (op, n, self.seed))
            elif rule.kind == "kill":
                try:
                    # flight recorder: leave postmortem evidence of the
                    # victim's last spans/events before the hard exit
                    from .. import telemetry as _tm

                    _tm.flight_recorder.dump("fault-kill:%s" % op)
                except Exception:
                    pass
                os._exit(137)
            # 'partial' and the corrupt kinds intentionally inert in
            # fire() — polled by their instrumented sites instead

    def partial_fraction(self, op: str) -> Optional[float]:
        """Fraction of the file to keep for a torn write at ``op``, or
        None when no ``partial`` rule fires on this call."""
        frac = None
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.kind != "partial" or \
                        not fnmatch.fnmatchcase(op, rule.op):
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                if rule.nth is not None:
                    hit = (n == rule.nth)
                else:
                    hit = self._rngs[i].random() < rule.rate
                if hit:
                    self.events.append((op, rule.kind, n))
                    frac = rule.param if rule.param is not None else 0.5
                    hit_no = n
        if frac is not None:
            self._note_injected(op, "partial", hit_no)
        return frac

    def targets_corruption(self, op: str) -> bool:
        """True when any ``nan``/``bitflip`` rule's glob matches ``op``.
        A pure predicate — counters and RNG streams are not advanced —
        so callers can branch (e.g. the Module keeps gradients
        host-visible for injection) without perturbing the schedule."""
        return any(r.kind in _CORRUPT_KINDS and
                   fnmatch.fnmatchcase(op, r.op) for r in self.rules)

    def corrupt(self, op: str, array):
        """Tensor-corruption poll for instrumented sites: returns
        ``array`` untouched when no ``nan``/``bitflip`` rule fires on
        this call, else a corrupted **copy**.

        The victim element is picked from the rule's own seeded stream,
        so which element is hit depends only on (spec, seed, call_no) —
        the determinism contract the chaos scenarios replay against.

        * ``nan`` — the picked element becomes NaN (for float dtypes;
          integer arrays get their maximum value).
        * ``bitflip`` — one bit of the picked element flips.  By default
          the most-significant *exponent* bit (the canonical worst-case
          SDC: the value scales by ~2**128 or collapses toward zero);
          ``@B`` picks an explicit bit index instead.
        """
        hits = []
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.kind not in _CORRUPT_KINDS or \
                        not fnmatch.fnmatchcase(op, rule.op):
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                if rule.nth is not None:
                    hit = (n == rule.nth)
                else:
                    hit = self._rngs[i].random() < rule.rate
                if hit:
                    self.events.append((op, rule.kind, n))
                    # element pick drawn under the lock from the rule's
                    # stream: stays deterministic per (spec, seed, N)
                    hits.append((rule, n, self._rngs[i].randrange(2 ** 31)))
        if not hits:
            return array
        import numpy as np

        out = np.array(array, copy=True)
        flat = out.reshape(-1).view()
        for rule, n, pick in hits:
            self._note_injected(op, rule.kind, n)
            idx = pick % max(1, flat.size)
            if rule.kind == "nan":
                if np.issubdtype(out.dtype, np.floating):
                    flat[idx] = np.nan
                else:
                    flat[idx] = np.iinfo(out.dtype).max
            else:  # bitflip
                itemsize = out.dtype.itemsize
                bits = itemsize * 8
                if rule.param is not None and rule.nth is None:
                    bit = int(rule.param) % bits
                elif np.issubdtype(out.dtype, np.floating) and bits >= 16:
                    bit = bits - 2  # MSB of the exponent field
                else:
                    bit = bits - 1
                u = np.dtype("uint%d" % bits)
                word = flat[idx:idx + 1].view(u)
                word ^= u.type(1) << u.type(bit)
        return out
