"""Deterministic, seed-driven fault injection — counterpart of
``mxnet_tpu/faults/`` (stdlib only, carried whole as the port's own copy).

Instrumented sites name themselves with dotted operation strings and call
:func:`fire` before touching the real resource; in this package those are
the generation engine and its KV pool (``generation.engine.*``,
``generation.kv.alloc``, ``generation.prefix.lookup``,
``generation.draft.verify``) and the parameter server's wire
(``kv.client.connect``/``send``/``recv``, ``kv.server.send``/``recv``,
``kv.server.evict``).  An installed :class:`FaultPlan` then
injects connection drops, delays, I/O errors or process kills on a
reproducible schedule.

Three ways to activate a plan:

* **In-process** (tests)::

      with mt.faults.inject("kv.client.*:drop=0.3", seed=7):
          train()

* **Whole process via env** — the contract for subprocess workers::

      MXNET_FAULTS_SPEC="kv.client.*:drop=0.3" MXNET_FAULTS_SEED=7 \\
          python train.py

* **Explicit**: ``mt.faults.install(FaultPlan(spec, seed))`` /
  ``mt.faults.uninstall()``.

When no plan is installed every hook is a single global-is-None check —
the production hot path pays nothing.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

from .plan import (FaultPlan, InjectedConnectionError, InjectedIOError, Rule,
                   parse_spec)

__all__ = ["FaultPlan", "Rule", "InjectedConnectionError", "InjectedIOError",
           "parse_spec", "install", "uninstall", "active", "fire",
           "partial_fraction", "corrupt", "targets_corruption", "inject",
           "install_from_env"]

_plan: Optional[FaultPlan] = None
_lock = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-global active plan (replacing any)."""
    global _plan
    with _lock:
        _plan = plan
    return plan


def uninstall() -> None:
    global _plan
    with _lock:
        _plan = None


def active() -> Optional[FaultPlan]:
    return _plan


def fire(op: str) -> None:
    """Injection point: no-op without an active plan, else the plan may
    sleep, raise, or kill here.  Called from instrumented I/O sites."""
    p = _plan
    if p is not None:
        p.fire(op)


def partial_fraction(op: str) -> Optional[float]:
    """Torn-write poll for file writers (see FaultPlan.partial_fraction)."""
    p = _plan
    if p is None:
        return None
    return p.partial_fraction(op)


def corrupt(op: str, array):
    """Tensor-corruption poll for array sites (``guardian.grad``, ...):
    returns ``array`` untouched without an active plan, else whatever
    :meth:`FaultPlan.corrupt` decides (a corrupted copy when a
    ``nan``/``bitflip`` rule fires on this call)."""
    p = _plan
    if p is None:
        return array
    return p.corrupt(op, array)


def targets_corruption(op: str) -> bool:
    """True when the active plan has a corruption rule aimed at ``op``
    (pure predicate — no counters advance)."""
    p = _plan
    return p is not None and p.targets_corruption(op)


@contextlib.contextmanager
def inject(spec: str, seed: int = 0):
    """Scoped installation for tests: installs a fresh plan, yields it,
    restores whatever was active before."""
    prev = _plan
    plan = FaultPlan(spec, seed)
    install(plan)
    try:
        yield plan
    finally:
        with _lock:
            globals()["_plan"] = prev


def install_from_env() -> Optional[FaultPlan]:
    """Activate from ``MXNET_FAULTS_SPEC`` / ``MXNET_FAULTS_SEED`` (the
    subprocess contract).  No-op when the spec var is unset/empty or a
    plan is already installed explicitly."""
    spec = os.environ.get("MXNET_FAULTS_SPEC", "")
    if not spec or _plan is not None:
        return _plan
    seed = int(os.environ.get("MXNET_FAULTS_SEED", "0"))
    return install(FaultPlan(spec, seed))


# env activation happens at import: a worker launched with the env vars
# set is fault-injected from its very first wire op
install_from_env()
