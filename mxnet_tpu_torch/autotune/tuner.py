"""The tuning loop: enumerate a declared space, score every candidate,
record the winner with provenance; counterpart of
``mxnet_tpu/autotune/tuner.py``.

Objective ladder (cheapest that applies wins):

* ``score_fn`` — closed-form analytic cost (bucket sets: expected
  padding waste + per-bucket build cost).  No compiler involved.
* ``build_fn`` — ``(fn, abstract)`` per candidate, counted by the shared
  :func:`mxnet_tpu_torch.hlo_analysis.lower_and_analyze` (the program run
  once on meta tensors of the abstract shapes, every op's operations and
  bytes counted; no card needed) and scored by the roofline bound
  max(flops/peak, bytes/bandwidth).  The RANKING across candidates of the
  same program tracks the roofline even where absolute times don't.
* ``measure_fn`` — real timed execution of the top-K candidates (CUDA
  events on the card), used where CUDA is available (or where
  ``MXNET_AUTOTUNE_MEASURE=1`` forces it).  The measured winner
  overrides the analytic ranking.

Ties break on the candidate's canonical JSON, so the winner is a pure
function of (space, objective) — deterministic across processes.
"""
from __future__ import annotations

import json
import time
from typing import Callable, List, Optional

from ..base import env

__all__ = ["Tuner"]


def _cand_key(cand: dict) -> str:
    return json.dumps(cand, sort_keys=True, default=str)


class Tuner:
    def __init__(self, db, topk: Optional[int] = None,
                 measure: Optional[bool] = None):
        self._db = db
        self._topk = int(env("MXNET_AUTOTUNE_TOPK", 3, int)
                         if topk is None else topk)
        if measure is None:
            measure = bool(env("MXNET_AUTOTUNE_MEASURE", 0, int))
            if not measure:
                try:
                    import torch

                    measure = torch.cuda.is_available()
                except Exception:
                    measure = False
        self._measure = bool(measure)

    def tune(self, site: str, key: dict, candidates: List[dict],
             build_fn: Optional[Callable] = None,
             score_fn: Optional[Callable] = None,
             measure_fn: Optional[Callable] = None,
             default: Optional[dict] = None) -> Optional[dict]:
        """Score ``candidates`` and persist the winner.  Returns the
        winning config, or ``default`` when nothing scores (every
        candidate failed to build) — in which case nothing is stored and
        the site keeps consulting its built-in default."""
        from . import _log_event, _metrics

        t0 = time.perf_counter()
        scored = []  # (score, cand_key, cand)
        objective = "analytic" if score_fn is not None else "roofline_proxy"
        for cand in candidates:
            try:
                if score_fn is not None:
                    score = float(score_fn(cand))
                elif build_fn is not None:
                    from ..hlo_analysis import lower_and_analyze, roofline_ms

                    fn, abstract = build_fn(cand)
                    _, info = lower_and_analyze(fn, abstract)
                    score = roofline_ms(info)
                    if score is None:
                        raise ValueError("no cost analysis")
                else:
                    raise ValueError("tune() needs score_fn or build_fn")
            except Exception as exc:
                _log_event("autotune_candidate_failed", site=site,
                           config=cand, error=repr(exc)[:200])
                continue
            scored.append((score, _cand_key(cand), cand))
        if not scored:
            _log_event("autotune_no_winner", site=site,
                       candidates=len(candidates))
            return default
        scored.sort(key=lambda t: (t[0], t[1]))
        winner = scored[0][2]
        provenance = {
            "objective": objective,
            "score": scored[0][0],
            "scores": [[c, s] for s, _, c in scored],
            "candidates": len(candidates),
        }
        if measure_fn is not None and self._measure:
            measured = []
            for score, ck, cand in scored[:max(1, self._topk)]:
                try:
                    ms = float(measure_fn(cand))
                except Exception as exc:
                    _log_event("autotune_measure_failed", site=site,
                               config=cand, error=repr(exc)[:200])
                    continue
                measured.append((ms, ck, cand))
            if measured:
                measured.sort(key=lambda t: (t[0], t[1]))
                winner = measured[0][2]
                provenance["objective"] = "measured"
                provenance["measured_ms"] = {ck: round(ms, 4)
                                             for ms, ck, _ in measured}
                provenance["score"] = measured[0][0]
        tuning_ms = (time.perf_counter() - t0) * 1e3
        provenance["tuning_ms"] = round(tuning_ms, 1)
        _metrics()["tuning_ms"].observe(tuning_ms)
        self._db.put(site, key, winner, provenance)
        _log_event("autotune_winner", site=site, config=winner,
                   objective=provenance["objective"],
                   score=provenance["score"],
                   tuning_ms=provenance["tuning_ms"])
        return winner
