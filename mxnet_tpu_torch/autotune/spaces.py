"""Declared search spaces, one per tunable site; the lists of
``mxnet_tpu/autotune/spaces.py``.

Each function enumerates the candidate configs the Tuner scores — small,
hand-declared grids (the TVM "search once per workload" loop, not an
open-ended schedule search).  Enumeration order is deterministic and
candidates are deduped by their EFFECTIVE config (e.g. flash block
requests that clamp to the same tile), so scoring never pays twice for
the same program.
"""
from __future__ import annotations

from typing import List, Sequence

# the JAX package's flash block grid (its Pallas kernels' tiles; the
# port's kernels size their own, so the winner sizes nothing here)
FLASH_BLOCK_CHOICES = (128, 256, 512, 1024)

GEN_PAGE_SIZE_CHOICES = (8, 16, 32, 64)


def flash_blocks(seq_q: int, seq_k: int) -> List[dict]:
    """block_q x block_k grid, deduped by the clamped tile actually
    staged (``_pick_block`` halves a request until it divides the
    sequence)."""
    from ..ops.attention import _pick_block

    seen, out = set(), []
    for bq in FLASH_BLOCK_CHOICES:
        for bk in FLASH_BLOCK_CHOICES:
            try:
                eff = (_pick_block(bq, seq_q), _pick_block(bk, seq_k))
            except ValueError:
                continue
            if eff in seen:
                continue
            seen.add(eff)
            out.append({"block_q": eff[0], "block_k": eff[1]})
    return out


def fused_step(donate_allowed: bool = True) -> List[dict]:
    """Remat (gradient checkpointing) on/off crossed with buffer
    donation on/off.  Donation candidates are only offered when the
    caller may donate (the port's executor never does: donation has no
    torch counterpart)."""
    out = []
    for remat in (0, 1):
        for donate in ((1, 0) if donate_allowed else (0,)):
            out.append({"remat": remat, "donate": donate})
    return out


def _pow2_up_to(n: int) -> List[int]:
    out, b = [], 1
    while b < n:
        out.append(b)
        b *= 2
    out.append(n)
    return out


def lane_bucket_sets(max_lanes: int) -> List[Sequence[int]]:
    """Candidate decode lane-count bucket sets: pow2 ladder, single
    max-size bucket, min+max, and (small fleets) the dense ladder."""
    cands = [tuple(_pow2_up_to(max_lanes)), (max_lanes,)]
    if max_lanes > 1:
        cands.append((1, max_lanes))
    if 2 < max_lanes <= 16:
        cands.append(tuple(range(1, max_lanes + 1)))
    seen, out = set(), []
    for c in cands:
        if c in seen:
            continue
        seen.add(c)
        out.append(c)
    return out


def decode_engine(max_lanes: int, max_seq_len: int) -> List[dict]:
    """Lane-bucket sets x gen page sizes for the DecodeEngine."""
    out = []
    for buckets in lane_bucket_sets(max_lanes):
        for page in GEN_PAGE_SIZE_CHOICES:
            if page > max_seq_len:
                continue
            out.append({"lane_buckets": list(buckets),
                        "page_size": page})
    return out


DRAFT_K_CHOICES = (1, 2, 3, 4, 6, 8)


def draft_k() -> List[dict]:
    """Candidate speculative draft lengths (tokens proposed per
    iteration).  The engine scores them analytically — expected cost
    per accepted token under the configured acceptance hint — so the
    grid stays small and the tune is instant."""
    return [{"k": k} for k in DRAFT_K_CHOICES]


def serving_buckets(max_batch: int) -> List[dict]:
    """Candidate serving micro-batch bucket sets: pow2 ladder, single
    max bucket, halves ladder, and (small max) the dense ladder."""
    cands = [tuple(_pow2_up_to(max_batch)), (max_batch,)]
    halves, b = [], max_batch
    while b >= 1:
        halves.append(b)
        b //= 2
    cands.append(tuple(sorted(set(halves))))
    if 2 < max_batch <= 32:
        cands.append(tuple(range(1, max_batch + 1)))
    seen, out = set(), []
    for c in cands:
        if c in seen:
            continue
        seen.add(c)
        out.append({"buckets": list(c)})
    return out
