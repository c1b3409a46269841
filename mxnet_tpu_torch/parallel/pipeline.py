"""Collective-permute pipeline parallelism over a 'pipe' mesh axis —
counterpart of ``mxnet_tpu/parallel/pipeline.py``.

Every shard holds one stage's parameters (stacked on a leading stage axis
and split over 'pipe'), and microbatch activations stream stage to stage
with ``ppermute`` — the GPipe schedule, run by ``shard_map``; the last
stage's outputs reach every shard through a ``psum``.
"""
from __future__ import annotations

import functools

from ._compat import axis_index, ppermute, psum, shard_map, _tree_map
from .mesh import PartitionSpec as P

__all__ = ["pipeline_spmd"]


def _pipeline_inner(params, xs, *, axis, n_stages, n_micro, stage_fn):
    import torch

    stage = axis_index(axis)
    # local params arrive with a leading stage axis of length 1
    local_params = _tree_map(lambda p: p[0], params)
    n_steps = n_micro + n_stages - 1
    state = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    outs = [torch.zeros_like(state) for _ in range(n_micro)]
    fwd_perm = [(j, j + 1) for j in range(n_stages - 1)]
    for t in range(n_steps):
        feed = xs[min(t, n_micro - 1)]
        inp = feed if stage == 0 else state
        out = stage_fn(local_params, inp)
        # last stage: record finished microbatch t-(n_stages-1)
        done_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and done_idx >= 0:
            outs[done_idx] = out
        state = ppermute(out, axis, fwd_perm)
    outs = torch.stack(outs)
    # outputs live only on the last stage; zero elsewhere then psum to
    # replicate them across the pipe axis
    if stage != n_stages - 1:
        outs = torch.zeros_like(outs)
    return psum(outs, axis)


def pipeline_spmd(stage_fn, stage_params, x, mesh, axis: str = "pipe",
                  n_microbatches: int = None):
    """Run ``n_stages`` homogeneous stages as a pipeline over ``axis``.

    ``stage_fn(params_i, act) -> act`` must preserve the activation shape.
    ``stage_params``: pytree whose leaves have leading dim n_stages (split
    over ``axis``). ``x``: [batch, ...] global input; split into
    ``n_microbatches`` along batch. Returns [batch, ...] outputs."""
    n_stages = mesh.shape[axis]
    if n_microbatches is None:
        n_microbatches = n_stages
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (batch, n_microbatches))
    xs = x.reshape((n_microbatches, batch // n_microbatches)
                   + tuple(x.shape[1:]))
    param_specs = _tree_map(lambda _: P(axis), stage_params)
    inner = functools.partial(_pipeline_inner, axis=axis, n_stages=n_stages,
                              n_micro=n_microbatches, stage_fn=stage_fn)
    fn = shard_map(inner, mesh=mesh, in_specs=(param_specs, P()),
                   out_specs=P())
    outs = fn(stage_params, xs)
    return outs.reshape((batch,) + tuple(x.shape[1:]))
