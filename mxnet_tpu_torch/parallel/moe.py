"""Expert parallelism — a mixture-of-experts FFN with the expert dimension
split over a mesh axis; counterpart of ``mxnet_tpu/parallel/moe.py``.

Exact einsum dispatch (no capacity dropping): every token's top-k expert
outputs are combined with renormalized gate weights.  Each shard holds E/n
expert FFNs and computes them for the whole token stream; the weighted
combine is a ``psum`` over the expert axis.
"""
from __future__ import annotations

import functools

from ._compat import axis_index, psum, shard_map
from .mesh import PartitionSpec as P

__all__ = ["moe_ffn", "moe_ffn_reference"]


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    import torch.nn.functional as F

    return F.gelu(x, approximate="tanh")


def _gate_combine(x, gate_w, top_k):
    """combine[b, s, E]: renormalized top-k gate weight of each expert for
    each token — the single routing implementation shared by the sharded
    path and the dense oracle."""
    import torch

    logits = torch.einsum("bsd,de->bse", x, gate_w)
    weights, assign = torch.topk(torch.softmax(logits, dim=-1), top_k,
                                 dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    one_hot = torch.nn.functional.one_hot(assign, gate_w.shape[-1]) \
        .to(x.dtype)
    return (one_hot * weights[..., None]).sum(2)


def moe_ffn_reference(x, gate_w, w1, w2, top_k=1, act=None):
    """Dense single-device oracle. x: [b, s, d]; gate_w: [d, E];
    w1: [E, d, h]; w2: [E, h, d]."""
    import torch

    act = act or _gelu
    combine = _gate_combine(x, gate_w, top_k)
    hidden = act(torch.einsum("bsd,edh->besh", x, w1))
    out = torch.einsum("besh,ehd->besd", hidden, w2)
    return torch.einsum("bse,besd->bsd", combine, out)


def _moe_inner(x, gate_w, w1, w2, *, axis, top_k, act):
    import torch

    e_local = w1.shape[0]
    idx = axis_index(axis)
    # routing is computed from the replicated gate everywhere
    combine = _gate_combine(x, gate_w, top_k)             # [b, s, E]
    local = combine[..., idx * e_local:(idx + 1) * e_local]  # [b, s, E/n]
    hidden = act(torch.einsum("bsd,edh->besh", x, w1))
    out = torch.einsum("besh,ehd->besd", hidden, w2)
    partial = torch.einsum("bse,besd->bsd", local, out)
    return psum(partial, axis)


def moe_ffn(x, gate_w, w1, w2, mesh, axis: str = "expert", top_k: int = 1,
            act=None):
    """Expert-parallel MoE FFN. ``w1``/``w2`` are split on their expert
    dimension over ``axis`` of ``mesh``; ``x``/``gate_w`` replicated.
    Exact — matches ``moe_ffn_reference`` to float tolerance."""
    act = act or _gelu
    n = mesh.shape[axis]
    if gate_w.shape[-1] != w1.shape[0]:
        raise ValueError(
            "gate has %d experts but w1 has %d"
            % (gate_w.shape[-1], w1.shape[0]))
    if w1.shape[0] % n:
        raise ValueError(
            "experts (%d) must be divisible by mesh axis %r size %d"
            % (w1.shape[0], axis, n))
    inner = functools.partial(_moe_inner, axis=axis, top_k=top_k, act=act)
    fn = shard_map(inner, mesh=mesh,
                   in_specs=(P(), P(), P(axis), P(axis)), out_specs=P())
    return fn(x, gate_w, w1, w2)
