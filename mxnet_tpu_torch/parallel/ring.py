"""Sequence-parallel attention over the mesh — counterpart of
``mxnet_tpu/parallel/ring.py``.  Three exact schemes:

* ``ring_attention`` — K/V blocks rotate around the mesh ring (``ppermute``)
  while each shard's Q block accumulates the softmax online, in plain
  PyTorch under ``shard_map``; autograd differentiates it.
* ``ring_flash_attention`` — the same ring with the flash kernels as the
  per-block compute, forward and backward, as one
  ``torch.autograd.Function`` that walks every shard in lockstep: K1
  (``flash_forward``) on each (query block, key block) pair the causal mask
  does not empty — the diagonal block causal, each past block full, a
  future block launches nothing — with the partials merged in float32 by
  logaddexp; backward, Δ computed once per shard from the final O and the
  global lse, then K2/K3 (``flash_bwd_dq``/``flash_bwd_dkv``) per block
  with that Δ and lse, dK and dV accumulated in float32 and riding the ring
  home with their block.  One call launches n(n+1)/2 of each kernel per
  ring under ``causal`` and n² without.  On CPU tensors the same schedule
  reaches the plain versions, as ``flash_forward`` does.
* ``ulysses_attention`` — ``all_to_all`` from sequence-sharded to
  head-sharded, dense local attention (or ``attn_fn``), and back.

Tensor convention: [batch, seq, heads, head_dim], sequence sharded on
``axis`` (default 'seq'), batch optionally on ``batch_axis``.  Inputs and
outputs are global tensors; each shard's piece lives on its context's
device, and blocks that arrive by ``ppermute`` may alias their source when
two shards share a device, so none is updated in place.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..ops import attention as _att
from ._compat import axis_index, ppermute, shard_map
from .mesh import PartitionSpec as P, _assemble, _local_piece

__all__ = ["local_attention", "ring_attention", "ring_flash_attention",
           "ulysses_attention"]

_NEG = -1e30


def local_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Dense single-device softmax attention — the oracle and the inner
    kernel for ulysses. [b, s, h, d] in/out."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s,
                        torch.full((), _NEG, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)).to(q.dtype)


def _ring_inner(q, k, v, *, axis, n_shards, causal, scale):
    idx = axis_index(axis)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    q_pos = idx * sq + torch.arange(sq, device=dev)
    perm = [(j, (j + 1) % n_shards) for j in range(n_shards)]
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for t in range(n_shards):
        # after t right-rotations this shard holds block (idx - t) mod n
        k_idx = (idx - t) % n_shards
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).to(torch.float32)
        s = s * scale
        if causal:
            k_pos = k_idx * sk + torch.arange(sk, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s,
                            torch.full((), _NEG, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)  # [b, h, q]
        l = l * corr + p.sum(-1)
        o = (o * corr.transpose(1, 2)[..., None] +
             torch.einsum("bhqk,bkhd->bqhd", p, v_blk.to(torch.float32)))
        m = m_new
        if t + 1 < n_shards:
            k_blk = ppermute(k_blk, axis, perm)
            v_blk = ppermute(v_blk, axis, perm)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis: str = "seq",
                   batch_axis: Optional[str] = None, causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention with the sequence dimension sharded over ``axis`` of
    ``mesh``; K/V ride the ring via ppermute.  q, k, v: [batch, seq, heads,
    head_dim] global tensors (batch optionally split on ``batch_axis``)."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    n_shards = mesh.shape[axis]
    spec = P(batch_axis, axis, None, None)
    inner = functools.partial(_ring_inner, axis=axis, n_shards=n_shards,
                              causal=causal, scale=scale)
    fn = shard_map(inner, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=spec)
    return fn(q, k, v)


def _merge_blocks(o_a, lse_a, o_b, lse_b):
    """Numerically-stable merge of two flash partial results.
    o: [b, sq, h, d] f32 (normalized), lse: [b*h, sq] f32."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    b, sq, h, d = o_a.shape

    def w(lse):
        return torch.exp(lse - lse_new).reshape(b, h, sq) \
            .transpose(1, 2)[..., None]

    return o_a * w(lse_a) + o_b * w(lse_b), lse_new


def _block_schedule(n, causal):
    """The ring's blocks in launch order: (step t, shard i, key block j,
    diagonal).  Under ``causal`` a block after the shard's own (j > i) is
    left out: it launches nothing."""
    return [(t, i, (i - t) % n, (i - t) % n == i)
            for t in range(n) for i in range(n)
            if not (causal and (i - t) % n > i)]


def _rotate(blocks, devices):
    """``ppermute`` to the right neighbour: shard i receives shard i-1's
    block, on its own device (the same tensor when both share one)."""
    n = len(blocks)
    return [blocks[(i - 1) % n].to(devices[i]) for i in range(n)]


def _bwd_block(q, k, v, do, lse, delta, causal, scale):
    """(dq, dk, dv) of one block: K2 and K3 on CUDA tensors, their plain
    version on the CPU."""
    if q.device.type == "cuda":
        dq = _att.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = _att.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    if q.device.type in ("cpu", "meta"):
        return _att.attention_bwd_reference(q, k, v, do, lse, delta, causal,
                                            scale)
    raise MXNetError("ring_flash_attention: no kernel for device %s"
                     % q.device)


class _RingLayout:
    """The rings of one call: for each coordinate of ``batch_axis`` (one
    ring without it) the mesh coordinates along ``axis``, every other axis
    at coordinate 0 (its replicas compute the same)."""

    def __init__(self, mesh, axis, batch_axis):
        if axis not in mesh.shape or (batch_axis is not None and
                                      batch_axis not in mesh.shape):
            raise MXNetError("ring_flash_attention: axes %r/%r not in mesh "
                             "%s" % (axis, batch_axis, mesh.axis_names))
        self.mesh = mesh
        self.spec = P(batch_axis, axis, None, None)
        self.n = mesh.shape[axis]
        groups = mesh.shape[batch_axis] if batch_axis else 1
        self.rings = []
        for g in range(groups):
            ring = []
            for i in range(self.n):
                c = dict.fromkeys(mesh.axis_names, 0)
                c[axis] = i
                if batch_axis:
                    c[batch_axis] = g
                ring.append(tuple(c[a] for a in mesh.axis_names))
            self.rings.append(ring)

    def pieces(self, x):
        return [[_local_piece(x, self.spec, self.mesh, c) for c in ring]
                for ring in self.rings]

    def devices(self, ring):
        return [self.mesh.torch_device(c) for c in ring]

    def assemble(self, per_ring):
        return _assemble({c: t for ring, ts in zip(self.rings, per_ring)
                          for c, t in zip(ring, ts)}, self.spec, self.mesh)


def _ring_flash_fwd(layout, q, k, v, causal, scale):
    """Per ring: the normalized outputs (q's dtype) and global lse of each
    shard."""
    outs, lses = [], []
    for ring, qs, ks, vs in zip(layout.rings, layout.pieces(q),
                                layout.pieces(k), layout.pieces(v)):
        devs = layout.devices(ring)
        n = layout.n
        o, lse = [None] * n, [None] * n
        step = 0
        for t, i, _, diag in _block_schedule(n, causal):
            while step < t:
                ks, vs = _rotate(ks, devs), _rotate(vs, devs)
                step += 1
            o_b, lse_b = _att.flash_forward(qs[i], ks[i], vs[i],
                                            causal and diag, scale)
            if o[i] is None:  # the diagonal block comes first, t = 0
                o[i], lse[i] = o_b.to(torch.float32), lse_b
            else:
                o[i], lse[i] = _merge_blocks(o[i], lse[i],
                                             o_b.to(torch.float32), lse_b)
        outs.append([x.to(q.dtype) for x in o])
        lses.append(lse)
    return outs, lses


def _ring_flash_bwd(layout, q, k, v, outs, lses, do, causal, scale):
    dqs, dks, dvs = [], [], []
    for ring, qs, ks, vs, os_, ls, dos in zip(
            layout.rings, layout.pieces(q), layout.pieces(k),
            layout.pieces(v), outs, lses, layout.pieces(do)):
        devs = layout.devices(ring)
        n = layout.n
        # Δ and the lse do not change across ring steps: once per shard
        deltas = [_att._row_delta(o_, do_).contiguous()
                  for o_, do_ in zip(os_, dos)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qs]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in ks]
        dv = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in vs]
        step = 0
        for t, i, _, diag in _block_schedule(n, causal):
            while step < t:
                # dk/dv travel WITH their k/v block: after the full cycle
                # each block's gradient is home with every shard's share
                ks, vs = _rotate(ks, devs), _rotate(vs, devs)
                dk, dv = _rotate(dk, devs), _rotate(dv, devs)
                step += 1
            dq_c, dk_c, dv_c = _bwd_block(qs[i], ks[i], vs[i], dos[i], ls[i],
                                          deltas[i], causal and diag, scale)
            dq[i] = dq[i] + dq_c.to(torch.float32)
            dk[i] = dk[i] + dk_c.to(torch.float32)
            dv[i] = dv[i] + dv_c.to(torch.float32)
        while step < n:
            dk, dv = _rotate(dk, devs), _rotate(dv, devs)
            step += 1
        dqs.append([x.to(q.dtype) for x in dq])
        dks.append([x.to(k.dtype) for x in dk])
        dvs.append([x.to(v.dtype) for x in dv])
    return (layout.assemble(dqs).to(q.device),
            layout.assemble(dks).to(k.device),
            layout.assemble(dvs).to(v.device))


class _RingFlash(torch.autograd.Function):
    """The ring's forward and its ring-level backward as one Function."""

    @staticmethod
    def forward(ctx, q, k, v, layout, causal, scale):
        outs, lses = _ring_flash_fwd(layout, q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v)
        ctx.layout, ctx.causal, ctx.scale = layout, causal, scale
        ctx.outs, ctx.lses = outs, lses
        return layout.assemble(outs)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        grads = _ring_flash_bwd(ctx.layout, q, k, v, ctx.outs, ctx.lses,
                                do.contiguous(), ctx.causal, ctx.scale)
        ctx.outs = ctx.lses = None
        return grads + (None, None, None)


def ring_flash_attention(q, k, v, mesh, axis: str = "seq",
                         batch_axis: Optional[str] = None,
                         causal: bool = False, scale: Optional[float] = None,
                         block_q: int = 512, block_k: int = 512):
    """Ring attention whose per-block compute is the flash kernels (K1
    forward, K2/K3 backward): sequence sharded over ``axis``, K/V (and their
    gradients, on the backward ring) rotating shard to shard, per-block
    partials merged by logsumexp.  Exact.  ``block_q``/``block_k`` size the
    TPU's tiles and are not read: the kernels pick their own."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    layout = _RingLayout(mesh, axis, batch_axis)
    return _RingFlash.apply(q, k, v, layout, bool(causal), float(scale))


def _ulysses_inner(q, k, v, *, axis, n_shards, causal, scale, attn_fn):
    from ._compat import all_to_all

    # [b, s/n, h, d] -> [b, s, h/n, d]: gather sequence, scatter heads
    def fwd(x):
        return all_to_all(x, axis, split_axis=2, concat_axis=1, tiled=True)

    def bwd(x):
        return all_to_all(x, axis, split_axis=1, concat_axis=2, tiled=True)

    out = attn_fn(fwd(q), fwd(k), fwd(v), causal=causal, scale=scale)
    return bwd(out)


def ulysses_attention(q, k, v, mesh, axis: str = "seq",
                      batch_axis: Optional[str] = None, causal: bool = False,
                      scale: Optional[float] = None, attn_fn=None):
    """All-to-all sequence parallelism: heads are sharded during attention,
    sequence is sharded elsewhere. Requires heads % mesh.shape[axis] == 0."""
    n_shards = mesh.shape[axis]
    if q.shape[2] % n_shards:
        raise ValueError(
            "ulysses needs heads (%d) divisible by mesh axis %r size %d"
            % (q.shape[2], axis, n_shards))
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    if attn_fn is None:
        attn_fn = local_attention
    spec = P(batch_axis, axis, None, None)
    inner = functools.partial(_ulysses_inner, axis=axis, n_shards=n_shards,
                              causal=causal, scale=scale, attn_fn=attn_fn)
    fn = shard_map(inner, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=spec)
    return fn(q, k, v)
