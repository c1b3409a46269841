"""Paged-KV attention ops — counterpart of ``mxnet_tpu/ops/paged.py``, the
ops behind ``mxnet_tpu_torch.generation`` (continuous batching over a
paged KV pool).  The JAX ops are jnp gathers, scatters and a masked
softmax that XLA fuses; here they are the same steps in plain torch.

* ``_contrib_DenseAttention`` — dense softmax attention over
  ``[b, s, h, d]`` (the prefill pass's attention), after the JAX
  package's ``parallel/ring.py::local_attention``, of which
  :func:`local_attention` is this package's own copy.
* ``_contrib_PagedAttention`` — one decode step over a paged KV pool:
  each lane writes its new K/V at ``positions[lane]`` through its page
  table, then attends its query against its own gathered history.
* ``_contrib_PagedAttentionWindow`` — the same for ``width`` known tokens
  per lane in one causal pass (prefix catch-up, speculative verify).

Page 0 of the pool is reserved as a scratch page: inactive lanes carry an
all-zero page-table row and position 0, so their writes land in the
scratch page and never touch a live sequence.

The paged ops are functional, as the JAX ops are: each returns new pool
tensors (a copy of the input pool with the new slots written) and leaves
its inputs unchanged.  The generation engine adopts the returned pools as
its planes, so a decode step copies each plane once on the device.  They
run inside a ``torch.profiler`` range named "paged attention".
"""
from __future__ import annotations

import numpy as np
import torch

from .param import Param
from .registry import register

_NEG = -1e30
#: the profiler range the paged ops run in
RANGE = "paged attention"


def local_attention(q, k, v, causal: bool = False, scale=None):
    """Dense softmax attention, [b, s, h, d] in and out, step for step the
    JAX package's ``local_attention``: scores in the inputs' dtype, then
    float32 times ``scale``; a causal mask of -1e30; softmax by max
    subtraction, exp and division; P in float32 times V, cast back to q's
    dtype."""
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
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


def _dense_infer(attrs, shapes):
    return shapes, [shapes[0]], []


@register("_contrib_DenseAttention",
          inputs=("query", "key", "value"),
          params={"causal": Param(bool, True),
                  "scale": Param("float-or-none", None)},
          infer_shape=_dense_infer, hint="denseattention")
def _dense_attention(opctx, attrs, query, key, value):
    scale = attrs.get("scale")
    return local_attention(query, key, value,
                           causal=bool(attrs.get("causal", True)),
                           scale=None if scale is None else float(scale))


def _paged_infer(attrs, shapes):
    q, k_new, v_new, k_pool, v_pool, page_table, positions = shapes
    if q is None or k_pool is None:
        return shapes, [None, None, None], []
    return shapes, [q, k_pool, v_pool], []


def _write(k_pool, v_pool, slot, k_new, v_new):
    """New pools: copies of ``k_pool``/``v_pool`` flattened to rows
    ``(num_pages * page_size, heads, head_dim)`` with rows ``slot`` set
    to the new K/V (where slots repeat, as the scratch page's do, one of
    the writes lands)."""
    num_pages, ps, heads, hd = k_pool.shape
    flat_k = k_pool.reshape(num_pages * ps, heads, hd).clone()
    flat_v = v_pool.reshape(num_pages * ps, heads, hd).clone()
    flat_k[slot] = k_new.to(flat_k.dtype)
    flat_v[slot] = v_new.to(flat_v.dtype)
    return flat_k, flat_v


def _history(flat_k, flat_v, pt, ps):
    """Each lane's ``max_pages * ps`` history rows, gathered in page-table
    order: token t of a lane lives at ``page_table[lane, t // ps]``,
    offset ``t % ps``."""
    lanes, max_pages = pt.shape
    ctx_idx = (pt[:, :, None] * ps
               + torch.arange(ps, device=pt.device)[None, None, :])
    ctx_idx = ctx_idx.reshape(lanes, max_pages * ps)
    return flat_k[ctx_idx], flat_v[ctx_idx]  # (lanes, T, heads, hd)


def _masked_softmax(s, valid):
    s = torch.where(valid, s, torch.full((), _NEG, device=s.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def _scale(attrs, hd):
    scale = attrs.get("scale")
    return (1.0 / np.sqrt(hd)) if scale is None else float(scale)


@register("_contrib_PagedAttentionWindow",
          inputs=("query", "key", "value", "k_pool", "v_pool",
                  "page_table", "positions"),
          params={"page_size": Param(int, required=True),
                  "scale": Param("float-or-none", None)},
          num_outputs=3, infer_shape=_paged_infer,
          no_grad_inputs=("page_table", "positions"),
          output_names=lambda attrs: ["out", "k_pool_out", "v_pool_out"],
          hint="pagedattentionwindow")
def _paged_attention_window(opctx, attrs, q, k_new, v_new, k_pool, v_pool,
                            page_table, positions):
    """``width`` known tokens per lane in one causal pass over paged KV.

    Shapes: q, k_new, v_new (lanes * width, heads, head_dim); k_pool,
    v_pool (num_pages, page_size, heads, head_dim); page_table (lanes,
    max_pages); positions (lanes, width), the absolute position of each
    window slot (pad slots point at the scratch page).  Page ids and
    positions are float carriers, cast to integers.  Returns (att_out
    (lanes * width, heads, head_dim), k_pool_out, v_pool_out)."""
    with torch.profiler.record_function(RANGE):
        ps = int(attrs["page_size"])
        lanes, width = positions.shape
        heads, hd = q.shape[-2], q.shape[-1]
        scale = _scale(attrs, hd)
        pt = page_table.to(torch.int64)
        pos = positions.to(torch.int64)  # (lanes, width)
        page_idx = torch.gather(pt, 1, pos // ps)  # (lanes, width)
        slot = (page_idx * ps + pos % ps).reshape(-1)
        flat_k, flat_v = _write(k_pool, v_pool, slot, k_new, v_new)
        keys, vals = _history(flat_k, flat_v, pt, ps)
        qw = q.reshape(lanes, width, heads, hd)
        s = torch.einsum("lwhd,lthd->lwht", qw, keys).to(torch.float32) \
            * scale
        valid = (torch.arange(keys.shape[1], device=q.device)[None, None, :]
                 <= pos[:, :, None])  # (lanes, width, T)
        p = _masked_softmax(s, valid[:, :, None, :])
        out = torch.einsum("lwht,lthd->lwhd", p,
                           vals.to(torch.float32)).to(q.dtype)
        return (out.reshape(lanes * width, heads, hd),
                flat_k.reshape(k_pool.shape), flat_v.reshape(v_pool.shape))


@register("_contrib_PagedAttention",
          inputs=("query", "key", "value", "k_pool", "v_pool",
                  "page_table", "positions"),
          params={"page_size": Param(int, required=True),
                  "scale": Param("float-or-none", None)},
          num_outputs=3, infer_shape=_paged_infer,
          no_grad_inputs=("page_table", "positions"),
          output_names=lambda attrs: ["out", "k_pool_out", "v_pool_out"],
          hint="pagedattention")
def _paged_attention(opctx, attrs, q, k_new, v_new, k_pool, v_pool,
                     page_table, positions):
    """One decode step for ``lanes`` sequences at once.

    Shapes: q, k_new, v_new (lanes, heads, head_dim), this step's
    projections; k_pool, v_pool (num_pages, page_size, heads, head_dim);
    page_table (lanes, max_pages), pool-page ids per lane in sequence
    order; positions (lanes,), this token's absolute position per lane.
    Page ids and positions are float carriers (the executor feeds every
    input in its bind dtype), cast to integers.  Returns (att_out,
    k_pool_out, v_pool_out)."""
    with torch.profiler.record_function(RANGE):
        ps = int(attrs["page_size"])
        lanes, heads, hd = q.shape
        scale = _scale(attrs, hd)
        pt = page_table.to(torch.int64)
        pos = positions.to(torch.int64)
        cur_page = torch.gather(pt, 1, (pos // ps)[:, None])[:, 0]
        slot = cur_page * ps + pos % ps  # inactive lanes hit page 0
        flat_k, flat_v = _write(k_pool, v_pool, slot, k_new, v_new)
        keys, vals = _history(flat_k, flat_v, pt, ps)
        s = torch.einsum("lhd,lthd->lht", q, keys).to(torch.float32) * scale
        valid = (torch.arange(keys.shape[1], device=q.device)[None, :]
                 <= pos[:, None])  # history up to and incl. this token
        p = _masked_softmax(s, valid[:, None, :])
        out = torch.einsum("lht,lthd->lhd", p,
                           vals.to(torch.float32)).to(q.dtype)
        return (out, flat_k.reshape(k_pool.shape),
                flat_v.reshape(v_pool.shape))
