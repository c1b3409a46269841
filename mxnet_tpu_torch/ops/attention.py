"""Fused attention — the flash-attention forward as a hand-written CUDA
kernel (``csrc/flash_fwd.cu``), counterpart of ``mxnet_tpu/ops/attention.py``
whose Pallas ``_fwd_kernel`` it replaces.

``flash_forward`` is the kernel's wrapper.  On a CUDA tensor it launches
the kernel or raises; it takes the plain version, ``attention_reference``,
only for tensors on the CPU (the tests) or on the meta device (shape
inference).  The op ``_contrib_FlashAttention`` keeps the JAX package's
params, so graph JSON is identical; its ``block_q``/``block_k`` attrs size
the TPU's tiles and are not read here — the card's kernel picks its own.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..base import MXNetError

__all__ = ["attention_reference", "flash_forward", "flash_attention"]

_NEG = -1e30
_LOG2E = 1.4426950408889634
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_BLOCK_Q = 64  # query rows per thread block (kBQ in flash_fwd.cu)


def attention_reference(q, k, v, causal: bool, scale: float):
    """Plain dense softmax attention in float32, after the JAX package's
    oracle ``parallel/ring.py::local_attention``.  q: [b, sq, h, d], k and
    v: [b, sk, h, d].  Returns (o in q's dtype, lse [b*h, sq] float32,
    natural log).  Causal masking is top-left aligned: query i sees keys
    j <= i."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), _NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / denom, v.to(torch.float32))
    lse = (m + torch.log(denom)).reshape(b * h, sq)
    return o.to(q.dtype), lse


def _kernel_fn():
    fn = kernels.library("flash_fwd").mxtt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _flash_forward_cuda(q, k, v, causal: bool, scale: float):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not (k.device == q.device and v.device == q.device):
        raise MXNetError("flash_forward: q, k, v on different devices")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError("flash_forward: the kernel takes float32 or "
                         "bfloat16 q, k, v of one dtype, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if d not in _KERNEL_HEAD_DIMS:
        raise MXNetError("flash_forward: head dim %d not supported by the "
                         "kernel (supported: %s)" % (d, _KERNEL_HEAD_DIMS))
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise MXNetError("flash_forward: q, k, v need unit stride in the "
                         "head dim")
    if (sq + _KERNEL_BLOCK_Q - 1) // _KERNEL_BLOCK_Q > 65535:
        raise MXNetError("flash_forward: sequence of %d query rows exceeds "
                         "the kernel's grid" % sq)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = torch.tensor(
        [q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
         k.stride(2), v.stride(0), v.stride(1), v.stride(2)],
        dtype=torch.int64)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq, sk,
                 strides.data_ptr(), float(scale) * _LOG2E, int(causal),
                 stream)
    if err != 0:
        raise MXNetError("flash_forward: kernel launch failed (cudaError %d)"
                         % err)
    kernels.count("flash_fwd")
    return o, lse


def flash_forward(q, k, v, causal: bool = False, scale=None):
    """Flash-attention forward: (o [b, sq, h, d], lse [b*h, sq] float32,
    natural log) for q [b, sq, h, d] and k, v [b, sk, h, d] — the
    counterpart of ``mxnet_tpu.ops.attention._flash_forward``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise MXNetError("flash_forward: expected q [b, sq, h, d] and k, v "
                         "[b, sk, h, d], got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if k.shape[1] == 0:
        raise MXNetError("flash_forward: no keys to attend to")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, causal, scale)
    if q.device.type in ("cpu", "meta"):
        return attention_reference(q, k, v, causal, scale)
    raise MXNetError("flash_forward: no kernel for device %s" % q.device)


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q=None, block_k=None):
    """Exact fused attention output, q, k, v: [b, seq, heads, d].  The
    block sizes are accepted for API parity and not read: the kernel sizes
    its own tiles for the card."""
    return flash_forward(q, k, v, causal=causal, scale=scale)[0]


# ---------------------------------------------------------------------------
# registry op — registered through register_kernel_op, as the JAX package
# registers it through register_pallas_op
# ---------------------------------------------------------------------------


def _attrs_config(attrs, q):
    scale = attrs.get("scale")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    return bool(attrs.get("causal", False)), float(scale)


def _fa_fn(attrs, query, key, value):
    causal, scale = _attrs_config(attrs, query)
    return flash_forward(query, key, value, causal, scale)[0]


def _fa_fwd(attrs, query, key, value):
    causal, scale = _attrs_config(attrs, query)
    o, lse = flash_forward(query, key, value, causal, scale)
    return o, (query, key, value, o, lse)


def _fa_bwd(attrs, res, ct):
    raise NotImplementedError(
        "_contrib_FlashAttention backward: the dQ and dK/dV kernels "
        "(mxnet_tpu/ops/attention.py _bwd_dq_kernel, _bwd_dkv_kernel) are "
        "not ported yet")


def _register():
    from .kernel_op import register_kernel_op
    from .param import Param

    register_kernel_op(
        "_contrib_FlashAttention", _fa_fn, bwd=_fa_bwd, fwd=_fa_fwd,
        inputs=("query", "key", "value"),
        params={"causal": Param(bool, False),
                "scale": Param("float-or-none", None),
                "block_q": Param("int-or-none", None),
                "block_k": Param("int-or-none", None)},
        infer_shape=lambda attrs, s: (s, [s[0]], []),
        hint="flashattention")


_register()
