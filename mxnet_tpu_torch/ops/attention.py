"""Fused attention — the flash-attention forward and backward as
hand-written CUDA kernels, counterpart of ``mxnet_tpu/ops/attention.py``:
``csrc/flash_fwd.cu`` replaces its Pallas ``_fwd_kernel``,
``csrc/flash_bwd.cu`` its ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``.
Each dtype has its own kernels: bfloat16 runs ``flash_fwd_tc_kernel``,
``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkv_tc_kernel`` on the tensor
cores (``wgmma`` fed by TMA, 128 rows per block), so its q, k, v and dO
must pass ``_check_tma_view``; float32 (``Module``'s default and serving)
runs ``flash_fwd_kernel`` on the CUDA cores (64 rows per block) and
``flash_bwd_dq_tf32_kernel`` and ``flash_bwd_dkv_tf32_kernel`` on the
tensor cores (split TF32: ``wgmma``, or ``mma.sync`` at width 256; fed by
``cp.async``, so any view with unit stride in d; 128 rows per block, 64 at
width 256).

``flash_forward`` and ``flash_backward`` are the kernels' wrappers.  On a
CUDA tensor they launch the kernels or raise; they take the plain versions,
``attention_reference`` and ``attention_backward_reference``, only for
tensors on the CPU (the tests) or on the meta device (shape inference).
The kernels take head dims 32, 64, 96, 128 and 256 (``kernel_width``); 32
and 96 run zero-padded at the widths 64 and 128.
The op ``_contrib_FlashAttention`` keeps the JAX package's params, so graph
JSON is identical; its ``block_q``/``block_k`` attrs size the TPU's tiles
and are not read here — the card's kernels pick their own.  Its gradient
is ``flash_backward``.

``splash_attention`` and the op ``_contrib_SplashAttention`` are the
counterparts of the JAX package's wrapper around upstream JAX's splash
kernel: q pre-scaled in its own dtype, then the same kernels at scale 1,
with the forward's split-P variant (``flash_fwd_splitp``: P kept at float32
precision for P·V, as splash keeps it) in bf16.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..base import MXNetError

__all__ = ["attention_reference", "attention_backward_reference",
           "flash_forward", "flash_backward", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_attention", "kernel_width", "splash_attention"]

_NEG = -1e30
_LOG2E = 1.4426950408889634
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dim -> the width the kernels are instantiated at and run it at (the
#: C entries take it as ``width``): columns past d are zeros in shared memory
_KERNEL_WIDTHS = {32: 64, 64: 64, 96: 128, 128: 128, 256: 256}
#: query rows per block of the forward kernel each dtype runs (flash_fwd.cu:
#: kBQ of the CUDA-core kernel, kRes of the tensor-core one)
_FWD_BLOCK_Q = {torch.float32: 64, torch.bfloat16: 128}
#: the fewest rows per block of the backward kernels of each dtype
#: (flash_bwd.cu: kRes of the tensor-core kernels; F32Tile<256>::kRes)
_BWD_BLOCK_ROWS = {torch.float32: 64, torch.bfloat16: 128}


def _causal_mask(sq, sk, device):
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


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
        s = torch.where(_causal_mask(sq, sk, q.device), s,
                        torch.full((), _NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / denom, v.to(torch.float32))
    lse = (m + torch.log(denom)).reshape(b * h, sq)
    return o.to(q.dtype), lse


def _row_delta(o, do):
    """Δ = rowsum(dO ∘ O) in float32, [b*h, sq] — ``_flash_bwd_precompute``
    of the JAX package."""
    b, sq, h, _ = o.shape
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    return delta.transpose(1, 2).reshape(b * h, sq)


def attention_backward_reference(q, k, v, o, lse, do, causal: bool,
                                 scale: float):
    """Plain attention backward in float32: P recomputed from the natural-
    log ``lse`` [b*h, sq], then the five products written out densely
    (S = QKᵀ, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q).  Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    qf, kf, vf, dof = (t.to(torch.float32) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if causal:
        p = torch.where(_causal_mask(sq, sk, q.device), p,
                        torch.zeros((), device=q.device))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = _row_delta(o, do).reshape(b, h, sq, 1)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_width(d: int, what: str = "attention") -> int:
    """The instantiated width the kernels run head dim ``d`` at; raises for
    a head dim they do not take."""
    width = _KERNEL_WIDTHS.get(int(d))
    if width is None:
        raise MXNetError("%s: head dim %d not supported by the kernel "
                         "(supported: %s)" % (what, d,
                                              tuple(sorted(_KERNEL_WIDTHS))))
    return width


def _check_kernel_inputs(what, tensors):
    """The kernels' contract: one device, one dtype of float32 or bfloat16,
    a head dim ``kernel_width`` takes, unit stride in the head dim."""
    first = tensors[0]
    if any(t.device != first.device for t in tensors):
        raise MXNetError("%s: inputs on different devices" % what)
    if first.dtype not in _KERNEL_DTYPES or \
            any(t.dtype != first.dtype for t in tensors):
        raise MXNetError("%s: the kernel takes float32 or bfloat16 inputs of "
                         "one dtype, got %s" % (what, [t.dtype for t in tensors]))
    kernel_width(first.shape[-1], what)
    if any(t.stride(-1) != 1 for t in tensors):
        raise MXNetError("%s: inputs need unit stride in the head dim" % what)


def _view_strides(t):
    """(b, s, h) strides of a [b, s, h, d] view, in elements.  A dim of
    size 1 is never stepped along; it gets the stride of a packed tensor,
    whatever the view says."""
    b, s, h, d = t.shape
    packed = (s * h * d, h * d, d)
    return [t.stride(i) if t.shape[i] > 1 else packed[i] for i in range(3)]


def _strides(*tensors):
    """(b, s, h) strides of each tensor, in elements, as a host int64
    array the kernels read."""
    return torch.tensor([x for t in tensors for x in _view_strides(t)],
                        dtype=torch.int64)


def _check_tma_view(what, name, t):
    """The bf16 kernels load ``t`` [b, s, h, d] with TMA, which
    needs unit stride in d, a 16-byte aligned base and (b, s, h) strides in
    whole 16-byte units.  Raise on a view that breaks that rule: nothing
    copies it, and no other kernel stands in for it."""
    size = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or \
            any(st * size % 16 for st in _view_strides(t)):
        raise MXNetError(
            "%s: %s (strides %s, base address %% 16 = %d) breaks the TMA "
            "rule of the tensor-core kernel: unit stride in d, a 16-byte "
            "aligned base and (b, s, h) strides that are multiples of 16 "
            "bytes" % (what, name, tuple(t.stride()), t.data_ptr() % 16))


def _kernel_fn():
    fn = kernels.library("flash_fwd").mxtt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_forward_launch(q, k, v):
    """What the forward kernel of q's dtype takes, checked before any
    launch: the inputs' contract, one grid row per block of query rows,
    and for bf16 the TMA rule on q, k and v."""
    _check_kernel_inputs("flash_forward", (q, k, v))
    sq = q.shape[1]
    if -(-sq // _FWD_BLOCK_Q[q.dtype]) > 65535:
        raise MXNetError("flash_forward: sequence of %d query rows exceeds "
                         "the kernel's grid" % sq)
    if q.dtype == torch.bfloat16:
        for t, name in zip((q, k, v), "qkv"):
            _check_tma_view("flash_forward", name, t)


def _flash_forward_cuda(q, k, v, causal: bool, scale: float,
                        split_p: bool = False):
    """K1 on the card; ``split_p`` (bf16) launches the variant that keeps P
    at float32 precision for P·V, counted as ``flash_fwd_splitp``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_forward_launch(q, k, v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = _strides(q, k, v)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KERNEL_DTYPES[q.dtype], d, kernel_width(d), q.data_ptr(),
                 k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq, sk,
                 strides.data_ptr(), float(scale) * _LOG2E, int(causal),
                 int(split_p), stream)
    if err != 0:
        raise MXNetError("flash_forward: kernel launch failed (cudaError %d)"
                         % err)
    kernels.count("flash_fwd_splitp" if split_p and q.dtype == torch.bfloat16
                  else "flash_fwd")
    return o, lse


def flash_forward(q, k, v, causal: bool = False, scale=None,
                  split_p: bool = False):
    """Flash-attention forward: (o [b, sq, h, d], lse [b*h, sq] float32,
    natural log) for q [b, sq, h, d] and k, v [b, sk, h, d] — the
    counterpart of ``mxnet_tpu.ops.attention._flash_forward``.  With
    ``split_p`` a bf16 forward keeps P at float32 precision for P·V (the
    plain version keeps it in float32 in any case)."""
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
        return _flash_forward_cuda(q, k, v, causal, scale, split_p)
    if q.device.type in ("cpu", "meta"):
        return attention_reference(q, k, v, causal, scale)
    raise MXNetError("flash_forward: no kernel for device %s" % q.device)


def _bwd_fn(name):
    """The C entry of K2 or K3.  K3's takes one more argument, where it
    writes how many kernels it launched (two at width 256)."""
    fn = getattr(kernels.library(name), "mxtt_" + name)
    if fn.argtypes is None:
        dkv = name == "flash_bwd_dkv"
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * (7 + dkv)
                       + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p]
                       + [ctypes.POINTER(ctypes.c_int)] * dkv)
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(name, q, k, v, do, lse, delta, outs, causal, scale):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs(name, (q, k, v, do))
    if q.dtype == torch.bfloat16:
        for t, what in zip((q, k, v, do), ("q", "k", "v", "do")):
            _check_tma_view(name, what, t)
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (b * h, sq) or not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous float32 [b*h, sq] = "
                             "%s on %s, got %s %s on %s" % (
                                 name, what, (b * h, sq), q.device, t.dtype,
                                 tuple(t.shape), t.device))
    if -(-max(sq, sk) // _BWD_BLOCK_ROWS[q.dtype]) > 65535:
        raise MXNetError("%s: sequence of %d rows exceeds the kernel's grid"
                         % (name, max(sq, sk)))
    if outs[0].numel() == 0:
        return
    strides = _strides(q, k, v, do)  # held: the kernel reads it on the host
    launched = ctypes.c_int(1)
    extra = (ctypes.byref(launched),) if name == "flash_bwd_dkv" else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_fn(name)(
            _KERNEL_DTYPES[q.dtype], d, kernel_width(d), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), b, h, sq, sk,
            strides.data_ptr(), float(scale), int(causal), stream, *extra)
    if err != 0:
        raise MXNetError("%s: kernel launch failed (cudaError %d)"
                         % (name, err))
    kernels.count(name, launched.value)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ [b, sq, h, d] from the K2 kernel (CUDA tensors only; the tensor
    cores in either dtype); ``delta`` is Δ = rowsum(dO ∘ O), float32
    [b*h, sq]."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal,
                scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dK, dV) [b, sk, h, d] from the K3 kernel (CUDA tensors only).  At
    width 256 one call is two launches, dV then dK, and counts two."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal,
                scale)
    return dk, dv


def flash_backward(q, k, v, o, lse, do, causal: bool = False, scale=None):
    """Flash-attention backward: (dq, dk, dv) for the forward's q, k, v
    [b, s, h, d], its output o, its lse [b*h, sq] and the output cotangent
    do — the counterpart of ``mxnet_tpu.ops.attention._flash_backward``.
    q, k, v and do are read through their strides (the views
    ``SliceChannel`` hands out); the gradients come back contiguous."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            o.shape != q.shape or do.shape != q.shape or \
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise MXNetError("flash_backward: expected q, o, do [b, sq, h, d] and "
                         "k, v [b, sk, h, d], got %s %s %s %s %s" % tuple(
                             tuple(t.shape) for t in (q, k, v, o, do)))
    if k.shape[1] == 0:
        raise MXNetError("flash_backward: no keys to attend to")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        if o.device != q.device:
            raise MXNetError("flash_backward: o on %s, q on %s"
                             % (o.device, q.device))
        delta = _row_delta(o, do).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv
    if q.device.type in ("cpu", "meta"):
        return attention_backward_reference(q, k, v, o, lse, do, causal,
                                            scale)
    raise MXNetError("flash_backward: no kernel for device %s" % q.device)


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q=None, block_k=None):
    """Exact fused attention output, q, k, v: [b, seq, heads, d].  The
    block sizes are accepted for API parity and not read: the kernel sizes
    its own tiles for the card."""
    return flash_forward(q, k, v, causal=causal, scale=scale)[0]


class _SplashCore(torch.autograd.Function):
    """softmax(q·kᵀ)·v at scale 1 for an already scaled q: K1's split-P
    variant forward, K2 and K3 at scale 1 backward (splash's own vjp rounds
    P and dS to the operand dtype where K2 and K3 do).  Δ is recomputed
    from o and dO by ``flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_forward(q, k, v, causal, 1.0, split_p=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_backward(q, k, v, o, lse, do, ctx.causal, 1.0) + (None,)


def splash_attention(q, k, v, causal: bool = True, scale=None):
    """Counterpart of ``mxnet_tpu.ops.attention.splash_attention`` (upstream
    JAX's splash kernel behind the [b, seq, heads, d] layout): q [b, s, h,
    d] is multiplied by ``scale`` in its own dtype (bf16 q is rounded after
    scaling, and dq is scaled in that dtype, as JAX's vjp scales it), then
    attention at scale 1 runs on the kernels, causal or full.  The sequence
    must be a multiple of 128, as splash requires."""
    s, d = q.shape[1], q.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    if s % 128:
        raise ValueError(
            "splash_attention requires seq_len to be a multiple of 128 "
            "(got %d); use the flash implementation instead" % s)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    return _SplashCore.apply(qs, k, v, bool(causal))


# ---------------------------------------------------------------------------
# registry ops — FlashAttention through register_kernel_op, as the JAX
# package registers it through register_pallas_op; SplashAttention as a
# plain op whose gradient is its autograd Function, as the JAX package's
# differentiates through splash's custom vjp
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
    q, k, v, o, lse = res
    causal, scale = _attrs_config(attrs, q)
    return flash_backward(q, k, v, o, lse, ct, causal, scale)


def _register():
    from .kernel_op import register_kernel_op
    from .param import Param
    from .registry import register

    register_kernel_op(
        "_contrib_FlashAttention", _fa_fn, bwd=_fa_bwd, fwd=_fa_fwd,
        inputs=("query", "key", "value"),
        params={"causal": Param(bool, False),
                "scale": Param("float-or-none", None),
                "block_q": Param("int-or-none", None),
                "block_k": Param("int-or-none", None)},
        infer_shape=lambda attrs, s: (s, [s[0]], []),
        hint="flashattention")

    @register("_contrib_SplashAttention",
              inputs=("query", "key", "value"),
              params={"causal": Param(bool, True),
                      "scale": Param("float-or-none", None)},
              infer_shape=lambda attrs, shapes: (shapes, [shapes[0]], []),
              hint="splashattention")
    def _splash_op(opctx, attrs, query, key, value):
        return splash_attention(query, key, value,
                                causal=bool(attrs.get("causal", True)),
                                scale=attrs.get("scale"))


_register()
