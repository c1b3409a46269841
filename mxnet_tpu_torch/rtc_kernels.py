"""User kernels of the extension path, pushed through ``rtc.MXRtc``: CUDA C
bodies compiled at run time for the card, each beside the same function as
Python source (``MXRtc``'s CPU route) and as plain torch (what the card's
result is held against).  They replace no kernel of the JAX package; they
are what its ``mx.rtc`` (``mxnet_tpu/rtc.py``) and ``register_pallas_op``
(``mxnet_tpu/ops/pallas_op.py``) exist to run.  Each is a simple
elementwise pass, bound by the bytes it moves.

- ``axpy``: out = 2·x + y in float32, a 2-D launch with explicit
  ``grid_dims``/``block_dims`` (``axpy_dims``).  NVRTC contracts 2·x + y to
  one FMA, which rounds as 2·x (exact) then + y does: the same bits.
- ``sgd_update``: w -= lr·(rescale·g + wd·w) in float32, in place
  (``push([w, g, hp], [w])``, ``hp`` = [lr, rescale, wd] on the device).
  The body rounds every product and sum on its own, in the order of the
  port's ``sgd_update`` (``ops/optimizer_ops.py``), so the two agree bit for
  bit; plain ``*`` and ``+`` would let NVRTC contract them into FMAs.
- ``gelu_fwd``/``gelu_bwd``: the exact erf GELU, 0.5·x·(1 + erf(x/√2)) as
  ``jax.nn.gelu(approximate=False)``, and its derivative
  Φ(x) + x·φ(x), float32 or bfloat16 in and out, arithmetic in float32.
  ``gelu_fwd`` reads and writes 16-byte vectors in a grid-stride loop over
  the blocks that ``gelu_dims`` names; a scalar loop in the same launch
  takes the tail and any view not 16-byte aligned.
  ``register_rtc_gelu`` makes them the op ``rtc_gelu`` through
  ``register_kernel_op``, with ``gelu_bwd`` as its gradient, and
  ``with_rtc_gelu`` swaps ``gelu`` nodes of a symbol for it.

The wrappers take tensors on the card or the CPU and pick the route by the
tensor's device; a kernel object per (kernel, shape, dtype, device) is
cached, as MXRtc's prototypes fix shapes.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from .base import MXNetError
from .rtc import MXRtc

__all__ = ["AXPY_CUDA", "AXPY_PYTHON", "SGD_CUDA", "SGD_PYTHON",
           "GELU_FWD_CUDA", "GELU_FWD_PYTHON", "GELU_BWD_CUDA",
           "GELU_BWD_PYTHON", "axpy", "axpy_dims", "axpy_plain", "gelu_dims",
           "sgd_hyper", "sgd_update", "gelu_forward", "gelu_backward",
           "gelu_plain", "gelu_grad_plain", "register_rtc_gelu",
           "with_rtc_gelu"]

AXPY_CUDA = r"""
const int r = blockIdx.y * blockDim.y + threadIdx.y;
const int c = blockIdx.x * blockDim.x + threadIdx.x;
if (r < out_dims[0] && c < out_dims[1]) {
  const long long i = (long long)r * out_dims[1] + c;
  out[i] = 2.0f * x[i] + y[i];
}
"""

#: the JAX package's own axpy source (``mxnet_tpu/rtc.py:11-14``)
AXPY_PYTHON = """
def kernel(x_ref, y_ref, out_ref):
    out_ref[...] = 2.0 * x_ref[...] + y_ref[...]
"""

SGD_CUDA = r"""
const float lr = hp[0], rescale = hp[1], wd = hp[2];
for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
     i < w_size; i += (long long)gridDim.x * blockDim.x) {
  float t = __fmul_rn(g[i], rescale);
  if (wd != 0.0f) t = __fadd_rn(t, __fmul_rn(wd, w[i]));
  w_out[i] = __fsub_rn(w[i], __fmul_rn(lr, t));
}
"""

SGD_PYTHON = """
def sgd_update(w_ref, g_ref, hp_ref, w_out_ref):
    lr, rescale, wd = (float(v) for v in hp_ref[...])
    t = g_ref[...] * rescale
    if wd:
        t = t + wd * w_ref[...]
    w_out_ref[...] = w_ref[...] - lr * t
"""

GELU_FWD_CUDA = r"""
// grid-stride over 16-byte vectors (8 bf16 or 4 float) while x and y are
// both 16-byte aligned; the scalar loop takes the tail, or every element
// when either is not
constexpr int W = 16 / sizeof(x[0]);
const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
const long long stride = (long long)gridDim.x * blockDim.x;
const bool aligned = ((reinterpret_cast<unsigned long long>(x) |
                       reinterpret_cast<unsigned long long>(y)) & 15) == 0;
const long long n_vec = aligned ? y_size / W : 0;
for (long long i = first; i < n_vec; i += stride) {
  const uint4 in = reinterpret_cast<const uint4*>(x)[i];
  uint4 out;
  const auto* xs = reinterpret_cast<decltype(&x[0])>(&in);
  auto* ys = reinterpret_cast<decltype(&y[0])>(&out);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float v = static_cast<float>(xs[e]);
    ys[e] = v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
  }
  reinterpret_cast<uint4*>(y)[i] = out;
}
for (long long i = n_vec * W + first; i < y_size; i += stride) {
  const float v = static_cast<float>(x[i]);
  y[i] = v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}
"""

GELU_FWD_PYTHON = """
def gelu_fwd(x_ref, y_ref):
    import torch
    v = x_ref[...].float()
    y_ref[...] = v * 0.5 * (1.0 + torch.erf(v * 0.7071067811865476))
"""

GELU_BWD_CUDA = r"""
for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
     i < dx_size; i += (long long)gridDim.x * blockDim.x) {
  const float v = static_cast<float>(x[i]);
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
  const float pdf = expf(-0.5f * v * v) * 0.39894228040143267794f;
  dx[i] = static_cast<float>(dy[i]) * (cdf + v * pdf);
}
"""

GELU_BWD_PYTHON = """
def gelu_bwd(x_ref, dy_ref, dx_ref):
    import torch
    v = x_ref[...].float()
    cdf = 0.5 * (1.0 + torch.erf(v * 0.7071067811865476))
    pdf = torch.exp(-0.5 * v * v) * 0.3989422804014327
    dx_ref[...] = dy_ref[...].float() * (cdf + v * pdf)
"""

_SOURCES = {"axpy": (AXPY_CUDA, AXPY_PYTHON, ("x", "y"), ("out",)),
            "sgd_update": (SGD_CUDA, SGD_PYTHON, ("w", "g", "hp"),
                           ("w_out",)),
            "gelu_fwd": (GELU_FWD_CUDA, GELU_FWD_PYTHON, ("x",), ("y",)),
            "gelu_bwd": (GELU_BWD_CUDA, GELU_BWD_PYTHON, ("x", "dy"),
                         ("dx",))}
_CACHE: Dict[tuple, MXRtc] = {}
_LOCK = threading.Lock()


def _nd(t: torch.Tensor):
    from .ndarray import NDArray, _context_of

    return NDArray(t, _context_of(t.device))


def _push(name, ins, outs, grid_dims=None, block_dims=None):
    """Push user kernel ``name`` on tensors: the CUDA body on the card, the
    Python source on the CPU."""
    device = outs[0].device
    if device.type not in ("cuda", "cpu"):
        raise MXNetError("rtc kernel %s: no route for device %s"
                         % (name, device))
    key = (name, device, tuple((tuple(t.shape), t.dtype) for t in ins + outs))
    with _LOCK:
        krnl = _CACHE.get(key)
        if krnl is None:
            cuda, python, in_names, out_names = _SOURCES[name]
            krnl = _CACHE[key] = MXRtc(
                name, list(zip(in_names, map(_nd, ins))),
                list(zip(out_names, map(_nd, outs))),
                cuda if device.type == "cuda" else python)
    krnl.push([_nd(t) for t in ins], [_nd(t) for t in outs], grid_dims,
              block_dims)
    return outs


# -- axpy --------------------------------------------------------------------

def axpy_dims(shape):
    """(grid, block) of the 2-D axpy launch: 32 x 8 threads a block."""
    rows, cols = shape
    return (-(-cols // 32), -(-rows // 8), 1), (32, 8, 1)


def axpy(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = 2·x + y for 2-D float32 tensors, written into ``out``."""
    grid, block = axpy_dims(out.shape)
    _push("axpy", [x, y], [out], grid, block)
    return out


def axpy_plain(x, y):
    return 2.0 * x + y


#: blocks of 256 threads per SM in the gelu_fwd launch: several rounds of
#: the blocks an SM holds at once, so that the last, partial round is a
#: small share of the pass (a launch of one round ends with SMs that wait
#: for the slowest block)
GELU_BLOCKS_PER_SM = 32


def gelu_dims(n, itemsize, sms):
    """(grid, block) of the gelu_fwd launch over ``n`` elements of
    ``itemsize`` bytes on a card with ``sms`` SMs: 256-thread blocks, one
    16-byte vector a thread per pass, as many blocks as cover ``n`` up to
    ``GELU_BLOCKS_PER_SM`` per SM (the grid-stride loop takes the rest)."""
    per_block = 256 * (16 // itemsize)
    blocks = max(1, min(-(-n // per_block), GELU_BLOCKS_PER_SM * sms))
    return (blocks, 1, 1), (256, 1, 1)


# -- sgd_update ---------------------------------------------------------------

def sgd_hyper(lr, rescale_grad=1.0, wd=0.0, device="cpu") -> torch.Tensor:
    """The [lr, rescale, wd] array that ``sgd_update`` reads."""
    return torch.tensor([lr, rescale_grad, wd], dtype=torch.float32,
                        device=device)


def sgd_update(weight: torch.Tensor, grad: torch.Tensor,
               hp: torch.Tensor) -> torch.Tensor:
    """weight -= lr·(rescale·grad + wd·weight), in place, float32."""
    _push("sgd_update", [weight, grad, hp], [weight])
    return weight


# -- gelu ---------------------------------------------------------------------

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """0.5·x·(1 + erf(x/√2)) in float32, in ``x``'s dtype."""
    v = x.float()
    return (v * 0.5 * (1.0 + torch.erf(v * _SQRT_HALF))).to(x.dtype)


def gelu_grad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dy·(Φ(x) + x·φ(x)) in float32, in ``x``'s dtype."""
    v = x.float()
    cdf = 0.5 * (1.0 + torch.erf(v * _SQRT_HALF))
    pdf = torch.exp(-0.5 * v * v) * _INV_SQRT_2PI
    return (dy.float() * (cdf + v * pdf)).to(x.dtype)


def _sm_count(device) -> int:
    """SMs of a CUDA device; 1 elsewhere (the CPU route ignores dims)."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def gelu_forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "meta":
        return torch.empty_like(x)
    x = x.contiguous()
    grid, block = gelu_dims(x.numel(), x.element_size(), _sm_count(x.device))
    return _push("gelu_fwd", [x], [torch.empty_like(x)], grid, block)[0]


def gelu_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    if x.device.type == "meta":
        return torch.empty_like(x)
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    return _push("gelu_bwd", [x, dy], [torch.empty_like(x)])[0]


def register_rtc_gelu() -> None:
    """Register the op ``rtc_gelu`` (once): ``gelu_fwd`` forward and
    ``gelu_bwd`` gradient through ``register_kernel_op``; it appears on
    ``mx.sym`` and ``mx.nd``."""
    from .ops import register_kernel_op, registered_ops

    if "rtc_gelu" in registered_ops():
        return
    register_kernel_op(
        "rtc_gelu", lambda attrs, x: gelu_forward(x),
        bwd=lambda attrs, res, ct: (gelu_backward(res[0], ct),),
        infer_shape=lambda attrs, s: (s, [s[0]], []), hint="rtc_gelu")


def with_rtc_gelu(symbol):
    """``symbol`` with every ``gelu`` node computed by ``rtc_gelu``: the op
    names swapped in its graph JSON, the node names kept."""
    from .symbol import load_json

    register_rtc_gelu()
    js = symbol.tojson()
    if '"op": "gelu"' not in js:
        raise MXNetError("with_rtc_gelu: the symbol has no gelu node")
    return load_json(js.replace('"op": "gelu"', '"op": "rtc_gelu"'))
