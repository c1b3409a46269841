"""User kernels of the extension path, pushed through ``rtc.MXRtc``: CUDA C
bodies compiled at run time for the card, each beside the same function as
Python source (``MXRtc``'s CPU route) and as plain torch (what the card's
result is held against).  They replace no kernel of the JAX package; they
are what its ``mx.rtc`` (``mxnet_tpu/rtc.py``) and ``register_pallas_op``
(``mxnet_tpu/ops/pallas_op.py``) exist to run.  Each is a simple
elementwise pass, bound by the bytes it moves.

- ``axpy``: out = 2·x + y in float32, a 2-D launch with explicit
  ``grid_dims``/``block_dims`` (``axpy_dims``): rows over y, 16-byte
  vectors of a row over x, both grid-stride, and floats (4 a thread,
  loads first) where the rows do not start on 16-byte boundaries.  NVRTC
  contracts 2·x + y to one FMA, which rounds as 2·x (exact) then + y
  does: the same bits.
- ``sgd_update``: w -= lr·(rescale·g + wd·w) in float32, in place
  (``push([w, g, hp], [w])``, ``hp`` = [lr, rescale, wd] on the device),
  a grid-stride loop over the blocks that ``sgd_dims`` names.
  The body rounds every product and sum on its own, in the order of the
  port's ``sgd_update`` (``ops/optimizer_ops.py``), so the two agree bit for
  bit; plain ``*`` and ``+`` would let NVRTC contract them into FMAs.
- ``gelu_fwd``/``gelu_bwd``: the exact erf GELU, 0.5·x·(1 + erf(x/√2)) as
  ``jax.nn.gelu(approximate=False)``, and its derivative
  Φ(x) + x·φ(x), float32 or bfloat16 in and out, arithmetic in float32.
  Both read and write 16-byte vectors in a grid-stride loop over the
  blocks that ``gelu_dims`` names; a scalar loop in the same launch takes
  the tail and any view not 16-byte aligned.
  ``register_rtc_gelu`` makes them the op ``rtc_gelu`` through
  ``register_kernel_op``, with ``gelu_bwd`` as its gradient, and
  ``with_rtc_gelu`` swaps ``gelu`` nodes of a symbol for it.

The wrappers take tensors on the card or the CPU and pick the route by the
tensor's device; a kernel object per (kernel, output device, shape and
dtype, inputs' dtypes) is cached, as MXRtc's prototypes fix shapes and the
CUDA body's argument types, and pushed the tensors as they are (MXRtc
takes a tensor wherever it takes an NDArray).
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
           "sgd_dims", "sgd_hyper", "sgd_update", "gelu_forward",
           "gelu_backward", "gelu_plain", "gelu_grad_plain",
           "register_rtc_gelu", "with_rtc_gelu"]

AXPY_CUDA = r"""
// rows over y (threadIdx.y, blockIdx.y) and within a row over x
// (threadIdx.x, blockIdx.x), both grid-stride: 16-byte vectors when every
// row of x, y and out starts on a 16-byte boundary (the three bases
// aligned and the row length a multiple of 4), else floats, 4 a thread a
// pass (the x threads cover a quarter of the row) with all 8 loads issued
// before the 4 stores, as many in flight as the vector loop's 2.
// The row length is a constant of the prototype, so each loop's bound is.
const long long rows = out_dims[0], cols = out_dims[1];
const long long r_first = (long long)blockIdx.y * blockDim.y + threadIdx.y;
const long long r_step = (long long)gridDim.y * blockDim.y;
const long long c_first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
const long long c_step = (long long)gridDim.x * blockDim.x;
const bool aligned = cols % 4 == 0 &&
    ((reinterpret_cast<unsigned long long>(x) |
      reinterpret_cast<unsigned long long>(y) |
      reinterpret_cast<unsigned long long>(out)) & 15) == 0;
if (aligned) {
  for (long long r = r_first; r < rows; r += r_step) {
    const float4* xv = reinterpret_cast<const float4*>(x + r * cols);
    const float4* yv = reinterpret_cast<const float4*>(y + r * cols);
    float4* ov = reinterpret_cast<float4*>(out + r * cols);
    for (long long c = c_first; c < cols / 4; c += c_step) {
      const float4 a = xv[c], b = yv[c];
      ov[c] = make_float4(2.0f * a.x + b.x, 2.0f * a.y + b.y,
                          2.0f * a.z + b.z, 2.0f * a.w + b.w);
    }
  }
} else {
  for (long long r = r_first; r < rows; r += r_step) {
    const float* xr = x + r * cols;
    const float* yr = y + r * cols;
    float* orow = out + r * cols;
    for (long long c = c_first; c < cols; c += 4 * c_step) {
      float a[4], b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k * c_step < cols) {
          a[k] = xr[c + k * c_step];
          b[k] = yr[c + k * c_step];
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k * c_step < cols) orow[c + k * c_step] = 2.0f * a[k] + b[k];
    }
  }
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
// grid-stride over 16-byte vectors (8 bf16 or 4 float) while x, dy and dx
// are all 16-byte aligned; the scalar loop takes the tail, or every element
// when any of them is not.  One expression serves both loops.
static_assert(sizeof(x[0]) == sizeof(dy[0]) && sizeof(x[0]) == sizeof(dx[0]),
              "x, dy and dx share one dtype");
constexpr int W = 16 / sizeof(x[0]);
const auto grad = [](float v, float g) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
  const float pdf = expf(-0.5f * v * v) * 0.39894228040143267794f;
  return g * (cdf + v * pdf);
};
const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
const long long stride = (long long)gridDim.x * blockDim.x;
const bool aligned = ((reinterpret_cast<unsigned long long>(x) |
                       reinterpret_cast<unsigned long long>(dy) |
                       reinterpret_cast<unsigned long long>(dx)) & 15) == 0;
const long long n_vec = aligned ? dx_size / W : 0;
for (long long i = first; i < n_vec; i += stride) {
  const uint4 xin = reinterpret_cast<const uint4*>(x)[i];
  const uint4 gin = reinterpret_cast<const uint4*>(dy)[i];
  uint4 out;
  const auto* xs = reinterpret_cast<decltype(&x[0])>(&xin);
  const auto* gs = reinterpret_cast<decltype(&dy[0])>(&gin);
  auto* ds = reinterpret_cast<decltype(&dx[0])>(&out);
#pragma unroll
  for (int e = 0; e < W; ++e)
    ds[e] = grad(static_cast<float>(xs[e]), static_cast<float>(gs[e]));
  reinterpret_cast<uint4*>(dx)[i] = out;
}
for (long long i = n_vec * W + first; i < dx_size; i += stride)
  dx[i] = grad(static_cast<float>(x[i]), static_cast<float>(dy[i]));
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
_CACHE: Dict[tuple, tuple] = {}  # key -> (MXRtc, (grid, block))
_LOCK = threading.Lock()


def _nd(t: torch.Tensor):
    from .ndarray import NDArray, _context_of

    return NDArray(t, _context_of(t.device))


def _push(name, ins, outs, dims=None):
    """Push user kernel ``name`` on tensors: the CUDA body on the card, the
    Python source on the CPU.  The kernel object is cached by the output's
    device, shape and dtype and the inputs' dtypes (each dtype gets a
    kernel of its C types; the output's shape fixes the inputs' for every
    kernel here, and an input of another shape or device is refused by the
    prototype checks), together with its launch dims: ``dims(out)``, or
    MXRtc's default launch if ``dims`` is None."""
    out = outs[0]
    key = (name, out.device, out.shape, out.dtype) + tuple(
        [t.dtype for t in ins])
    hit = _CACHE.get(key)
    if hit is None:
        if out.device.type not in ("cuda", "cpu"):
            raise MXNetError("rtc kernel %s: no route for device %s"
                             % (name, out.device))
        with _LOCK:
            hit = _CACHE.get(key)
            if hit is None:
                cuda, python, in_names, out_names = _SOURCES[name]
                hit = _CACHE[key] = (MXRtc(
                    name, list(zip(in_names, ins)),
                    list(zip(out_names, outs)),
                    cuda if out.device.type == "cuda" else python),
                    dims(out) if dims is not None else (None, None))
    krnl, (grid, block) = hit
    krnl.push(ins, outs, grid, block)
    return outs


# -- axpy --------------------------------------------------------------------

def axpy_dims(shape):
    """(grid, block) of the 2-D axpy launch: blocks of 32 x 8 threads, x
    across a row's 16-byte vectors, y across rows, and as many blocks as
    give each thread one vector (the grid's y is capped at 65535; the
    kernel's row loop takes the rest).  On an H100 this ran faster than a
    grid capped at several rounds of blocks per SM with each thread
    walking rows, the launch of ``gelu_dims``."""
    rows, cols = shape
    vectors = -(-cols // 4)
    return ((max(1, -(-vectors // 32)), max(1, min(-(-rows // 8), 65535)), 1),
            (32, 8, 1))


def axpy(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = 2·x + y for 2-D float32 tensors, written into ``out``."""
    _push("axpy", [x, y], [out], lambda t: axpy_dims(t.shape))
    return out


def axpy_plain(x, y):
    return 2.0 * x + y


#: blocks of 256 threads per SM in the gelu and sgd_update launches:
#: several rounds of the blocks an SM holds at once, so that the last,
#: partial round is a small share of the pass (a launch of one round ends
#: with SMs that wait for the slowest block)
GELU_BLOCKS_PER_SM = 32


def _stride_dims(n, per_thread, sms):
    """256-thread blocks, ``per_thread`` elements a thread per pass, as
    many blocks as cover ``n`` up to ``GELU_BLOCKS_PER_SM`` per SM (the
    kernel's grid-stride loop takes the rest)."""
    per_block = 256 * per_thread
    blocks = max(1, min(-(-n // per_block), GELU_BLOCKS_PER_SM * sms))
    return (blocks, 1, 1), (256, 1, 1)


def gelu_dims(n, itemsize, sms):
    """(grid, block) of the gelu_fwd and gelu_bwd launches over ``n``
    elements of ``itemsize`` bytes on a card with ``sms`` SMs: one 16-byte
    vector a thread per pass."""
    return _stride_dims(n, 16 // itemsize, sms)


def sgd_dims(n, sms):
    """(grid, block) of the sgd_update launch over ``n`` elements on a
    card with ``sms`` SMs: one element a thread per pass."""
    return _stride_dims(n, 1, sms)


# -- sgd_update ---------------------------------------------------------------

def sgd_hyper(lr, rescale_grad=1.0, wd=0.0, device="cpu") -> torch.Tensor:
    """The [lr, rescale, wd] array that ``sgd_update`` reads."""
    return torch.tensor([lr, rescale_grad, wd], dtype=torch.float32,
                        device=device)


def sgd_update(weight: torch.Tensor, grad: torch.Tensor,
               hp: torch.Tensor) -> torch.Tensor:
    """weight -= lr·(rescale·grad + wd·weight), in place, float32."""
    _push("sgd_update", [weight, grad, hp], [weight],
          lambda t: sgd_dims(t.numel(), _sm_count(t.device)))
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


def _gelu_launch(t):
    return gelu_dims(t.numel(), t.element_size(), _sm_count(t.device))


def gelu_forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "meta":
        return torch.empty_like(x)
    x = x.contiguous()
    return _push("gelu_fwd", [x], [torch.empty_like(x)], _gelu_launch)[0]


def gelu_backward(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    if x.device.type == "meta":
        return torch.empty_like(x)
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    return _push("gelu_bwd", [x, dy], [torch.empty_like(x)], _gelu_launch)[0]


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
