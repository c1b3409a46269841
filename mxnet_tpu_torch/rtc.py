"""``mx.rtc`` — user kernels compiled at run time from source strings.

Counterpart of ``mxnet_tpu/rtc.py``, honouring upstream MXNet 0.9's
contract (src/common/mxrtc.cc:117-135, python/mxnet/rtc.py) on the card:
``MXRtc(name, inputs, outputs, kernel_src)`` takes (name, NDArray)
prototype pairs and a source string, and ``push(ins, outs, grid_dims,
block_dims)`` runs the kernel on NDArrays.  The source picks one of two
routes, and neither ever stands in for the other:

- **CUDA C kernel body — the card.**  The body is wrapped as

      extern "C" __global__ void <name>(const T* in0, ..., T* out0, ...)

  with ``T`` from each prototype's dtype (float32 ``float``, bfloat16
  ``__nv_bfloat16``, float16 ``__half``, int32 ``int``; the headers for the
  16-bit types are included).  Before the body come, for every argument
  ``a``, the prototype's geometry as constants, as upstream MXRtc emitted
  them: ``a_ndim``, ``a_dims[]`` and ``a_size`` (its element count).  NVRTC
  compiles it for sm_90a at the first push (``cuda_rtc``); the module is
  cached per source, which includes the prototypes, and per device.  A push
  launches it on PyTorch's current stream of the arrays' device, through a
  launch plan built at the first push on that device (``_Plan``: the
  function and ``cuda_rtc.LaunchPlan``'s argument block), with
  ``grid_dims``/``block_dims``
  (up to three ints each, missing ones 1) or, with neither given, a 1-D
  launch of 256-thread blocks covering the element count of the first
  output: ``blockIdx.x * blockDim.x + threadIdx.x`` indexes the elements
  (a grid-stride loop works under both).  Outputs are written in place in
  the output arrays' storage, so ``push([w, g], [w])`` updates ``w``;
  arrays must be contiguous CUDA arrays of the prototype's device and dtype.
  A launch that returned no error counts under ``kernels.LAUNCHES
  ["rtc:<name>"]``.
- **Python source defining exactly one function — the CPU.**  The JAX
  package's contract (``mxnet_tpu/rtc.py:11-14``): the function takes one
  ref per input, then one per output, and writes the outputs through
  ``out_ref[...] = ...``.  Here a ref is the array's tensor, so
  ``out_ref[...] = 2.0 * x_ref[...] + y_ref[...]`` runs as torch on CPU
  arrays only.  An input that shares storage with an output is handed over
  as a copy, so the function sees its inputs as they were, as Pallas refs
  do.  A syntax error raises at construction.

A dedented source whose first statement (blank and ``#`` lines skipped) is
``def`` is Python; anything else is CUDA C.

    x, y = mx.nd.ones((4096,)), mx.nd.ones((4096,))
    out = mx.nd.zeros((4096,))
    k = mx.rtc.MXRtc("axpy", [("x", x), ("y", y)], [("out", out)], '''
        long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
        if (i < out_size) out[i] = 2.0f * x[i] + y[i];
    ''')
    k.push([x, y], [out])          # 16 blocks of 256 threads

For a kernel that trains as a graph op, wrap its pushes in a function and
register it with ``mx.register_kernel_op`` (``rtc_kernels.py`` registers
the op ``rtc_gelu`` so).
"""
from __future__ import annotations

import functools
import math
import re
import textwrap
import threading
from typing import List, Sequence, Tuple

import torch

from . import cuda_rtc, kernels
from .base import MXNetError

__all__ = ["MXRtc", "cuda_source", "is_python_source", "launch_dims",
           "DEFAULT_BLOCK"]

#: threads per block of the default 1-D launch
DEFAULT_BLOCK = 256

#: the C type of a kernel argument per element dtype, and its header
_C_TYPES = {torch.float32: ("float", None),
            torch.bfloat16: ("__nv_bfloat16", "cuda_bf16.h"),
            torch.float16: ("__half", "cuda_fp16.h"),
            torch.int32: ("int", None)}

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")


def is_python_source(src: str) -> bool:
    """True when the dedented source's first statement is ``def``."""
    for line in textwrap.dedent(src).splitlines():
        stripped = line.strip()
        if stripped and not stripped.startswith("#"):
            return re.match(r"def\s", stripped) is not None
    return False


def cuda_source(name: str, inputs, outputs, body: str) -> str:
    """The full CUDA source of a kernel body: ``inputs`` and ``outputs``
    are (argument name, shape, torch dtype) triples."""
    for what in [name] + [a for a, _, _ in list(inputs) + list(outputs)]:
        if not _IDENT.match(what):
            raise MXNetError("rtc: %r is not a C identifier" % (what,))
    for arg, _, dtype in list(inputs) + list(outputs):
        if dtype not in _C_TYPES:
            raise MXNetError("rtc: argument %s has dtype %s; CUDA kernels take "
                             "%s" % (arg, dtype, sorted(str(d) for d in
                                                        _C_TYPES)))
    headers = sorted({_C_TYPES[d][1] for _, _, d in list(inputs)
                      + list(outputs)} - {None})
    args = ["const %s* %s" % (_C_TYPES[d][0], a) for a, _, d in inputs] + \
        ["%s* %s" % (_C_TYPES[d][0], a) for a, _, d in outputs]
    lines = ["#include <%s>" % h for h in headers]
    lines.append('extern "C" __global__ void %s(%s) {' % (name,
                                                         ", ".join(args)))
    for a, shape, _ in list(inputs) + list(outputs):
        lines.append("  const int %s_ndim = %d;" % (a, len(shape)))
        lines.append("  const int %s_dims[] = {%s};"
                     % (a, ", ".join(str(d) for d in shape) or "1"))
        lines.append("  const long long %s_size = %dLL;"
                     % (a, math.prod(shape)))
    lines.append(textwrap.indent(textwrap.dedent(body).strip("\n"), "  "))
    lines.append("}")
    return "\n".join(lines) + "\n"


def _dims3(dims, what) -> Tuple[int, int, int]:
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise MXNetError("rtc: %s must be 1 to 3 positive ints, got %s"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def launch_dims(n: int, grid_dims=None, block_dims=None):
    """(grid, block) of a launch over ``n`` output elements: the caller's
    dims, or 1-D blocks of ``DEFAULT_BLOCK`` threads covering ``n``."""
    if grid_dims is None and block_dims is None:
        return (-(-n // DEFAULT_BLOCK), 1, 1), (DEFAULT_BLOCK, 1, 1)
    if grid_dims is None or block_dims is None:
        raise MXNetError("rtc: give both grid_dims and block_dims, or neither")
    return _checked_dims(tuple(grid_dims), tuple(block_dims))


@functools.lru_cache(maxsize=256)
def _checked_dims(grid_dims, block_dims):
    """The explicit dims of ``launch_dims``, checked once per distinct pair
    (an update loop gives the same dims push after push)."""
    grid, block = _dims3(grid_dims, "grid_dims"), _dims3(block_dims,
                                                         "block_dims")
    if math.prod(block) > 1024 or block[2] > 64:
        raise MXNetError("rtc: block_dims %s exceed 1024 threads per block "
                         "(z at most 64)" % (block,))
    if grid[0] > 2 ** 31 - 1 or grid[1] > 65535 or grid[2] > 65535:
        raise MXNetError("rtc: grid_dims %s exceed the card's grid" % (grid,))
    return grid, block


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else a._data


def _where(t: torch.Tensor) -> str:
    from .ndarray import _context_of

    if t.device.type in ("cpu", "cuda"):
        return str(_context_of(t.device))
    return str(t.device)


class MXRtc:
    """A user kernel compiled at run time from ``kernel_src`` and pushed on
    NDArrays.  ``inputs`` and ``outputs`` are (name, NDArray) prototype
    pairs: they fix each argument's name and shape, and for the CUDA route
    its dtype and device (the Python route fixes the outputs' dtype)."""

    def __init__(self, name: str, inputs: Sequence[Tuple[str, object]],
                 outputs: Sequence[Tuple[str, object]], kernel_src: str):
        self.name = name
        self._in_protos = [(n, tuple(a.shape), _tensor(a).dtype,
                            _tensor(a).device) for n, a in inputs]
        self._out_protos = [(n, tuple(a.shape), _tensor(a).dtype,
                             _tensor(a).device) for n, a in outputs]
        src = textwrap.dedent(kernel_src)
        self.route = "python" if is_python_source(src) else "cuda"
        self.source = None
        self._kernel = None
        # the default launch covers the first output's elements
        self._size = math.prod(self._out_protos[0][1]) \
            if self._out_protos else 0
        self._plans = {}  # torch.device -> _Plan (the CUDA route)
        self._plans_lock = threading.Lock()
        if self.route == "cuda":
            self.source = cuda_source(
                name, [p[:3] for p in self._in_protos],
                [p[:3] for p in self._out_protos], src)
        else:
            self._kernel = self._compile_python(name, src)

    @staticmethod
    def _compile_python(name, src):
        srcfile = "<mx.rtc:%s>" % name
        scope = {}
        try:
            exec(compile(src, srcfile, "exec"), scope)
        except Exception as e:
            raise MXNetError("rtc kernel %r failed to compile: %s" % (name, e))
        fn = scope.get("kernel")
        if fn is None:
            # a single function defined in the source, under any name
            fns = [v for v in scope.values()
                   if callable(v) and getattr(getattr(v, "__code__", None),
                                              "co_filename", None) == srcfile]
            if len(fns) != 1:
                raise MXNetError(
                    "rtc kernel source must define exactly one function "
                    "(preferably named 'kernel')")
            fn = fns[0]
        return fn

    def _check(self, ins, outs) -> None:
        """The JAX package's prototype checks, with its error texts."""
        if len(ins) != len(self._in_protos):
            raise MXNetError("rtc %r expects %d inputs, got %d"
                             % (self.name, len(self._in_protos), len(ins)))
        for arr, (pname, shape, _, _) in zip(ins, self._in_protos):
            if arr.shape != shape:
                raise MXNetError(
                    "rtc %r input %s shape %s does not match prototype %s"
                    % (self.name, pname, tuple(arr.shape), shape))
        if len(outs) != len(self._out_protos):
            raise MXNetError("rtc %r expects %d outputs, got %d"
                             % (self.name, len(self._out_protos), len(outs)))
        for out, (pname, shape, _, _) in zip(outs, self._out_protos):
            if out.shape != shape:
                raise MXNetError(
                    "rtc %r output %s shape %s does not match prototype %s"
                    % (self.name, pname, tuple(out.shape), shape))

    def push(self, ins, outs, grid_dims=None, block_dims=None):
        """Run the kernel on ``ins``, writing ``outs`` in place; returns
        ``outs``.  The launch dims apply to the CUDA route."""
        self._check(ins, outs)
        t_in = [_tensor(a) for a in ins]
        t_out = [_tensor(a) for a in outs]
        if self.route == "python":
            self._push_python(t_in, t_out)
        else:
            self._push_cuda(t_in, t_out, grid_dims, block_dims)
        return outs

    __call__ = push

    def _push_python(self, t_in: List[torch.Tensor],
                     t_out: List[torch.Tensor]) -> None:
        for (pname, _, dtype, _), t in zip(self._in_protos + self._out_protos,
                                           t_in + t_out):
            if t.device.type != "cpu":
                raise MXNetError(
                    "rtc %r: a Python source runs on CPU arrays only, but %s "
                    "is on %s; push a CUDA C kernel body on the card"
                    % (self.name, pname, _where(t)))
        for (pname, _, dtype, _), t in zip(self._out_protos, t_out):
            if t.dtype != dtype:
                raise MXNetError("rtc %r output %s has dtype %s, the prototype "
                                 "%s" % (self.name, pname, t.dtype, dtype))
        from .ndarray import _shares_storage

        t_in = [t.clone() if any(_shares_storage(t, o) for o in t_out) else t
                for t in t_in]
        with torch.no_grad():
            self._kernel(*t_in, *t_out)

    def _push_cuda(self, t_in, t_out, grid_dims, block_dims) -> None:
        """The CUDA route, after the prototype checks: each array's device,
        dtype and layout, then a launch through the plan of the arrays'
        device, built at the first push on it."""
        args = t_in + t_out
        for (pname, _, dtype, device), t in zip(
                self._in_protos + self._out_protos, args):
            if not t.is_cuda:
                raise MXNetError(
                    "rtc %r: a CUDA C kernel body runs on CUDA arrays only, "
                    "but %s is on %s; give the CPU a Python source"
                    % (self.name, pname, _where(t)))
            if t.device != device or t.dtype != dtype:
                raise MXNetError(
                    "rtc %r: %s is %s on %s, the prototype %s on %s"
                    % (self.name, pname, t.dtype, t.device, dtype, device))
            if not t.is_contiguous():
                raise MXNetError("rtc %r: %s is not contiguous"
                                 % (self.name, pname))
        grid, block = launch_dims(self._size, grid_dims, block_dims)
        if grid[0] == 0:
            return  # an empty output: nothing to launch
        device = args[-1].device
        plan = self._plans.get(device) or self._plan(device)
        pointers = [t.data_ptr() for t in args]
        index = plan.index
        if _current_device() == index:
            res = plan.launch.launch(pointers, grid, block, _stream(index))
        else:
            with torch.cuda.device(index):
                res = plan.launch.launch(pointers, grid, block,
                                         _stream(index))
        if res != 0:
            raise MXNetError("rtc %r: kernel launch failed: %s"
                             % (self.name, cuda_rtc.error_string(res)))
        kernels.count(plan.counter)
        if kernels._records():  # a compile-cache entry's first run
            kernels.note("cubins", plan.cubin_key)

    def _plan(self, device: torch.device) -> "_Plan":
        """The launch plan of ``device``, built (the kernel compiled and
        loaded there) at the first push on it."""
        with self._plans_lock:
            plan = self._plans.get(device)
            if plan is None:
                plan = self._plans[device] = _Plan(self, device)
        return plan


def _current_device() -> int:
    """The index of PyTorch's current CUDA device."""
    return torch.cuda.current_device()


def _stream(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index``, as an int (the
    raw handle, without the ``torch.cuda.Stream`` object that
    ``current_stream`` builds around it)."""
    return torch._C._cuda_getCurrentRawStream(index)


class _Plan:
    """What one ``MXRtc`` needs to push on one CUDA device, found once:
    the loaded function and its ``cuda_rtc.LaunchPlan``, and the launch
    counter's name."""

    def __init__(self, krnl: MXRtc, device: torch.device):
        self.index = device.index
        func = cuda_rtc.function(krnl.source, krnl.name, self.index)
        self.launch = cuda_rtc.LaunchPlan(
            func, self.index, len(krnl._in_protos) + len(krnl._out_protos))
        self.counter = "rtc:" + krnl.name
        self.cubin_key = cuda_rtc.source_key(krnl.source, krnl.name)
