"""Cost model of a step — counterpart of ``mxnet_tpu/hlo_analysis.py``.

The JAX package lowers a jitted program and reads XLA's cost analysis
(flops and bytes accessed); the step monitor's MFU and the autotuner's
roofline objective read that.  The port runs eagerly and has no XLA, so
its cost model counts the eager plan itself: :func:`lower_and_analyze`
runs the program once on meta tensors of the abstract shapes (no data, no
device work) under a dispatch mode that counts every aten op it runs:

* products: 2·M·N·K for ``mm``/``addmm``, 2·B·M·N·K for ``bmm``/
  ``baddbmm``, the convolution's multiply-adds times 2
  (``torch.utils.flop_counter``'s formulas);
* a kernel of the port's own counts its own work (:func:`kernel_cost`):
  flash attention counts its products over the visible (query, key)
  pairs, as PERF.md's bounds do, not its plain version's masked square;
* view ops and data movement (copies, casts, gathers, concatenation,
  factories) count no operations; every other op counts one per element
  of its largest operand (elementwise ops, reductions, softmax, norms);
* bytes: every tensor an op reads plus every tensor it writes, views
  excepted.  The eager plan has no fusion, so its bytes exceed XLA's count
  of the fused program (a kept difference, ROADMAP.md C); only the
  operations are held against the JAX package.

:func:`roofline_ms` scores such a count against the card: the larger of
operations over the peak rate and bytes over the memory rate.  The peaks
default to the NVIDIA H100 SXM's published dense bf16 rate (989 TFLOP/s)
and HBM rate (3.35 TB/s), overridable by ``MXNET_TELEMETRY_PEAK_FLOPS``
and ``MXNET_TELEMETRY_HBM_GBS`` for another card or power limit.

:func:`hlo_op_counts` and :func:`bn_fusion_analysis` are the JAX
package's text parsers of an HLO dump, kept for dumps read from it.
"""
from __future__ import annotations

import collections
import re
import threading
from contextlib import contextmanager
from typing import Optional

from .base import env, register_env

__all__ = ["peak_flops", "hbm_bytes_per_s", "cost_analysis",
           "lower_and_analyze", "roofline_ms", "hlo_op_counts",
           "bn_fusion_analysis", "TensorSpec", "kernel_cost"]

register_env("MXNET_TELEMETRY_HBM_GBS", 0.0, float,
             "HBM bandwidth (GB/s) for the roofline bytes term; "
             "0 uses the NVIDIA H100 SXM figure (3,350 GB/s).")
register_env("MXNET_TELEMETRY_PEAK_FLOPS", 0.0, float,
             "MFU denominator in FLOP/s; 0 uses the NVIDIA H100 SXM dense "
             "bf16 peak (989e12).")

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
_H100_PEAK_FLOPS = 989e12
_H100_HBM_BYTES_S = 3.35e12


def peak_flops() -> float:
    """MFU denominator: MXNET_TELEMETRY_PEAK_FLOPS override, else the
    H100 SXM's dense bf16 peak (989 TFLOP/s)."""
    v = env("MXNET_TELEMETRY_PEAK_FLOPS", 0.0, float)
    return float(v) if v else _H100_PEAK_FLOPS


def hbm_bytes_per_s() -> float:
    """Roofline bytes denominator: MXNET_TELEMETRY_HBM_GBS override,
    else the H100 SXM's HBM rate (3.35 TB/s)."""
    v = env("MXNET_TELEMETRY_HBM_GBS", 0.0, float)
    return float(v) * 1e9 if v else _H100_HBM_BYTES_S


class TensorSpec:
    """An abstract argument: a shape and a torch dtype (the port's
    ``jax.ShapeDtypeStruct``; a leaf, not a tuple, to pytrees)."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return "TensorSpec(%s, %s)" % (self.shape, self.dtype)


def cost_analysis(info) -> Optional[dict]:
    """``{"flops", "bytes_accessed"}`` of a count (a dict as
    :func:`lower_and_analyze` returns, or an object whose
    ``cost_analysis()`` gives one), or None."""
    try:
        if not isinstance(info, dict):
            info = info.cost_analysis()
        return {"flops": info.get("flops"),
                "bytes_accessed": info.get("bytes_accessed",
                                           info.get("bytes accessed"))}
    except Exception:
        return None


# -- the counter ------------------------------------------------------------

_counter_lock = threading.Lock()
_active = []  # the running counters, innermost last

# ops that only move or make data: no operations, their bytes counted
_MOVES = ("copy", "clone", "cat", "stack", "index", "gather", "scatter",
          "embedding", "empty", "zeros", "ones", "full", "fill", "arange",
          "slice", "select", "split", "pad", "repeat", "roll", "flip",
          "narrow", "unfold", "new_", "lift", "detach", "alias", "masked_fill",
          "tril", "triu", "unsafe_view", "resize", "set_", "rand", "bernoulli")


def _nbytes(t):
    import torch

    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _numel(t):
    import torch

    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _product_flops(func, args, kwargs, out):
    """2·(multiply-adds) of a product op, or None for any other op."""
    name = func.overloadpacket.__name__
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * n * k
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * n * k
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        bsz, m, k = a.shape
        return 2 * bsz * m * b.shape[2] * k
    if name.startswith("convolution") or name.startswith("_convolution"):
        from torch.utils.flop_counter import flop_registry

        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            return int(fn(*args, **kwargs, out_val=out))
    return None


class _Count:
    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.paused = 0

    def note(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        if self.paused or func.is_view or \
                name in ("detach", "_unsafe_view", "lift_fresh"):
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        moves = any(m in name for m in _MOVES) or name.startswith("_to_") \
            or name in ("to", "contiguous", "zero_")
        if name.startswith("_foreach_"):
            # a list op: one operation per element of each array of its
            # first list, which an in-place one also writes
            first = _tensors(args[0])
            if name.endswith("_"):
                self.bytes += sum(_nbytes(t) for t in first)
            self.flops += 0 if moves else sum(_numel(t) for t in first)
            return
        flops = _product_flops(func, args, kwargs, out)
        if flops is None:
            flops = 0 if moves else \
                max([_numel(t) for t in ins + outs] or [0])
        self.flops += flops


def _dispatch_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __init__(self, count):
            super().__init__()
            self.count = count

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.count.note(func, args, kwargs, out)
            return out

    return _Mode


@contextmanager
def kernel_cost(flops, nbytes):
    """Inside a running count, a kernel of the port's own states its work
    here: ``flops`` and ``nbytes`` are counted, and the ops of the plain
    version it runs on the meta tensors are not.  Outside a count it does
    nothing."""
    with _counter_lock:
        count = _active[-1] if _active else None
    if count is None:
        yield
        return
    count.flops += int(flops)
    count.bytes += int(nbytes)
    count.paused += 1
    try:
        yield
    finally:
        count.paused -= 1


def _as_meta(x):
    import torch

    if isinstance(x, TensorSpec):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return x


def lower_and_analyze(fn, abstract):
    """Run ``fn(*abstract)`` once on meta tensors of the abstract
    arguments (``TensorSpec``s or tensors, in any nesting of lists, tuples
    and dicts) and count its work.  Returns ``(None, {"flops",
    "bytes_accessed"})`` — the JAX package returns the compiled program
    first; here there is none — or ``(None, None)`` without a program."""
    if fn is None:
        return None, None
    from torch.utils._pytree import tree_map

    metas = tree_map(_as_meta, tuple(abstract))
    count = _Count()
    with _counter_lock:
        _active.append(count)
    try:
        with _dispatch_mode()(count):
            fn(*metas)
    finally:
        with _counter_lock:
            _active.remove(count)
    return None, {"flops": float(count.flops),
                  "bytes_accessed": float(count.bytes)}


def roofline_ms(info) -> Optional[float]:
    """Roofline lower-bound runtime (ms) of a cost dict: the slower of the
    compute term (flops/peak) and the memory term (bytes/HBM bandwidth).
    The autotuner's cheap objective — exact runtimes are wrong off-card,
    but the RANKING across candidates of the same program tracks the
    roofline."""
    if not info:
        return None
    flops = float(info.get("flops") or 0.0)
    nbytes = float(info.get("bytes_accessed") or 0.0)
    if flops <= 0 and nbytes <= 0:
        return None
    return max(flops / peak_flops(), nbytes / hbm_bytes_per_s()) * 1e3


def hlo_op_counts(hlo_text, interesting=None) -> dict:
    """Histogram of HLO opcodes in a compiled ``as_text()`` dump,
    optionally filtered to an opcode whitelist."""
    ops = collections.Counter(
        re.findall(r"^\s*[%\w.-]+ = [\w\[\]<>{}, ]*?(\w+)\(", hlo_text,
                   re.M))
    if interesting is None:
        return dict(ops)
    return {k: v for k, v in ops.most_common() if k in interesting}


def bn_fusion_analysis(hlo_text) -> dict:
    """Does BN's scale/shift ride the conv epilogue?

    Classifies every convolution of an HLO dump by dataflow: a conv counts
    as epilogue-fused only when its RESULT name is an operand of a
    multiply/add/subtract inside the same non-entry fusion computation.
    Convs in the ENTRY computation are bare by definition — entry-level
    instructions are separate kernels even when an elementwise op consumes
    them there."""
    # computations: optional ENTRY prefix, then 'name (...) -> ... {'.
    # The '%' name sigil is optional THROUGHOUT: modern compiled.as_text()
    # dumps omit it, classic dumps keep it — names are normalized
    # sigil-less.
    blocks = re.findall(r"^(ENTRY\s+)?%?[\w.-]+ [^\n]*\{\n(.*?)^\s*\}",
                        hlo_text, re.M | re.S)
    fused = fused_plain = bare = 0
    for entry_prefix, body in blocks:
        conv_names = [m.group(1).lstrip("%") for m in re.finditer(
            r"(%?[\w.-]+)\s*=\s*\S+\s+convolution\(", body)]
        if not conv_names:
            continue
        if entry_prefix:
            bare += len(conv_names)
            continue
        ew_operands = set()
        for m in re.finditer(
                r"=\s*\S+\s+(?:multiply|add|subtract)\(([^)]*)\)", body):
            ew_operands.update(
                t.lstrip("%")
                for t in re.findall(r"%?[\w][\w.-]*", m.group(1)))
        for c in conv_names:
            if c in ew_operands:
                fused += 1
            else:
                fused_plain += 1
    return {"convs_total": fused + fused_plain + bare,
            "convs_fused_with_elementwise_epilogue": fused,
            "convs_fused_plain": fused_plain,
            "convs_bare_in_entry": bare}
