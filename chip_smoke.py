#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --profile DIR    # also trace one extra request,
                                           # one extra train step and one
                                           # extra rtc_gelu train step

Phases, each fatal on failure (non-zero exit, no result line):

1. build   — compile every CUDA kernel of the ported paths from
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
             source, all started together; load NVRTC (a missing libnvrtc is
             fatal) and print its version;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at several shapes and both dtypes, the main paths' own shapes
             included: K1 (flash forward) on O and lse, K2/K3 (flash
             backward) on dQ, dK and dV; time kernels, plain versions and the
             library calls (``scaled_dot_product_attention`` forward and
             backward, timed only as yardsticks).  Then the user kernels of
             ``mxnet_tpu_torch/rtc_kernels.py``, compiled by ``MXRtc`` with
             NVRTC: axpy (2-D launch), sgd_update, gelu_fwd and gelu_bwd
             (float32 and bf16) at ragged and full-width shapes, timed
             beside their bytes bound, the plain versions and the library
             calls (``F.gelu`` and its backward, ``torch.add``);
3. serve   — save a full-width transformer LM checkpoint (vocab 32000,
             6 x 2048, 16 heads, seq 4096, batch 4, float32; random weights
             from a seed), load it with ``Predictor.from_checkpoint`` on the
             default (GPU) context and answer requests, counting kernel
             launches;
4. train   — the same LM through ``mt.mod.Module`` on the default (GPU)
             context: bf16 compute, Xavier init, adam at lr 3e-4, one
             synthetic batch as ``examples/transformer/train_lm.py`` makes
             it; 2 warm-up and 5 timed steps; the loss must be finite and
             fall, and each step must launch each kernel once per layer;
             then the fused step and the two-phase path (forward_backward,
             then the updater over the gradients) are timed side by side;
5. extend  — the user extension path at full width: an axpy pushed
             through ``mt.rtc.MXRtc`` on NDArrays with explicit launch dims;
             ``sgd_update`` pushed over every parameter array of the LM
             (441,646,336 parameters) against the port's ``sgd_update`` on
             copies; the train phase's LM with its six gelu nodes swapped for
             the user op ``rtc_gelu`` in the symbol JSON, trained 2 + 3
             steps: each step launches gelu_fwd, gelu_bwd and K1-K3 six
             times, and its loss matches the train phase's loss at that step;
6. agree   — a small LM served, and trained 3 adam steps in float32 and in
             bf16, on the card and on the CPU from one numpy init, must
             agree; so must the small LM with ``rtc_gelu``, a net with the
             ``CustomOp`` sigmoid and softmax loss, and a few ``mt.nd``
             ops.

The second-to-last lines are the kernel table as JSON and the card's name
and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

FULL = dict(vocab_size=32000, num_layers=6, num_heads=16, hidden=2048,
            seq_len=4096)
BATCH = 4
REQUESTS = 3
SEED = 0
SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=128, seq_len=40)
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_LR = 2, 5, 3e-4
SOURCE_DIR = "mxnet_tpu_torch/csrc/"
RTC_SOURCE = "mxnet_tpu_torch/rtc_kernels.py"
AXPY_PY_SRC = """
def kernel(x_ref, out_ref):
    out_ref[...] = 2.0 * x_ref[...]
"""
EXTEND_WARMUP, EXTEND_STEPS = 2, 3
# the user kernels' full-width shape: the gelu input of the train phase's
# LM, (batch x seq, 4 x hidden)
WIDE = (BATCH * FULL["seq_len"], 4 * FULL["hidden"])
# sgd_update's hyperparameters in the extend phase
SGD = dict(lr=0.01, rescale_grad=1.0 / BATCH, wd=1e-4)

# Data-sheet peaks per H100 variant (dense): float32 on the CUDA cores and
# bf16 on the tensor cores (TFLOP/s), device memory (TB/s).  nvidia-smi
# names the SXM part "NVIDIA H100 80GB HBM3", so SXM is the fallback.
PEAKS = {
    "H100 PCIe": {"float32": 51.0, "bfloat16": 756.0, "tbs": 2.0},
    "H100 NVL": {"float32": 60.0, "bfloat16": 835.0, "tbs": 3.9},
    "H100 SXM": {"float32": 67.0, "bfloat16": 989.0, "tbs": 3.35},
}


def check(ok, msg):
    if not ok:
        raise SystemExit("chip_smoke FAILED: " + msg)


def peaks_for(name):
    for key, val in PEAKS.items():
        if all(part in name for part in key.split()):
            return key, val
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_work(kind, b, sq, sk, h, d, causal, itemsize):
    """(operations, bytes) that attention function ``kind`` must do for
    these shapes: 2·d operations per visible (query, key) pair for each
    distinct product, each input read once and each output written once.

    fwd     QKᵀ, PV                         reads q, k, v; writes o, lse
    bwd_dq  QKᵀ, dO·Vᵀ, dS·K                reads q, k, v, dO, lse, Δ; writes dq
    bwd_dkv QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q        reads q, k, v, dO, lse, Δ; writes dk, dv
    bwd     the five products of the whole backward (no product counted
            twice); reads q, k, v, o, dO, lse; writes dq, dk, dv
    """
    if causal:
        pairs = int(np.minimum(np.arange(sq) + 1, sk).sum())
    else:
        pairs = sq * sk
    qs = b * sq * h * d * itemsize  # one [b, sq, h, d] tensor
    ks = b * sk * h * d * itemsize  # one [b, sk, h, d] tensor
    rows = b * h * sq * 4           # one float32 [b*h, sq] row vector
    products, nbytes = {
        "fwd": (2, 2 * qs + 2 * ks + rows),
        "bwd_dq": (3, 3 * qs + 2 * ks + 2 * rows),
        "bwd_dkv": (4, 2 * qs + 4 * ks + 2 * rows),
        "bwd": (5, 4 * qs + 4 * ks + rows),
    }[kind]
    return 2.0 * products * d * pairs * b * h, nbytes


def bound_ms(torch, work, dtype):
    """(bound ms, what bounds it): the larger of the work's operations
    over the card's peak for ``dtype`` and its bytes over memory rate."""
    _, peak = peaks_for(torch.cuda.get_device_name(0))
    flops, nbytes = work
    t_ops = flops / (peak["bfloat16" if dtype == torch.bfloat16
                          else "float32"] * 1e12) * 1e3
    t_bytes = nbytes / (peak["tbs"] * 1e12) * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def qkv_views(torch, gen, b, sq, sk, h, d, dtype, device):
    """q, k, v as the LM hands them to the kernels: strided views of one
    packed [b, s, 3, h, d] projection when sq == sk."""
    if sq == sk:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device=device)
        return tuple(t.squeeze(2) for t in qkv.to(dtype).split(1, dim=2))
    mk = lambda s: torch.randn((b, s, h, d), generator=gen,  # noqa: E731
                               device=device).to(dtype)
    return mk(sq), mk(sk), mk(sk)


def rel_err(torch, got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def kernel_phase(torch, att, device):
    """K1 against ``attention_reference`` (O, lse) and K2/K3 against
    ``attention_backward_reference`` (dQ, dK, dV) at every case; then the
    timings at the main paths' shape.  Returns the three kernels' rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    main_shape = (BATCH, FULL["seq_len"], FULL["seq_len"], FULL["num_heads"],
                  FULL["hidden"] // FULL["num_heads"], True)
    cases = [  # name, b, sq, sk, h, d, causal, dtype
        ("f32 causal d64", 2, 256, 256, 4, 64, True, f32),
        ("f32 full d64", 2, 256, 256, 4, 64, False, f32),
        ("f32 causal sq<sk d128 ragged", 2, 200, 333, 4, 128, True, f32),
        ("f32 full sq>sk d128 ragged", 2, 333, 200, 4, 128, False, f32),
        ("f32 causal sq>sk d64", 1, 300, 100, 2, 64, True, f32),
        ("bf16 causal d128", 2, 512, 512, 4, 128, True, bf16),
        ("bf16 full sq<sk d64", 2, 192, 320, 4, 64, False, bf16),
        ("bf16 causal sq>sk d128 ragged", 2, 333, 200, 4, 128, True, bf16),
        ("f32 causal main-path shape",) + main_shape + (f32,),
        ("bf16 causal main-path shape",) + main_shape + (bf16,),
    ]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    main = {}
    for name, b, sq, sk, h, d, causal, dtype in cases:
        fwd_tol = 1e-4 if dtype == f32 else 2e-2  # abs, O and lse
        bwd_tol = 1e-4 if dtype == f32 else 2e-2  # relative to max |ref|
        q, k, v = qkv_views(torch, gen, b, sq, sk, h, d, dtype, device)
        scale = 1.0 / np.sqrt(d)
        o, lse = att.flash_forward(q, k, v, causal, scale)
        o_ref, lse_ref = att.attention_reference(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        print("kernel flash_fwd [%s] b=%d sq=%d sk=%d h=%d d=%d: "
              "max|dO|=%.3g max|dlse|=%.3g (tolerance %g)"
              % (name, b, sq, sk, h, d, err_o, err_l, fwd_tol), flush=True)
        check(torch.isfinite(o.float()).all().item()
              and torch.isfinite(lse).all().item(),
              "non-finite flash_fwd output in case %s" % name)
        check(err_o <= fwd_tol and err_l <= fwd_tol,
              "flash_fwd disagrees with its plain version in case %s" % name)
        del o_ref, lse_ref

        do = torch.randn((b, sq, h, d), generator=gen, device=device).to(dtype)
        grads = att.flash_backward(q, k, v, o, lse, do, causal, scale)
        refs = att.attention_backward_reference(q, k, v, o, lse, do, causal,
                                                scale)
        torch.cuda.synchronize()
        errs = {}
        for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            check(got.dtype == dtype and got.shape == ref.shape
                  and torch.isfinite(got.float()).all().item(),
                  "flash_backward %s: bad dtype, shape or non-finite values "
                  "in case %s" % (gname, name))
            errs[gname] = rel_err(torch, got, ref)
        print("kernel flash_bwd [%s]: max|err|/max|ref| dq %.3g dk %.3g dv "
              "%.3g (tolerance %g)" % (name, errs["dq"][1], errs["dk"][1],
                                       errs["dv"][1], bwd_tol), flush=True)
        check(all(e[1] <= bwd_tol for e in errs.values()),
              "flash_backward disagrees with its plain version in case %s"
              % name)
        if "main-path" in name:
            main[dtype] = dict(q=q, k=k, v=v, o=o, lse=lse, do=do,
                               scale=scale, err_o=err_o, errs=errs)
        del grads, refs
    torch.cuda.empty_cache()

    b, sq, sk, h, d, causal = main_shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        m = main[dtype]
        q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o",
                                                      "lse", "do", "scale"))
        size = torch.tensor([], dtype=dtype).element_size()
        t = {}
        t["fwd"] = cuda_ms(lambda: att.flash_forward(q, k, v, True, scale), 5)
        t["fwd_plain"] = cuda_ms(
            lambda: att.attention_reference(q, k, v, True, scale), 2)
        torch.cuda.empty_cache()
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v))
        t["fwd_lib"] = cuda_ms(
            lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale), 5)
        out = sdpa(qt, kt, vt, is_causal=True, scale=scale)
        dot = do.transpose(1, 2)
        t["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 5)
        del out, qt, kt, vt
        delta = att._row_delta(o, do).contiguous()
        t["bwd_dq"] = cuda_ms(lambda: att.flash_bwd_dq(
            q, k, v, do, lse, delta, True, scale), 3)
        t["bwd_dkv"] = cuda_ms(lambda: att.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, scale), 3)
        t["bwd"] = cuda_ms(lambda: att.flash_backward(
            q, k, v, o, lse, do, True, scale), 3)
        t["bwd_plain"] = cuda_ms(lambda: att.attention_backward_reference(
            q, k, v, o, lse, do, True, scale), 2)
        torch.cuda.empty_cache()
        for kind in ("fwd", "bwd_dq", "bwd_dkv", "bwd"):
            work = attention_work(kind, b, sq, sk, h, d, causal, size)
            t[kind + "_bound"] = bound_ms(torch, work, dtype)
            t[kind + "_tflops"] = work[0] / (t[kind] * 1e-3) / 1e12
        timings[dtype] = t
        print("kernel timing %s b=%d s=%d h=%d d=%d causal: K1 %.4f ms (plain "
              "%.4f, sdpa fwd %.4f, bound %.4f by %s, %.2f TFLOP/s); K2 %.4f "
              "ms (bound %.4f by %s); K3 %.4f ms (bound %.4f by %s); K2+K3 "
              "%.4f ms, flash_backward with Δ %.4f ms (bound %.4f by %s, "
              "%.2f TFLOP/s), plain %.4f ms, sdpa bwd %.4f ms"
              % (tag, b, sq, h, d, t["fwd"], t["fwd_plain"], t["fwd_lib"],
                 t["fwd_bound"][0], t["fwd_bound"][1], t["fwd_tflops"],
                 t["bwd_dq"], t["bwd_dq_bound"][0], t["bwd_dq_bound"][1],
                 t["bwd_dkv"], t["bwd_dkv_bound"][0], t["bwd_dkv_bound"][1],
                 t["bwd_dq"] + t["bwd_dkv"], t["bwd"], t["bwd_bound"][0],
                 t["bwd_bound"][1], t["bwd_tflops"], t["bwd_plain"],
                 t["bwd_lib"]), flush=True)
    variant, peak = peaks_for(torch.cuda.get_device_name(0))
    print("kernel bounds against the %s data sheet: %.0f TFLOP/s float32, "
          "%.0f TFLOP/s bf16 dense, %.2f TB/s" % (
              variant, peak["float32"], peak["bfloat16"], peak["tbs"]),
          flush=True)

    # the rows describe the training path's dtype (bf16), the main path
    from mxnet_tpu_torch.kernels import SOURCES

    t, m = timings[bf16], main[bf16]

    def row(name, replaces, kind, err, plain, lib):
        return {"name": name, "route": "cuda",
                "source": SOURCE_DIR + SOURCES[name],
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "ms": t[kind], "plain_ms": plain, "bound_ms": t[kind + "_bound"][0],
                "bound_by": t[kind + "_bound"][1], "library_ms": lib}

    return [
        row("flash_fwd", "mxnet_tpu/ops/attention.py:97", "fwd", m["err_o"],
            t["fwd_plain"], t["fwd_lib"]),
        # one library call computes dQ, dK and dV together: SDPA's backward
        # is the yardstick of both rows, against K2 + K3
        row("flash_bwd_dq", "mxnet_tpu/ops/attention.py:216", "bwd_dq",
            m["errs"]["dq"][0], t["bwd_plain"], t["bwd_lib"]),
        row("flash_bwd_dkv", "mxnet_tpu/ops/attention.py:262", "bwd_dkv",
            max(m["errs"]["dk"][0], m["errs"]["dv"][0]), t["bwd_plain"],
            t["bwd_lib"]),
    ]


def ulps(torch, got, ref):
    """Largest distance in units in the last place between two float32 or
    bf16 tensors of one dtype (0 = the same bits; +0 and -0 are equal)."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[ref.dtype]
    top = -(2 ** (8 * ref.element_size() - 1))

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i >= 0, i, top - i)

    return int((ordered(got) - ordered(ref)).abs().max().item())


def elementwise_bound(torch, n, nbytes_per, flops_per, dtype):
    """bound_ms of an elementwise pass over ``n`` elements."""
    return bound_ms(torch, (float(flops_per) * n, float(nbytes_per) * n),
                    dtype)


def rtc_kernel_phase(torch, mt, device):
    """The user kernels (``rtc_kernels``, compiled by MXRtc with NVRTC)
    against their plain versions: axpy and sgd_update exactly or within
    1 float32 ulp (an FMA rounds once), gelu within 1 bf16 ulp and, in
    float32, within 1e-6 of max |ref|; then timed at WIDE.  Returns the
    rows of axpy, gelu_fwd and gelu_bwd."""
    from mxnet_tpu_torch import rtc_kernels as rk

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)

    def randn(shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    err = {}
    for shape in ((1000, 777), WIDE):
        x, y = randn(shape), randn(shape)
        out = torch.empty_like(x)
        rk.axpy(x, y, out)
        err["axpy"] = (ulps(torch, out, rk.axpy_plain(x, y)),
                       (out - rk.axpy_plain(x, y)).abs().max().item())
        print("kernel rtc:axpy %s f32, grid/block %s: %d ulps from plain"
              % (shape, rk.axpy_dims(shape), err["axpy"][0]), flush=True)
        check(err["axpy"][0] <= 1, "rtc:axpy disagrees with its plain "
              "version at %s" % (shape,))
        del x, y, out
    for wd in (0.0, SGD["wd"]):
        w, g = randn((100003,), 0.02), randn((100003,))
        ref = w.clone()
        hp = rk.sgd_hyper(SGD["lr"], SGD["rescale_grad"], wd, device)
        for _ in range(2):
            rk.sgd_update(w, g, hp)
            mt.nd.sgd_update(ref, g, out=ref, lr=SGD["lr"],
                             rescale_grad=SGD["rescale_grad"], wd=wd)
        d = ulps(torch, w, ref)
        print("kernel rtc:sgd_update (100003,) f32 wd=%g, 2 in-place pushes: "
              "%d ulps from the port's sgd_update" % (wd, d), flush=True)
        check(d <= 1, "rtc:sgd_update disagrees with sgd_update")
    for shape, dtype in (((3001, 517), f32), ((3001, 517), bf16),
                         (WIDE, f32), (WIDE, bf16)):
        x, dy = randn(shape, 3.0, dtype), randn(shape, 1.0, dtype)
        got = (rk.gelu_forward(x), rk.gelu_backward(x, dy))
        ref = (rk.gelu_plain(x), rk.gelu_grad_plain(x, dy))
        for name, a, b in zip(("gelu_fwd", "gelu_bwd"), got, ref):
            d = ulps(torch, a, b)
            rel = ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            print("kernel rtc:%s %s %s: %d ulps, max|err|/max|ref| %.3g "
                  "(tolerance %s)" % (name, shape, str(dtype)[6:], d, rel,
                                      "1 ulp" if dtype == bf16 else "1e-6"),
                  flush=True)
            check(d <= 1 if dtype == bf16 else rel <= 1e-6,
                  "rtc:%s disagrees with its plain version at %s %s"
                  % (name, shape, dtype))
            if shape == WIDE and dtype == bf16:
                err[name] = (d, (a.float() - b.float()).abs().max().item())
        del x, dy, got, ref
    torch.cuda.empty_cache()

    # each route refuses the other device, and NVRTC's log reaches the user
    arr = mt.nd.zeros((4,))
    for what, src, want in (
            ("a CUDA body that does not compile", "out[0] = no_such_name;",
             "no_such_name"),
            ("a Python source on CUDA arrays", AXPY_PY_SRC, "CPU arrays only")):
        try:
            mt.rtc.MXRtc("probe", [("x", arr)], [("out", arr)], src).push(
                [arr], [arr])
            raised = ""
        except mt.MXNetError as e:
            raised = str(e)
        print("kernel rtc: %s raises: %s" % (what, raised.splitlines()[:3]),
              flush=True)
        check(want in raised, "%s did not raise as it should" % what)

    n = WIDE[0] * WIDE[1]
    t = {}
    x, y = randn(WIDE), randn(WIDE)
    out = torch.empty_like(x)
    t["axpy"] = (cuda_ms(lambda: rk.axpy(x, y, out), 10),
                 cuda_ms(lambda: rk.axpy_plain(x, y), 10),
                 cuda_ms(lambda: torch.add(y, x, alpha=2.0), 10),
                 elementwise_bound(torch, n, 12, 2, f32))
    del x, y, out
    x, dy = randn(WIDE, 3.0, bf16), randn(WIDE, 1.0, bf16)
    gelu_bwd_lib = torch.ops.aten.gelu_backward
    t["gelu_fwd"] = (cuda_ms(lambda: rk.gelu_forward(x), 10),
                     cuda_ms(lambda: rk.gelu_plain(x), 10),
                     cuda_ms(lambda: torch.nn.functional.gelu(x), 10),
                     elementwise_bound(torch, n, 4, 5, f32))
    t["gelu_bwd"] = (cuda_ms(lambda: rk.gelu_backward(x, dy), 10),
                     cuda_ms(lambda: rk.gelu_grad_plain(x, dy), 10),
                     cuda_ms(lambda: gelu_bwd_lib(dy, x), 10),
                     elementwise_bound(torch, n, 6, 12, f32))
    # what holds gelu back, printed only: float32 data (4-byte loads), and
    # a grid-stride launch of a few blocks per SM instead of one element a
    # thread
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for k in (4, 16):
        y = torch.empty_like(x)
        ms = cuda_ms(lambda: rk._push("gelu_fwd", [x], [y], (sms * k,),
                                      (256,)), 10)
        print("kernel timing rtc:gelu_fwd %s bf16 grid-stride over %d blocks "
              "of 256: %.4f ms" % (WIDE, sms * k, ms), flush=True)
    del x, dy, y
    x, dy = randn(WIDE, 3.0), randn(WIDE)
    print("kernel timing rtc:gelu_fwd/bwd %s f32: %.4f / %.4f ms (bounds "
          "%.4f / %.4f by bytes; F.gelu %.4f ms)" % (
              WIDE, cuda_ms(lambda: rk.gelu_forward(x), 10),
              cuda_ms(lambda: rk.gelu_backward(x, dy), 10),
              elementwise_bound(torch, n, 8, 5, f32)[0],
              elementwise_bound(torch, n, 12, 12, f32)[0],
              cuda_ms(lambda: torch.nn.functional.gelu(x), 10)), flush=True)
    del x, dy
    torch.cuda.empty_cache()
    rows = []
    for name, replaces in (("axpy", "mxnet_tpu/rtc.py:81"),
                           ("gelu_fwd", "mxnet_tpu/ops/pallas_op.py:33"),
                           ("gelu_bwd", "mxnet_tpu/ops/pallas_op.py:33")):
        ms, plain, lib, (bound, by) = t[name]
        print("kernel timing rtc:%s %s %s: %.4f ms (plain %.4f, library "
              "%.4f, bound %.4f by %s: %.1f%% of it)"
              % (name, WIDE, "f32" if name == "axpy" else "bf16", ms, plain,
                 lib, bound, by, 100 * bound / ms), flush=True)
        rows.append({"name": "rtc:" + name, "route": "cuda",
                     "source": RTC_SOURCE, "replaces": replaces,
                     "launches": None, "max_abs_err": err[name][1],
                     "ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib})
    return rows


def lm_params(mt, sym, shapes, rng, std):
    """Random LM weights from numpy: N(0, std) matrices and embeddings,
    unit LayerNorm gains, zero biases and shifts.  CPU NDArrays keyed as a
    checkpoint stores them."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            arr = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= std
        params["arg:" + name] = mt.nd.array(arr, mt.cpu())
    return params


def serve_phase(torch, mt):
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    # the label is bound too (as zeros): its shape cannot be inferred back
    # through the symbol's Reshape, in this package or the JAX one
    shapes = {"data": (b, s), "softmax_label": (b, s)}
    rng = np.random.default_rng(SEED)
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        t0 = time.perf_counter()
        params = lm_params(mt, net, shapes, rng, 0.02)
        n_params = sum(p.size for p in params.values())
        net.save(prefix + "-symbol.json")
        mt.nd.save(prefix + "-0000.params", params)
        del params
        t1 = time.perf_counter()
        pred = mt.Predictor.from_checkpoint(prefix, 0, shapes)
        t2 = time.perf_counter()
    print("serve: %d parameters; checkpoint written in %.2f s, Predictor "
          "built in %.2f s" % (n_params, t1 - t0, t2 - t1), flush=True)

    requests = [rng.integers(0, vocab, (b, s)).astype(np.float32)
                for _ in range(REQUESTS)]
    per_request = FULL["num_layers"]  # one attention per layer
    torch.cuda.reset_peak_memory_stats()
    times = []
    mt.kernels.reset_launches()
    for i, tokens in enumerate(requests):
        before = mt.kernels.LAUNCHES["flash_fwd"]
        t0 = time.perf_counter()
        out = pred.forward(data=tokens)[0]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = mt.kernels.LAUNCHES["flash_fwd"] - before
        probs = out._data
        check(out.context == mt.gpu(0) and probs.is_cuda,
              "request %d answered on %s, not the card" % (i, out.context))
        check(out.shape == (b * s, vocab), "request %d output shape %s"
              % (i, out.shape))
        check(torch.isfinite(probs).all().item(),
              "request %d output has non-finite values" % i)
        row_err = (probs.sum(dim=-1) - 1).abs().max().item()
        check(row_err <= 1e-4, "request %d rows sum to 1 only within %.3g"
              % (i, row_err))
        check(delta == per_request, "request %d launched flash_fwd %d "
              "times, expected %d" % (i, delta, per_request))
        print("serve: request %d: %.2f ms, flash_fwd launches %d, rows sum "
              "to 1 within %.2g" % (i, times[-1] * 1e3, delta, row_err),
              flush=True)
    launches = dict(mt.kernels.LAUNCHES)
    check(launches["flash_fwd"] > 0, "the serving path never launched "
          "flash_fwd")
    steady = float(np.mean(times[1:]))
    print("serve: %d requests of %d tokens; first %.2f ms, then %.2f ms per "
          "request = %.1f tokens/s; peak device memory %.2f GB; launches %s"
          % (REQUESTS, b * s, times[0] * 1e3, steady * 1e3, b * s / steady,
             torch.cuda.max_memory_allocated() / 1e9, launches), flush=True)
    return pred, requests[0]


def step_paths(torch, mod, batch):
    """Step ms and peak device memory of the two ways ``Module`` trains at
    the train phase's shapes: the fused step (``forward_backward`` defers
    the batch, ``update`` runs ``Executor.fused_step``) and the two-phase
    path (the executor group's ``forward_backward`` writes ``grad_dict``,
    then ``update`` runs the updater over it).  Blocks of one warm-up and
    two timed steps, in the order fused, two-phase, two-phase, fused."""
    def fused():
        mod.forward_backward(batch)
        mod.update()

    def two_phase():
        mod._exec_group.forward_backward(batch)
        mod.update()

    got = {"fused": [], "two-phase": []}
    for name, step in (("fused", fused), ("two-phase", two_phase),
                       ("two-phase", two_phase), ("fused", fused)):
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        got[name].append(((time.perf_counter() - t0) / 2 * 1e3,
                          torch.cuda.max_memory_allocated() / 1e9))
    for name, blocks in got.items():
        print("train: %s path: step ms %s, peak device memory GB %s"
              % (name, ["%.2f" % ms for ms, _ in blocks],
                 ["%.3f" % gb for _, gb in blocks]), flush=True)


def lm_loss(torch, probs, labels):
    """Mean cross-entropy of the SoftmaxOutput probabilities (an NDArray
    [n, vocab]) against the next-token labels, in float32."""
    p = probs._data.float()
    lab = torch.as_tensor(labels.reshape(-1), device=p.device).long()
    picked = p.gather(1, lab[:, None]).squeeze(1)
    return -picked.clamp_min(1e-30).log().mean().item()


def train_module(mt, net, ctx, data_shape, init=None, arg_params=None,
                 compute_dtype=None, optimizer_params=None):
    """A bound, initialized ``Module`` with adam, as
    ``train_lm.benchmark`` sets it up."""
    mod = mt.mod.Module(net, label_names=("softmax_label",), context=ctx,
                        compute_dtype=compute_dtype)
    mod.bind(data_shapes=[mt.io.DataDesc("data", data_shape)],
             label_shapes=[mt.io.DataDesc("softmax_label", data_shape)],
             for_training=True)
    mod.init_params(initializer=init, arg_params=arg_params)
    mod.init_optimizer(kvstore="local", optimizer="adam",
                       optimizer_params=optimizer_params or
                       {"learning_rate": TRAIN_LR})
    return mod


def train_phase(torch, mt):
    """The slice's main path: a full-width train loop through Module."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    # examples/transformer/train_lm.py::_synth_iter, one batch
    rng = np.random.RandomState(SEED)
    X = rng.randint(0, vocab, size=(b, s)).astype(np.float32)
    Y = (X + 1) % vocab
    it = mt.io.NDArrayIter(X, Y, batch_size=b, label_name="softmax_label")
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    mt.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod = train_module(mt, net, None, (b, s),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34),
                       compute_dtype="bfloat16")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ex = mod._exec_group.execs[0]
    n_params = sum(ex.arg_dict[n].size for n in mod._exec_group.param_names)
    check(all(ex.arg_dict[n]._data.is_cuda and
              ex.arg_dict[n].context == mt.gpu(0)
              for n in mod._exec_group.param_names),
          "the parameters do not live on the card")
    print("train: %d parameters on %s, bound and initialized in %.2f s"
          % (n_params, ex.arg_dict[mod._exec_group.param_names[0]].context,
             t1 - t0), flush=True)
    batch = it.next()

    per_step = FULL["num_layers"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    losses, times = [], []
    mt.kernels.reset_launches()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES[n] - before[n] for n in names}
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        print("train: step %d: %.2f ms, loss %.6f, launches %s"
              % (step, times[-1] * 1e3, losses[-1], delta), flush=True)
        check(np.isfinite(losses[-1]), "step %d loss is not finite" % step)
        check(all(v == per_step for v in delta.values()),
              "step %d launched %s, expected %d of each" % (step, delta,
                                                            per_step))
    launches = dict(mt.kernels.LAUNCHES)
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)
    check(all(ex.arg_dict[n]._data.is_cuda
              for n in mod._exec_group.param_names),
          "the parameters left the card")
    steady = float(np.mean(times[TRAIN_WARMUP:]))
    print("train: step ms %.2f (mean of %d timed steps after %d warm-up)"
          % (steady * 1e3, TRAIN_STEPS, TRAIN_WARMUP), flush=True)
    print("train: tokens/s %.1f" % (b * s / steady), flush=True)
    print("train: peak device memory %.2f GB"
          % (torch.cuda.max_memory_allocated() / 1e9), flush=True)
    print("train: loss %.6f -> %.6f over %d steps on one batch; launches %s"
          % (losses[0], losses[-1], len(losses), launches), flush=True)
    return mod, batch, launches, losses, steady * 1e3


def extend_phase(torch, mt, train_losses, train_step_ms, profile_dir=None):
    """The user extension path at full width, with every launch count set
    to 0 before it and read after.  Returns the counts and the
    sgd_update row."""
    from mxnet_tpu_torch import rtc_kernels as rk
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    mt.kernels.reset_launches()

    # (a0) a user's imperative push: MXRtc on NDArrays, explicit 2-D dims
    x = mt.nd.NDArray(torch.randn(WIDE, generator=gen, device=device),
                      mt.gpu(0))
    y = mt.nd.ones(WIDE)
    out = mt.nd.zeros(WIDE)
    krnl = mt.rtc.MXRtc("axpy", [("x", x), ("y", y)], [("out", out)],
                        rk.AXPY_CUDA)
    grid, block = rk.axpy_dims(WIDE)
    krnl.push([x, y], [out], grid_dims=grid, block_dims=block)
    d = ulps(torch, out._data, 2.0 * x._data + 1.0)
    print("extend: axpy pushed on %s NDArrays with grid %s block %s: %d ulps "
          "from 2x + 1" % (WIDE, grid, block, d), flush=True)
    check(d == 0, "the axpy push disagrees with 2x + 1")
    del x, y, out

    # (a) sgd_update pushed over every parameter array of the LM
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    shape = (BATCH, FULL["seq_len"])
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    weights, grads = [], []
    for name, ashape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            w = torch.ones(ashape, device=device)
        elif name.endswith(("_beta", "_bias")):
            w = torch.zeros(ashape, device=device)
        else:
            w = torch.randn(ashape, generator=gen, device=device) * 0.02
        weights.append(w)
        grads.append(torch.randn(ashape, generator=gen, device=device))
    n_params = sum(w.numel() for w in weights)
    refs = [w.clone() for w in weights]
    hp = rk.sgd_hyper(SGD["lr"], SGD["rescale_grad"], SGD["wd"], device)

    def pushes():
        for w, g in zip(weights, grads):
            rk.sgd_update(w, g, hp)

    def plain():
        for w, g in zip(refs, grads):
            mt.nd.sgd_update(w, g, out=w, **SGD)

    t0 = time.perf_counter()
    pushes()  # compiles one kernel per distinct shape
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    plain()

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    ms, plain_ms = timed(pushes), timed(plain)
    t0 = time.perf_counter()  # the host's share: enqueue a pass, no sync
    pushes()
    host_us = (time.perf_counter() - t0) / len(weights) * 1e6
    torch.cuda.synchronize()
    plain()
    d = max(ulps(torch, w, r) for w, r in zip(weights, refs))
    check(d <= 1, "the sgd_update pushes disagree with sgd_update (%d ulps)"
          % d)
    lib_w = [w.clone() for w in weights]
    lib_g = [g.clone() for g in grads]
    scale = torch.tensor(1.0 / SGD["rescale_grad"], device=device)
    lib_ms = cuda_ms(lambda: torch._fused_sgd_(
        lib_w, lib_g, [], weight_decay=SGD["wd"], momentum=0.0,
        lr=SGD["lr"], dampening=0.0, nesterov=False, maximize=False,
        is_first_step=False, grad_scale=scale), 3)
    bound, by = elementwise_bound(torch, n_params, 12, 5, torch.float32)
    n_pushes = mt.kernels.LAUNCHES["rtc:sgd_update"]
    print("extend: sgd_update pushed over %d parameter arrays (%d parameters,"
          " %d distinct shapes compiled in %.2f s with the first pass): %.4f "
          "ms per pass of %d pushes (%d counted over all passes), plain "
          "sgd_update %.4f ms, torch._fused_sgd_ %.4f ms, bound %.4f ms by "
          "%s; %d ulps from sgd_update after 3 passes; %.1f us of host time "
          "per push (enqueue, not synchronized)" % (
              len(weights), n_params, len({tuple(w.shape) for w in weights}),
              first, ms, len(weights), n_pushes, plain_ms, lib_ms, bound, by,
              d, host_us),
          flush=True)
    sgd_row = {"name": "rtc:sgd_update", "route": "cuda",
               "source": RTC_SOURCE, "replaces": "mxnet_tpu/rtc.py:81",
               "launches": None,
               "max_abs_err": max((w - r).abs().max().item()
                                  for w, r in zip(weights, refs)),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": lib_ms}
    del weights, grads, refs, lib_w, lib_g
    torch.cuda.empty_cache()

    # (b) the train phase's LM with rtc_gelu in place of gelu
    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    rng = np.random.RandomState(SEED)
    X = rng.randint(0, vocab, size=(b, s)).astype(np.float32)
    Y = (X + 1) % vocab
    batch = mt.io.NDArrayIter(X, Y, batch_size=b,
                              label_name="softmax_label").next()
    with mt.NameManager():
        net = rk.with_rtc_gelu(get_transformer_lm(**FULL))
    mt.random.seed(SEED)
    mod = train_module(mt, net, None, (b, s),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34),
                       compute_dtype="bfloat16")
    per_step = FULL["num_layers"]
    names = ("rtc:gelu_fwd", "rtc:gelu_bwd", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv")
    times = []
    for step in range(EXTEND_WARMUP + EXTEND_STEPS):
        before = {n: mt.kernels.LAUNCHES.get(n, 0) for n in names}
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES.get(n, 0) - before[n] for n in names}
        loss = lm_loss(torch, mod.get_outputs()[0], Y)
        rel = abs(loss - train_losses[step]) / abs(train_losses[step])
        print("extend: rtc_gelu step %d: %.2f ms, loss %.6f (train phase "
              "%.6f, relative difference %.3g, tolerance 1e-3), launches %s"
              % (step, times[-1] * 1e3, loss, train_losses[step], rel, delta),
              flush=True)
        check(rel <= 1e-3, "step %d loss with rtc_gelu differs from the "
              "train phase's" % step)
        check(all(v == per_step for v in delta.values()),
              "step %d launched %s, expected %d of each" % (step, delta,
                                                            per_step))
    launches = dict(mt.kernels.LAUNCHES)
    if profile_dir:
        def step():
            mod.forward_backward(batch)
            mod.update()
        profile(torch, step, profile_dir, "train_step_rtc_gelu")
    steady = float(np.mean(times[EXTEND_WARMUP:])) * 1e3
    print("extend: rtc_gelu step ms %.2f (mean of %d timed steps after %d "
          "warm-up), train phase step ms %.2f (gelu)" % (
              steady, EXTEND_STEPS, EXTEND_WARMUP, train_step_ms), flush=True)
    print("extend: launches %s" % launches, flush=True)
    del mod
    torch.cuda.empty_cache()
    return launches, sgd_row


def small_agreement(mt):
    """The same small checkpoint served on the card (kernel) and on the CPU
    (plain versions) must agree."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    with mt.NameManager():
        net = get_transformer_lm(**SMALL)
    rng = np.random.default_rng(SEED + 1)
    params = lm_params(mt, net, shapes, rng, 0.3)
    tokens = rng.integers(0, SMALL["vocab_size"],
                          shapes["data"]).astype(np.float32)
    out_gpu = mt.Predictor(net, params, shapes).forward(data=tokens)[0]
    out_cpu = mt.Predictor(net, params, shapes, ctx=mt.cpu()).forward(
        data=tokens)[0]
    err = float(np.abs(out_gpu.asnumpy() - out_cpu.asnumpy()).max())
    print("check: small LM %s served on the card vs the CPU: max|d| = %.3g "
          "(tolerance 1e-4)" % (SMALL, err), flush=True)
    check(err <= 1e-4, "small LM served on the card disagrees with the CPU")


# card vs CPU training of the small LM: (init std, loss limit, limit on the
# parameters).  float32: every parameter within 1e-4 of the largest
# parameter.  bf16: the change of the parameters (after - before) within
# 3e-2 of its norm, the loss within 1e-3.  A sound run on an H100 read
# 6.4e-3 and 1.5e-4; on the CPU the port's bf16 run differs from its
# float32 run by 1.5% of the change.  A lost update moves the change error
# to 1, an lr off by 10% to about 0.1.
AGREE = {None: (0.3, 1e-4, 1e-4), "bfloat16": (0.02, 1e-3, 3e-2)}


def small_train_agreement(torch, mt, dtype, rtc_gelu=False):
    """A small LM trained 3 adam steps on the card (kernels) and on the CPU
    (plain versions) from one numpy init, in float32 or with bf16
    compute, must agree (limits in ``AGREE``); with ``rtc_gelu`` its gelu
    nodes are the user op (NVRTC kernels on the card, Python source on the
    CPU).  Adam's epsilon is 1e-4:
    with the usual 1e-8 its first steps are ±lr for any gradient, so
    roundoff in a gradient that is 0 in exact arithmetic (the key bias:
    softmax ignores a per-row shift) would become a full step of either
    sign."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    from mxnet_tpu_torch.rtc_kernels import with_rtc_gelu

    std, loss_tol, param_tol = AGREE[dtype]
    shape = (2, SMALL["seq_len"])
    with mt.NameManager():
        net = get_transformer_lm(**SMALL)
    if rtc_gelu:
        net = with_rtc_gelu(net)
    rng = np.random.default_rng(SEED + 2)
    params = lm_params(mt, net, {"data": shape, "softmax_label": shape}, rng,
                       std)
    arg_params = {k[4:]: v for k, v in params.items()}
    init = {k: v.asnumpy() for k, v in arg_params.items()}
    X = rng.integers(0, SMALL["vocab_size"], shape).astype(np.float32)
    Y = (X + 1) % SMALL["vocab_size"]
    batch = mt.io.DataBatch(data=[mt.nd.array(X, mt.cpu())],
                            label=[mt.nd.array(Y, mt.cpu())])
    runs = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        mod = train_module(mt, net, ctx, shape, arg_params=arg_params,
                           compute_dtype=dtype,
                           optimizer_params={"learning_rate": 1e-3,
                                             "epsilon": 1e-4})
        losses = []
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
            losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        args, _ = mod.get_params()
        runs[ctx.device_type] = (losses, {k: v.asnumpy()
                                          for k, v in args.items()})
    (lg, pg), (lc, pc) = runs["gpu"], runs["cpu"]
    loss_err = float((np.abs(np.array(lg) - np.array(lc)) / np.abs(lc)).max())
    change = {k: pc[k].astype(np.float64) - init[k] for k in pc}
    scale = max(float(np.abs(pc[k]).max()) for k in pc)
    moved = max(float(np.abs(c).max()) for c in change.values()) / scale
    if dtype is None:
        param_err = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc) / \
            scale
        what = "parameter error %.3g of the largest parameter" % param_err
    else:
        num = sum(float(((pg[k].astype(np.float64) - pc[k]) ** 2).sum())
                  for k in pc)
        den = sum(float((c ** 2).sum()) for c in change.values())
        param_err = (num / den) ** 0.5
        what = "parameter change error %.3g of its norm" % param_err
    print("check: small LM%s trained 3 adam steps (%s, init std %g) on the "
          "card "
          "vs the CPU: losses %s vs %s, relative loss error %.3g (tolerance "
          "%g), %s (tolerance %g; the steps moved parameters by up to %.3g "
          "of the largest)"
          % (" with rtc_gelu" if rtc_gelu else "", dtype or "float32", std,
             ["%.6f" % x for x in lg],
             ["%.6f" % x for x in lc], loss_err, loss_tol, what, param_tol,
             moved), flush=True)
    check(loss_err <= loss_tol and param_err <= param_tol,
          "small LM%s trained on the card (%s) disagrees with the CPU"
          % (" with rtc_gelu" if rtc_gelu else "", dtype or "float32"))


def register_custom_props(mt):
    """The sigmoid and softmax-loss CustomOps of tests/test_custom_op.py."""

    @mt.operator.register("_smoke_sigmoid")
    class SigmoidProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Sigmoid(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0],
                                (1.0 / (1.0 + np.exp(-x))).astype(x.dtype))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    y = out_data[0].asnumpy()
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                (g * y * (1.0 - y)).astype(y.dtype))

            return Sigmoid()

    @mt.operator.register("_smoke_softmax_loss")
    class SoftmaxLossProp(mt.operator.CustomOpProp):
        def __init__(self):
            super(SoftmaxLossProp, self).__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class SoftmaxLoss(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    e = np.exp(x - x.max(axis=1, keepdims=True))
                    self.assign(out_data[0], req[0],
                                (e / e.sum(axis=1, keepdims=True))
                                .astype(x.dtype))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    lab = in_data[1].asnumpy().astype(np.int64)
                    y = out_data[0].asnumpy().copy()
                    y[np.arange(lab.shape[0]), lab] -= 1.0
                    self.assign(in_grad[0], req[0], y)
                    self.assign(in_grad[1], req[1],
                                np.zeros_like(in_data[1].asnumpy()))

            return SoftmaxLoss()


def custom_op_agreement(mt):
    """A net with the CustomOp sigmoid and softmax loss, trained 3 SGD
    steps through Module on the card and on the CPU from one numpy init:
    parameters within 1e-4 of the largest, outputs within 1e-4."""
    register_custom_props(mt)
    rng = np.random.default_rng(SEED + 5)
    X = rng.standard_normal((32, 10), dtype=np.float32)
    L = rng.integers(0, 3, 32).astype(np.float32)
    init = {"fc1_weight": rng.standard_normal((16, 10), dtype=np.float32) * .3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.standard_normal((3, 16), dtype=np.float32) * .3,
            "fc2_bias": np.zeros(3, np.float32)}
    runs = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=16,
                                    name="fc1")
        net = mt.sym.Custom(net, op_type="_smoke_sigmoid", name="sig")
        net = mt.sym.FullyConnected(net, num_hidden=3, name="fc2")
        net = mt.sym.Custom(net, mt.sym.Variable("label"),
                            op_type="_smoke_softmax_loss", name="loss")
        mod = mt.mod.Module(net, label_names=("label",), context=ctx)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("label", L.shape)])
        mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                    for k, v in init.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                                [mt.nd.array(L, mt.cpu())])
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        runs[ctx.device_type] = (mod.get_outputs()[0].asnumpy(), {
            k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    (og, pg), (oc, pc) = runs["gpu"], runs["cpu"]
    scale = max(float(np.abs(v).max()) for v in pc.values())
    param_err = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc) / scale
    moved = max(float(np.abs(pc[k] - init[k]).max()) for k in pc)
    out_err = float(np.abs(og - oc).max())
    print("check: CustomOp sigmoid + softmax-loss net trained 3 SGD steps on "
          "the card vs the CPU: parameter error %.3g of the largest, output "
          "error %.3g (tolerance 1e-4; the steps moved parameters by up to "
          "%.3g)" % (param_err, out_err, moved), flush=True)
    check(param_err <= 1e-4 and out_err <= 1e-4 and moved > 1e-2,
          "the CustomOp net trained on the card disagrees with the CPU")


def nd_agreement(mt):
    """A few ``mt.nd`` ops and operators on the card against the CPU,
    within 1e-5 of the largest value."""
    rng = np.random.default_rng(SEED + 6)
    a_np = rng.standard_normal((64, 33), dtype=np.float32)
    b_np = rng.standard_normal((1, 33), dtype=np.float32)
    got = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        a, b = mt.nd.array(a_np, ctx), mt.nd.array(b_np, ctx)
        onehot = mt.nd.zeros((64, 40), ctx)
        mt.nd.onehot_encode(mt.nd.arange(64, ctx=ctx) % 37, onehot)
        got[ctx.device_type] = {
            "exp": mt.nd.exp(a), "broadcast_add": mt.nd.broadcast_add(a, b),
            "sum": mt.nd.sum(a, axis=1), "softmax": mt.nd.softmax(a),
            "arith": (a * 2.0 - b) / (abs(a) + 1.0), "compare": a > b,
            "add_n": mt.nd.add_n(a, a, a), "norm": mt.nd.norm(a),
            "argmax": mt.nd.argmax(a, axis=0), "onehot": onehot,
            "gelu": mt.nd.gelu(a), "T": a.T.copy()}
    errs = {}
    for name, ref in got["cpu"].items():
        on_card = got["gpu"][name]
        check(on_card.context == mt.gpu(0), "nd.%s ran on %s"
              % (name, on_card.context))
        r = ref.asnumpy()
        errs[name] = float(np.abs(on_card.asnumpy() - r).max()) / max(
            float(np.abs(r).max()), 1e-30)
    print("check: mt.nd ops on the card vs the CPU, max|err|/max|ref|: %s "
          "(tolerance 1e-5)" % {k: float("%.3g" % v) for k, v in
                                errs.items()}, flush=True)
    check(all(e <= 1e-5 for e in errs.values()),
          "mt.nd ops on the card disagree with the CPU")


def device_op_group(event):
    """The group a device op of a profiler trace counts under."""
    name = event["name"]
    for key, group in (("gelu_fwd", "rtc:gelu_fwd"),
                       ("gelu_bwd", "rtc:gelu_bwd"),
                       ("flash_bwd_dkv", "K3 flash_bwd_dkv"),
                       ("flash_bwd_dq", "K2 flash_bwd_dq"),
                       ("flash_fwd", "K1 flash_fwd")):
        if key in name:
            return group
    if event.get("cat") != "kernel":
        return event["cat"]
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "GEMM (cuBLAS)"
    for key, group in (("reduce", "reductions"), ("softmax", "softmax"),
                       ("index", "gather/scatter"),
                       ("gather", "gather/scatter"),
                       ("scatter", "gather/scatter")):
        if key in low:
            return group
    return "elementwise"


def profile(torch, fn, outdir, label):
    """Run ``fn`` once under torch.profiler: device time by kernel name
    (table in DIR/<label>.txt, timeline in DIR/<label>.json; the groups
    printed) and the device's idle share between the first and the last
    device op."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    os.makedirs(outdir, exist_ok=True)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30)
    with open(os.path.join(outdir, label + ".txt"), "w") as f:
        f.write(table)
    trace = os.path.join(outdir, label + ".json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span = max(e["ts"] + e["dur"] for e in events) - \
        min(e["ts"] for e in events)
    busy = sum(e["dur"] for e in events)
    groups = {}
    for e in events:
        group = device_op_group(e)
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e["dur"] / 1e3, n + 1)
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print("profile %s: %-26s %10.3f ms %7.2f%% %5d ops"
              % (label, group, ms, 100 * ms * 1e3 / busy, n), flush=True)
    print("profile %s: %d device ops, busy %.1f us of a %.1f us span: idle "
          "share %.4f" % (label, len(events), busy, span, 1 - busy / span),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra request, one extra train step and "
                         "one extra rtc_gelu train step with torch.profiler")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a machine with an NVIDIA card")
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import attention as att

    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)
    secs = mt.kernels.build_all()
    print("build: %s built in %.2f s" % (
        sorted(set(mt.kernels.SOURCES.values())), secs), flush=True)
    print("build: NVRTC %d.%d from %s, options %s" % (
        mt.cuda_rtc.nvrtc_version() + (mt.cuda_rtc._LIBS["nvrtc"]._name,
                                       " ".join(mt.cuda_rtc.nvrtc_options()))),
          flush=True)
    for source, log in sorted(mt.kernels.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or \
                    "Compiling entry" in line:
                print("  ptxas %s: %s" % (source, line.strip()), flush=True)

    rows = kernel_phase(torch, att, torch.device("cuda", 0))
    rtc_rows = rtc_kernel_phase(torch, mt, torch.device("cuda", 0))
    pred, tokens = serve_phase(torch, mt)
    mod, batch, launches, losses, step_ms = train_phase(torch, mt)
    for name in mt.kernels.SOURCES:
        check(launches[name] > 0, "the training path never launched %s"
              % name)
    for r in rows:
        r["launches"] = launches[r["name"]]
    step_paths(torch, mod, batch)
    if opts.profile:
        profile(torch, lambda: pred.forward(data=tokens), opts.profile,
                "serve_request")

        def step():
            mod.forward_backward(batch)
            mod.update()
        profile(torch, step, opts.profile, "train_step")
    del pred, mod, batch
    torch.cuda.empty_cache()
    ext_launches, sgd_row = extend_phase(torch, mt, losses, step_ms,
                                         opts.profile)
    rtc_rows.insert(1, sgd_row)
    for r in rtc_rows:
        r["launches"] = ext_launches.get(r["name"], 0)
        check(r["launches"] > 0, "the extension path never launched %s"
              % r["name"])
    rows += rtc_rows
    small_agreement(mt)
    for dtype in (None, "bfloat16"):
        small_train_agreement(torch, mt, dtype)
    small_train_agreement(torch, mt, None, rtc_gelu=True)
    custom_op_agreement(mt)
    nd_agreement(mt)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
