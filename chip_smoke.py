#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --parent-csrc DIR [--parent-csrc DIR ...]
                                           # also hold the bf16 K1 and
                                           # split-P of other versions'
                                           # csrc (flash_fwd.cu and its
                                           # headers) against these, bits
                                           # and time, at every bf16 case
                                           # of the main length, after the
                                           # kernel table is timed
    python3 chip_smoke.py --profile DIR    # also trace one extra request
                                           # (its K1 the split-TF32 kernel),
                                           # one extra train step (its K1
                                           # must be the tensor-core
                                           # kernel), one extra float32
                                           # step (its K1/K2/K3 the
                                           # split-TF32 kernels), one extra
                                           # splash step
                                           # (its K1 the split-P variant)
                                           # and one extra rtc_gelu step

Phases, each fatal on failure (non-zero exit, no result line):

1. build   — compile every CUDA kernel of the ported paths from
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
             source, all started together (and beside them each
             ``--parent-csrc`` build of flash_fwd.cu); print ptxas's
             registers,
             shared memory and spills (a spill is fatal, and so are wgmmas
             that ptxas serialized), and the count of
             tensor-core instructions in each attention kernel from
             ``cuobjdump -sass``: ``HGMMA`` (wgmma) and ``HMMA``
             (mma.sync, which the float32 K2/K3 issue at the width 256);
             an instantiation without any is
             fatal: it would not run on the tensor cores (K1 plain and
             split-P in bf16, K1, K2 and K3 in both dtypes, at the widths
             64, 128 and 256);
             load NVRTC (a missing libnvrtc is fatal) and print its
             version;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at several shapes and both dtypes, the main paths' own shapes
             included: K1 (flash forward) on O and lse, K2/K3 (flash
             backward) on dQ, dK and dV, with bf16 cases for the tensor-core
             tiling (ragged, sq != sk, causal and full, packed and
             contiguous views, d=64 at the main length), and at the main
             length (b=4, s=4096) the main path's shape and the head dims
             32, 96 and 256 (64/16/8 heads) in float32 and bf16.  At each
             of those, repeated launches of K1, K2 and K3 give the same
             bits; at each float32 one the split-TF32 K1's mean error on
             O, and K2/K3's on dQ, dK, dV, against a float64 forward and
             backward (batch 0, two heads) is at most 8x the plain float32
             version's; at each bf16 one K1's split-P
             variant (splash's forward: P kept
             at float32 precision for P V), on a pre-scaled q at scale 1,
             must agree with the plain version and have at most half the
             mean error of plain K1 on the same inputs; a view that breaks
             the TMA rule must raise ``MXNetError`` in the forward and the
             backward.  Each of those shapes is timed beside its bound,
             the plain versions and the library calls
             (``scaled_dot_product_attention`` forward and backward, timed
             only as yardsticks).  Then the user kernels of
             ``mxnet_tpu_torch/rtc_kernels.py``, compiled by ``MXRtc`` with
             NVRTC: axpy (2-D launch), sgd_update, gelu_fwd and gelu_bwd
             (float32 and bf16) at ragged and full-width shapes and on an
             odd length and a misaligned view, timed beside their bytes
             bound, the plain versions and the library calls (``F.gelu``
             and its backward, ``torch.add``);
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
             then the same LM, init and batch in float32 (``Module``'s
             default ``compute_dtype``), 2 warm-up and 3 timed steps: each
             launches K1, K2 and K3 (split TF32) once per layer, the loss
             falls, and neither of PyTorch's TF32 flags is on;
5. replay  — the train phase's first 3 steps again in a new Module from
             its initial parameters and batch: every loss and parameter
             the same bits; then once more under
             ``torch.use_deterministic_algorithms(True, warn_only=True)``,
             printing the ops it alerts on, with the same bits;
6. splash  — ``get_transformer_lm(attn_impl="splash")`` at the same
             geometry, trained 2 + 5 steps from the train phase's init and
             batch: each step launches K1 split-P, K2 and K3 once per
             layer, its step-0 loss within 1e-3 of the flash LM's; then one
             float32 request on the serve phase's weights within 1e-4 of
             the flash LM's answer;
7. extend  — the user extension path at full width: an axpy pushed
             through ``mt.rtc.MXRtc`` on NDArrays with explicit launch dims;
             ``sgd_update`` pushed over every parameter array of the LM
             (441,646,336 parameters) against the port's ``sgd_update`` on
             copies, its host time per push and a pass's device time beside
             ``torch._fused_sgd_``, and one pass under cProfile (host time
             per push by function); the train phase's LM with its six
             gelu nodes swapped for the user op ``rtc_gelu`` in the symbol
             JSON, trained 2 + 3
             steps: each step launches gelu_fwd, gelu_bwd and K1-K3 six
             times, and its loss matches the train phase's loss at that step;
8. agree   — a small LM served, and trained 3 adam steps in float32 and in
             bf16, on the card and on the CPU from one numpy init, must
             agree; so must the small splash LM (s=128), small LMs at head
             dims 32, 96 and 256, the small LM with ``rtc_gelu``, a net
             with the ``CustomOp`` sigmoid and softmax loss, and a few
             ``mt.nd`` ops; and a recorded reading (``spread_witness``) of
             how far one float32 ulp of the init moves the d=256 LM.

The second-to-last lines are the kernel table as JSON and the card's name
and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import argparse
import json
import os
import re
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
# the agree phase's other small LMs: head dims 32, 96, 256 (flash; trained
# at the init spread of the CPU tests' 64-wide LM, std 0.3 * sqrt(64 /
# hidden): at SMALL's spread three float32 steps of the 256-wide LM took
# the loss from 8.09 to 3.14 and amplified summation order to 1.06e-4 of
# the largest parameter, with K1-K3 at d=256 within 8e-7 of their plain
# versions) and the splash LM (its sequence a multiple of 128)
SMALL_HEAD_DIMS = {32: dict(SMALL, num_heads=4), 96: dict(SMALL, hidden=192),
                   256: dict(SMALL, num_heads=1, hidden=256)}
SMALL_SPLASH = dict(SMALL, seq_len=128, attn_impl="splash")
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_LR = 2, 5, 3e-4
F32_WARMUP, F32_STEPS = 2, 3  # the float32 train phase
REPLAY_STEPS = 3
SOURCE_DIR = "mxnet_tpu_torch/csrc/"
# the TPU kernel each CUDA kernel replaces (the split-P K1 serves splash,
# upstream JAX's Pallas kernel, reached from the repo at attention.py:604)
REPLACES = {"flash_fwd": "mxnet_tpu/ops/attention.py:97",
            "flash_fwd_splitp": "mxnet_tpu/ops/attention.py:604",
            "flash_bwd_dq": "mxnet_tpu/ops/attention.py:216",
            "flash_bwd_dkv": "mxnet_tpu/ops/attention.py:262"}
RTC_SOURCE = "mxnet_tpu_torch/rtc_kernels.py"
AXPY_PY_SRC = """
def kernel(x_ref, out_ref):
    out_ref[...] = 2.0 * x_ref[...]
"""
EXTEND_WARMUP, EXTEND_STEPS = 2, 3
# the user kernels' full-width shape: the gelu input of the train phase's
# LM, (batch x seq, 4 x hidden)
WIDE = (BATCH * FULL["seq_len"], 4 * FULL["hidden"])
# sgd_update's hyperparameters in the extend phase, and the passes over
# the LM's arrays whose enqueue is timed for the host time per push
SGD = dict(lr=0.01, rescale_grad=1.0 / BATCH, wd=1e-4)
HOST_PASSES = 3

# Data-sheet peaks per H100 variant (dense): float32 on the CUDA cores, bf16
# and TF32 (half of bf16) on the tensor cores (TFLOP/s), device memory
# (TB/s).  nvidia-smi names the SXM part "NVIDIA H100 80GB HBM3", so SXM is
# the fallback.
PEAKS = {
    "H100 PCIe": {"float32": 51.0, "bfloat16": 756.0, "tf32": 378.0,
                  "tbs": 2.0},
    "H100 NVL": {"float32": 60.0, "bfloat16": 835.0, "tf32": 417.5,
                 "tbs": 3.9},
    "H100 SXM": {"float32": 67.0, "bfloat16": 989.0, "tf32": 495.0,
                 "tbs": 3.35},
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


def bound_ms(torch, work, dtype, products=False, cuda_cores=False):
    """(bound ms, what bounds it): the larger of the work's operations
    over the card's peak for ``dtype`` and its bytes over memory rate.
    float32 matrix ``products`` are bounded on the tensor cores by the
    split-TF32 product, three TF32 operations per operation ("operations
    (3xTF32)" in the printed lines; "operations" in the kernel table);
    ``cuda_cores`` bounds them at the float32 CUDA-core peak instead, the
    bound of the tables before that route."""
    _, peak = peaks_for(torch.cuda.get_device_name(0))
    flops, nbytes = work
    if dtype == torch.bfloat16:
        t_ops = flops / (peak["bfloat16"] * 1e12) * 1e3
    elif products and not cuda_cores:
        t_ops = 3 * flops / (peak["tf32"] * 1e12) * 1e3
    else:
        t_ops = flops / (peak["float32"] * 1e12) * 1e3
    t_bytes = nbytes / (peak["tbs"] * 1e12) * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def qkv_views(torch, gen, b, sq, sk, h, d, dtype, device, packed=True):
    """q, k, v as the LM hands them to the kernels: strided views of one
    packed [b, s, 3, h, d] projection when sq == sk (and ``packed``), else
    three contiguous tensors."""
    if packed and sq == sk:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device=device)
        return tuple(t.squeeze(2) for t in qkv.to(dtype).split(1, dim=2))
    mk = lambda s: torch.randn((b, s, h, d), generator=gen,  # noqa: E731
                               device=device).to(dtype)
    return mk(sq), mk(sk), mk(sk)


def rel_err(torch, got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


# the head dims the kernels take besides the main path's, at the main
# length: (heads, d), b = BATCH, s = 4096
HEAD_DIM_CASES = ((64, 32), (16, 96), (8, 256))


def kernel_phase(torch, att, device, parents=()):
    """K1 against the plain forward (O, lse) and K2/K3 against the plain
    backward (dQ, dK, dV) at every case.  The cases "timed" are those at
    the main length: the main path's shape and the head dims of
    ``HEAD_DIM_CASES``, each in float32 and bf16, and d=64 in bf16; at each
    one, two launches of each kernel give the same bits
    (``repeat_check``); at each bf16 one K1's split-P variant is held to
    what it adds (``splitp_check``), at each float32 one the split-TF32
    K2/K3 to a float64 truth (``precision_check``).  Then every timed case beside its bound, its
    plain version and SDPA (``time_case``), and after all of them, at each
    bf16 case, the comparison with the ``--parent-csrc`` builds
    (``parent_lines``), so that their longer load does not set the clock
    the table is timed at.
    Returns (the rows of the main
    path's shape in bf16 keyed by kernel, the other rows keyed (kernel, d,
    dtype): the main shape in float32 (the float32 train phase's) and the
    head dims)."""
    f32, bf16 = torch.float32, torch.bfloat16
    h_main, s = FULL["num_heads"], FULL["seq_len"]
    d_main = FULL["hidden"] // h_main
    cases = [  # name, b, sq, sk, h, d, causal, dtype[, packed]
        ("f32 causal d64", 2, 256, 256, 4, 64, True, f32),
        ("f32 full d64", 2, 256, 256, 4, 64, False, f32),
        ("f32 causal sq<sk d128 ragged", 2, 200, 333, 4, 128, True, f32),
        ("f32 full sq>sk d128 ragged", 2, 333, 200, 4, 128, False, f32),
        ("f32 causal sq>sk d64", 1, 300, 100, 2, 64, True, f32),
        ("bf16 causal d128", 2, 512, 512, 4, 128, True, bf16),
        ("bf16 full sq<sk d64", 2, 192, 320, 4, 64, False, bf16),
        ("bf16 causal sq>sk d128 ragged", 2, 333, 200, 4, 128, True, bf16),
        # the tensor-core kernels' tiling: 128 resident rows per block (two
        # warpgroups of 64), streamed tiles of 128 keys (K1) or 64 rows
        # (K2/K3)
        ("bf16 causal d64 tiny ragged", 1, 17, 17, 2, 64, True, bf16),
        ("bf16 full d64 tiny ragged", 1, 17, 17, 2, 64, False, bf16),
        ("bf16 causal d128 ragged", 2, 333, 333, 4, 128, True, bf16),
        ("bf16 full d128 ragged", 2, 333, 333, 4, 128, False, bf16),
        ("bf16 causal sq<sk d64 ragged", 2, 200, 333, 4, 64, True, bf16),
        ("bf16 full sq>sk d64 ragged", 2, 333, 200, 4, 64, False, bf16),
        ("bf16 causal d128 contiguous", 2, 320, 320, 4, 128, True, bf16,
         False),
        ("bf16 causal d64 main length", BATCH, s, s, 16, 64, True, bf16),
    ]
    for h, d in ((h_main, d_main),) + HEAD_DIM_CASES:
        what = "main-path shape" if d == d_main else "head dim %d" % d
        cases += [("%s causal %s" % (tag, what), BATCH, s, s, h, d, True,
                   dtype) for dtype, tag in ((f32, "f32"), (bf16, "bf16"))]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    timed = {}
    for name, b, sq, sk, h, d, causal, dtype, *packed in cases:
        fwd_tol = 1e-4 if dtype == f32 else 2e-2  # abs, O and lse
        bwd_tol = 1e-4 if dtype == f32 else 2e-2  # relative to max |ref|
        q, k, v = qkv_views(torch, gen, b, sq, sk, h, d, dtype, device,
                            *packed)
        scale = 1.0 / np.sqrt(d)
        o, lse = att.flash_forward(q, k, v, causal, scale)
        o_ref, lse_ref = plain_forward(att, q, k, v, causal, scale)
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
        refs = plain_backward(att, q, k, v, o, lse, do, causal, scale)
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
        del grads, refs
        if b == BATCH and sq == s:
            m = dict(name=name, q=q, k=k, v=v, o=o, lse=lse, do=do,
                     scale=scale, err_o=err_o, errs=errs)
            repeat_check(torch, att, m)
            if dtype == bf16:
                m.update(splitp_check(torch, att, m))
            else:
                forward_precision_check(torch, att, m)
                precision_check(torch, att, m)
            timed[(d, dtype)] = m
    torch.cuda.empty_cache()
    tma_rule_check(torch, att, timed[(d_main, bf16)])
    variant, peak = peaks_for(torch.cuda.get_device_name(0))
    print("kernel bounds against the %s data sheet: %.0f TFLOP/s float32, "
          "%.0f TFLOP/s bf16 dense, %.1f TFLOP/s TF32 dense (float32 "
          "products: 3 TF32 operations each), %.2f TB/s" % (
              variant, peak["float32"], peak["bfloat16"], peak["tf32"],
              peak["tbs"]), flush=True)
    main_rows, dim_rows = {}, {}
    for (d, dtype), m in timed.items():
        rows = time_case(torch, att, m)
        del m["o"], m["do"]
        if dtype == f32 or not parents:
            for key in ("q", "qs", "k", "v"):
                m.pop(key, None)
        torch.cuda.empty_cache()
        if d == d_main and dtype == bf16:
            main_rows = rows  # the bf16 train, replay and splash paths
            continue
        if d not in {dim for _, dim in HEAD_DIM_CASES} | {d_main}:
            continue  # d=64 at the main length: printed only
        tag = "f32" if dtype == f32 else "bf16"
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            row = dict(rows[kernel])
            row["name"] = "%s[d=%d,%s%s]" % (
                kernel, d, tag, ",dV+dK" if kernel == "flash_bwd_dkv" and
                att.kernel_width(d) > 128 else "")
            dim_rows[(kernel, d, tag)] = row
    for (d, dtype), m in timed.items():
        if dtype == bf16 and parents:
            parent_lines(torch, att, parents, m)
            del m["q"], m["qs"], m["k"], m["v"]
    return main_rows, dim_rows


def repeat_check(torch, att, m):
    """Two launches of K1, K2 and K3 on one bf16 case give the same bits as
    the case's own (no atomics)."""
    q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o", "lse",
                                                  "do", "scale"))
    runs = [att.flash_forward(q, k, v, True, scale) for _ in range(2)]
    same = [torch.equal(a, b) for a, b in zip(*runs)] + \
        [torch.equal(runs[0][0], o), torch.equal(runs[0][1], lse)]
    del runs
    delta = att._row_delta(o, do).contiguous()
    runs = [(att.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),)
            + att.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    same += [torch.equal(a, b) for a, b in zip(*runs)]
    print("kernel [%s], two launches of K1 (and the case's own), K2, K3: o, "
          "lse (, o, lse), dq, dk, dv bitwise equal %s" % (m["name"], same),
          flush=True)
    check(all(same), "repeated launches differ in case %s" % m["name"])


def backward_f64(torch, q, k, v, o, lse, do, scale):
    """The causal attention backward in float64 from float32 inputs and the
    forward's lse (natural log): the truth ``precision_check`` measures
    against (``attention_backward_reference`` computes in float32)."""
    b, s, h, _ = q.shape
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                  - lse.double().reshape(b, h, s, 1))
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(b, h, s, 1)
    ds = p * (dp - delta) * scale
    del p, dp
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q), dv)


# the split-TF32 K2/K3's mean |error| against float64 may be at most this
# many times the plain float32 version's (one TF32 product reads ~1000x)
SPLIT_MEAN_LIMIT = 8.0


def precision_check(torch, att, m):
    """The split-TF32 K2/K3 of one float32 case against a float64 backward
    on batch 0, heads 0 and 1: the mean |error| of dQ, dK and dV at most
    ``SPLIT_MEAN_LIMIT`` times that of the plain float32 version on the same
    inputs.  The 1e-4 limit on max |err| / max |ref| does not tell a split
    product from a float32 one; this does."""
    cut = (slice(0, 1), slice(None), slice(0, 2))
    q, k, v, o, do = (m[x][cut] for x in ("q", "k", "v", "o", "do"))
    b, s, h, _ = m["q"].shape
    lse = m["lse"].view(b, h, s)[0:1, 0:2].reshape(2, s).contiguous()
    got = att.flash_backward(q, k, v, o, lse, do, True, m["scale"])
    plain = att.attention_backward_reference(q, k, v, o, lse, do, True,
                                             m["scale"])
    truth = backward_f64(torch, q, k, v, o, lse, do, m["scale"])
    ratios = {}
    for name, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        ka = (a.double() - t).abs().mean().item()
        pa = (p.double() - t).abs().mean().item()
        ratios[name] = (ka, pa, ka / max(pa, 1e-300))
    print("kernel flash_bwd [%s] batch 0, heads 0-1 against a float64 "
          "backward: mean|err| kernel / plain float32 %s (limit %g)"
          % (m["name"], ", ".join("%s %.4g / %.4g = %.3g" % (n, *r)
                                  for n, r in ratios.items()),
             SPLIT_MEAN_LIMIT), flush=True)
    check(all(r[2] <= SPLIT_MEAN_LIMIT for r in ratios.values()),
          "the split-TF32 backward is not of float32 precision in case %s"
          % m["name"])


def forward_f64(torch, q, k, v, scale):
    """The causal attention forward in float64 from float32 inputs: (o,
    lse in natural log), the truth ``forward_precision_check`` measures
    against (``attention_reference`` computes in float32)."""
    b, s, h, _ = q.shape
    q, k, v = (t.double() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    mx = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - mx)
    del sc
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / den, v)
    return o, (mx + torch.log(den)).reshape(b * h, s)


def forward_precision_check(torch, att, m):
    """The split-TF32 K1 of one float32 case against a float64 forward on
    batch 0, heads 0 and 1: max |error| on O and lse at most 1e-4, and the
    mean |error| of O at most ``SPLIT_MEAN_LIMIT`` times that of the plain
    float32 version on the same inputs (which one TF32 product breaks)."""
    cut = (slice(0, 1), slice(None), slice(0, 2))
    q, k, v = (m[x][cut] for x in ("q", "k", "v"))
    got = att.flash_forward(q, k, v, True, m["scale"])
    plain = att.attention_reference(q, k, v, True, m["scale"])
    truth = forward_f64(torch, q, k, v, m["scale"])
    errs = {}
    for name, a, p, t in zip(("o", "lse"), got, plain, truth):
        errs[name] = ((a.double() - t).abs().max().item(),
                      (a.double() - t).abs().mean().item(),
                      (p.double() - t).abs().mean().item())
    ratio = errs["o"][1] / max(errs["o"][2], 1e-300)
    print("kernel flash_fwd [%s] batch 0, heads 0-1 against a float64 "
          "forward: max|err| o %.3g lse %.3g (tolerance 1e-4); mean|err| "
          "kernel / plain float32 o %.4g / %.4g = %.3g (limit %g), lse "
          "%.4g / %.4g" % (m["name"], errs["o"][0], errs["lse"][0],
                           errs["o"][1], errs["o"][2], ratio,
                           SPLIT_MEAN_LIMIT, errs["lse"][1], errs["lse"][2]),
          flush=True)
    check(errs["o"][0] <= 1e-4 and errs["lse"][0] <= 1e-4,
          "the split-TF32 forward is off a float64 forward in case %s"
          % m["name"])
    check(ratio <= SPLIT_MEAN_LIMIT, "the split-TF32 forward is not of "
          "float32 precision in case %s" % m["name"])


def splitp_check(torch, att, m):
    """K1's split-P variant as splash runs it (q pre-scaled in bf16, scale
    1) against the plain version (P in float32), and what it adds: it
    exists to keep P at float32 precision in P·V, which the limit on O
    (2e-2 abs, one bf16 rounding of O at its largest) cannot show, since
    plain K1, which rounds P to bf16, passes it too.  So its mean |error|
    over O must be at most half that of plain K1 on the same inputs; lse
    within 1e-4; two launches give the same bits.  Returns the pre-scaled q
    and its max|error| on O."""
    from mxnet_tpu_torch.kernels import LAUNCHES

    q, k, v, scale = m["q"], m["k"], m["v"], m["scale"]
    qs = q * torch.tensor(scale, dtype=q.dtype)
    before = LAUNCHES["flash_fwd_splitp"]
    o, lse = att.flash_forward(qs, k, v, True, 1.0, split_p=True)
    check(LAUNCHES["flash_fwd_splitp"] == before + 1,
          "split_p=True did not launch flash_fwd_splitp")
    o_k1, _ = att.flash_forward(qs, k, v, True, 1.0)
    again = att.flash_forward(qs, k, v, True, 1.0, split_p=True)
    o_ref, lse_ref = plain_forward(att, qs, k, v, True, 1.0)
    torch.cuda.synchronize()
    err = {}
    for what, got in (("split-P", o), ("K1", o_k1)):
        diff = (got.float() - o_ref.float()).abs()
        err[what] = (diff.max().item(), diff.mean().item())
        del diff
    err_l = (lse - lse_ref).abs().max().item()
    same = [torch.equal(again[0], o), torch.equal(again[1], lse)]
    ratio = err["split-P"][1] / max(err["K1"][1], 1e-30)
    print("kernel flash_fwd_splitp [%s] (q pre-scaled, scale 1): max|dO| "
          "%.3g, mean|dO| %.4g; K1 with P rounded on the same inputs: max|dO| "
          "%.3g, mean|dO| %.4g; mean ratio %.3g (limit 0.5); max|dlse| %.3g "
          "(tolerance 2e-2 on O, 1e-4 on lse); two launches bitwise equal %s"
          % (m["name"], err["split-P"][0], err["split-P"][1], err["K1"][0],
             err["K1"][1], ratio, err_l, same), flush=True)
    check(err["split-P"][0] <= 2e-2 and err_l <= 1e-4,
          "flash_fwd_splitp disagrees with its plain version in case %s"
          % m["name"])
    check(ratio <= 0.5, "flash_fwd_splitp is not closer than K1 to P in "
          "float32 in case %s: its mean error is %.3g of K1's"
          % (m["name"], ratio))
    check(all(same), "repeated flash_fwd_splitp launches differ in case %s"
          % m["name"])
    return {"qs": qs, "err_sp": err["split-P"][0]}


def time_case(torch, att, m):
    """K1, K2, K3 (and for bf16 the split-P K1 on the pre-scaled q) of one
    timed case beside their bounds (counted at the real d: columns padded
    to the kernels' width are waste), the plain versions and SDPA.  Returns
    the rows keyed by kernel name."""
    from mxnet_tpu_torch.kernels import SOURCES

    q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o", "lse",
                                                  "do", "scale"))
    b, s, h, d = q.shape
    dtype = q.dtype
    sdpa = torch.nn.functional.scaled_dot_product_attention
    delta = att._row_delta(o, do).contiguous()
    t = {"fwd": cuda_ms(lambda: att.flash_forward(q, k, v, True, scale), 20),
         "bwd_dq": cuda_ms(lambda: att.flash_bwd_dq(
             q, k, v, do, lse, delta, True, scale), 3),
         "bwd_dkv": cuda_ms(lambda: att.flash_bwd_dkv(
             q, k, v, do, lse, delta, True, scale), 3),
         "bwd": cuda_ms(lambda: att.flash_backward(
             q, k, v, o, lse, do, True, scale), 3),
         "fwd_plain": cuda_ms(lambda: plain_forward(att, q, k, v, True,
                                                    scale), 1),
         "bwd_plain": cuda_ms(lambda: plain_backward(
             att, q, k, v, o, lse, do, True, scale), 1)}
    torch.cuda.empty_cache()
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    t["fwd_lib"] = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        scale=scale), 20)
    out = sdpa(qt, kt, vt, is_causal=True, scale=scale)
    t["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 3)
    del out, qt, kt, vt
    size = torch.tensor([], dtype=dtype).element_size()
    work = {kind: attention_work(kind, b, s, s, h, d, True, size)
            for kind in ("fwd", "bwd_dq", "bwd_dkv", "bwd")}
    bound = {kind: bound_ms(torch, w, dtype, products=True)
             for kind, w in work.items()}
    tflops = {kind: work[kind][0] / (t[kind] * 1e-3) / 1e12 for kind in work}
    pair = t["bwd_dq"] + t["bwd_dkv"]
    ops14 = work["bwd_dq"][0] + work["bwd_dkv"][0]
    two = att.kernel_width(d) > 128
    print("kernel timing [%s] b=%d s=%d h=%d d=%d (runs at width %d) causal: "
          "K1 %.4f ms (plain %.4f, sdpa fwd %.4f, %.2fx it, bound %.4f by %s, "
          "%.2f TFLOP/s on the 4·d count at the real d); K2 %.4f ms (bound "
          "%.4f by %s); K3 %.4f ms%s (bound %.4f by %s); K2+K3 %.4f ms "
          "(%.2f TFLOP/s on the 14·d count, split kernels' bound %.4f ms; "
          "%.2f TFLOP/s on the 10·d count), %.2fx sdpa bwd %.4f ms; "
          "flash_backward with Δ %.4f ms (bound %.4f by %s), plain %.4f ms"
          % (m["name"], b, s, h, d, att.kernel_width(d), t["fwd"],
             t["fwd_plain"], t["fwd_lib"], t["fwd"] / t["fwd_lib"],
             bound["fwd"][0], bound["fwd"][1], tflops["fwd"], t["bwd_dq"],
             bound["bwd_dq"][0], bound["bwd_dq"][1], t["bwd_dkv"],
             " (two launches: dV, then dK)" if two else "",
             bound["bwd_dkv"][0], bound["bwd_dkv"][1], pair,
             ops14 / (pair * 1e-3) / 1e12,
             bound_ms(torch, (ops14, 0.0), dtype, products=True)[0],
             work["bwd"][0] / (pair * 1e-3) / 1e12, pair / t["bwd_lib"],
             t["bwd_lib"], t["bwd"], bound["bwd"][0], bound["bwd"][1],
             t["bwd_plain"]), flush=True)
    if dtype == torch.float32:
        # the share of the 3xTF32 bound beside that of the CUDA-core bound
        # the tables used before the float32 backward took the tensor cores
        old = {kind: bound_ms(torch, w, dtype, products=True,
                              cuda_cores=True)[0] for kind, w in work.items()}
        print("kernel timing [%s] share of the bound by operations (3xTF32) "
              "/ by the float32 CUDA-core peak: K1 %.1f%% / %.1f%%, K2 %.1f%% "
              "/ %.1f%%, K3 %.1f%% / %.1f%%, K2+K3 %.1f%% / %.1f%%" % (
                  m["name"], *(100 * x for kind in ("fwd", "bwd_dq",
                                                    "bwd_dkv")
                               for x in (bound[kind][0] / t[kind],
                                         old[kind] / t[kind])),
                  100 * (bound["bwd_dq"][0] + bound["bwd_dkv"][0]) / pair,
                  100 * (old["bwd_dq"] + old["bwd_dkv"]) / pair), flush=True)

    def row(name, kind, err, plain, lib, ms=None):
        return {"name": name, "route": "cuda",
                "source": SOURCE_DIR + SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": err, "ms": t[kind] if ms is None else ms,
                "plain_ms": plain, "bound_ms": bound[kind][0],
                "bound_by": bound[kind][1], "library_ms": lib}

    errs = m["errs"]
    rows = {
        "flash_fwd": row("flash_fwd", "fwd", m["err_o"], t["fwd_plain"],
                         t["fwd_lib"]),
        # one library call computes dQ, dK and dV together: SDPA's backward
        # is the yardstick of both rows, against K2 + K3
        "flash_bwd_dq": row("flash_bwd_dq", "bwd_dq", errs["dq"][0],
                            t["bwd_plain"], t["bwd_lib"]),
        "flash_bwd_dkv": row("flash_bwd_dkv", "bwd_dkv",
                             max(errs["dk"][0], errs["dv"][0]),
                             t["bwd_plain"], t["bwd_lib"]),
    }
    if dtype == torch.bfloat16:
        qs = m["qs"]
        ms = cuda_ms(lambda: att.flash_forward(qs, k, v, True, 1.0,
                                               split_p=True), 20)
        k1_ms = cuda_ms(lambda: att.flash_forward(qs, k, v, True, 1.0), 20)
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))
        lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=1.0), 20)
        plain = cuda_ms(lambda: plain_forward(att, qs, k, v, True, 1.0), 1)
        # split-P issues 6·d operations per visible pair (P_hi V and P_lo
        # V), where the function needs 4·d
        print("kernel timing [%s] flash_fwd_splitp on the pre-scaled q: %.4f "
              "ms (%.2f TFLOP/s on the 4·d count, %.2f on the 6·d count it "
              "issues: bounds %.4f / %.4f ms), K1 on the same inputs %.4f ms "
              "(%+.1f%%), sdpa fwd at scale 1 %.4f ms (%.2fx it), plain %.4f "
              "ms" % (m["name"], ms, work["fwd"][0] / (ms * 1e-3) / 1e12,
                      1.5 * work["fwd"][0] / (ms * 1e-3) / 1e12,
                      bound["fwd"][0],
                      bound_ms(torch, (1.5 * work["fwd"][0], work["fwd"][1]),
                               dtype)[0], k1_ms, 100 * (ms / k1_ms - 1), lib,
                      ms / lib, plain), flush=True)
        rows["flash_fwd_splitp"] = row("flash_fwd_splitp", "fwd",
                                       m["err_sp"], plain, lib, ms)
        del qt, kt, vt
    return rows


def tma_rule_check(torch, att, m):
    """A bf16 view that breaks the TMA rule raises ``MXNetError`` without a
    launch (no copy, no fallback), in the forward and in the backward."""
    from mxnet_tpu_torch import MXNetError, kernels

    q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o", "lse",
                                                  "do", "scale"))
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    shifted = flat[1:].view(q.shape)  # base 2 bytes past a 16-byte boundary
    for what, call in (
            ("flash_fwd", lambda: att.flash_forward(shifted, k, v, True,
                                                    scale)),
            ("flash_bwd", lambda: att.flash_backward(shifted, k, v, o, lse,
                                                     do, True, scale))):
        before = dict(kernels.LAUNCHES)
        try:
            call()
            raised = ""
        except MXNetError as e:
            raised = str(e)
        print("kernel %s bf16 with a misaligned q view raises: %s"
              % (what, raised[:160]), flush=True)
        check("TMA" in raised and kernels.LAUNCHES == before,
              "a misaligned bf16 view did not raise before any %s launch"
              % what)


def plain_forward(att, q, k, v, causal, scale):
    """``attention_reference`` one batch element and at most 16 heads at a
    time, so that its float32 score tensors stay near 1 GB at s = 4096."""
    import torch

    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(b):
        for j in range(0, h, 16):
            cut = (slice(i, i + 1), slice(None), slice(j, j + 16))
            o[cut], part = att.attention_reference(q[cut], k[cut], v[cut],
                                                   causal, scale)
            lse[i, j:j + 16] = part
    return o, lse.view(b * h, sq)


def plain_backward(att, q, k, v, o, lse, do, causal, scale):
    """``attention_backward_reference`` in the pieces of ``plain_forward``."""
    import torch

    b, sq, h, _ = q.shape
    lse3 = lse.view(b, h, sq)
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    for i in range(b):
        for j in range(0, h, 16):
            cut = (slice(i, i + 1), slice(None), slice(j, j + 16))
            parts = att.attention_backward_reference(
                q[cut], k[cut], v[cut], o[cut],
                lse3[i, j:j + 16].contiguous(), do[cut], causal, scale)
            for g, part in zip(grads, parts):
                g[cut] = part
    return grads


def ptxas_report(tag, log):
    """Print ptxas's registers, shared memory, spills and wgmma notes from
    a build log; returns its faults: a spill, and wgmmas that ptxas
    serialized (each product then waits for the one before it)."""
    faults = []
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or \
                "Compiling entry" in line or "setmaxnreg" in line or \
                "wgmma" in line:
            print("  ptxas %s: %s" % (tag, line.strip()), flush=True)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills and spills.groups() != ("0", "0"):
            faults.append("a kernel of %s spills registers: %s"
                          % (tag, line.strip()))
        if "instructions are serialized" in line:
            faults.append("ptxas serialized the wgmmas of a kernel of %s: %s"
                          % (tag, line.strip()))
    return faults


def fwd_entry(lib):
    """``mxtt_flash_fwd`` of another build of flash_fwd.cu, with its
    argument types."""
    import ctypes

    fn = lib.mxtt_flash_fwd
    fn.argtypes = ([ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def extra_forward(torch, att, fn, q, k, v, scale, split_p):
    """The causal bf16 forward through another build's ``mxtt_flash_fwd``
    (``fwd_entry``).  Not counted in ``LAUNCHES``: these launches only
    compare."""
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    strides = att._strides(q, k, v)
    err = fn(1, d, att.kernel_width(d), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq,
             k.shape[1], strides.data_ptr(),
             float(scale) * att._LOG2E, 1, int(split_p),
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, "flash_fwd build entry failed (cudaError %d)" % err)
    return o, lse


def in_turns(torch, calls, rounds=8, reps=10):
    """Device ms of each named call, timed in turns: ``rounds`` passes over
    the calls, in order and in reverse by turns, ``reps`` launches each per
    pass (the card's clock moves with its power draw over a pass).  Returns
    {name: (median ms, [the readings])}."""
    got = {name: [] for name, _ in calls}
    for r in range(rounds):
        for name, fn in (calls if r % 2 == 0 else calls[::-1]):
            got[name].append(cuda_ms(fn, reps))
    return {name: (float(np.median(v)), v) for name, v in got.items()}


def parent_lines(torch, att, parents, m):
    """K1 and split-P on one bf16 case against other builds of
    flash_fwd.cu (``--parent-csrc``, {label: entry}): the same bits (fatal
    for K1; printed for split-P) and the times in turns (each build and
    this one, in order and in reverse by turns)."""
    q, qs, k, v, scale = m["q"], m["qs"], m["k"], m["v"], m["scale"]
    b, s, h, d = q.shape
    flops = attention_work("fwd", b, s, s, h, d, True, 2)[0]
    for split, qq, sc in ((False, q, scale), (True, qs, 1.0)):
        what = "split-P" if split else "K1"
        mine = att.flash_forward(qq, k, v, True, sc, split_p=split)
        calls = [("this", lambda: att.flash_forward(qq, k, v, True, sc,
                                                    split_p=split))]
        same = {}
        for label, fn in parents.items():
            theirs = extra_forward(torch, att, fn, qq, k, v, sc, split)
            torch.cuda.synchronize()
            same[label] = torch.equal(mine[0], theirs[0]) and \
                torch.equal(mine[1], theirs[1])
            del theirs
            calls.append((label, lambda fn=fn: extra_forward(
                torch, att, fn, qq, k, v, sc, split)))
        del mine
        times = in_turns(torch, calls)
        this = times["this"][0]
        for label, (ms, runs) in times.items():
            print("kernel parent [%s] %s %s: %.4f ms (median of %s), %+.1f%% "
                  "against this, %.2f TFLOP/s on the 4·d count%s%s" % (
                      m["name"], what, label, ms,
                      " / ".join("%.4f" % x for x in runs),
                      100 * (ms / this - 1), flops / (ms * 1e-3) / 1e12,
                      ", %.2f on the 6·d count" % (
                          1.5 * flops / (ms * 1e-3) / 1e12) if split else "",
                      "" if label == "this" else
                      "; o, lse this build's bits %s" % same[label]),
                  flush=True)
        if not split:
            check(all(same.values()), "K1 does not give the bits of the "
                  "builds %s in case %s" % (
                      sorted(k for k, v in same.items() if not v), m["name"]))


def sass_mma(paths):
    """Tensor-core instructions per attention kernel in the libraries at
    ``paths``, from ``cuobjdump -sass``: {(kernel, template args): count},
    the args as a tuple of ints (width D, then for K1 in bf16 split-P,
    for K3 its outputs).  A
    count is of HGMMA (wgmma) or HMMA (mma.sync), whichever the kernel
    issues."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts, key = {}, None
    for path in paths:
        sass = subprocess.run([tool, "-sass", path],
                              capture_output=True, text=True,
                              check=True).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                found = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)"
                                  r"(?:_tc|_tf32)?_kernel)I((?:L[a-z]\d+E)+)E",
                                  line)
                key = (found.group(1), tuple(
                    int(a) for a in re.findall(r"L[a-z](\d+)E",
                                               found.group(2)))) \
                    if found else None
                if key:
                    counts[key] = 0
            elif key and ("HGMMA" in line or "HMMA" in line):
                counts[key] += 1
    return counts


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
    # gelu_fwd and gelu_bwd where their 16-byte vector loops do not reach:
    # an odd length (the scalar tail) and contiguous views one element (2
    # bytes in bf16, 4 in float32) past a 16-byte boundary (every element
    # by the scalar loop)
    for dtype in (bf16, f32):
        flat = randn((WIDE[0] * WIDE[1] + 1,), 3.0, dtype)
        flat_dy = randn((WIDE[0] * WIDE[1] + 1,), 1.0, dtype)
        for what, x, dy in (("odd length", flat, flat_dy),
                            ("misaligned view", flat[1:], flat_dy[1:])):
            for name, got, ref in (
                    ("gelu_fwd", rk.gelu_forward(x), rk.gelu_plain(x)),
                    ("gelu_bwd", rk.gelu_backward(x, dy),
                     rk.gelu_grad_plain(x, dy))):
                d = ulps(torch, got, ref)
                rel = ((got.float() - ref.float()).abs().max()
                       / ref.float().abs().max()).item()
                print("kernel rtc:%s %s %s (%d elements, base %% 16 = %d): "
                      "%d ulps, max|err|/max|ref| %.3g (tolerance %s)"
                      % (name, str(dtype)[6:], what, x.numel(),
                         x.data_ptr() % 16, d, rel,
                         "1 ulp" if dtype == bf16 else "1e-6"), flush=True)
                check(d <= 1 if dtype == bf16 else rel <= 1e-6,
                      "rtc:%s disagrees with its plain version on the %s %s"
                      % (name, str(dtype)[6:], what))
                del got, ref
        del flat, flat_dy, x, dy
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
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print("kernel rtc:gelu_fwd and gelu_bwd %s bf16 launch dims (grid, "
          "block) %s on %d SMs" % (WIDE, rk.gelu_dims(n, 2, sms), sms),
          flush=True)
    del x, dy
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


# the label is bound too (as zeros): its shape cannot be inferred back
# through the symbol's Reshape, in this package or the JAX one
SERVE_SHAPES = {"data": (BATCH, FULL["seq_len"]),
                "softmax_label": (BATCH, FULL["seq_len"])}


def serve_inputs(mt, net):
    """The served LM's weights (N(0, 0.02) from SEED, as a checkpoint
    stores them) and its requests, the same for every LM of the full
    geometry whatever its attention op."""
    rng = np.random.default_rng(SEED)
    params = lm_params(mt, net, SERVE_SHAPES, rng, 0.02)
    requests = [rng.integers(0, FULL["vocab_size"], SERVE_SHAPES["data"])
                .astype(np.float32) for _ in range(REQUESTS)]
    return params, requests


def serve_phase(torch, mt):
    """Returns the Predictor, the first request and its output (on the
    host)."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    shapes = SERVE_SHAPES
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        t0 = time.perf_counter()
        params, requests = serve_inputs(mt, net)
        n_params = sum(p.size for p in params.values())
        net.save(prefix + "-symbol.json")
        mt.nd.save(prefix + "-0000.params", params)
        del params
        t1 = time.perf_counter()
        pred = mt.Predictor.from_checkpoint(prefix, 0, shapes)
        t2 = time.perf_counter()
    print("serve: %d parameters; checkpoint written in %.2f s, Predictor "
          "built in %.2f s" % (n_params, t1 - t0, t2 - t1), flush=True)

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
        if i == 0:
            first = probs.cpu()
    launches = dict(mt.kernels.LAUNCHES)
    check(launches["flash_fwd"] > 0, "the serving path never launched "
          "flash_fwd")
    steady = float(np.mean(times[1:]))
    print("serve: %d requests of %d tokens; first %.2f ms, then %.2f ms per "
          "request = %.1f tokens/s; peak device memory %.2f GB; launches %s"
          % (REQUESTS, b * s, times[0] * 1e3, steady * 1e3, b * s / steady,
             torch.cuda.max_memory_allocated() / 1e9, launches), flush=True)
    return pred, requests[0], first


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
    # the replay check's reference: the parameters before the first step
    # and after step REPLAY_STEPS
    init = param_snapshot(mod)
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
        if step + 1 == REPLAY_STEPS:
            replayed = param_snapshot(mod)
    launches = dict(mt.kernels.LAUNCHES)
    check(launches["flash_fwd_splitp"] == 0, "the flash LM launched the "
          "split-P forward")
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
    replay = {"net": net, "init": init, "after": replayed,
              "losses": losses[:REPLAY_STEPS], "Y": Y}
    return mod, batch, launches, losses, steady * 1e3, replay


def train_f32_phase(torch, mt, batch, Y, bf16_losses, profile_dir=None):
    """The train phase's LM, init and batch with ``compute_dtype`` left at
    its float32 default, as a user who does not ask for bf16 trains: adam
    at lr 3e-4, F32_WARMUP + F32_STEPS steps; each step launches K1, K2
    and K3 (the split-TF32 backward) once per layer, and the loss falls.
    Neither TF32 flag of PyTorch may be on: the GEMMs run in float32.
    Returns the launch counts."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s = BATCH, FULL["seq_len"]
    flags = {"torch.backends.cuda.matmul.allow_tf32":
             torch.backends.cuda.matmul.allow_tf32,
             "torch.backends.cudnn.allow_tf32":
             torch.backends.cudnn.allow_tf32}
    print("train f32: %s" % flags, flush=True)
    check(not any(flags.values()), "a TF32 flag is on: the float32 step's "
          "GEMMs would not run in float32")
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    mt.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    mod = train_module(mt, net, None, (b, s),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34))
    ex = mod._exec_group.execs[0]
    check(all(ex.arg_dict[n]._data.dtype == torch.float32
              for n in mod._exec_group.param_names),
          "the float32 Module holds parameters of another dtype")
    per_step = FULL["num_layers"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    losses, times = [], []
    mt.kernels.reset_launches()
    for step in range(F32_WARMUP + F32_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES[n] - before[n] for n in names}
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        print("train f32: step %d: %.2f ms, loss %.6f (bf16 step %.6f), "
              "launches %s" % (step, times[-1] * 1e3, losses[-1],
                               bf16_losses[step], delta), flush=True)
        check(np.isfinite(losses[-1]), "float32 step %d loss is not finite"
              % step)
        check(all(v == per_step for v in delta.values()),
              "float32 step %d launched %s, expected %d of each"
              % (step, delta, per_step))
    launches = dict(mt.kernels.LAUNCHES)
    check(losses[-1] < losses[0], "the float32 loss did not fall: %s"
          % losses)
    steady = float(np.mean(times[F32_WARMUP:]))
    print("train f32: step ms %.2f (mean of %d timed steps after %d "
          "warm-up)" % (steady * 1e3, F32_STEPS, F32_WARMUP), flush=True)
    print("train f32: tokens/s %.1f" % (b * s / steady), flush=True)
    print("train f32: peak device memory %.2f GB"
          % (torch.cuda.max_memory_allocated() / 1e9), flush=True)
    print("train f32: loss %.6f -> %.6f over %d steps; launches %s"
          % (losses[0], losses[-1], len(losses), launches), flush=True)
    if profile_dir:
        def step():
            mod.forward_backward(batch)
            mod.update()
        got = profile(torch, step, profile_dir, "train_step_f32")
        names = [n for group in ("K1 flash_fwd", "K2 flash_bwd_dq",
                                 "K3 flash_bwd_dkv")
                 for n in sorted(got.get(group, ()))]
        print("profile train_step_f32: K1/K2/K3 kernels %s" % names,
              flush=True)
        check(len(names) == 3 and all("_tf32_kernel<128" in n
                                      for n in names),
              "the float32 step's K1/K2/K3 are not the split-TF32 kernels")
    del mod, ex
    torch.cuda.empty_cache()
    return launches


def param_snapshot(mod):
    """Copies of a bound Module's parameters in host memory, by name (kept
    off the card, so that they do not count in its peak memory)."""
    ex = mod._exec_group.execs[0]
    return {n: ex.arg_dict[n]._data.to("cpu", copy=True)
            for n in mod._exec_group.param_names}


def replay_phase(torch, mt, batch, replay):
    """The train phase's first REPLAY_STEPS steps again, from its initial
    parameters and its batch, in a new Module: every loss and every
    parameter must be the same bits.  Then once more under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the ops
    it warns about are the step's ops that have no deterministic CUDA
    implementation, and that run must give the same bits too."""
    import warnings

    b, s = BATCH, FULL["seq_len"]
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    for mode in ("default", "deterministic"):
        mod = train_module(mt, replay["net"], None, (b, s), arg_params=init,
                           compute_dtype="bfloat16")
        losses = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if mode == "deterministic":
                torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for _ in range(REPLAY_STEPS):
                    mod.forward_backward(batch)
                    mod.update()
                    torch.cuda.synchronize()
                    losses.append(lm_loss(torch, mod.get_outputs()[0],
                                          replay["Y"]))
            finally:
                torch.use_deterministic_algorithms(False)
        after = param_snapshot(mod)
        differ = sorted(n for n, t in after.items()
                        if not torch.equal(t, replay["after"][n]))
        alerts = sorted({str(w.message).split("\n")[0][:160]
                         for w in caught
                         if "deterministic" in str(w.message)})
        print("replay (%s): %d steps from the train phase's init and batch: "
              "losses %s vs %s, bitwise equal %s; %d of %d parameters differ "
              "%s; nondeterministic-op alerts: %s"
              % (mode, REPLAY_STEPS, ["%.9g" % x for x in losses],
                 ["%.9g" % x for x in replay["losses"]],
                 losses == replay["losses"], len(differ), len(after),
                 differ[:5], alerts or "none"), flush=True)
        check(losses == replay["losses"] and not differ,
              "the bf16 train step is not reproducible (%s mode)" % mode)
        del mod, after
        torch.cuda.empty_cache()


def splash_phase(torch, mt, batch, replay, flash_losses, flash_step_ms,
                 tokens, flash_out, profile_dir=None):
    """The splash LM (``attn_impl="splash"``) at the full geometry: trained
    through Module in bf16 from the train phase's init and batch, 2 + 5
    steps, each launching K1's split-P variant, K2 and K3 once per layer
    (and the plain K1 never); its step-0 loss within 1e-3 of the flash
    LM's.  Then one float32 request on the serve phase's weights, within
    1e-4 of the flash LM's answer.  Returns the launch counts."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s = BATCH, FULL["seq_len"]
    with mt.NameManager():
        net = get_transformer_lm(attn_impl="splash", **FULL)
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    torch.cuda.reset_peak_memory_stats()
    mod = train_module(mt, net, None, (b, s), arg_params=init,
                       compute_dtype="bfloat16")
    per_step = FULL["num_layers"]
    want = {"flash_fwd_splitp": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step, "flash_fwd": 0}
    losses, times = [], []
    mt.kernels.reset_launches()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES[n] - before[n] for n in want}
        losses.append(lm_loss(torch, mod.get_outputs()[0], replay["Y"]))
        print("splash: step %d: %.2f ms, loss %.6f (flash LM %.6f), launches "
              "%s" % (step, times[-1] * 1e3, losses[-1], flash_losses[step],
                      delta), flush=True)
        check(np.isfinite(losses[-1]), "splash step %d loss is not finite"
              % step)
        check(delta == want, "splash step %d launched %s, expected %s"
              % (step, delta, want))
    launches = dict(mt.kernels.LAUNCHES)
    rel0 = abs(losses[0] - flash_losses[0]) / abs(flash_losses[0])
    steady = float(np.mean(times[TRAIN_WARMUP:]))
    print("splash: step ms %.2f (mean of %d timed steps after %d warm-up; "
          "flash LM %.2f)" % (steady * 1e3, TRAIN_STEPS, TRAIN_WARMUP,
                              flash_step_ms), flush=True)
    print("splash: tokens/s %.1f" % (b * s / steady), flush=True)
    print("splash: peak device memory %.2f GB"
          % (torch.cuda.max_memory_allocated() / 1e9), flush=True)
    print("splash: loss %.6f -> %.6f; step-0 loss relative to the flash LM's "
          "%.3g (tolerance 1e-3)" % (losses[0], losses[-1], rel0),
          flush=True)
    check(rel0 <= 1e-3, "the splash LM's step-0 loss differs from the flash "
          "LM's")
    check(losses[-1] < losses[0], "the splash LM's loss did not fall")
    if profile_dir:
        def step():
            mod.forward_backward(batch)
            mod.update()
        k1 = sorted(profile(torch, step, profile_dir, "splash_step")
                    .get("K1 flash_fwd split-P", ()))
        print("profile splash_step: K1 kernels %s" % k1, flush=True)
        check(k1 and all("flash_fwd_tc_kernel<128, true>" in n for n in k1),
              "the splash step's K1 is not flash_fwd_tc_kernel<128, true>")
    del mod, init
    torch.cuda.empty_cache()

    params, _ = serve_inputs(mt, net)
    pred = mt.Predictor(net, params, SERVE_SHAPES)
    del params
    before = mt.kernels.LAUNCHES["flash_fwd"]
    t0 = time.perf_counter()
    out = pred.forward(data=tokens)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n_fwd = mt.kernels.LAUNCHES["flash_fwd"] - before
    err = (out._data.cpu() - flash_out).abs().max().item()
    print("splash: one float32 request on the serve phase's weights: %.2f ms "
          "(first request), K1 (float32) launches %d, max|d| from the flash "
          "LM's answer %.3g (tolerance 1e-4)" % (ms, n_fwd, err), flush=True)
    check(out.context == mt.gpu(0) and n_fwd == per_step and err <= 1e-4,
          "the splash LM's served answer differs from the flash LM's")
    del pred, out
    torch.cuda.empty_cache()
    return launches


def lm_update_arrays(torch, mt, gen, device):
    """(weights, gradients) of every parameter array of the full-width LM,
    as an update loop meets them: gammas 1, betas and biases 0, the rest
    N(0, 0.02); gradients N(0, 1)."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

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
    return weights, grads


def sgd_pass(rk, weights, grads, hp):
    """One ``rtc_kernels.sgd_update`` push per array."""
    for w, g in zip(weights, grads):
        rk.sgd_update(w, g, hp)


def event_ms(torch, fn):
    """Device time of one call of ``fn`` from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sgd_pass_times(torch, rk, weights, grads, hp):
    """(ms of one pass of pushes from CUDA events, host µs per push: the
    enqueue of HOST_PASSES passes back to back, timed on the host clock
    without a synchronize); makes 1 + HOST_PASSES passes."""
    ms = event_ms(torch, lambda: sgd_pass(rk, weights, grads, hp))
    t0 = time.perf_counter()
    for _ in range(HOST_PASSES):
        sgd_pass(rk, weights, grads, hp)
    host_us = (time.perf_counter() - t0) / (HOST_PASSES * len(weights)) * 1e6
    torch.cuda.synchronize()
    return ms, host_us


def fused_sgd_ms(torch, weights, grads):
    """``torch._fused_sgd_`` (the library's multi-tensor SGD) on copies of
    the arrays with the extend phase's hyperparameters, mean of 3 calls."""
    lib_w = [w.clone() for w in weights]
    lib_g = [g.clone() for g in grads]
    scale = torch.tensor(1.0 / SGD["rescale_grad"], device=weights[0].device)
    ms = cuda_ms(lambda: torch._fused_sgd_(
        lib_w, lib_g, [], weight_decay=SGD["wd"], momentum=0.0,
        lr=SGD["lr"], dampening=0.0, nesterov=False, maximize=False,
        is_first_step=False, grad_scale=scale), 3)
    del lib_w, lib_g
    return ms


def push_profile(torch, fn, n_pushes, what):
    """One call of ``fn`` (``n_pushes`` pushes) under cProfile: the host
    time per push by function (cProfile's own cost included, so the shares
    matter more than the sum), largest first."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])
    total = sum(v[2] for _, v in rows)
    print("extend: %s push profile (cProfile, %d pushes): %.1f us per push "
          "in all; by function, own time per push: %s" % (
              what, n_pushes, total / n_pushes * 1e6, "; ".join(
                  "%s:%d %s %.2f us (%.2g calls)" % (
                      os.path.basename(f), line, name, v[2] / n_pushes * 1e6,
                      v[1] / n_pushes)
                  for (f, line, name), v in rows[:14])), flush=True)


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
    weights, grads = lm_update_arrays(torch, mt, gen, device)
    n_params = sum(w.numel() for w in weights)
    refs = [w.clone() for w in weights]
    hp = rk.sgd_hyper(SGD["lr"], SGD["rescale_grad"], SGD["wd"], device)

    def plain():
        for w, g in zip(refs, grads):
            mt.nd.sgd_update(w, g, out=w, **SGD)

    t0 = time.perf_counter()
    sgd_pass(rk, weights, grads, hp)  # compiles one kernel per shape
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    plain()
    ms, host_us = sgd_pass_times(torch, rk, weights, grads, hp)
    plain_ms = event_ms(torch, plain)
    for _ in range(HOST_PASSES):
        plain()
    passes = 2 + HOST_PASSES
    d = max(ulps(torch, w, r) for w, r in zip(weights, refs))
    check(d <= 1, "the sgd_update pushes disagree with sgd_update (%d ulps)"
          % d)
    lib_ms = fused_sgd_ms(torch, weights, grads)
    bound, by = elementwise_bound(torch, n_params, 12, 5, torch.float32)
    n_pushes = mt.kernels.LAUNCHES["rtc:sgd_update"]
    print("extend: sgd_update pushed over %d parameter arrays (%d parameters,"
          " %d distinct shapes compiled in %.2f s with the first pass): %.4f "
          "ms per pass of %d pushes (%d counted over all passes), plain "
          "sgd_update %.4f ms, torch._fused_sgd_ %.4f ms, bound %.4f ms by "
          "%s; %d ulps from sgd_update after %d passes" % (
              len(weights), n_params, len({tuple(w.shape) for w in weights}),
              first, ms, len(weights), n_pushes, plain_ms, lib_ms, bound, by,
              d, passes), flush=True)
    print("extend: sgd_update host time %.1f us per push (enqueue of %d "
          "passes back to back, not synchronized), %.4f ms per pass of %d "
          "pushes; torch._fused_sgd_ %.4f ms over the same arrays"
          % (host_us, HOST_PASSES, ms, len(weights), lib_ms), flush=True)
    sgd_row = {"name": "rtc:sgd_update", "route": "cuda",
               "source": RTC_SOURCE, "replaces": "mxnet_tpu/rtc.py:81",
               "launches": None,
               "max_abs_err": max((w - r).abs().max().item()
                                  for w, r in zip(weights, refs)),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": lib_ms}
    push_profile(torch, lambda: sgd_pass(rk, weights, grads, hp),
                 len(weights), "sgd_update")
    del weights, grads, refs
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


def train3(torch, mt, net, ctx, shape, arg_params, dtype, batch, Y):
    """3 adam steps (lr 1e-3, epsilon 1e-4) of ``net`` on ``ctx`` from
    ``arg_params`` on one batch: (losses, parameters as numpy)."""
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
    return losses, {k: v.asnumpy() for k, v in args.items()}


def small_train_agreement(torch, mt, dtype, rtc_gelu=False, cfg=None,
                          std_width=None):
    """A small LM (``SMALL``, or ``cfg``) trained 3 adam steps on the card
    (kernels) and on the CPU (plain versions) from one numpy init, in
    float32 or with bf16 compute, must agree (limits in ``AGREE``; with
    ``std_width`` the init std is scaled by sqrt(std_width / hidden), so
    that every width has the pre-activation spread of a std_width-wide
    LM); with ``rtc_gelu`` its gelu
    nodes are the user op (NVRTC kernels on the card, Python source on the
    CPU).  Returns the kernel launches of the card's run.  Adam's epsilon is
    1e-4:
    with the usual 1e-8 its first steps are ±lr for any gradient, so
    roundoff in a gradient that is 0 in exact arithmetic (the key bias:
    softmax ignores a per-row shift) would become a full step of either
    sign."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    from mxnet_tpu_torch.rtc_kernels import with_rtc_gelu

    cfg = cfg or SMALL
    std, loss_tol, param_tol = AGREE[dtype]
    std *= np.sqrt((std_width or cfg["hidden"]) / cfg["hidden"])
    shape = (2, cfg["seq_len"])
    with mt.NameManager():
        net = get_transformer_lm(**cfg)
    if rtc_gelu:
        net = with_rtc_gelu(net)
    rng = np.random.default_rng(SEED + 2)
    params = lm_params(mt, net, {"data": shape, "softmax_label": shape}, rng,
                       std)
    arg_params = {k[4:]: v for k, v in params.items()}
    init = {k: v.asnumpy() for k, v in arg_params.items()}
    X = rng.integers(0, cfg["vocab_size"], shape).astype(np.float32)
    Y = (X + 1) % cfg["vocab_size"]
    batch = mt.io.DataBatch(data=[mt.nd.array(X, mt.cpu())],
                            label=[mt.nd.array(Y, mt.cpu())])
    mt.kernels.reset_launches()
    lg, pg = train3(torch, mt, net, mt.gpu(0), shape, arg_params, dtype,
                    batch, Y)
    launches = dict(mt.kernels.LAUNCHES)
    lc, pc = train3(torch, mt, net, mt.cpu(), shape, arg_params, dtype,
                    batch, Y)
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
    what_lm = "%s%s" % ("" if cfg is SMALL else " %s" % {
        k: v for k, v in cfg.items() if SMALL.get(k) != v},
        " with rtc_gelu" if rtc_gelu else "")
    print("check: small LM%s trained 3 adam steps (%s, init std %.3g) on the "
          "card "
          "vs the CPU: losses %s vs %s, relative loss error %.3g (tolerance "
          "%g), %s (tolerance %g; the steps moved parameters by up to %.3g "
          "of the largest)"
          % (what_lm, dtype or "float32", std,
             ["%.6f" % x for x in lg],
             ["%.6f" % x for x in lc], loss_err, loss_tol, what, param_tol,
             moved), flush=True)
    check(loss_err <= loss_tol and param_err <= param_tol,
          "small LM%s trained on the card (%s) disagrees with the CPU"
          % (what_lm, dtype or "float32"))
    return launches


# one-ulp draws of the init per device and spread in ``spread_witness``
WITNESS_DRAWS = 4


def spread_witness(torch, mt):
    """A recorded reading, not a check: the d=256 LM of the agree phase in
    float32, at the spread the agree phase holds (a 64-wide LM's, std 0.3 *
    sqrt(64 / 256)) and at a 128-wide LM's (std 0.3 * sqrt(128 / 256)),
    where three steps amplify roundoff more: the card-vs-CPU gap beside
    the gaps that moving the init one float32 ulp per entry (at random,
    ``WITNESS_DRAWS`` draws) makes on the card alone and on the CPU alone.
    A card-vs-CPU gap inside that range is amplified summation order, not
    a fault of the kernels."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    cfg = SMALL_HEAD_DIMS[256]
    shape = (2, cfg["seq_len"])
    with mt.NameManager():
        net = get_transformer_lm(**cfg)
    for width in (64, 128):
        std = AGREE[None][0] * np.sqrt(width / cfg["hidden"])
        rng = np.random.default_rng(SEED + 2)  # small_train_agreement's
        params = lm_params(mt, net, {"data": shape, "softmax_label": shape},
                           rng, std)
        arg_params = {k[4:]: v for k, v in params.items()}
        X = rng.integers(0, cfg["vocab_size"], shape).astype(np.float32)
        Y = (X + 1) % cfg["vocab_size"]
        batch = mt.io.DataBatch(data=[mt.nd.array(X, mt.cpu())],
                                label=[mt.nd.array(Y, mt.cpu())])
        base = {ctx: train3(torch, mt, net, ctx, shape, arg_params, None,
                            batch, Y)[1] for ctx in (mt.gpu(0), mt.cpu())}
        scale = max(float(np.abs(v).max()) for v in base[mt.cpu()].values())

        def gap(a, b):
            return max(float(np.abs(a[k] - b[k]).max()) for k in a) / scale
        off_gaps = {ctx: [] for ctx in base}
        for draw in range(WITNESS_DRAWS):
            flip = np.random.default_rng(SEED + 100 + draw)
            off = {}
            for k, v in arg_params.items():
                a = v.asnumpy()
                if not k.endswith(("_gamma", "_beta", "_bias")):
                    a = np.nextafter(a, np.where(
                        flip.random(a.shape) < 0.5, -np.inf,
                        np.inf).astype(np.float32))
                off[k] = mt.nd.array(a, mt.cpu())
            for ctx in base:
                got = train3(torch, mt, net, ctx, shape, off, None, batch,
                             Y)[1]
                off_gaps[ctx].append(gap(got, base[ctx]))
        print("witness: d=256 LM at init std %.3g (a %d-wide LM's spread), "
              "3 float32 adam steps, gaps of the largest parameter: card vs "
              "CPU %.3g; from the init one ulp off, %d draws: card vs card "
              "%s, CPU vs CPU %s (recorded, not checked)" % (
                  std, width, gap(base[mt.gpu(0)], base[mt.cpu()]),
                  WITNESS_DRAWS,
                  ["%.3g" % g for g in off_gaps[mt.gpu(0)]],
                  ["%.3g" % g for g in off_gaps[mt.cpu()]]), flush=True)


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
            if key == "flash_fwd" and re.search(
                    r"flash_fwd_tc_kernel<\d+, true", name):
                return "K1 flash_fwd split-P"
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
    device op.  Returns the device ops' names by group."""
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
    groups, names = {}, {}
    for e in events:
        group = device_op_group(e)
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e["dur"] / 1e3, n + 1)
        names.setdefault(group, set()).add(e["name"])
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print("profile %s: %-26s %10.3f ms %7.2f%% %5d ops"
              % (label, group, ms, 100 * ms * 1e3 / busy, n), flush=True)
    print("profile %s: %d device ops, busy %.1f us of a %.1f us span: idle "
          "share %.4f" % (label, len(events), busy, span, 1 - busy / span),
          flush=True)
    return names


def build_phase(torch, mt, parent_csrcs=()):
    """Build every kernel (and flash_fwd.cu of each directory of
    ``parent_csrcs``, beside them), print ptxas's report and the
    tensor-core instruction counts; fatal on a spill or a bf16 or float32
    attention kernel without one.  Returns {label: ``mxtt_flash_fwd`` of
    each parent build}, the label the directory's name."""
    import ctypes

    kernels = mt.kernels
    t0 = time.perf_counter()
    os.makedirs(kernels._BUILD, exist_ok=True)
    procs = {}
    for folder in parent_csrcs:
        label = os.path.basename(os.path.normpath(folder))
        out = os.path.join(kernels._BUILD, "libflash_fwd-parent-%s.so" % label)
        procs[label] = (subprocess.Popen(
            [kernels._nvcc()] + kernels.NVCC_FLAGS +
            ["-o", out, os.path.join(folder, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    secs = kernels.build_all()
    print("build: %s built in %.2f s" % (
        sorted(set(kernels.SOURCES.values())), secs), flush=True)
    logs, parents = {}, {}
    for label, (proc, out) in procs.items():
        logs["parent " + label], _ = proc.communicate()
        check(proc.returncode == 0, "the build of %s failed:\n%s"
              % (label, logs["parent " + label]))
        parents[label] = fwd_entry(ctypes.CDLL(out))
    if procs:
        print("build: flash_fwd.cu of %s built beside them, %.2f s in all"
              % (sorted(procs), time.perf_counter() - t0), flush=True)
    print("build: NVRTC %d.%d from %s, options %s" % (
        mt.cuda_rtc.nvrtc_version() + (mt.cuda_rtc._LIBS["nvrtc"]._name,
                                       " ".join(mt.cuda_rtc.nvrtc_options()))),
          flush=True)
    faults = []
    for source, log in sorted(mt.kernels.BUILD_LOGS.items()):
        faults += ptxas_report(source, log)
    for tag, log in sorted(logs.items()):
        faults += ptxas_report(tag, log)
    check(not faults, "; ".join(faults))
    mma = sass_mma([kernels._lib_path(s) for s in ("flash_fwd.cu",
                                                   "flash_bwd.cu")])
    print("build: tensor-core instructions (HGMMA + HMMA) per attention "
          "kernel (cuobjdump -sass): "
          "%s" % ", ".join("%s<%s> %d" % (k, ",".join(map(str, a)), n)
                           for (k, a), n in sorted(mma.items())),
          flush=True)
    # every bf16 instantiation: K1 at each width, plain and split-P; K2 at
    # each width; K3 fused (outputs 3) up to 128, as its dV (2) and dK (1)
    # launches at 256; and K1 at each width and the same K2/K3
    # instantiations in float32
    tc_kernels = [("flash_fwd_tc_kernel", (w, split)) for w in (64, 128, 256)
                  for split in (0, 1)]
    tc_kernels += [("flash_fwd_tf32_kernel", (w,)) for w in (64, 128, 256)]
    for tag in ("_tc", "_tf32"):
        tc_kernels += [("flash_bwd_dq%s_kernel" % tag, (w,))
                       for w in (64, 128, 256)]
        tc_kernels += [("flash_bwd_dkv%s_kernel" % tag, (w, 3))
                       for w in (64, 128)]
        tc_kernels += [("flash_bwd_dkv%s_kernel" % tag, (256, out))
                       for out in (1, 2)]
    for kernel, args in tc_kernels:
        found = [n for (k, a), n in mma.items()
                 if k == kernel and a[:len(args)] == args]
        check(found and min(found) > 0, "%s<%s...> has no tensor-core "
              "instruction (HGMMA or HMMA): it does not run on the tensor "
              "cores" % (kernel, ",".join(map(str, args))))

    return parents


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra request, one extra train step "
                         "(bf16 and float32), one extra splash step and one "
                         "extra rtc_gelu train step with torch.profiler")
    ap.add_argument("--parent-csrc", metavar="DIR", action="append",
                    default=[],
                    help="a csrc directory of another version (flash_fwd.cu "
                         "and its headers), repeatable: its bf16 K1 and "
                         "split-P are held bit for bit and timed in turns "
                         "against this one's at every bf16 main-length case")
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
    parents = build_phase(torch, mt, opts.parent_csrc)
    device = torch.device("cuda", 0)
    main_rows, dim_rows = kernel_phase(torch, att, device, parents)
    splitp_row = main_rows.pop("flash_fwd_splitp")
    rows = list(main_rows.values())
    rtc_rows = rtc_kernel_phase(torch, mt, device)
    pred, tokens, flash_out = serve_phase(torch, mt)
    mod, batch, launches, losses, step_ms, replay = train_phase(torch, mt)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] > 0, "the training path never launched %s"
              % name)
    for r in rows:
        r["launches"] = launches[r["name"]]
    step_paths(torch, mod, batch)
    if opts.profile:
        k1 = sorted(profile(torch, lambda: pred.forward(data=tokens),
                            opts.profile, "serve_request")
                    .get("K1 flash_fwd", ()))
        print("profile serve_request: K1 kernels %s" % k1, flush=True)
        check(k1 and all("flash_fwd_tf32_kernel<128>" in n for n in k1),
              "the float32 request's K1 is not flash_fwd_tf32_kernel<128>")

        def step():
            mod.forward_backward(batch)
            mod.update()
        k1 = sorted(profile(torch, step, opts.profile,
                            "train_step").get("K1 flash_fwd", ()))
        print("profile train_step: K1 kernels %s" % k1, flush=True)
        check(k1 and all("flash_fwd_tc_kernel<128, false>" in n for n in k1),
              "the bf16 train step's K1 is not "
              "flash_fwd_tc_kernel<128, false>")
    del pred, mod
    torch.cuda.empty_cache()
    f32_launches = train_f32_phase(torch, mt, batch, replay["Y"], losses,
                                   opts.profile)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        dim_rows[(name, FULL["hidden"] // FULL["num_heads"], "f32")][
            "launches"] = f32_launches[name]
        check(f32_launches[name] > 0, "the float32 training path never "
              "launched %s" % name)
    replay_phase(torch, mt, batch, replay)
    splash_launches = splash_phase(torch, mt, batch, replay, losses, step_ms,
                                   tokens, flash_out, opts.profile)
    splitp_row["launches"] = splash_launches["flash_fwd_splitp"]
    check(splitp_row["launches"] > 0, "the splash path never launched "
          "flash_fwd_splitp")
    rows.append(splitp_row)
    del batch, replay, flash_out
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
        small_train_agreement(torch, mt, dtype, cfg=SMALL_SPLASH)
        for d, cfg in sorted(SMALL_HEAD_DIMS.items()):
            got = small_train_agreement(torch, mt, dtype, cfg=cfg,
                                        std_width=64)
            tag = "bf16" if dtype else "f32"
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                dim_rows[(name, d, tag)]["launches"] = got[name]
                check(got[name] > 0, "the d=%d LM never launched %s"
                      % (d, name))
    rows += [dim_rows[k] for k in sorted(dim_rows)]
    spread_witness(torch, mt)
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
