#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --profile DIR    # also trace one extra request
                                           # and one extra train step

Phases, each fatal on failure (non-zero exit, no result line):

1. build   — compile every CUDA kernel of the ported paths from
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
             source, all started together;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at several shapes and both dtypes, the main paths' own shapes
             included: K1 (flash forward) on O and lse, K2/K3 (flash
             backward) on dQ, dK and dV; time kernels, plain versions and the
             library calls (``scaled_dot_product_attention`` forward and
             backward, timed only as yardsticks);
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
5. agree   — a small LM served, and trained 3 adam steps in float32 and in
             bf16, on the card and on the CPU from one numpy init, must
             agree.

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
    return mod, batch, launches


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


def small_train_agreement(torch, mt, dtype):
    """A small LM trained 3 adam steps on the card (kernels) and on the CPU
    (plain versions) from one numpy init, in float32 or with bf16
    compute, must agree (limits in ``AGREE``).  Adam's epsilon is 1e-4:
    with the usual 1e-8 its first steps are ±lr for any gradient, so
    roundoff in a gradient that is 0 in exact arithmetic (the key bias:
    softmax ignores a per-row shift) would become a full step of either
    sign."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    std, loss_tol, param_tol = AGREE[dtype]
    shape = (2, SMALL["seq_len"])
    with mt.NameManager():
        net = get_transformer_lm(**SMALL)
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
    print("check: small LM trained 3 adam steps (%s, init std %g) on the card "
          "vs the CPU: losses %s vs %s, relative loss error %.3g (tolerance "
          "%g), %s (tolerance %g; the steps moved parameters by up to %.3g "
          "of the largest)"
          % (dtype or "float32", std, ["%.6f" % x for x in lg],
             ["%.6f" % x for x in lc], loss_err, loss_tol, what, param_tol,
             moved), flush=True)
    check(loss_err <= loss_tol and param_err <= param_tol,
          "small LM trained on the card (%s) disagrees with the CPU"
          % (dtype or "float32"))


def device_op_group(event):
    """The group a device op of a profiler trace counts under."""
    name = event["name"]
    for key, group in (("flash_bwd_dkv", "K3 flash_bwd_dkv"),
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
    (table in DIR/<label>.txt, timeline in DIR/<label>.json) and the
    device's idle share between the first and the last device op."""
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
    print(table, flush=True)
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
                    help="trace one extra request and one extra train step "
                         "with torch.profiler")
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
    for source, log in sorted(mt.kernels.BUILD_LOGS.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or \
                    "Compiling entry" in line:
                print("  ptxas %s: %s" % (source, line.strip()), flush=True)

    rows = kernel_phase(torch, att, torch.device("cuda", 0))
    pred, tokens = serve_phase(torch, mt)
    mod, batch, launches = train_phase(torch, mt)
    for name, count in launches.items():
        check(count > 0, "the training path never launched %s" % name)
    for r in rows:
        r["launches"] = launches[r["name"]]
    step_paths(torch, mod, batch)
    small_agreement(mt)
    for dtype in (None, "bfloat16"):
        small_train_agreement(torch, mt, dtype)
    if opts.profile:
        profile(torch, lambda: pred.forward(data=tokens), opts.profile,
                "serve_request")

        def step():
            mod.forward_backward(batch)
            mod.update()
        profile(torch, step, opts.profile, "train_step")

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
