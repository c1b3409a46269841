#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --profile DIR    # also trace one extra request

Phases, each fatal on failure (non-zero exit, no result line):

1. build   — compile every CUDA kernel of the serving path from
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at several shapes and both dtypes, the serving path's own shape
             included, and time kernel, plain version and the library call
             (``scaled_dot_product_attention``, timed only as a yardstick);
3. serve   — save a full-width transformer LM checkpoint (vocab 32000,
             6 x 2048, 16 heads, seq 4096, batch 4, float32; random weights
             from a seed), load it with ``Predictor.from_checkpoint`` on the
             default (GPU) context and answer requests, counting kernel
             launches; then serve a small LM on the card and on the CPU and
             require the two to agree.

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

# Data-sheet peaks per H100 variant: float32 on the CUDA cores (TFLOP/s)
# and device memory (TB/s).  nvidia-smi names the SXM part
# "NVIDIA H100 80GB HBM3", so SXM is the fallback.
PEAKS = {
    "H100 PCIe": {"float32": 51.0, "tbs": 2.0},
    "H100 NVL": {"float32": 60.0, "tbs": 3.9},
    "H100 SXM": {"float32": 67.0, "tbs": 3.35},
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


def attention_work(b, sq, sk, h, d, causal, itemsize):
    """(operations, bytes) the attention forward must do for these shapes:
    4·d per visible (query, key) pair, each input read once and each output
    written once."""
    if causal:
        rows = np.arange(sq)
        pairs = int(np.minimum(rows + 1, sk).sum())
    else:
        pairs = sq * sk
    flops = 4.0 * d * pairs * b * h
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * itemsize + \
        b * h * sq * 4
    return flops, nbytes


def qkv_views(torch, gen, b, sq, sk, h, d, dtype, device):
    """q, k, v as the serving path hands them to the kernel: strided views
    of one packed [b, s, 3, h, d] projection when sq == sk."""
    if sq == sk:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device=device)
        return tuple(t.squeeze(2) for t in qkv.to(dtype).split(1, dim=2))
    mk = lambda s: torch.randn((b, s, h, d), generator=gen,  # noqa: E731
                               device=device).to(dtype)
    return mk(sq), mk(sk), mk(sk)


def kernel_phase(torch, att, device):
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, b, sq, sk, h, d, causal, dtype, tolerance
        ("f32 causal d64", 2, 256, 256, 4, 64, True, f32, 1e-4),
        ("f32 full d64", 2, 256, 256, 4, 64, False, f32, 1e-4),
        ("f32 causal sq<sk d128 ragged", 2, 200, 333, 4, 128, True, f32, 1e-4),
        ("f32 full sq>sk d128 ragged", 2, 333, 200, 4, 128, False, f32, 1e-4),
        ("f32 causal sq>sk d64", 1, 300, 100, 2, 64, True, f32, 1e-4),
        ("bf16 causal d128", 2, 512, 512, 4, 128, True, bf16, 2e-2),
        ("bf16 full sq<sk d64", 2, 192, 320, 4, 64, False, bf16, 2e-2),
        ("f32 causal main-path shape", BATCH, FULL["seq_len"],
         FULL["seq_len"], FULL["num_heads"],
         FULL["hidden"] // FULL["num_heads"], True, f32, 1e-4),
    ]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    main = None
    for name, b, sq, sk, h, d, causal, dtype, tol in cases:
        q, k, v = qkv_views(torch, gen, b, sq, sk, h, d, dtype, device)
        scale = 1.0 / np.sqrt(d)
        o, lse = att.flash_forward(q, k, v, causal, scale)
        o_ref, lse_ref = att.attention_reference(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        print("kernel flash_fwd [%s] b=%d sq=%d sk=%d h=%d d=%d: "
              "max|dO|=%.3g max|dlse|=%.3g (tolerance %g)"
              % (name, b, sq, sk, h, d, err_o, err_l, tol), flush=True)
        check(torch.isfinite(o.float()).all().item()
              and torch.isfinite(lse).all().item(),
              "non-finite kernel output in case %s" % name)
        check(err_o <= tol and err_l <= tol,
              "flash_fwd disagrees with its plain version in case %s" % name)
        if "main-path" in name:
            main = dict(q=q, k=k, v=v, scale=scale, err=err_o, b=b, sq=sq,
                        sk=sk, h=h, d=d)
        del o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()

    q, k, v, scale = main["q"], main["k"], main["v"], main["scale"]
    ms = cuda_ms(lambda: att.flash_forward(q, k, v, True, scale), 10)
    plain_ms = cuda_ms(lambda: att.attention_reference(q, k, v, True, scale), 3)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale),
                         10)
    variant, peak = peaks_for(torch.cuda.get_device_name(0))
    flops, nbytes = attention_work(main["b"], main["sq"], main["sk"],
                                   main["h"], main["d"], True, 4)
    t_ops = flops / (peak["float32"] * 1e12) * 1e3
    t_bytes = nbytes / (peak["tbs"] * 1e12) * 1e3
    print("kernel flash_fwd main-path timing: kernel %.4f ms, plain %.4f ms, "
          "sdpa %.4f ms; %.4g TFLOP and %.4g GB -> bound %.4f ms (%s data "
          "sheet: %.0f TFLOP/s float32, %.2f TB/s); %.2f TFLOP/s achieved"
          % (ms, plain_ms, library_ms, flops / 1e12, nbytes / 1e9,
             max(t_ops, t_bytes), variant, peak["float32"], peak["tbs"],
             flops / (ms * 1e-3) / 1e12), flush=True)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mxnet_tpu/ops/attention.py:97",
            "launches": None, "max_abs_err": main["err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


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
        mt.kernels.reset_launches()
        pred = mt.Predictor.from_checkpoint(prefix, 0, shapes)
        t2 = time.perf_counter()
    print("serve: %d parameters; checkpoint written in %.2f s, Predictor "
          "built in %.2f s" % (n_params, t1 - t0, t2 - t1), flush=True)

    requests = [rng.integers(0, vocab, (b, s)).astype(np.float32)
                for _ in range(REQUESTS)]
    per_request = FULL["num_layers"]  # one attention per layer
    times = []
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
    steady = float(np.mean(times[1:]))
    print("serve: %d requests of %d tokens; first %.2f ms, then %.2f ms per "
          "request = %.1f tokens/s; peak device memory %.2f GB"
          % (REQUESTS, b * s, times[0] * 1e3, steady * 1e3, b * s / steady,
             torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return pred, requests[0], launches


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
    print("check: small LM %s on the card vs the CPU: max|d| = %.3g "
          "(tolerance 1e-4)" % (SMALL, err), flush=True)
    check(err <= 1e-4, "small LM served on the card disagrees with the CPU")


def profile_request(torch, pred, tokens, outdir):
    """One more request under torch.profiler: device time by kernel name
    (table in DIR/profile.txt, timeline in DIR/trace.json) and the device's
    idle share between the request's first and last kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.forward(data=tokens)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    with open(os.path.join(outdir, "profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span = max(e["ts"] + e["dur"] for e in events) - \
        min(e["ts"] for e in events)
    busy = sum(e["dur"] for e in events)
    print(table, flush=True)
    print("profile: %d device ops, busy %.1f us of a %.1f us span: idle "
          "share %.4f" % (len(events), busy, span, 1 - busy / span),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra request with torch.profiler")
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
    for name in mt.kernels.SOURCES:
        print("build: %s built in %.2f s (%s)" % (
            name, secs, mt.kernels.SOURCES[name]), flush=True)
        for line in mt.kernels.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  ptxas: " + line.strip(), flush=True)

    row = kernel_phase(torch, att, torch.device("cuda", 0))
    pred, tokens, launches = serve_phase(torch, mt)
    check(launches["flash_fwd"] > 0, "the serving path never launched "
          "flash_fwd")
    row["launches"] = launches["flash_fwd"]
    small_agreement(mt)
    if opts.profile:
        profile_request(torch, pred, tokens, opts.profile)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
