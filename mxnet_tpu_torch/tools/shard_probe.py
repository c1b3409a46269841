"""Sharding probe — make a tensor-parallel layout inspectable before a run;
the port's counterpart of the JAX package's ``tools/shard_probe.py``, with
its flags and its JSON last line.

Builds a bench model, binds it on a named mesh under partition rules, and
reports:

  * the resolved rule table (which regex claimed each parameter);
  * per-parameter sharding and the per-device bytes against replicated;
  * the partitioned walk's plan of the train step, in place of the JAX
    tool's post-SPMD HLO collective mix: the ops that run once on the
    gathered value (``_Partitioned.gathered_ops``), each node's strategy,
    and the launches of the flash-attention kernels (K1 forward, K2/K3
    backward) that the plan implies for one step.

The last stdout line is one JSON record.  The mesh's contexts are
``--devices`` of ``--ctx``: on the card they cycle over the CUDA devices
(``[gpu(0)] * 2`` on a machine with one card), on the CPU they are
``cpu(0..N-1)``, one torch device.

Usage:
  python -m mxnet_tpu_torch.tools.shard_probe --model transformer \\
      --mesh data=1,model=2 --devices 2 --rules transformer_megatron \\
      [--steps 2] [--smoke] [--ctx cpu] [--hidden 2048 --layers 6 ...]
"""
import argparse
import json
import sys
import time

ATTENTION_OPS = ("_contrib_FlashAttention", "_contrib_SplashAttention")


def build_mlp(mt, batch):
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=256, name="fc1")
    h = mt.sym.Activation(h, act_type="relu")
    h = mt.sym.FullyConnected(h, num_hidden=10, name="fc2")
    net = mt.sym.SoftmaxOutput(h, name="softmax")
    return net, [("data", (batch, 128))], [("softmax_label", (batch,))]


def build_transformer(mt, batch, seq_len=64, hidden=128, layers=2, heads=4,
                      vocab=512):
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    net = get_transformer_lm(vocab_size=vocab, num_layers=layers,
                             num_heads=heads, hidden=hidden, seq_len=seq_len,
                             block_q=seq_len, block_k=seq_len)
    return net, [("data", (batch, seq_len))], \
        [("softmax_label", (batch, seq_len))]


def synthetic_batch(mt, ctx, data_shapes, label_shapes, vocab=512):
    import numpy as np

    rng = np.random.RandomState(7)
    data = [mt.nd.array(rng.randint(0, vocab, size=shape).astype(np.float32),
                        ctx) for _, shape in data_shapes]
    label = [mt.nd.array(rng.randint(0, 10, size=s).astype(np.float32), ctx)
             for _, s in label_shapes]
    return mt.io.DataBatch(data=data, label=label)


def mesh_contexts(mt, ctx, n):
    """``n`` contexts of kind ``ctx``: cycling over the CUDA devices, or
    ``cpu(0..n-1)``."""
    if ctx == "cpu":
        return [mt.cpu(i) for i in range(n)]
    cards = mt.num_gpus()
    if cards == 0:
        raise SystemExit("shard_probe: no CUDA device (pass --ctx cpu)")
    return [mt.gpu(i % cards) for i in range(n)]


def walk_plan(executor):
    """The partitioned walk's plan of a step: the gathered ops, each
    strategy's node count, and the attention kernels' launches (each
    attention node once, or once per batch shard where it runs per shard;
    its backward launches K2 and K3 as often)."""
    dp = executor._dp
    strategies = {}
    attention = 0
    for n in executor._plan.nodes:
        if n.is_variable:
            continue
        strat = dp.strategy[id(n)][0]
        strategies[strat] = strategies.get(strat, 0) + 1
        if n.op.name in ATTENTION_OPS:
            attention += dp.nb if dp.local[id(n)] else 1
    return {"gathered_ops": dp.gathered_ops(),
            "strategies": dict(sorted(strategies.items())),
            "kernel_launches_per_step": {"flash_fwd": attention,
                                         "flash_bwd_dq": attention,
                                         "flash_bwd_dkv": attention}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="transformer",
                    choices=("mlp", "transformer"))
    ap.add_argument("--mesh", default="data=-1,model=2",
                    help="mesh layout, e.g. data=-1,model=2")
    ap.add_argument("--rules", default=None,
                    help="preset name (default: transformer_megatron for "
                         "--model transformer, replicated otherwise)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="minimal run for CI: tiny model, 1 step")
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--devices", type=int, default=None,
                    help="contexts in the mesh (default: the CUDA devices, "
                         "or 8 on the CPU)")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    args = ap.parse_args(argv)

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import sharding

    if args.rules is None:
        args.rules = ("transformer_megatron" if args.model == "transformer"
                      else "replicated")
    if args.smoke:
        args.steps = 1
    n = args.devices or (8 if args.ctx == "cpu" else mt.num_gpus())
    contexts = mesh_contexts(mt, args.ctx, n)
    ctx = contexts[0]

    mesh = sharding.build_mesh(args.mesh, contexts)
    rules = sharding.as_rules(args.rules)
    if args.model == "mlp":
        net, data_shapes, label_shapes = build_mlp(mt, args.batch_size)
    else:
        net, data_shapes, label_shapes = build_transformer(
            mt, args.batch_size, seq_len=args.seq_len, hidden=args.hidden,
            layers=args.layers, heads=args.heads, vocab=args.vocab)

    mod = mt.mod.Module(net, context=ctx)
    mod.bind(data_shapes=data_shapes, label_shapes=label_shapes,
             mesh=mesh, partition_rules=rules)
    mod.init_params(initializer=mt.init.Xavier(magnitude=2.0))
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})

    group = mod._exec_group
    executor = group.execs[0]
    shapes = {n: tuple(executor.arg_dict[n].shape) for n in group.param_names}
    shapes.update({n: tuple(executor.aux_dict[n].shape)
                   for n in group.aux_names})
    print("== mesh ==")
    print(sharding.mesh_axes(mesh))
    print("\n== rule table ==")
    print(rules.explain_str(shapes))

    print("\n== per-parameter sharding ==")
    params = {n: executor.arg_dict[n] for n in group.param_names}
    params.update({n: executor.aux_dict[n] for n in group.aux_names})
    for name, arr in sorted(params.items()):
        spec = group._param_specs.get(name)
        factor = sharding.spec_shard_factor(mesh, spec) \
            if spec is not None else 1
        print("%-28s %-16s %d-way  %s" % (
            name, tuple(arr.shape), factor, tuple(spec or ())))
    per_dev, repl = sharding.param_bytes(params.values())
    print("\nper-device param bytes: %d (replicated would be %d, %.2fx)"
          % (per_dev, repl, repl / max(per_dev, 1)))

    step_ms = 0.0
    if args.steps:
        batch = synthetic_batch(mt, ctx, data_shapes, label_shapes,
                                vocab=args.vocab)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            mod.forward_backward(batch)
            mod.update()
        for o in mod.get_outputs():
            o.asnumpy()
        step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    plan = walk_plan(executor)
    print("\n== partitioned walk plan ==")
    print("gathered ops: %s" % ", ".join(plan["gathered_ops"]))
    print("strategies: %s" % plan["strategies"])
    print("kernel launches per step: %s" % plan["kernel_launches_per_step"])

    record = {
        "probe": "shard",
        "model": args.model,
        "mesh": sharding.mesh_axes(mesh),
        "rules": rules.name,
        "params_sharded_bytes": per_dev,
        "params_replicated_bytes": repl,
        "walk": plan,
        "avg_step_ms": round(step_ms, 2),
        "steps": args.steps,
        "contexts": [str(c) for c in contexts],
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
