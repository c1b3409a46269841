"""Port parity for splash attention: ``mxnet_tpu_torch.ops.attention.
splash_attention`` and the op ``_contrib_SplashAttention`` against the JAX
package's wrapper around upstream JAX's splash kernel, run in interpret
mode as tests/test_transformer.py runs it, on identical numpy inputs; the
splash LM's graph JSON and a 3-step Module train of it.

On CPU tensors the port takes its plain versions (``attention_reference`` /
``attention_backward_reference`` on the pre-scaled q at scale 1); the CUDA
kernels (K1's split-P variant, K2, K3) are held against those on the card by
chip_smoke.py.  Tolerances: the forward within 1e-5 abs in float32 and one
bf16 ulp of max|ref| in bf16 (both keep P in float32 and round O once);
gradients within 1e-4 of max|ref| in float32 and 2e-2 in bf16 (splash's
backward rounds P and dS to bf16, the plain version keeps them in
float32)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.transformer import get_transformer_lm as jax_lm
from mxnet_tpu.ops.attention import splash_attention as jax_splash
from mxnet_tpu_torch.models.transformer import get_transformer_lm as port_lm
from mxnet_tpu_torch.ops import OpContext, get_op
from mxnet_tpu_torch.ops import attention as att

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _bf16_ulp(x):
    """One bf16 ulp at magnitude ``x`` (8 bits of mantissa)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [32, 64, 96, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_splash_matches_jax_splash(causal, d, s, dtype):
    """Forward and the gradients of q, k and v for one output cotangent."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(d + s + int(causal))
    q, k, v, do = (rng.randn(1, s, 2, d).astype(np.float32)
                   for _ in range(4))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jo, vjp = jax.vjp(lambda a, b, c: jax_splash(a, b, c, causal=causal),
                      *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(x).to(TORCH[dtype]).requires_grad_(True)
                  for x in (q, k, v))
    o = att.splash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv),
                                torch.from_numpy(do).to(TORCH[dtype]))
    assert o.dtype == TORCH[dtype] and o.shape == jo.shape
    ref = np.asarray(jo, np.float32)
    err = np.abs(o.detach().float().numpy() - ref).max()
    fwd_tol = 1e-5 if dtype == "float32" else _bf16_ulp(np.abs(ref).max())
    assert err <= fwd_tol, (err, fwd_tol)
    for name, got, jref in zip("qkv", grads, jgrads):
        assert got.dtype == TORCH[dtype]
        e = _rel(got.float().numpy(), np.asarray(jref, np.float32))
        assert e <= GRAD_TOL[dtype], (name, e)


def test_splash_op_matches_jax_op_and_scales_q_in_its_dtype():
    """``_contrib_SplashAttention`` through both registries with an explicit
    scale; the port pre-scales q in its own dtype, so a bf16 q gives what
    the plain version gives on the rounded product at scale 1."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op

    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 128, 2, 64).astype(np.float32) for _ in range(3))
    attrs = {"causal": False, "scale": 0.3}
    jop = jget_op("_contrib_SplashAttention")
    (jo,), _ = jop.apply(JOpContext(), jop.parse_attrs(attrs),
                         [jnp.asarray(x) for x in (q, k, v)])
    op = get_op("_contrib_SplashAttention")
    assert op.hint == "splashattention"
    (o,), _ = op.apply(OpContext(), op.parse_attrs(attrs),
                       [torch.from_numpy(x) for x in (q, k, v)])
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)

    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = att.splash_attention(tq, tk, tv, causal=True, scale=0.3)
    scaled = tq * torch.tensor(0.3, dtype=torch.bfloat16)
    assert scaled.dtype == torch.bfloat16
    want, _ = att.attention_reference(scaled, tk, tv, True, 1.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [100, 200])
def test_splash_rejects_sequences_off_128_in_both_packages(s):
    import jax.numpy as jnp

    x = np.zeros((1, s, 2, 64), np.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        jax_splash(*(jnp.asarray(x),) * 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        att.splash_attention(*(torch.from_numpy(x),) * 3)


def test_splash_on_meta_tensors():
    q = torch.empty((2, 256, 4, 96), device="meta")
    assert att.splash_attention(q, q, q).shape == (2, 256, 4, 96)


LM = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=64, seq_len=128,
          attn_impl="splash")
SHAPE = (2, LM["seq_len"])


def test_splash_lm_json_is_byte_identical():
    with mx.NameManager():
        jn = jax_lm(**LM)
    with mt.NameManager():
        tn = port_lm(**LM)
    assert tn.tojson() == jn.tojson()
    assert "_contrib_SplashAttention" in tn.tojson()
    # a JSON written by the JAX package loads in the port and back
    assert mt.sym.load_json(jn.tojson()).tojson() == jn.tojson()


def lm_init(net, shape, vocab_size, seed=0, std=0.3):
    """One numpy init of an LM (N(0, std) matrices, unit gains, zero shifts
    and biases) and one batch of tokens X with labels (X + 1) % vocab."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    params = {}
    for name, ashape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(ashape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(ashape, np.float32)
        else:
            params[name] = rng.randn(*ashape).astype(np.float32) * std
    X = rng.randint(0, vocab_size, shape).astype(np.float32)
    return params, X, (X + 1) % vocab_size


def train_lm(pkg, net, shape, params, X, Y, compute_dtype=None):
    """3 adam steps of ``net`` from ``params`` on one batch through
    ``pkg``'s Module and its fused step: (losses, parameters)."""
    mod = pkg.mod.Module(net, context=pkg.cpu(), compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in params.items()},
                    aux_params={})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 1e-3,
                                         "epsilon": 1e-4})
    batch = pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                             [pkg.nd.array(Y, pkg.cpu())])
    losses = []
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
        p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float32)
        losses.append(float(-np.log(p[np.arange(p.shape[0]),
                                      Y.reshape(-1).astype(int)]).mean()))
    args, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in args.items()}


def both_lms(cfg):
    """The JAX package's and the port's ``get_transformer_lm(**cfg)``, each
    under a fresh NameManager; their JSON is byte-identical."""
    with mx.NameManager():
        jn = jax_lm(**cfg)
    with mt.NameManager():
        tn = port_lm(**cfg)
    assert tn.tojson() == jn.tojson()
    return jn, tn


def lm_trains_like_jax(cfg, shape, compute_dtype, seed=0, std=0.3):
    """3 adam steps of ``get_transformer_lm(**cfg)`` from one numpy init
    (``lm_init``) in both packages (``train_lm``).  float32: losses and
    parameters within 1e-4 (parameters against the largest); bf16: within
    2e-2, and the change of the parameters within ``BF16_CHANGE_LIMIT`` of
    its norm (tests/test_torch_train.py)."""
    from test_torch_train import BF16_CHANGE_LIMIT, _rel_norm

    jn, tn = both_lms(cfg)
    params, X, Y = lm_init(jn, shape, cfg["vocab_size"], seed, std)
    ref_losses, ref = train_lm(mx, jn, shape, params, X, Y, compute_dtype)
    losses, got = train_lm(mt, tn, shape, params, X, Y, compute_dtype)
    tol = 1e-4 if compute_dtype is None else 2e-2
    assert losses[-1] < losses[0]
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) / abs(b) <= tol, (losses, ref_losses)
    scale = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() / scale <= tol, k
    change = {k: got[k] - params[k] for k in params}
    ref_change = {k: ref[k] - params[k] for k in params}
    limit = tol if compute_dtype is None else BF16_CHANGE_LIMIT
    assert _rel_norm(change, ref_change) <= limit


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_splash_lm_training_matches_jax(compute_dtype):
    """The 2-layer splash LM trains 3 steps as the JAX package trains it
    (``lm_trains_like_jax``)."""
    lm_trains_like_jax(LM, SHAPE, compute_dtype)
