"""Port parity for the attention backward: ``mxnet_tpu_torch.ops.attention.
flash_backward`` (dQ, dK, dV) against the JAX package's Pallas backward
``_flash_backward``, run in interpret mode as tests/test_attention.py runs
it, on identical numpy inputs (o and lse from the JAX forward, fed to
both); and ``_contrib_FlashAttention``'s gradient through both registries.
On CPU tensors the port's wrappers take their plain versions; the CUDA
kernels are held against those on the card by chip_smoke.py.  Tolerance:
max|err| / max|ref| <= 1e-4 in float32 (sums in another order), 2e-2 in
bfloat16 (the JAX kernels round P and dS to bf16 before their products)."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.ops.attention import _flash_backward, _flash_forward
from mxnet_tpu_torch.ops import OpContext, get_op
from mxnet_tpu_torch.ops import attention as att

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) * 0.6
                 for s in (sq, sk, sk, sq))


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _port(x, dtype):
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("causal,sq,sk,block,dtype", [
    (False, 64, 64, 32, "float32"),
    (True, 64, 64, 16, "float32"),
    (True, 32, 64, 16, "float32"),
    (False, 64, 32, 32, "float32"),
    (True, 64, 32, 32, "float32"),
    (True, 32, 32, 16, "bfloat16"),
    (False, 32, 48, 16, "bfloat16"),
])
def test_flash_backward_matches_pallas(causal, sq, sk, block, dtype):
    import jax.numpy as jnp

    q, k, v, do = _inputs(2, sq, sk, 2, 16, seed=sq + 2 * sk + int(causal))
    scale = 1.0 / np.sqrt(16)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    jo, jlse = _flash_forward(jq, jk, jv, causal, scale, block, block, True)
    grads_ref = _flash_backward(jq, jk, jv, jo, jlse, jdo, causal, scale,
                                block, block, True)
    o = _port(np.asarray(jo, np.float32), dtype)
    lse = torch.from_numpy(np.array(jlse))
    grads = att.flash_backward(_port(q, dtype), _port(k, dtype),
                               _port(v, dtype), o, lse, _port(do, dtype),
                               causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
        assert tuple(got.shape) == tuple(ref.shape)
        err = _rel(got.float().numpy(), ref)
        assert err <= TOL[dtype], (name, err)


def test_flash_backward_strided_views_and_meta():
    """The LM hands the kernels strided q/k/v views of one packed
    projection; the backward takes them as they are.  On meta tensors it
    gives the gradients' shapes."""
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(2, 40, 3, 2, 16).astype(np.float32))
    q, k, v = (t.squeeze(2) for t in qkv.split(1, dim=2))
    assert not q.is_contiguous()
    do = torch.from_numpy(rng.randn(2, 40, 2, 16).astype(np.float32))
    o, lse = att.flash_forward(q, k, v, True)
    strided = att.flash_backward(q, k, v, o, lse, do, True)
    dense = att.flash_backward(q.contiguous(), k.contiguous(),
                               v.contiguous(), o, lse, do, True)
    for a, b in zip(strided, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy())
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    dq, dk, dv = att.flash_backward(m(2, 48, 4, 32), m(2, 40, 4, 32),
                                    m(2, 40, 4, 32), m(2, 48, 4, 32),
                                    m(8, 48), m(2, 48, 4, 32), True)
    assert dq.shape == (2, 48, 4, 32) and dk.shape == dv.shape == (2, 40, 4,
                                                                    32)


def test_flash_backward_rejects_bad_shapes():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(mt.MXNetError):
        att.flash_backward(q, q, q, q, torch.zeros((2, 8)),
                           torch.zeros((1, 8, 2, 8)))
    with pytest.raises(mt.MXNetError):
        att.flash_backward(q, torch.zeros((1, 8, 3, 16)),
                           torch.zeros((1, 8, 3, 16)), q,
                           torch.zeros((2, 8)), q)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_op_gradients_match_jax_op(causal):
    """``_contrib_FlashAttention``'s gradient through both registries:
    the JAX op under ``jax.vjp`` (its custom vjp, the Pallas backward) and
    the port's op under autograd (``flash_backward``)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op

    q, k, v, g = _inputs(1, 64, 64, 2, 32, seed=7 + int(causal))
    attrs = {"causal": causal, "block_q": 32, "block_k": 32}
    jop = jget_op("_contrib_FlashAttention")
    jattrs = jop.parse_attrs(attrs)

    def f(q, k, v):
        return jop.apply(JOpContext(), jattrs, [q, k, v])[0][0]

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    refs = vjp(jnp.asarray(g))

    op = get_op("_contrib_FlashAttention")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    (o,), _ = op.apply(OpContext(), op.parse_attrs(attrs), [tq, tk, tv])
    o.backward(torch.from_numpy(g))
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), refs):
        assert _rel(got.numpy(), ref) <= TOL["float32"], name
