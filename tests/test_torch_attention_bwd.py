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


def _bf16_views(layout, b, s, h, d):
    """q, k, v as the LM hands them over (strided views of one packed
    [b, s, 3, h, d] projection) or as three contiguous tensors."""
    if layout == "packed":
        qkv = torch.zeros((b, s, 3, h, d), dtype=torch.bfloat16)
        return tuple(t.squeeze(2) for t in qkv.split(1, dim=2))
    return tuple(torch.zeros((b, s, h, d), dtype=torch.bfloat16)
                 for _ in range(3))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["packed", "contiguous"])
@pytest.mark.parametrize("b,s,h", [(2, 40, 3), (1, 17, 1)])
def test_tma_rule_accepts_lm_views_and_contiguous(d, layout, b, s, h):
    for name, t in zip("qkv", _bf16_views(layout, b, s, h, d)):
        att._check_tma_view("flash_bwd_dq", name, t)
    st = att._strides(*_bf16_views(layout, b, s, h, d))
    assert st.dtype == torch.int64 and st.numel() == 9
    assert all(int(x) * 2 % 16 == 0 for x in st)


def test_tma_rule_ignores_strides_of_size_one_dims():
    """A dim of size 1 is never stepped along, so its stride (0 for an
    expanded batch, anything for ``as_strided``) is replaced by a packed
    one: the view is accepted and the kernels get strides TMA takes."""
    s, d = 24, 64
    base = torch.zeros((s, d), dtype=torch.bfloat16)
    views = (base[None, :, None, :].expand(1, s, 1, d),
             base.as_strided((1, s, 1, d), (7, d, 3, 1)))
    for t in views:
        att._check_tma_view("flash_bwd_dq", "q", t)
        assert [int(x) for x in att._strides(t)] == [s * d, d, d]


def _misaligned(kind, b=2, s=24, h=2, d=64):
    if kind == "base":  # one element past an aligned allocation
        flat = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
        return flat[1:].view(b, s, h, d)
    if kind == "head stride":  # heads 68 elements (136 bytes) apart
        return torch.zeros((b, s, h, d + 4), dtype=torch.bfloat16)[..., :d]
    if kind == "seq stride":  # rows 3 * 64 + 4 elements apart
        return torch.zeros((b, s, 3 * d + 4), dtype=torch.bfloat16)[
            ..., :h * d].view(b, s, h, d)
    return torch.zeros((b, s, h, 2 * d), dtype=torch.bfloat16)[..., ::2]


@pytest.mark.parametrize("kind", ["base", "head stride", "seq stride",
                                  "d stride"])
def test_tma_rule_rejects_misaligned_views(kind):
    t = _misaligned(kind)
    with pytest.raises(mt.MXNetError, match="TMA|unit stride"):
        att._check_tma_view("flash_bwd_dkv", "k", t)


def test_bf16_kernel_wrapper_refuses_misaligned_view_before_launch():
    """The wrappers check the rule before they touch the kernel library,
    and do not copy the view or fall back to the plain version."""
    q, k, v = _bf16_views("packed", 2, 24, 2, 64)
    do = torch.zeros_like(q)
    lse = torch.zeros((4, 24))
    delta = torch.zeros((4, 24))
    before = dict(mt.kernels.LAUNCHES)
    for fn in (att.flash_bwd_dq, att.flash_bwd_dkv):
        with pytest.raises(mt.MXNetError, match="TMA"):
            fn(q, _misaligned("base"), v, do, lse, delta, True, 0.125)
    assert mt.kernels.LAUNCHES == before


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
