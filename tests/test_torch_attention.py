"""Port parity for attention: ``mxnet_tpu_torch.ops.attention.flash_forward``
(O and the natural-log lse) against the JAX package's Pallas forward
``_flash_forward``, run in interpret mode as tests/test_attention.py runs it,
on identical numpy inputs.  On CPU tensors the port's wrapper takes its
plain version; the CUDA kernel itself is held against that plain version on
the card by chip_smoke.py.  float32 tolerance 1e-5."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.ops.attention import _flash_forward
from mxnet_tpu_torch.ops import OpContext, get_op
from mxnet_tpu_torch.ops import attention as att

TOL = 1e-5


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,sq,sk,block", [
    (False, 64, 64, 32),
    (True, 64, 64, 16),
    (True, 32, 64, 16),
    (False, 64, 32, 32),
    (True, 64, 32, 32),
])
def test_flash_forward_matches_pallas(causal, sq, sk, block):
    import jax.numpy as jnp

    q, k, v = _qkv(2, sq, sk, 2, 16, seed=sq + sk + int(causal))
    scale = 1.0 / np.sqrt(16)
    jo, jlse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, scale, block, block, True)
    o, lse = att.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, scale)
    assert o.shape == jo.shape and lse.shape == jlse.shape
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=TOL,
                               atol=TOL)


def test_flash_op_matches_jax_op():
    """``_contrib_FlashAttention`` through both registries, with the block
    attrs the JAX op uses for its tiles (the port accepts and ignores
    them)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import OpContext as JOpContext, get_op as jget_op

    q, k, v = _qkv(1, 64, 64, 2, 32, seed=3)
    attrs = {"causal": True, "block_q": 32, "block_k": 32}
    jop = jget_op("_contrib_FlashAttention")
    (jo,), _ = jop.apply(JOpContext(), jop.parse_attrs(attrs),
                         [jnp.asarray(x) for x in (q, k, v)])
    op = get_op("_contrib_FlashAttention")
    (o,), _ = op.apply(OpContext(), op.parse_attrs(attrs),
                       [torch.from_numpy(x) for x in (q, k, v)])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    # functional form: output only
    o2 = att.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True)
    np.testing.assert_allclose(o2.numpy(), o.detach().numpy())


def test_flash_forward_strided_views_and_bf16():
    """The serving path hands the kernel strided q/k/v views of one packed
    projection; the plain version takes them as they are.  bf16 inputs give
    a bf16 O and a float32 lse."""
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(2, 40, 3, 2, 16).astype(np.float32))
    q, k, v = (t.squeeze(2) for t in qkv.split(1, dim=2))
    assert not q.is_contiguous()
    o, lse = att.flash_forward(q, k, v, True)
    o_c, lse_c = att.flash_forward(q.contiguous(), k.contiguous(),
                                   v.contiguous(), True)
    np.testing.assert_allclose(o.numpy(), o_c.numpy())
    np.testing.assert_allclose(lse.numpy(), lse_c.numpy())
    ob, lseb = att.flash_forward(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 True)
    assert ob.dtype == torch.bfloat16 and lseb.dtype == torch.float32
    np.testing.assert_allclose(ob.float().numpy(), o.numpy(), atol=2e-2)


def test_flash_forward_on_meta_tensors():
    q = torch.empty((2, 48, 4, 32), device="meta")
    k = torch.empty((2, 40, 4, 32), device="meta")
    o, lse = att.flash_forward(q, k, k, True)
    assert o.shape == (2, 48, 4, 32) and lse.shape == (8, 48)


def test_flash_forward_rejects_bad_shapes():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(mt.MXNetError):
        att.flash_forward(q, torch.zeros((1, 8, 3, 16)),
                          torch.zeros((1, 8, 3, 16)))
    with pytest.raises(mt.MXNetError):
        att.flash_forward(q, torch.zeros((1, 0, 2, 16)),
                          torch.zeros((1, 0, 2, 16)))


def test_backward_not_ported_raises():
    """The op's gradient is ported (it once raised here): autograd through
    ``_contrib_FlashAttention`` reaches ``flash_backward`` and matches
    autograd of plain dense attention."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 1, 16).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    op = get_op("_contrib_FlashAttention")
    (o,), _ = op.apply(OpContext(), op.parse_attrs({"causal": True}),
                       [q, k, v])
    grads = torch.autograd.grad(o.sum(), (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    s = s.masked_fill(~torch.ones(8, 8, dtype=torch.bool).tril(), -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    refs = torch.autograd.grad(ref.sum(), (q, k, v))
    for g, r in zip(grads, refs):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: without a compiler the kernel library cannot be
    had, and asking for it raises."""
    from mxnet_tpu_torch import kernels

    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_LIBS", {})
    before = kernels.LAUNCHES["flash_fwd"]
    with pytest.raises(mt.MXNetError, match="nvcc"):
        kernels.library("flash_fwd")
    assert kernels.LAUNCHES["flash_fwd"] == before


@pytest.mark.parametrize("causal,sq,sk", [
    (True, 128, 128),
    (False, 128, 128),
    (True, 64, 128),
])
def test_bf16_flash_forward_matches_pallas_bf16(causal, sq, sk):
    """bf16 in, as the train step runs: the port's plain route against the
    Pallas forward run in bf16 (interpret mode, blocks of 64).  Both take
    the products from bf16 operands with float32 sums; the Pallas kernel
    rounds P to bf16 before P·V where the plain version keeps it in
    float32, so O agrees within 2e-2 abs (one bf16 rounding of O and of
    P); lse, summed over float32 P in both, within 1e-3."""
    import jax.numpy as jnp

    q, k, v = _qkv(2, sq, sk, 2, 64, seed=sq + sk + int(causal) + 7)
    scale = 1.0 / np.sqrt(64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jo, jlse = _flash_forward(*(jnp.asarray(t.float().numpy(),
                                            dtype=jnp.bfloat16)
                                for t in (tq, tk, tv)),
                              causal, scale, 64, 64, True)
    o, lse = att.flash_forward(tq, tk, tv, causal, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert jo.dtype == jnp.bfloat16 and o.shape == jo.shape
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, dtype=np.float32), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-3)


def _long(dtype, sq, d=64):
    """q, k, v of ``sq`` rows that take no memory: one row expanded."""
    row = torch.zeros((1, 1, 1, d), dtype=dtype)
    return (row.expand(1, sq, 1, d),) * 3


def test_forward_launch_rows_per_block_and_grid_limit():
    """The forward kernel takes at least 64 query rows per block in float32
    (one warpgroup at width 256, two elsewhere) and 128 in bf16 (two
    warpgroups); a sequence that needs more than 65535 blocks of the fewest
    rows raises before any launch."""
    assert att._FWD_BLOCK_Q == {torch.float32: 64, torch.bfloat16: 128}
    att._check_forward_launch(*_long(torch.float32, 65535 * 64))
    with pytest.raises(mt.MXNetError, match="grid"):
        att._check_forward_launch(*_long(torch.float32, 65535 * 64 + 1))
    att._check_forward_launch(*_long(torch.bfloat16, 65535 * 64 + 1))
    att._check_forward_launch(*_long(torch.bfloat16, 65535 * 128))
    with pytest.raises(mt.MXNetError, match="grid"):
        att._check_forward_launch(*_long(torch.bfloat16, 65535 * 128 + 1))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_forward_launch_refuses_bf16_view_off_a_16_byte_boundary(which):
    """The bf16 forward reads q, k and v with TMA: a view 2 bytes past a
    16-byte boundary raises in the wrapper, before it touches the kernel
    library, with no copy and no other kernel.  float32 runs the split-TF32
    kernel, fed by cp.async, which reads any view with unit stride in d."""
    b, s, h, d = 2, 24, 2, 64
    for dtype in (torch.bfloat16, torch.float32):
        qkv = [torch.zeros((b, s, h, d), dtype=dtype) for _ in range(3)]
        flat = torch.zeros(b * s * h * d + 1, dtype=dtype)
        qkv[which] = flat[1:].view(b, s, h, d)
        assert qkv[which].data_ptr() % 16 == flat.element_size()
        if dtype == torch.float32:
            att._check_forward_launch(*qkv)
            continue
        before = dict(mt.kernels.LAUNCHES)
        with pytest.raises(mt.MXNetError, match="TMA"):
            att._flash_forward_cuda(*qkv, True, 0.125)
        assert mt.kernels.LAUNCHES == before
