"""The float32 attention kernels' split-TF32 arithmetic, emulated on the
CPU: the backward (K2/K3) and the forward (K1).

On the card the float32 K1 (``csrc/flash_fwd.cu``) and K2/K3
(``csrc/flash_bwd.cu``) run every product on the tensor cores in TF32 (10
explicit mantissa bits).  Each operand is
split as x = x_hi + x_lo, both rounded by ``cvt.rna.tf32.f32`` (to
nearest, ties away from zero, at the 13 low bits of the magnitude), and
A·B is taken as A_lo·B_hi + A_hi·B_lo + A_hi·B_hi accumulated in float32
(``hopper.cuh::split_tf32``, ``mma_3xtf32``).  Here the same split is
applied to the backward's products at a small size, in the kernels'
formulas (scores in base 2 against lse·log2(e), the scale applied to the
sums), against a float64 backward:

- the three-term split stays within 1e-4 of max |ref| (the card's limit
  against the plain version) and within 8x the plain float32 version's
  mean error (``chip_smoke.py``'s limit);
- one TF32 product alone breaks the 1e-4 limit, so the limit bites.

The forward is emulated as K1 takes it: S = Q Kᵀ over each 32 columns of d
(4 k-steps x 3 terms: a chain of 12 products) in a zeroed part added to S
in float32; an online softmax in base 2 over key tiles of 32 (16 at d=256),
exp2 of one rounding (FMA); O += P V per tile (12 products, 6 at d=256) in
a zeroed part added in float32; lse in natural log.  It is held against a
float64 forward as the backward is, and against the JAX package's
``_flash_forward`` in interpret mode on the same numpy inputs.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import attention as att

LOG2E = 1.4426950408889634
SPLIT_MEAN_LIMIT = 8.0  # chip_smoke.py's limit on the card


def tf32_rna(x):
    """cvt.rna.tf32.f32: round float32 ``x`` to 10 explicit mantissa bits,
    to nearest with ties away from zero (add half of the dropped 13 bits'
    weight to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm(a, b, terms):
    """a @ b in float32 from TF32 parts: three terms (the kernels') or one
    (a plain TF32 product)."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def inputs(d, s=64, h=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, h, d),
                                                        dtype=np.float32))
                   for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    o, lse = att.attention_reference(q, k, v, True, scale)
    return q, k, v, o, lse, do, scale


def backward_split(q, k, v, o, lse, do, scale, terms):
    """The causal backward as K2/K3 compute it, every product by ``mm``."""
    _, s, h, _ = q.shape
    mask = torch.ones((s, s), dtype=torch.bool).tril()
    delta = att._row_delta(o, do).reshape(h, s)
    outs = [torch.empty_like(q) for _ in range(3)]
    for j in range(h):
        qh, kh, vh, doh = (t[0, :, j] for t in (q, k, v, do))
        p = torch.exp2(mm(qh, kh.T, terms) * np.float32(scale * LOG2E)
                       - lse[j, :, None] * np.float32(LOG2E))
        p = torch.where(mask, p, torch.zeros(()))
        ds = p * (mm(doh, vh.T, terms) - delta[j, :, None])
        outs[0][0, :, j] = mm(ds, kh, terms) * np.float32(scale)
        outs[1][0, :, j] = mm(ds.T, qh, terms) * np.float32(scale)
        outs[2][0, :, j] = mm(p.T, doh, terms)
    return outs


def backward_f64(q, k, v, o, lse, do, scale):
    s, h = q.shape[1], q.shape[2]
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                  - lse.double().reshape(1, h, s, 1))
    p = torch.where(torch.ones((s, s), dtype=torch.bool).tril(), p,
                    torch.zeros((), dtype=torch.float64))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(1, h, s, 1)
    ds = p * (dp - delta) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q), dv)


def errors(got, truth):
    """(max |err| / max |truth|, mean |err|) per gradient."""
    return [((g.double() - t).abs().max() / t.abs().max()).item()
            for g, t in zip(got, truth)], \
        [(g.double() - t).abs().mean().item() for g, t in zip(got, truth)]


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)


def test_split_parts_are_tf32_and_carry_22_bits():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096, dtype=np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -22 * x.double().abs()).all()
    assert ((x.double() - hi.double()).abs()
            > 2.0 ** -16 * x.double().abs()).any()


@pytest.mark.parametrize("d", [32, 64, 128])
def test_three_term_split_holds_float32_precision(d):
    args = inputs(d)
    truth = backward_f64(*args)
    rel, mean = errors(backward_split(*args, terms=3), truth)
    _, plain_mean = errors(att.attention_backward_reference(
        *args[:6], True, args[6]), truth)
    assert max(rel) <= 1e-4, rel
    ratios = [m / p for m, p in zip(mean, plain_mean)]
    assert max(ratios) <= SPLIT_MEAN_LIMIT, ratios


@pytest.mark.parametrize("d", [32, 64, 128])
def test_one_tf32_product_breaks_the_limit(d):
    args = inputs(d)
    rel, _ = errors(backward_split(*args, terms=1), backward_f64(*args))
    assert max(rel) > 1e-4, rel


# -- the forward (K1) ---------------------------------------------------------

LN2 = 0.6931471805599453
CHUNK = 32  # columns of d per chained part of S (flash_fwd.cu: kChunkK)


def key_tile(d):
    """Keys per streamed tile of K1 (flash_fwd.cu: F32Fwd<D>::kStr)."""
    return 16 if d > 128 else 32


def forward_split(q, k, v, scale, terms, causal=True):
    """(o, lse) of q [1, sq, h, d], k, v [1, sk, h, d] as K1 computes
    them, every product by ``mm`` from TF32 parts."""
    _, sq, h, d = q.shape
    sk = k.shape[1]
    kt = key_tile(d)
    sl2 = np.float32(scale * LOG2E)
    o = torch.empty_like(q)
    lse = torch.empty((h, sq), dtype=torch.float32)
    rows = torch.arange(sq)[:, None]
    for j in range(h):
        qh, kh, vh = (t[0, :, j] for t in (q, k, v))
        m = torch.full((sq,), -1e30)
        l = torch.zeros(sq)
        acc = torch.zeros(sq, d)
        for k0 in range(0, sk, kt):
            kb, vb = kh[k0:k0 + kt], vh[k0:k0 + kt]
            sc = torch.zeros(sq, kb.shape[0])
            for c in range(0, d, CHUNK):
                sc = sc + mm(qh[:, c:c + CHUNK], kb[:, c:c + CHUNK].T, terms)
            cols = k0 + torch.arange(kb.shape[0])[None, :]
            if causal:
                sc = torch.where(cols <= rows, sc, torch.tensor(-np.inf))
            m_new = torch.maximum(m, sc.max(dim=-1).values * sl2)
            corr = torch.exp2(m - m_new)
            # exp2(fma(s, scale·log2e, -m)): one rounding
            p = torch.exp2((sc.double() * float(sl2) - m_new.double()[:, None])
                           .float())
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[:, None] + mm(p, vb, terms)
            m = m_new
        lsafe = torch.where(l > 0, l, torch.ones(()))
        o[0, :, j] = acc / lsafe[:, None]
        lse[j] = (m + torch.log2(lsafe)) * np.float32(LN2)
    return o, lse


def forward_f64(q, k, v, scale):
    _, s, h, _ = q.shape
    q, k, v = (t.double() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    sc = sc.masked_fill(~torch.ones((s, s), dtype=torch.bool).tril(),
                        float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    den = p.sum(dim=-1, keepdim=True)
    return (torch.einsum("bhqk,bkhd->bqhd", p / den, v),
            (m + torch.log(den)).reshape(h, s))


def fwd_inputs(d, s=96, h=2, seed=0):
    rng = np.random.default_rng(seed + d)
    return [rng.standard_normal((1, s, h, d), dtype=np.float32)
            for _ in range(3)], 1.0 / np.sqrt(d)


HEAD_DIMS = [32, 64, 96, 128, 256]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_split_holds_float32_precision(d):
    arrays, scale = fwd_inputs(d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    truth = forward_f64(q, k, v, scale)
    got = forward_split(q, k, v, scale, terms=3)
    plain = att.attention_reference(q, k, v, True, scale)
    rel, mean = errors(got, truth)
    _, plain_mean = errors(plain, truth)
    assert max(rel) <= 1e-4, rel
    assert mean[0] / plain_mean[0] <= SPLIT_MEAN_LIMIT, (mean, plain_mean)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_one_tf32_product_breaks_the_limit(d):
    arrays, scale = fwd_inputs(d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    rel, _ = errors(forward_split(q, k, v, scale, terms=1),
                    forward_f64(q, k, v, scale))
    assert max(rel) > 1e-4, rel


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_split_matches_the_jax_forward(d):
    """The emulated K1 against the JAX package's Pallas forward
    (``_flash_forward`` in interpret mode, blocks of 32) on the same numpy
    inputs, within 1e-4."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import _flash_forward

    arrays, scale = fwd_inputs(d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    o, lse = forward_split(q, k, v, scale, terms=3)
    jo, jlse = _flash_forward(*(jnp.asarray(a) for a in arrays), True, scale,
                              32, 32, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)
