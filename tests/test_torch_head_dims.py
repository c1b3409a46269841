"""Head dims on the port's attention kernels: the kernels take d = 32, 64,
96, 128 and 256 (32 and 96 zero-padded to the instantiated widths 64 and
128) and refuse any other d on a CUDA tensor before a launch.  On the CPU,
the width mapping and the refusal, flash forward and backward at the new
dims against the JAX package's Pallas kernels (interpret mode, which take
any d), and LMs whose head dim is 32, 96 or 256 trained 3 steps in both
packages.  The CUDA kernels at these dims are held against the plain
versions on the card by chip_smoke.py.  Tolerances as in
tests/test_torch_attention.py and tests/test_torch_attention_bwd.py."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.attention import _flash_backward, _flash_forward
from mxnet_tpu_torch.ops import attention as att

from test_torch_splash import both_lms, lm_init, lm_trains_like_jax, train_lm
from test_torch_train import _rel_norm


@pytest.mark.parametrize("d,width", [(32, 64), (64, 64), (96, 128),
                                     (128, 128), (256, 256)])
def test_kernel_width_of_each_supported_head_dim(d, width):
    assert att.kernel_width(d) == width
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((2, 130, 3, d), dtype=dtype)
        att._check_forward_launch(q, q, q)  # checks only, launches nothing


@pytest.mark.parametrize("d", [16, 48, 512])
def test_other_head_dims_raise_before_any_launch(d):
    with pytest.raises(mt.MXNetError, match="head dim %d not supported" % d):
        att.kernel_width(d)
    before = dict(mt.kernels.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 64, 2, d), dtype=dtype)
        lse = torch.zeros((2, 64))
        with pytest.raises(mt.MXNetError, match="supported: \\(32, 64, 96, "
                                                "128, 256\\)"):
            att._flash_forward_cuda(q, q, q, True, 0.1)
        with pytest.raises(mt.MXNetError, match="head dim"):
            att.flash_bwd_dq(q, q, q, q, lse, lse, True, 0.1)
        with pytest.raises(mt.MXNetError, match="head dim"):
            att.flash_bwd_dkv(q, q, q, q, lse, lse, True, 0.1)
    assert mt.kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 96, 256])
def test_flash_at_new_head_dims_matches_pallas(d, dtype):
    """Forward (O, lse) and backward (dQ, dK, dV) at b=1, s=96, h=2 causal
    against the Pallas kernels in interpret mode: float32 1e-5 abs on the
    forward and 1e-4 of max|ref| on the gradients; bf16 2e-2 (the Pallas
    kernels round P and dS to bf16 before their products)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(d)
    q, k, v, do = (rng.randn(1, 96, 2, d).astype(np.float32) * 0.6
                   for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jo, jlse = _flash_forward(jq, jk, jv, True, scale, 32, 32, True)
    jgrads = _flash_backward(jq, jk, jv, jo, jlse, jdo, True, scale, 32, 32,
                             True)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = att.flash_forward(tq, tk, tv, True, scale)
    fwd_tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, np.float32), rtol=0,
                               atol=fwd_tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=fwd_tol if dtype == "float32" else 1e-3)
    o_ref = torch.from_numpy(np.array(jo, np.float32)).to(tdt)
    grads = att.flash_backward(tq, tk, tv, o_ref,
                               torch.from_numpy(np.array(jlse)), tdo, True,
                               scale)
    bwd_tol = 1e-4 if dtype == "float32" else 2e-2
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= bwd_tol, (name, err)


# (num_heads, hidden): head dims 32, 96 and 256
HEAD_DIM_LMS = {32: (2, 64), 96: (2, 192), 256: (1, 256)}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", sorted(HEAD_DIM_LMS))
def test_lm_with_head_dim_trains_like_jax(d, compute_dtype):
    """The LM at head dim d trains 3 steps as the JAX package trains it.  The
    init's std is 0.3 * sqrt(64 / hidden), so that every width has the
    pre-activation spread of the 64-wide LM of tests/test_torch_train.py
    (N(0, 0.3)); at N(0, 0.3) a 256-wide LM's pre-activations spread 2x as
    far and three steps amplify summation order past the limits."""
    heads, hidden = HEAD_DIM_LMS[d]
    cfg = dict(vocab_size=64, num_layers=2, num_heads=heads, hidden=hidden,
               seq_len=32)
    assert hidden // heads == d
    lm_trains_like_jax(cfg, (2, 32), compute_dtype,
                       std=0.3 * np.sqrt(64 / hidden))


def _one_ulp_off(params, seed=1):
    """``params`` with every element of the random matrices moved one
    float32 ulp up or down at random; unit gains and zero shifts kept."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in params.items():
        if k.endswith(("_gamma", "_beta", "_bias")):
            out[k] = v
        else:
            to = np.where(rng.rand(*v.shape) < 0.5, -np.inf, np.inf)
            out[k] = np.nextafter(v, to.astype(np.float32))
    return out


@pytest.mark.parametrize("d", [96, 256])
def test_lm_gap_at_spread_0_3_is_amplified_roundoff(d):
    """Why the LMs above start at std 0.3 * sqrt(64 / hidden).  At N(0, 0.3)
    three float32 steps of the 192- and 256-wide LMs amplify roundoff: one
    float32 ulp of the init (about 1e-7 of each entry) moves either
    package's parameters by at least half the 1e-4 limit, by both measures
    (the largest change against the largest parameter, and the norm of the
    change), while the gap between the packages is no larger than that.
    Prints the readings (``-s``)."""
    heads, hidden = HEAD_DIM_LMS[d]
    cfg = dict(vocab_size=64, num_layers=2, num_heads=heads, hidden=hidden,
               seq_len=32)
    shape = (2, 32)
    jn, tn = both_lms(cfg)
    params, X, Y = lm_init(jn, shape, cfg["vocab_size"], 0, 0.3)
    off = _one_ulp_off(params)
    jax_p, port, jax_off, port_off = (
        train_lm(pkg, net, shape, init, X, Y)[1]
        for pkg, net, init in ((mx, jn, params), (mt, tn, params),
                               (mx, jn, off), (mt, tn, off)))
    scale = max(np.abs(v).max() for v in jax_p.values())

    def gaps(a, b, init_b):
        largest = max(np.abs(a[k] - b[k]).max() for k in a) / scale
        norm = _rel_norm({k: a[k] - params[k] for k in a},
                         {k: b[k] - init_b[k] for k in b})
        return largest, norm

    pairs = {"jax-port": gaps(port, jax_p, params),
             "port-port(init 1 ulp off)": gaps(port, port_off, off),
             "jax-jax(init 1 ulp off)": gaps(jax_p, jax_off, off)}
    print("d=%d hidden=%d N(0, 0.3), 3 float32 adam steps: %s" % (
        d, hidden, ", ".join("%s: largest %.3g, norm %.3g" % (k, *v)
                             for k, v in pairs.items())))
    between = pairs.pop("jax-port")
    for i in range(2):
        worst_off = max(v[i] for v in pairs.values())
        assert min(v[i] for v in pairs.values()) >= 5e-5, pairs
        assert between[i] <= worst_off, (between, pairs)
