"""The port's ``parallel`` package against the JAX package's on the same
numpy inputs (tests/test_parallel.py): ring attention, ring-flash attention
forward and gradients, ulysses, the 2-D mesh, the pipeline, MoE at top-k 1
and 2, ``MeshConfig`` and ``current_mesh``; the ring's block schedule and
launch counts; and the long-context train step of chip_smoke.py (its torch
copy of examples/transformer/train_lm_longctx.py) against the example's
``make_step``.  The JAX side runs on the 8 virtual CPU devices, Pallas in
interpret mode; the port's shards on ``cpu(0..7)``."""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar


def _qkv(b=2, s=32, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


def _jmesh(axes, n=None):
    import jax

    devs = jax.devices()[:n] if n else None
    return jpar.make_mesh(axes, devices=devs) if devs else \
        jpar.make_mesh(axes)


def _tmesh(axes, n=8):
    return tpar.make_mesh(axes, devices=[mt.cpu(i) for i in range(n)])


def _j(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _t(x, grad=False):
    t = torch.tensor(np.asarray(x))
    return t.requires_grad_(True) if grad else t


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()) if
                               isinstance(got, torch.Tensor) else
                               np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(causal):
    q, k, v = _qkv()
    ref = jpar.ring_attention(_j(q), _j(k), _j(v), _jmesh({"seq": 8}),
                              causal=causal)
    out = tpar.ring_attention(_t(q), _t(k), _t(v), _tmesh({"seq": 8}),
                              causal=causal)
    _close(out, ref)
    _close(out, tpar.local_attention(_t(q), _t(k), _t(v), causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_matches_jax(causal):
    """Forward and gradients of the ring over 4 shards (K1 per block, K2/K3
    with the global lse and Δ on the way back; here their plain versions)
    against the JAX ring over its Pallas kernels."""
    import jax
    import jax.numpy as jnp

    q, k, v = _qkv(b=2, s=128, h=2, d=16)
    jmesh = _jmesh({"seq": 4}, 4)
    tmesh = _tmesh({"seq": 4}, 4)

    def jloss(q, k, v):
        o = jpar.ring_flash_attention(q, k, v, jmesh, causal=causal,
                                      block_q=32, block_k=32)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(_j(q), _j(k), _j(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    to = tpar.ring_flash_attention(tq, tk, tv, tmesh, causal=causal)
    (to.float() ** 2).sum().backward()
    _close(to, jo)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_launch_counts_follow_the_block_schedule(monkeypatch,
                                                            causal):
    """n(n+1)/2 blocks of each kernel under causal, n² without: the
    forward calls K1 once per scheduled block (the diagonal causal, past
    blocks full), the backward K2 and K3 once each, all with the global
    lse and one Δ per shard."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.parallel import ring

    n = 4
    sched = ring._block_schedule(n, causal)
    assert len(sched) == (n * (n + 1) // 2 if causal else n * n)
    assert all((j == i) == diag for _, i, j, diag in sched)
    assert not causal or all(j <= i for _, i, j, _ in sched)
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = att.flash_forward, att.attention_bwd_reference

    def count_fwd(q, k, v, causal_, scale):
        calls["fwd"].append(causal_)
        return fwd(q, k, v, causal_, scale)

    def count_bwd(q, k, v, do, lse, delta, causal_, scale):
        calls["bwd"].append((id(lse), id(delta), causal_))
        return bwd(q, k, v, do, lse, delta, causal_, scale)

    monkeypatch.setattr(att, "flash_forward", count_fwd)
    monkeypatch.setattr(att, "attention_bwd_reference", count_bwd)
    q, k, v = (_t(x, True) for x in _qkv(b=1, s=64, h=2, d=16))
    o = tpar.ring_flash_attention(q, k, v, _tmesh({"seq": n}, n),
                                  causal=causal)
    o.sum().backward()
    want = n * (n + 1) // 2 if causal else n * n
    assert len(calls["fwd"]) == want and len(calls["bwd"]) == want
    assert sum(calls["fwd"]) == (n if causal else 0)
    # one lse and one Δ per shard, reused by every block of its row
    assert len({c[:2] for c in calls["bwd"]}) == n


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(causal):
    q, k, v = _qkv(h=8)
    ref = jpar.ulysses_attention(_j(q), _j(k), _j(v), _jmesh({"seq": 8}),
                                 causal=causal)
    out = tpar.ulysses_attention(_t(q), _t(k), _t(v), _tmesh({"seq": 8}),
                                 causal=causal)
    _close(out, ref)


def test_ring_attention_2d_mesh_batch_sharded():
    q, k, v = _qkv(b=4, s=16)
    ref = jpar.ring_attention(_j(q), _j(k), _j(v),
                              _jmesh({"data": 2, "seq": 4}), axis="seq",
                              batch_axis="data", causal=True)
    tmesh = _tmesh({"data": 2, "seq": 4})
    out = tpar.ring_attention(_t(q), _t(k), _t(v), tmesh, axis="seq",
                              batch_axis="data", causal=True)
    _close(out, ref)
    flash = tpar.ring_flash_attention(_t(q), _t(k), _t(v), tmesh,
                                      axis="seq", batch_axis="data",
                                      causal=True)
    _close(flash, ref)


def test_ring_attention_grads_match_jax():
    import jax

    q, k, v = _qkv(s=16)
    jmesh = _jmesh({"seq": 8})
    jg = jax.grad(lambda q, k, v: jpar.ring_attention(
        q, k, v, jmesh, causal=True).sum(), argnums=(0, 1, 2))(
            _j(q), _j(k), _j(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tpar.ring_attention(tq, tk, tv, _tmesh({"seq": 8}),
                        causal=True).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want, rtol=1e-4, atol=1e-4)


def test_pipeline_spmd_matches_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    ws = rng.randn(4, 6, 6).astype(np.float32) * 0.3
    x = rng.randn(8, 6).astype(np.float32)
    ref = jpar.pipeline_spmd(lambda w, a: jnp.tanh(a @ w), _j(ws), _j(x),
                             _jmesh({"pipe": 4}, 4), axis="pipe",
                             n_microbatches=4)
    tw = _t(ws, True)
    out = tpar.pipeline_spmd(lambda w, a: torch.tanh(a @ w), tw, _t(x),
                             _tmesh({"pipe": 4}, 4), axis="pipe",
                             n_microbatches=4)
    _close(out, ref)
    out.sum().backward()  # the gradient rides ppermute back stage by stage
    assert tw.grad is not None and torch.isfinite(tw.grad).all()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_expert_parallel_matches_jax(top_k):
    import jax
    import jax.numpy as jnp

    b, s, d, h, E = 2, 6, 8, 16, 8
    rng = np.random.RandomState(0)
    x = rng.randn(b, s, d).astype(np.float32)
    gw = rng.randn(d, E).astype(np.float32) * 0.5
    w1 = rng.randn(E, d, h).astype(np.float32) * 0.3
    w2 = rng.randn(E, h, d).astype(np.float32) * 0.3
    jmesh = _jmesh({"expert": 4}, 4)
    ref = jpar.moe_ffn(_j(x), _j(gw), _j(w1), _j(w2), jmesh, top_k=top_k)
    jg = jax.grad(lambda w: jnp.sum(jpar.moe_ffn(
        _j(x), _j(gw), w, _j(w2), jmesh, top_k=top_k) ** 2))(_j(w1))
    tmesh = _tmesh({"expert": 4}, 4)
    tw1 = _t(w1, True)
    out = tpar.moe_ffn(_t(x), _t(gw), tw1, _t(w2), tmesh, top_k=top_k)
    _close(out, ref, atol=1e-6)
    _close(out, tpar.moe_ffn_reference(_t(x), _t(gw), _t(w1), _t(w2),
                                       top_k=top_k), atol=1e-6)
    (out ** 2).sum().backward()
    _close(tw1.grad, jg, rtol=1e-4, atol=1e-5)


def test_moe_validates_expert_divisibility():
    mesh = _tmesh({"expert": 4}, 4)
    x = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="divisible"):
        tpar.moe_ffn(x, torch.zeros((4, 6)), torch.zeros((6, 4, 8)),
                     torch.zeros((6, 8, 4)), mesh)
    with pytest.raises(ValueError, match="gate has"):
        tpar.moe_ffn(x, torch.zeros((4, 8)), torch.zeros((4, 4, 8)),
                     torch.zeros((4, 8, 4)), mesh)


def test_mesh_config_infer():
    jm = jpar.make_mesh({"data": -1, "model": 2})
    tm = _tmesh({"data": -1, "model": 2})
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape["data"] * 2 == len(tm.devices.ravel())
    with pytest.raises(ValueError):
        tpar.MeshConfig(a=-1, b=-1).resolve(8)
    with pytest.raises(ValueError):
        tpar.MeshConfig(a=3).resolve(8)


def test_current_mesh_scope():
    mesh = tpar.data_parallel_mesh(devices=[mt.cpu(i) for i in range(8)])
    assert tpar.current_mesh() is None
    with tpar.set_current_mesh(mesh):
        assert tpar.current_mesh() is mesh
    assert tpar.current_mesh() is None


def test_default_mesh_needs_a_card():
    """``devices=None`` is one shard per CUDA device; without one it
    raises instead of building a CPU mesh."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default mesh is built")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        tpar.make_mesh({"seq": 4})


def test_shard_and_replicate_place_one_piece_per_shard():
    mesh = _tmesh({"data": 2, "seq": 4})
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    sh = tpar.shard(x, mesh, ("data", "seq"))
    assert sh.shards[(1, 2)].tolist() == x[4:8, 2:3].tolist()
    assert torch.equal(sh.full(), x)
    rep = tpar.replicate(x, mesh)
    assert rep.is_fully_replicated and torch.equal(rep.shards[(1, 3)], x)


def test_shard_map_collectives():
    """The collectives a per-shard function gets, on a 2 x 4 mesh: each
    along one axis, within the shard's group of the other."""
    from mxnet_tpu_torch.parallel import _compat as c

    mesh = _tmesh({"data": 2, "seq": 4})
    x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)

    def f(x):
        i = c.axis_index("seq")
        return (c.all_gather(x, "seq", dim=1, tiled=True),
                c.all_gather(x, "seq").sum(0),
                c.psum(x, "seq"),
                c.ppermute(x, "seq", [(j, (j + 1) % 4) for j in range(4)]),
                c.all_to_all(x, "seq", split_axis=2, concat_axis=1),
                torch.full_like(x, float(i)))

    spec = tpar.PartitionSpec("data", "seq", None)
    gathered, stacked, summed, rolled, a2a, idx = c.shard_map(
        f, mesh=mesh, in_specs=(spec,),
        out_specs=(tpar.PartitionSpec("data", None, None),
                   tpar.PartitionSpec("data", None, None),
                   tpar.PartitionSpec("data", None, None), spec,
                   tpar.PartitionSpec("data", None, "seq"), spec))(x)
    assert torch.equal(gathered, x)
    want = x.reshape(2, 4, 2, 4).sum(1)
    assert torch.equal(summed, want) and torch.equal(stacked, want)
    assert torch.equal(rolled, torch.roll(x, 2, dims=1))
    assert torch.equal(a2a, x)
    assert torch.equal(idx[:, :, 0], torch.arange(4).repeat_interleave(2)
                       .float().expand(2, 8))
    with pytest.raises(mt.MXNetError, match="inside a shard_map"):
        c.psum(x, "seq")


def test_long_context_step_matches_the_example():
    """chip_smoke.py's torch copy of train_lm_longctx.py's build_params and
    make_step (2 layers x 128, seq 256, 4 sequence shards) over 3 steps:
    losses and parameters within 1e-4 of the example's."""
    import jax
    from jax.sharding import Mesh

    import chip_smoke
    from examples.transformer import train_lm_longctx as ex

    vocab, hidden, heads, layers, seq, batch, lr = 256, 128, 4, 2, 256, 2, \
        0.05
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))
    jparams = ex.build_params(np.random.RandomState(0), vocab, hidden, heads,
                              layers, seq)
    step = ex.make_step(jmesh, heads, 32, lr)
    tparams = chip_smoke.longctx_params(torch, np.random.RandomState(0),
                                        vocab, hidden, heads, layers, seq,
                                        torch.device("cpu"))
    X = np.random.RandomState(1).randint(0, vocab, size=(batch, seq))
    Y = (X + 1) % vocab
    tmesh = _tmesh({"data": 1, "seq": 4}, 4)
    for _ in range(3):
        jparams, jl = step(jparams, _j(X.astype(np.int32)),
                           _j(Y.astype(np.int32)))
        tl = chip_smoke.longctx_step(torch, mt, tparams, torch.tensor(X),
                                     torch.tensor(Y), heads, lr, tmesh)
        assert abs(float(tl) - float(jl)) <= 1e-4, (float(tl), float(jl))
    jleaves = [jparams["embed"], jparams["pos"], jparams["ln_f"]["g"],
               jparams["ln_f"]["b"], jparams["head"]]
    for lp in jparams["layers"]:
        jleaves += [lp["ln1"]["g"], lp["ln1"]["b"], lp["qkv"], lp["proj"],
                    lp["ln2"]["g"], lp["ln2"]["b"], lp["fc1"], lp["fc2"]]
    for got, want in zip(chip_smoke.longctx_leaves(tparams), jleaves):
        _close(got, want, rtol=0, atol=1e-4)
