"""Sharded checkpoints in the port (``mxnet_tpu_torch.checkpoint``) beside
the JAX package's (tests/test_checkpoint_sharded.py): train -> sharded
save -> restore (whole, onto explicit shardings, onto a fresh mesh from
the saved specs) -> the same arrays; a missing or incomplete directory
and an unknown mesh axis raise; ``partition_specs.json`` is the JAX
package's JSON for the same specs; a resumed Module continues bit for
bit.  The payload is the port's own (one ``.params`` stream per piece),
not orbax's."""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import sharding as tsh

CTXS = [mt.cpu(i) for i in range(8)]
P = tsh.PartitionSpec


def _small_module():
    np.random.seed(0)
    X = np.random.randn(40, 6).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    it = mt.io.NDArrayIter(X, y, batch_size=10)
    net = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = mt.sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = mt.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2})
    return mod, X


def test_sharded_checkpoint_roundtrip(tmp_path):
    mod, X = _small_module()
    args, auxs = mod.get_params()
    prefix = str(tmp_path / "model")
    path = mt.checkpoint.save_sharded_checkpoint(prefix, 2, mod.symbol,
                                                 args, auxs)
    assert path.endswith("-0002.orbax")
    assert sorted(os.listdir(path)) == [
        "extra_state.pkl", "layout.json", "mxnet_complete",
        "partition_specs.json", "piece-whole.rank0.params"]
    sym2, args2, auxs2 = mt.checkpoint.load_sharded_checkpoint(prefix, 2)
    assert sym2 is not None and sym2.tojson() == mod.symbol.tojson()
    for src, got in ((args, args2), (auxs, auxs2)):
        assert sorted(got) == sorted(src)
        for k in src:
            np.testing.assert_array_equal(got[k].asnumpy(),
                                          src[k].asnumpy(), err_msg=k)
    # the restored parameters serve the same predictions
    shapes = {"data": (10, 6), "softmax_label": (10,)}

    def predict(symbol, a, x):
        params = {"arg:%s" % k: v for k, v in a[0].items()}
        params.update({"aux:%s" % k: v for k, v in a[1].items()})
        pred = mt.Predictor(symbol, params, shapes, ctx=mt.cpu())
        return pred.forward(data=X[:10])[0].asnumpy()

    np.testing.assert_array_equal(predict(sym2, (args2, auxs2), X),
                                  predict(mod.symbol, (args, auxs), X))


def test_sharded_checkpoint_restore_onto_explicit_shardings(tmp_path):
    mod, _ = _small_module()
    args, auxs = mod.get_params()
    prefix = str(tmp_path / "meshmodel")
    mt.checkpoint.save_sharded_checkpoint(prefix, 1, None, args, auxs)
    assert not os.path.exists(prefix + "-symbol.json")
    mesh = tsh.build_mesh((("model", 4),), CTXS[:4])
    shardings = {"arg": {"fc1_weight": tsh.NamedSharding(
        mesh, P("model", None))}}
    _, args2, _ = mt.checkpoint.load_sharded_checkpoint(
        prefix, 1, shardings=shardings)
    w = args2["fc1_weight"]._data
    assert isinstance(w, tsh.ShardedTensor)
    assert tsh.NamedSharding(w.mesh, w.spec) == \
        shardings["arg"]["fc1_weight"]
    assert [tuple(p.shape) for p in w.shards.values()] == [(2, 6)] * 4
    np.testing.assert_array_equal(args2["fc1_weight"].asnumpy(),
                                  args["fc1_weight"].asnumpy())
    assert not isinstance(args2["fc2_weight"]._data, tsh.ShardedTensor)


def test_sharded_checkpoint_missing_and_incomplete(tmp_path):
    with pytest.raises(mt.MXNetError, match="no sharded checkpoint"):
        mt.checkpoint.load_sharded_checkpoint(str(tmp_path / "nope"), 0)
    prefix = str(tmp_path / "torn")
    path = mt.checkpoint.save_sharded_checkpoint(
        prefix, 5, None, {"w": mt.nd.ones((2, 2), mt.cpu())}, {})
    os.remove(os.path.join(path, "mxnet_complete"))
    with pytest.raises(mt.MXNetError, match="incomplete"):
        mt.checkpoint.load_sharded_checkpoint(prefix, 5)
    # both packages name the two failures alike
    with pytest.raises(mx.base.MXNetError, match="no sharded checkpoint"):
        mx.checkpoint.load_sharded_checkpoint(str(tmp_path / "nope"), 0)


def _lm(pkg):
    from importlib import import_module

    tr = import_module(pkg.__name__ + ".models.transformer")
    with pkg.NameManager():
        return tr.get_transformer_lm(vocab_size=64, num_layers=1,
                                     num_heads=2, hidden=32, seq_len=16,
                                     block_q=16, block_k=16)


def _megatron(pkg, ctx, mesh):
    mod = pkg.mod.Module(_lm(pkg), context=ctx)
    mod.bind(data_shapes=[("data", (8, 16))],
             label_shapes=[("softmax_label", (8, 16))],
             mesh=mesh, partition_rules="transformer_megatron")
    return mod


def _placed(mod):
    ex = mod._exec_group.execs[0]
    return ({k: ex.arg_dict[k] for k in mod._exec_group.param_names},
            {k: ex.aux_dict[k] for k in mod._exec_group.aux_names})


def test_partition_specs_roundtrip_onto_fresh_mesh(tmp_path):
    """A tensor-parallel save writes each piece once; the spec metadata
    restores the layout onto a FRESH mesh with every piece read onto its
    own coordinate's context."""
    mod = _megatron(mt, CTXS, "data=-1,model=2")
    mod.init_params(initializer=mt.init.Xavier(magnitude=2.0))
    args, auxs = _placed(mod)
    prefix = str(tmp_path / "tp")
    path = mt.checkpoint.save_sharded_checkpoint(prefix, 3, mod.symbol,
                                                 args, auxs)
    assert sorted(n for n in os.listdir(path) if n.startswith("piece-")) \
        == ["piece-0-0.rank0.params", "piece-0-1.rank0.params"]
    specs = mt.checkpoint.load_partition_specs(prefix, 3)
    assert specs["arg"]["layer0_qkv_weight"] == P("model", None)
    assert specs["arg"]["layer0_proj_weight"] == P(None, "model")
    assert specs["arg"]["ln_f_gamma"] == P()

    fresh = tsh.build_mesh("data=-1,model=2", CTXS)
    _, args2, _ = mt.checkpoint.load_sharded_checkpoint(prefix, 3,
                                                        mesh=fresh)
    w = args2["layer0_qkv_weight"]._data
    assert w.mesh is fresh and w.spec == P("model", None)
    assert [tuple(p.shape) for p in w.shards.values()] == [(48, 32)] * 2
    for k, v in args.items():
        np.testing.assert_array_equal(args2[k].asnumpy(), v.asnumpy(),
                                      err_msg=k)
    # a mesh with other sizes takes the arrays split anew
    other = tsh.build_mesh("data=2,model=4", CTXS)
    _, args3, _ = mt.checkpoint.load_sharded_checkpoint(prefix, 3,
                                                        mesh=other)
    w3 = args3["layer0_qkv_weight"]._data
    assert [tuple(p.shape) for p in w3.shards.values()] == [(24, 32)] * 4
    np.testing.assert_array_equal(args3["layer0_qkv_weight"].asnumpy(),
                                  args["layer0_qkv_weight"].asnumpy())


def test_partition_specs_json_is_the_jax_packages(tmp_path):
    jmod = _megatron(mx, mx.cpu(), mx.sharding.build_mesh("data=-1,model=2"))
    jmod.init_params(initializer=mx.init.Xavier(magnitude=2.0))
    jprefix = str(tmp_path / "jax")
    mx.checkpoint.save_sharded_checkpoint(jprefix, 1, None, *_placed(jmod))
    tmod = _megatron(mt, CTXS, "data=-1,model=2")
    tmod.init_params(initializer=mt.init.Xavier(magnitude=2.0))
    tprefix = str(tmp_path / "port")
    mt.checkpoint.save_sharded_checkpoint(tprefix, 1, None, *_placed(tmod))

    def read(prefix):
        with open(os.path.join(prefix + "-0001.orbax",
                               "partition_specs.json"), "rb") as f:
            return f.read()

    assert read(tprefix) == read(jprefix)
    assert mt.checkpoint.load_partition_specs(tprefix, 1) == {
        grp: {k: P(*v) for k, v in sub.items()} for grp, sub in
        mx.checkpoint.load_partition_specs(jprefix, 1).items()}


def test_mesh_restore_rejects_unknown_axis(tmp_path):
    mod = _megatron(mt, CTXS, "data=-1,model=2")
    mod.init_params(initializer=mt.init.Xavier(magnitude=2.0))
    prefix = str(tmp_path / "tp2")
    mt.checkpoint.save_sharded_checkpoint(prefix, 1, None, _placed(mod)[0],
                                          {})
    wrong = tsh.build_mesh((("x", 4), ("y", 2)), CTXS)
    with pytest.raises(mt.MXNetError, match="mesh axes"):
        mt.checkpoint.load_sharded_checkpoint(prefix, 1, mesh=wrong)


def _lm_batches(n):
    rng = np.random.RandomState(3)
    return [mt.io.DataBatch(
        data=[mt.nd.array(rng.randint(0, 64, (8, 16)).astype(np.float32),
                          mt.cpu())],
        label=[mt.nd.array(rng.randint(0, 64, (8, 16)).astype(np.float32),
                           mt.cpu())]) for _ in range(n)]


def test_resume_from_a_sharded_checkpoint_is_bitwise(tmp_path):
    """Two steps, a sharded save with the optimizer states, then a fresh
    Module on a fresh mesh restored from it takes the next two steps:
    losses and parameters bit for bit those of the run that went on, and
    the random stream comes back with ``restore_rng``."""
    opt = {"learning_rate": 1e-2}
    batches = _lm_batches(4)
    mt.random.seed(7)
    mod = _megatron(mt, CTXS, "data=-1,model=2")
    mod.init_params(initializer=mt.init.Xavier(magnitude=2.0))
    mod.init_optimizer(optimizer="adam", optimizer_params=opt)
    for b in batches[:2]:
        mod.forward_backward(b)
        mod.update()
    prefix = str(tmp_path / "resume")
    mt.checkpoint.save_sharded_checkpoint(prefix, 2, mod.symbol,
                                          *_placed(mod))
    mod.save_optimizer_states(prefix + "-0002.states")
    draw = mt.nd.random_uniform(shape=(4,), ctx=mt.cpu()).asnumpy()
    outs = []
    for b in batches[2:]:
        mod.forward_backward(b)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    fresh = tsh.build_mesh("data=-1,model=2", CTXS)
    _, args, auxs = mt.checkpoint.load_sharded_checkpoint(prefix, 2,
                                                          mesh=fresh)
    state = mt.checkpoint.load_sharded_checkpoint_state(prefix, 2,
                                                        restore_rng=True)
    assert "rng" in state
    np.testing.assert_array_equal(
        mt.nd.random_uniform(shape=(4,), ctx=mt.cpu()).asnumpy(), draw)
    mod2 = _megatron(mt, CTXS, fresh)
    mod2.set_params(args, auxs)
    mod2.init_optimizer(optimizer="adam",
                        optimizer_params=dict(opt, begin_num_update=2))
    mod2.load_optimizer_states(prefix + "-0002.states")
    for b, out in zip(batches[2:], outs):
        mod2.forward_backward(b)
        mod2.update()
        np.testing.assert_array_equal(mod2.get_outputs()[0].asnumpy(), out)
    for k, v in mod2.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), want[k], err_msg=k)
