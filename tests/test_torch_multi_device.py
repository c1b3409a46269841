"""Data parallelism over several contexts in the port (``Module(context=[
...])``, ``DataParallelExecutorGroup``) against the JAX package's mesh
Module on the 8 virtual CPU devices (tests/test_multi_device.py), plus
group2ctx placement, BatchNorm's global statistics, the kvstore paths,
``shared_exec`` and ``shared_module``.  The port's ``cpu(0..7)`` are one
torch CPU device: the shards run in lockstep there."""

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def _mlp(pkg, bn=False):
    sym = pkg.sym
    with pkg.NameManager():
        data = sym.Variable("data")
        net = sym.FullyConnected(data=data, num_hidden=16, name="fc1")
        if bn:
            net = sym.BatchNorm(net, name="bn1", fix_gamma=False)
        net = sym.Activation(data=net, act_type="relu")
        net = sym.FullyConnected(data=net, num_hidden=4, name="fc2")
        return sym.SoftmaxOutput(data=net, name="softmax")


def _params(seed=0, bn=False):
    rng = np.random.RandomState(seed)
    p = {"fc1_weight": rng.uniform(-0.3, 0.3, (16, 10)).astype(np.float32),
         "fc1_bias": rng.uniform(-0.1, 0.1, 16).astype(np.float32),
         "fc2_weight": rng.uniform(-0.3, 0.3, (4, 16)).astype(np.float32),
         "fc2_bias": rng.uniform(-0.1, 0.1, 4).astype(np.float32)}
    aux = {}
    if bn:
        p["bn1_gamma"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        p["bn1_beta"] = rng.uniform(-0.2, 0.2, 16).astype(np.float32)
        aux = {"bn1_moving_mean": np.zeros(16, np.float32),
               "bn1_moving_var": np.ones(16, np.float32)}
    return p, aux


def _ctxs(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _module(pkg, ctx, batch, bn=False, seed=0, **kw):
    mod = pkg.mod.Module(_mlp(pkg, bn), label_names=("softmax_label",),
                         context=ctx, **kw)
    mod.bind(data_shapes=[("data", (batch, 10))],
             label_shapes=[("softmax_label", (batch,))], for_training=True)
    arg, aux = _params(seed, bn)
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in arg.items()},
                    aux_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in aux.items()})
    return mod


def _batch(pkg, X, y):
    return pkg.io.DataBatch(data=[pkg.nd.array(X, pkg.cpu())],
                            label=[pkg.nd.array(y, pkg.cpu())])


def _data(n=16, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 10).astype(np.float32),
            (np.arange(n) % 4).astype(np.float32))


def test_eight_contexts_on_both_packages():
    import jax

    assert len(jax.devices()) >= 8
    assert len(set(_ctxs(mt, 8))) == 8


def test_dp_forward_matches_single_device_and_jax_mesh():
    X, y = _data()
    outs = {}
    for tag, pkg, n in (("port1", mt, 1), ("port8", mt, 8),
                        ("jax8", mx, 8)):
        mod = _module(pkg, _ctxs(pkg, n), 16)
        mod.forward(_batch(pkg, X, y), is_train=False)
        outs[tag] = mod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(outs["port8"], outs["port1"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs["port8"], outs["jax8"], rtol=1e-5,
                               atol=1e-6)


def test_dp_gradients_match_single_device_and_jax_mesh():
    X, y = _data()
    grads = {}
    for tag, pkg, n in (("port1", mt, 1), ("port8", mt, 8),
                        ("jax8", mx, 8)):
        mod = _module(pkg, _ctxs(pkg, n), 16)
        mod.forward(_batch(pkg, X, y), is_train=True)
        mod.backward()
        grads[tag] = {k: v.asnumpy() for k, v in
                      mod._exec_group.execs[0].grad_dict.items()}
    assert grads["port8"].keys() == grads["jax8"].keys()
    for name in grads["jax8"]:
        for other in ("port1", "jax8"):
            np.testing.assert_allclose(grads["port8"][name],
                                       grads[other][name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_dp_batch_is_split_params_replicated():
    """The port's counterpart of the mesh's shardings: the batch inputs
    split along axis 0 over the contexts, the parameters replicated, every
    op of the MLP run per shard."""
    mod = mt.mod.Module(_mlp(mt), label_names=("softmax_label",),
                        context=_ctxs(mt, 8))
    mod.bind(data_shapes=[("data", (32, 10))],
             label_shapes=[("softmax_label", (32,))])
    dp = mod._exec_group.execs[0]._dp
    plan = mod._exec_group.execs[0]._plan
    var = {n.name: (id(n), 0) for n in plan.nodes if n.is_variable}
    assert dp.kind[var["data"]] == "shard"
    assert dp.kind[var["softmax_label"]] == "shard"
    assert dp.kind[var["fc1_weight"]] == "rep"
    assert dp.gathered_ops() == []
    assert mod._exec_group.slices == [slice(4 * i, 4 * i + 4)
                                      for i in range(8)]


def test_dp_fit_converges():
    rng = np.random.RandomState(3)
    X = rng.randn(256, 10).astype(np.float32)
    w = rng.randn(10, 4).astype(np.float32)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    train = mt.io.NDArrayIter(X, y, batch_size=64, shuffle=True)
    mod = mt.mod.Module(_mlp(mt), label_names=("softmax_label",),
                        context=_ctxs(mt, 8))
    mt.random.seed(0)
    mod.fit(train, num_epoch=25, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            kvstore="device")
    score = mod.score(mt.io.NDArrayIter(X, y, batch_size=64),
                      mt.metric.Accuracy())
    acc = dict(score)["accuracy"]
    assert acc >= 0.9, "DP fit under-converged: %f" % acc


@pytest.mark.parametrize("pkg", [mx, mt], ids=["jax", "port"])
def test_indivisible_batch_raises(pkg):
    mod = pkg.mod.Module(_mlp(pkg), label_names=("softmax_label",),
                         context=_ctxs(pkg, 3))
    with pytest.raises(pkg.MXNetError):
        mod.bind(data_shapes=[("data", (16, 10))],
                 label_shapes=[("softmax_label", (16,))])


@pytest.mark.parametrize("pkg", [mx, mt], ids=["jax", "port"])
def test_uneven_workload_raises(pkg):
    mod = pkg.mod.Module(_mlp(pkg), label_names=("softmax_label",),
                         context=_ctxs(pkg, 2), work_load_list=[1, 2])
    with pytest.raises(pkg.MXNetError, match="uneven"):
        mod.bind(data_shapes=[("data", (16, 10))],
                 label_shapes=[("softmax_label", (16,))])


def _staged_net(pkg):
    sym = pkg.sym
    with pkg.NameManager():
        with pkg.AttrScope(ctx_group="dev1"):
            data = sym.Variable("data")
            fc1 = sym.FullyConnected(data=data, num_hidden=16, name="fc1")
            act1 = sym.Activation(data=fc1, act_type="relu")
        with pkg.AttrScope(ctx_group="dev2"):
            fc2 = sym.FullyConnected(data=act1, num_hidden=4, name="fc2")
            return sym.SoftmaxOutput(data=fc2, name="softmax")


def _run_group2ctx(pkg, g2c):
    n, d = 8, 6
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    lab = rng.randint(0, 4, (n,)).astype(np.float32)
    exe = _staged_net(pkg).simple_bind(pkg.cpu(), data=(n, d),
                                       grad_req="write", group2ctx=g2c)
    if g2c:
        assert len(exe._placement) >= 2
        assert len(set(exe._placement.values())) == 2
    for name, arr in sorted(exe.arg_dict.items()):
        if name in ("data", "softmax_label"):
            continue
        arr[:] = rng.uniform(-0.1, 0.1, arr.shape).astype(np.float32)
    exe.arg_dict["data"][:] = x
    exe.arg_dict["softmax_label"][:] = lab
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return out, {k: v.asnumpy() for k, v in exe.grad_dict.items()
                 if v is not None}


def test_group2ctx_model_parallel():
    """Graph stages placed on two contexts by group2ctx: the values and
    gradients of single-device execution, and of the JAX package's."""
    got = {}
    for tag, pkg in (("jax", mx), ("port", mt)):
        for placed in (True, False):
            g2c = {"dev1": pkg.Context("cpu", 0),
                   "dev2": pkg.Context("cpu", 1)} if placed else None
            got[(tag, placed)] = _run_group2ctx(pkg, g2c)
    out_mp, grads_mp = got[("port", True)]
    for ref in (got[("port", False)], got[("jax", True)]):
        np.testing.assert_allclose(out_mp, ref[0], rtol=1e-5, atol=1e-6)
        assert grads_mp.keys() == ref[1].keys()
        for k in ref[1]:
            np.testing.assert_allclose(grads_mp[k], ref[1][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_batchnorm_over_four_contexts_uses_global_statistics():
    """BatchNorm over 4 contexts: outputs, moving statistics and gradients
    of the JAX package's 4-device mesh (the statistics of the whole batch,
    not of each shard's piece)."""
    X, y = _data(16, seed=4)
    X = X * np.linspace(0.5, 3.0, 16, dtype=np.float32)[:, None]
    res = {}
    for tag, pkg, n in (("jax", mx, 4), ("port", mt, 4), ("port1", mt, 1)):
        mod = _module(pkg, _ctxs(pkg, n), 16, bn=True, seed=2)
        mod.forward(_batch(pkg, X, y), is_train=True)
        mod.backward()
        ex = mod._exec_group.execs[0]
        res[tag] = (mod.get_outputs()[0].asnumpy(),
                    {k: v.asnumpy() for k, v in ex.aux_dict.items()},
                    {k: v.asnumpy() for k, v in ex.grad_dict.items()})
    assert mod is not None
    for ref in ("jax", "port1"):
        np.testing.assert_allclose(res["port"][0], res[ref][0], rtol=1e-5,
                                   atol=1e-5)
        for k in res[ref][1]:
            np.testing.assert_allclose(res["port"][1][k], res[ref][1][k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in res[ref][2]:
            np.testing.assert_allclose(res["port"][2][k], res[ref][2][k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # per-shard statistics would differ: the shards' means are not the
    # batch's
    shard_means = X.reshape(4, 4, 10).mean(1)
    assert np.abs(shard_means - X.mean(0)).max() > 0.1


def _bn_ops_gathered():
    mod = mt.mod.Module(_mlp(mt, bn=True), label_names=("softmax_label",),
                        context=_ctxs(mt, 4))
    mod.bind(data_shapes=[("data", (16, 10))],
             label_shapes=[("softmax_label", (16,))])
    return mod._exec_group.execs[0]._dp.gathered_ops()


def test_batchnorm_is_the_one_gathered_op():
    assert _bn_ops_gathered() == ["BatchNorm"]


@pytest.mark.parametrize("kvstore", [None, "local", "device"])
def test_sgd_momentum_steps_through_each_kvstore_match_jax(kvstore):
    """Three SGD-momentum steps over 4 contexts with each kvstore path:
    the JAX package's parameters within 1e-5.  The JAX package's 'device'
    store cannot take a mesh-replicated gradient (its push adds it to an
    array on one device and raises), so the port's update through the
    store is held to the JAX package's local updater, the same SGD on the
    same gradients."""
    X, y = _data(16, seed=6)
    params = {}
    for tag, pkg in (("jax", mx), ("port", mt)):
        mod = _module(pkg, _ctxs(pkg, 4), 16, seed=3)
        kv = None if (pkg is mx and kvstore == "device") else kvstore
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-3})
        for step in range(3):
            batch = _batch(pkg, X * (1 + 0.1 * step), y)
            mod.forward_backward(batch)
            mod.update()
        arg, _ = mod.get_params()
        params[tag] = {k: v.asnumpy() for k, v in arg.items()}
        if pkg is mt:
            want = {None: type(None), "local": mt.kv.KVStore,
                    "device": mt.comm_engine.AsyncKVStore}[kvstore]
            assert isinstance(mod._kvstore, want)
            assert mod._update_on_kvstore == (kvstore == "device")
    for k in params["jax"]:
        np.testing.assert_allclose(params["port"][k], params["jax"][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_shared_exec_shares_plan_and_arrays():
    net = _mlp(mt)
    ex1 = net.simple_bind(mt.cpu(), data=(8, 10))
    ex2 = net.simple_bind(mt.cpu(), data=(4, 10), shared_exec=ex1)
    assert ex2._plan is ex1._plan
    assert ex2.arg_dict["fc1_weight"] is ex1.arg_dict["fc1_weight"]
    assert ex2.grad_dict["fc2_bias"] is ex1.grad_dict["fc2_bias"]
    assert ex2.arg_dict["data"] is not ex1.arg_dict["data"]
    ex1.arg_dict["fc1_weight"][:] = 0.5
    np.testing.assert_array_equal(ex2.arg_dict["fc1_weight"].asnumpy(),
                                  np.full((16, 10), 0.5, np.float32))
    ex3 = net.bind(mt.cpu(), dict(ex2.arg_dict), shared_exec=ex1)
    assert ex3._plan is ex1._plan


def test_shared_module_shares_parameters():
    X, y = _data(8)
    base = _module(mt, mt.cpu(), 16)
    base.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1})
    small = mt.mod.Module(_mlp(mt), label_names=("softmax_label",),
                          context=mt.cpu())
    small.bind(data_shapes=[("data", (8, 10))],
               label_shapes=[("softmax_label", (8,))], shared_module=base)
    assert small.params_initialized and small.optimizer_initialized
    assert small._exec_group.execs[0].arg_dict["fc1_weight"] is \
        base._exec_group.execs[0].arg_dict["fc1_weight"]
    small.forward_backward(_batch(mt, X, y))
    small.update()
    np.testing.assert_array_equal(
        base._exec_group.execs[0].arg_dict["fc2_weight"].asnumpy(),
        small._exec_group.execs[0].arg_dict["fc2_weight"].asnumpy())


def test_reshape_keeps_the_trained_parameters():
    X, y = _data(16)
    mod = _module(mt, _ctxs(mt, 4), 16)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod.forward_backward(_batch(mt, X, y))
    mod.update()
    before = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.reshape(data_shapes=[("data", (8, 10))],
                label_shapes=[("softmax_label", (8,))])
    assert mod._exec_group.batch_size == 8
    assert mod._exec_group.slices == [slice(2 * i, 2 * i + 2)
                                      for i in range(4)]
    ex = mod._exec_group.execs[0]
    for k, v in before.items():
        np.testing.assert_array_equal(ex.arg_dict[k].asnumpy(), v)
    mod.forward(_batch(mt, X[:8], y[:8]), is_train=False)
    assert mod.get_outputs()[0].shape == (8, 4)
    with pytest.raises(mt.MXNetError, match="divisible"):
        mod.reshape(data_shapes=[("data", (6, 10))],
                    label_shapes=[("softmax_label", (6,))])


def test_bind_with_a_one_context_mesh_trains_like_no_mesh():
    """``bind(mesh="data=-1")`` on one context resolves the mesh over the
    Module's own context (one shard) and three SGD-momentum steps give
    the parameters and outputs of the Module bound without one, bit for
    bit."""
    X, y = _data(8, seed=4)
    got = {}
    for tag, mesh in (("plain", None), ("mesh", "data=-1")):
        mod = mt.mod.Module(_mlp(mt), label_names=("softmax_label",),
                            context=mt.cpu())
        mod.bind(data_shapes=[("data", (8, 10))],
                 label_shapes=[("softmax_label", (8,))], mesh=mesh)
        arg, _ = _params(2)
        mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                    for k, v in arg.items()}, aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for _ in range(3):
            mod.forward_backward(_batch(mt, X, y))
            mod.update()
        got[tag] = ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                    mod.get_outputs()[0].asnumpy(), mod._exec_group)
    assert got["mesh"][2]._mesh.shape == {"data": 1}
    assert got["plain"][2]._mesh is None
    for k, v in got["plain"][0].items():
        np.testing.assert_array_equal(got["mesh"][0][k], v, err_msg=k)
    np.testing.assert_array_equal(got["mesh"][1], got["plain"][1])
