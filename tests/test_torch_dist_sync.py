"""``dist_sync`` in the port (``mxnet_tpu_torch.kvstore_dist``) with two
worker processes over gloo, started by the test under the DMLC environment
contract: the store's init takes rank 0's value, a push sums across the
workers, and ``Module`` training over the two workers (with BatchNorm too,
over the global batch, and under loss layers that reduce over the batch
or ignore their head gradient) matches the JAX package's one-process
``Module`` at the combined batch; evaluation runs on each worker alone.
The worker is this
file's own ``__main__`` branch.  Also the single-worker degrade (as
tests/test_dist_sync.py)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKERS, BATCH, STEPS, TIMEOUT = 2, 8, 3, 120
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
LOCAL_STORES = (None, "local")
# heads beside SoftmaxOutput: a loss normalized by the global batch, a
# row-wise regression loss, a loss layer over a whole-batch reduction, and
# that reduction as a plain output (head gradient ones)
HEADS = ("batch", "linreg", "makeloss", "mean")


def _net(pkg, bn=False, head="softmax"):
    sym = pkg.sym
    with pkg.NameManager():
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                                 name="fc1")
        if bn:
            net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, num_hidden=3, name="fc2")
        if head in ("softmax", "batch"):
            return sym.SoftmaxOutput(
                net, name="softmax",
                normalization="batch" if head == "batch" else "null")
        if head == "linreg":
            return sym.LinearRegressionOutput(net, name="softmax")
        err = sym.mean(sym.square(net - sym.Variable("softmax_label")))
        return sym.MakeLoss(err, name="softmax") if head == "makeloss" \
            else err


def _init():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (16, 10)).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.uniform(-0.3, 0.3, (3, 16)).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _bn_init():
    """BatchNorm's parameters and moving statistics beside ``_init``'s."""
    rng = np.random.RandomState(2)
    return (dict(_init(), bn1_gamma=rng.uniform(0.5, 1.5, 16).astype(
        np.float32), bn1_beta=rng.uniform(-0.2, 0.2, 16).astype(np.float32)),
            {"bn1_moving_mean": np.zeros(16, np.float32),
             "bn1_moving_var": np.ones(16, np.float32)})


def _data(head="softmax"):
    rng = np.random.RandomState(1)
    X = rng.randn(WORKERS * BATCH, 10).astype(np.float32)
    if head in ("softmax", "batch"):
        return X, (np.arange(WORKERS * BATCH) % 3).astype(np.float32)
    return X, rng.randn(WORKERS * BATCH, 3).astype(np.float32)


def _train(pkg, mod, X, y, kvstore, aux=False):
    """STEPS SGD-momentum steps of ``mod`` (bound at X's batch) from
    ``_init``; (losses, parameters), and with ``aux`` the aux states.  The
    losses are the softmax head's cross-entropy, else the first output's
    mean."""
    batch = pkg.io.DataBatch(data=[pkg.nd.array(X, pkg.cpu())],
                             label=[pkg.nd.array(y, pkg.cpu())])
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=SGD)
    losses = []
    for _ in range(STEPS):
        mod.forward_backward(batch)
        mod.update()
        p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float32)
        losses.append(float(-np.log(p[np.arange(len(y)),
                                      y.astype(int)]).mean())
                      if y.ndim == 1 else float(p.mean()))
    arg, auxs = mod.get_params()
    arg = {k: v.asnumpy() for k, v in arg.items()}
    if aux:
        return losses, arg, {k: v.asnumpy() for k, v in auxs.items()}
    return losses, arg


def _module(pkg, batch, init, aux=None, head="softmax", **kw):
    mod = pkg.mod.Module(_net(pkg, bn=aux is not None, head=head),
                         label_names=("softmax_label",), context=pkg.cpu(),
                         **kw)
    label = (batch,) if head in ("softmax", "batch") else (batch, 3)
    mod.bind(data_shapes=[("data", (batch, 10))],
             label_shapes=[("softmax_label", label)])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in init.items()},
                    aux_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in (aux or {}).items()})
    return mod


def worker(outdir):
    """One worker: its rank from the DMLC variables."""
    import mxnet_tpu_torch as mt

    kv = mt.kv.create("dist_sync")
    rank, n = kv.rank, kv.num_workers
    assert n == WORKERS, n
    kv.init("probe", mt.nd.array(np.full(4, rank + 1.0, np.float32),
                                 mt.cpu()))
    probe = mt.nd.zeros((4,), mt.cpu())
    kv.pull("probe", out=probe)
    kv.push("probe", mt.nd.array(np.full(4, rank + 1.0, np.float32),
                                 mt.cpu()))
    summed = mt.nd.zeros((4,), mt.cpu())
    kv.pull("probe", out=summed)
    X, y = _data()
    rows = slice(rank * BATCH, (rank + 1) * BATCH)
    # every rank but 0 starts elsewhere: the store's init must replace it
    init = {k: v + rank for k, v in _init().items()}
    mod = _module(mt, BATCH, init)
    losses, params = _train(mt, mod, X[rows], y[rows], kv)
    out = {"p:" + k: v for k, v in params.items()}
    # without a dist store the step still sums over the group: the default
    # gradient scale must count both workers' batches
    for store in LOCAL_STORES:
        loc_losses, loc_params = _train(mt, _module(mt, BATCH, _init()),
                                        X[rows], y[rows], store)
        out["losses:%s" % store] = np.array(loc_losses)
        out.update({"p:%s:%s" % (store, k): v
                    for k, v in loc_params.items()})
    # BatchNorm over the global batch, and with dist_mesh=False over the
    # worker's own
    for tag, kw in (("bn", {}), ("bnlocal", {"dist_mesh": False})):
        bn_args, bn_aux = _bn_init()
        bn_losses, bn_params, bn_stats = _train(
            mt, _module(mt, BATCH, bn_args, bn_aux, **kw), X[rows], y[rows],
            None, aux=True)
        out["losses:" + tag] = np.array(bn_losses)
        out.update({"%s:%s" % (tag, k): v
                    for k, v in list(bn_params.items()) +
                    list(bn_stats.items())})
    # each rank evaluates alone, a different number of batches: no
    # collective in an inference forward (BatchNorm reads its moving
    # statistics, the loss layer's forward maps each row)
    bn_args, bn_aux = _bn_init()
    for head in ("softmax", "batch"):
        ev = _module(mt, BATCH, bn_args, bn_aux, head=head)
        evb = mt.io.DataBatch(data=[mt.nd.array(X[rows], mt.cpu())],
                              label=[mt.nd.array(y[rows], mt.cpu())])
        for _ in range(rank * 2 + 1):
            ev.forward(evb, is_train=False)
        out["eval:" + head] = ev.get_outputs()[0].asnumpy()
    # the loss counted once over the group under each head
    for head in HEADS:
        hX, hy = _data(head)
        h_losses, h_params = _train(mt, _module(mt, BATCH, _init(),
                                                head=head),
                                    hX[rows], hy[rows], None)
        out["losses:" + head] = np.array(h_losses)
        out.update({"%s:%s" % (head, k): v for k, v in h_params.items()})
    # each rank's rows of a global array, gathered whole on every rank
    out["gathered"] = mt.sharding.gather_params(
        {"x": mt.nd.array(np.full((2, 3), rank, np.float32), mt.cpu())},
        over_processes=True)["x"]
    np.savez(os.path.join(outdir, "rank%d.npz" % rank),
             probe=probe.asnumpy(), summed=summed.asnumpy(),
             losses=np.array(losses),
             multiprocess=np.array(mod._exec_group._multiprocess),
             backend=np.array(mt.kvstore_dist.BACKEND), **out)
    kv._barrier()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_workers(outdir):
    env = dict(os.environ, DMLC_NUM_WORKER=str(WORKERS),
               DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(_free_port()),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    env.pop("DMLC_ROLE", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(outdir)],
                              env=dict(env, DMLC_WORKER_ID=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORKERS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs, [dict(np.load(os.path.join(outdir, "rank%d.npz" % r)))
                  for r in range(WORKERS)]


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    return _run_workers(tmp_path_factory.mktemp("dist_sync"))


def test_workers_take_gloo_and_say_so(two_workers):
    logs, got = two_workers
    assert all(str(g["backend"]) == "gloo" for g in got)
    for r, log in enumerate(logs):
        assert "rank %d/%d, backend gloo" % (r, WORKERS) in log, log


def test_init_is_rank_zeros_and_push_sums(two_workers):
    _, got = two_workers
    for g in got:
        np.testing.assert_array_equal(g["probe"], np.full(4, 1.0))
        np.testing.assert_array_equal(g["summed"], np.full(4, 3.0))


def test_module_over_two_workers_matches_one_jax_process(two_workers):
    """The workers sum their gradients over the group inside the step and
    apply the same update: identical replicas, and the JAX package's
    one-process Module at the combined batch within 1e-5."""
    import mxnet_tpu as mx

    _, got = two_workers
    X, y = _data()
    losses, params = _train(mx, _module(mx, WORKERS * BATCH, _init()), X, y,
                            None)
    assert all(bool(g["multiprocess"]) for g in got)
    for k in params:
        np.testing.assert_array_equal(got[0]["p:" + k], got[1]["p:" + k])
        np.testing.assert_allclose(got[0]["p:" + k], params[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the mean of the workers' losses is the whole batch's
    mean = (got[0]["losses"] + got[1]["losses"]) / 2
    np.testing.assert_allclose(mean, losses, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("store", LOCAL_STORES)
def test_module_without_dist_store_over_two_workers_matches_one_jax_process(
        two_workers, store):
    """Two workers whose Module has no dist store (kvstore None or 'local'
    on one context) still sum their gradients over the group, so the
    default gradient scale counts both batches: the JAX package's
    one-process Module at the combined batch within 1e-5."""
    import mxnet_tpu as mx

    _, got = two_workers
    X, y = _data()
    losses, params = _train(mx, _module(mx, WORKERS * BATCH, _init()), X, y,
                            None)
    for k in params:
        key = "p:%s:%s" % (store, k)
        np.testing.assert_array_equal(got[0][key], got[1][key])
        np.testing.assert_allclose(got[0][key], params[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    mean = (got[0]["losses:%s" % store] + got[1]["losses:%s" % store]) / 2
    np.testing.assert_allclose(mean, losses, rtol=1e-5, atol=1e-5)


def test_batchnorm_over_two_workers_takes_the_global_batch(two_workers):
    """Every worker's batch is one shard of the global batch: BatchNorm
    takes its statistics and moving averages over both workers' rows, so
    the parameters and moving statistics match the JAX package's one
    process on the concatenated batch within 1e-5, identical on both
    workers; the mean loss is the whole batch's.  With dist_mesh=False each
    worker's statistics are its own batch's."""
    import mxnet_tpu as mx

    _, got = two_workers
    X, y = _data()
    bn_args, bn_aux = _bn_init()
    losses, params, stats = _train(
        mx, _module(mx, WORKERS * BATCH, bn_args, bn_aux), X, y, None,
        aux=True)
    for k, v in list(params.items()) + list(stats.items()):
        np.testing.assert_array_equal(got[0]["bn:" + k], got[1]["bn:" + k])
        np.testing.assert_allclose(got[0]["bn:" + k], v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    mean = (got[0]["losses:bn"] + got[1]["losses:bn"]) / 2
    np.testing.assert_allclose(mean, losses, rtol=1e-5, atol=1e-5)
    # the workers' own statistics differ from the global ones
    gap = np.abs(got[0]["bnlocal:bn1_moving_mean"]
                 - stats["bn1_moving_mean"]).max()
    assert gap > 1e-3, gap


@pytest.mark.parametrize("head", HEADS)
def test_loss_heads_over_two_workers_count_the_loss_once(two_workers, head):
    """Under the global batch the loss is counted once over the group: a
    SoftmaxOutput normalized by the (global) batch and a loss layer over a
    whole-batch reduction, which run on the gathered batch and ignore
    their head gradient, a row-wise regression loss, and a whole-batch
    output with head gradient ones all match the JAX package's one process
    on the concatenated batch within 1e-5, identical on both workers (each
    would be twice its gradient if every worker counted the whole
    batch's)."""
    import mxnet_tpu as mx

    _, got = two_workers
    X, y = _data(head)
    losses, params = _train(mx, _module(mx, WORKERS * BATCH, _init(),
                                        head=head), X, y, None)
    for k in params:
        key = "%s:%s" % (head, k)
        np.testing.assert_array_equal(got[0][key], got[1][key])
        np.testing.assert_allclose(got[0][key], params[k], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    mean = (got[0]["losses:" + head] + got[1]["losses:" + head]) / 2
    np.testing.assert_allclose(mean, losses, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head", ("softmax", "batch"))
def test_eval_runs_on_each_worker_alone(two_workers, head):
    """Each worker runs a different number of inference forwards of a
    BatchNorm net under the global batch: none waits for the other, and
    each gives its own rows of the JAX package's one process."""
    import mxnet_tpu as mx

    _, got = two_workers
    X, y = _data()
    bn_args, bn_aux = _bn_init()
    ev = _module(mx, WORKERS * BATCH, bn_args, bn_aux, head=head)
    ev.forward(mx.io.DataBatch(data=[mx.nd.array(X, mx.cpu())],
                               label=[mx.nd.array(y, mx.cpu())]),
               is_train=False)
    want = ev.get_outputs()[0].asnumpy()
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["eval:" + head],
                                   want[r * BATCH:(r + 1) * BATCH],
                                   rtol=1e-5, atol=1e-6)


def test_gather_params_over_processes_concatenates_the_ranks(two_workers):
    _, got = two_workers
    want = np.repeat(np.arange(WORKERS, dtype=np.float32), 2)[:, None] * \
        np.ones((1, 3), np.float32)
    for g in got:
        np.testing.assert_array_equal(g["gathered"], want)


def test_dist_sync_in_process_single_worker(monkeypatch):
    """One worker, no process group: local semantics."""
    import mxnet_tpu_torch as mt

    monkeypatch.delenv("DMLC_NUM_WORKER", raising=False)
    kv = mt.kvstore.create("dist_sync")
    assert kv.type == "dist_sync"
    assert kv.num_workers == 1 and kv.rank == 0
    kv.init(0, mt.nd.ones((2, 2), mt.cpu()))
    kv.push(0, mt.nd.ones((2, 2), mt.cpu()) * 3)
    out = mt.nd.zeros((2, 2), mt.cpu())
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 2), 3, np.float32))
    assert kv.get_num_dead_node() == 0


def exit_worker():
    """A worker that joins the group, pushes once and leaves after the
    barrier while its liveness beat runs flat out."""
    import mxnet_tpu_torch as mt

    kv = mt.kv.create("dist_sync")
    kv.init("p", mt.nd.array(np.ones(2, np.float32), mt.cpu()))
    kv.push("p", mt.nd.array(np.ones(2, np.float32), mt.cpu()))
    kv._barrier()


def test_workers_leave_cleanly_while_their_heartbeat_beats():
    """Rank 0 hosts the group's store and may leave first: a worker whose
    heartbeat is still inside the store's client when the interpreter
    tears down must not abort (three pairs at once, beating every 0.5
    ms, so a beat is nearly always in flight at exit)."""
    pairs = []
    for _ in range(3):
        env = dict(os.environ, DMLC_NUM_WORKER=str(WORKERS),
                   DMLC_PS_ROOT_URI="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(_free_port()),
                   MXNET_KVSTORE_HEARTBEAT_INTERVAL="0.0005",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   CUDA_VISIBLE_DEVICES="")
        env.pop("DMLC_ROLE", None)
        pairs.append([subprocess.Popen(
            [sys.executable, __file__, "--exit-worker"],
            env=dict(env, DMLC_WORKER_ID=str(r)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORKERS)])
    procs = [p for pair in pairs for p in pair]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, (p.returncode, log[-3000:])


def test_backend_rule():
    from mxnet_tpu_torch import kvstore_dist

    backend, reason = kvstore_dist.choose_backend(2)
    import torch

    if torch.cuda.device_count() >= 2:
        assert backend == "nccl", reason
    else:
        assert backend == "gloo" and reason


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1] == "--exit-worker":
        exit_worker()
    else:
        worker(sys.argv[1])
