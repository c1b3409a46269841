"""``dist_sync`` in the port (``mxnet_tpu_torch.kvstore_dist``) with two
worker processes over gloo, started by the test under the DMLC environment
contract: the store's init takes rank 0's value, a push sums across the
workers, and ``Module`` training over the two workers matches the JAX
package's one-process ``Module`` at the combined batch.  The worker is this
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


def _net(pkg):
    sym = pkg.sym
    with pkg.NameManager():
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                                 name="fc1")
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, num_hidden=3, name="fc2")
        return sym.SoftmaxOutput(net, name="softmax")


def _init():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (16, 10)).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.uniform(-0.3, 0.3, (3, 16)).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _data():
    rng = np.random.RandomState(1)
    X = rng.randn(WORKERS * BATCH, 10).astype(np.float32)
    return X, (np.arange(WORKERS * BATCH) % 3).astype(np.float32)


def _train(pkg, mod, X, y, kvstore):
    """STEPS SGD-momentum steps of ``mod`` (bound at X's batch) from
    ``_init``; (losses, parameters)."""
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
                                      y.astype(int)]).mean()))
    arg, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in arg.items()}


def _module(pkg, batch, init):
    mod = pkg.mod.Module(_net(pkg), label_names=("softmax_label",),
                         context=pkg.cpu())
    mod.bind(data_shapes=[("data", (batch, 10))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in init.items()}, aux_params={})
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
    worker(sys.argv[1])
