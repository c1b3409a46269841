"""The port's KVStore (``mxnet_tpu_torch.kvstore``) against the JAX
package's on the same cases (tests/test_kvstore.py): local and device
semantics, push-sum, the updater on push, string keys, and the errors.
Sums and pulls must be bitwise equal."""

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

SHAPE = (4, 4)
KEYS = [3, 5, 7]


def _nd(pkg, x):
    return pkg.nd.array(np.asarray(x, np.float32), pkg.cpu())


def _both(case):
    """Run ``case(pkg)`` on both packages; the host arrays each returns
    must match bit for bit."""
    got_jax, got_port = case(mx), case(mt)
    assert len(got_jax) == len(got_port)
    for a, b in zip(got_jax, got_port):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got_port


def _single_kv_pair(pkg):
    kv = pkg.kv.create("local")
    kv.init(3, _nd(pkg, np.ones(SHAPE)))
    out = _nd(pkg, np.zeros(SHAPE))
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _push_aggregates(pkg):
    kv = pkg.kv.create("local")
    kv.init(3, _nd(pkg, np.zeros(SHAPE)))
    rng = np.random.RandomState(0)
    kv.push(3, [_nd(pkg, rng.randn(*SHAPE)) for _ in range(4)])
    out = _nd(pkg, np.zeros(SHAPE))
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _push_replaces_store_without_updater(pkg):
    kv = pkg.kv.create("local")
    kv.init(3, _nd(pkg, np.ones(SHAPE) * 2))
    kv.push(3, _nd(pkg, np.ones(SHAPE) * 8))
    out = _nd(pkg, np.zeros(SHAPE))
    kv.pull(3, out=out)
    first = out.asnumpy()
    kv.push(3, _nd(pkg, np.ones(SHAPE) * 5))
    kv.pull(3, out=out)
    return [first, out.asnumpy()]


def _list_kv_pairs(pkg):
    kv = pkg.kv.create("local")
    kv.init(KEYS, [_nd(pkg, np.zeros(SHAPE))] * len(KEYS))
    kv.push(KEYS, [[_nd(pkg, np.ones(SHAPE) * 2.0)]] * len(KEYS))
    outs = [_nd(pkg, np.zeros(SHAPE)) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return [o.asnumpy() for o in outs]


def _updater_runs_on_push(pkg):
    kv = pkg.kv.create("local")
    kv.init(3, _nd(pkg, np.ones(SHAPE) * 4))

    def updater(key, recv, stored):
        stored += recv * 2.0

    kv._set_updater(updater)
    kv.push(3, [_nd(pkg, np.ones(SHAPE))] * 3)  # merged = 3, stored += 6
    out = _nd(pkg, np.zeros(SHAPE))
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _set_optimizer_applies_update(pkg):
    kv = pkg.kv.create("local")
    rng = np.random.RandomState(1)
    kv.init(0, _nd(pkg, rng.randn(*SHAPE)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0,
                                       wd=0.0))
    kv.push(0, _nd(pkg, rng.randn(*SHAPE)))
    out = _nd(pkg, np.zeros(SHAPE))
    kv.pull(0, out=out)
    return [out.asnumpy()]


def _device_type_same_semantics(pkg):
    kv = pkg.kv.create("device")
    kv.init(3, _nd(pkg, np.zeros(SHAPE)))
    kv.push(3, [_nd(pkg, np.ones(SHAPE))] * 2)
    out = _nd(pkg, np.zeros(SHAPE))
    kv.pull(3, out=out)
    assert kv.type == "device"
    return [out.asnumpy()]


def _rank_and_num_workers_local(pkg):
    kv = pkg.kv.create("local")
    return [np.array([kv.rank, kv.num_workers])]


def _string_keys(pkg):
    kv = pkg.kv.create("local")
    kv.init("weight", _nd(pkg, np.ones((2, 2))))
    out = _nd(pkg, np.zeros((2, 2)))
    kv.pull("weight", out=out)
    return [out.asnumpy()]


@pytest.mark.parametrize("case", [
    _single_kv_pair, _push_aggregates, _push_replaces_store_without_updater,
    _list_kv_pairs, _updater_runs_on_push, _set_optimizer_applies_update,
    _device_type_same_semantics, _rank_and_num_workers_local, _string_keys],
    ids=lambda f: f.__name__.lstrip("_"))
def test_kvstore_case_matches_jax(case):
    _both(case)


def test_push_aggregates_values():
    got = _push_aggregates(mt)[0]
    rng = np.random.RandomState(0)
    parts = [rng.randn(*SHAPE).astype(np.float32) for _ in range(4)]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    np.testing.assert_array_equal(got, want)
    assert _rank_and_num_workers_local(mt)[0].tolist() == [0, 1]
    np.testing.assert_array_equal(_updater_runs_on_push(mt)[0],
                                  np.full(SHAPE, 10.0, np.float32))


@pytest.mark.parametrize("pkg", [mx, mt], ids=["jax", "port"])
def test_duplicate_init_raises(pkg):
    kv = pkg.kv.create("local")
    kv.init(1, _nd(pkg, np.zeros((2,))))
    with pytest.raises(pkg.MXNetError):
        kv.init(1, _nd(pkg, np.zeros((2,))))


@pytest.mark.parametrize("pkg", [mx, mt], ids=["jax", "port"])
def test_push_before_init_raises(pkg):
    kv = pkg.kv.create("local")
    with pytest.raises(pkg.MXNetError):
        kv.push(9, _nd(pkg, np.ones((2,))))


def test_pull_keeps_the_destination_device_and_dtype():
    """A pull copies into the destination array: its tensor, device and
    dtype stay."""
    import torch

    kv = mt.kv.create("device")
    kv.init(0, _nd(mt, np.arange(4)))
    out = mt.nd.zeros((4,), mt.cpu(1), dtype="float64")
    held = out._data
    kv.pull(0, out=out)
    assert out._data is held and out.context == mt.cpu(1)
    assert out._data.dtype == torch.float64
    np.testing.assert_array_equal(out.asnumpy(), np.arange(4))


def test_create_dist_async_returns_a_parameter_server_store():
    with mt.cpu():
        kv = mt.kv.create("dist_async")
    try:
        assert isinstance(kv, mt.kvstore.DistAsyncKVStore)
        assert kv.type == "dist_async" and kv._server.ctx == mt.cpu()
        kv.init(3, _nd(mt, np.ones(SHAPE)))
        out = _nd(mt, np.zeros(SHAPE))
        kv.pull(3, out=out)
        np.testing.assert_array_equal(out.asnumpy(), np.ones(SHAPE))
    finally:
        kv.close()
    with pytest.raises(mt.MXNetError, match="unknown KVStore"):
        mt.kv.create("nonsense")
