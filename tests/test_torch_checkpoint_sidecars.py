"""The checkpoint sidecars of the port (``mxnet_tpu_torch/model.py``) against
the JAX package's (``mxnet_tpu/model.py``): ``nd.save(checksum=)``,
``save_checkpoint(max_to_keep=, extra_state=, mark_last_good=)``,
``find_latest_checkpoint`` and ``load_checkpoint_state``.

The ``.params``, ``.params.crc32`` and ``-last-good`` bytes and the file
names are the JAX package's, so each package discovers and loads the
other's checkpoints; the ``.state`` pickle's ``rng`` entry is per package
(a threefry key there, generator states here) and everything else in it
crosses.  All comparisons are bitwise."""
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

SIDES = {"jax": mx, "port": mt}


def _arrays(pkg, seed=0):
    rng = np.random.RandomState(seed)
    ctx = {} if pkg is mx else {"ctx": mt.cpu()}
    return {"fc_weight": pkg.nd.array(rng.randn(3, 6).astype(np.float32),
                                      **ctx),
            "fc_bias": pkg.nd.array(rng.randn(3).astype(np.float32), **ctx)}


def _net(pkg):
    with pkg.NameManager():
        return pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                      num_hidden=3, name="fc")


def _save_epochs(pkg, prefix, epochs, kwargs=None):
    """Save epochs with ``kwargs[epoch]`` as each save's sidecar args."""
    net = _net(pkg)
    for ep in epochs:
        pkg.model.save_checkpoint(prefix, ep, net, _arrays(pkg, seed=ep), {},
                                  **(kwargs or {}).get(ep, {}))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_nd_save_checksum_writes_the_jax_bytes(tmp_path):
    paths = {}
    for side, pkg in SIDES.items():
        paths[side] = str(tmp_path / ("%s.params" % side))
        pkg.nd.save(paths[side], _arrays(pkg), checksum=True)
    assert _read(paths["jax"]) == _read(paths["port"])
    assert _read(paths["jax"] + ".crc32") == _read(paths["port"] + ".crc32")
    # without the flag no sidecar, in both
    plain = str(tmp_path / "plain.params")
    mt.nd.save(plain, _arrays(mt))
    assert not os.path.exists(plain + ".crc32")
    assert _read(plain) == _read(paths["jax"])


def test_save_checkpoint_sidecars_match(tmp_path):
    """Epochs 1-4 with epoch 1 marked last-good and a ring of 2: both
    packages keep 1, 3 and 4, with the same bytes but ``.state``'s rng."""
    files = {}
    for side, pkg in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        prefix = str(d / "m")
        _save_epochs(pkg, prefix, [1, 2, 3, 4], {
            1: {"mark_last_good": True, "max_to_keep": 2,
                "extra_state": {"iter": {"cursor": 1}}},
            2: {"max_to_keep": 2, "extra_state": {"iter": {"cursor": 2}}},
            3: {"max_to_keep": 2, "extra_state": {"iter": {"cursor": 3}}},
            4: {"max_to_keep": 2, "extra_state": {"iter": {"cursor": 4}}}})
        files[side] = {f: _read(str(d / f)) for f in sorted(os.listdir(d))}
    assert sorted(files["jax"]) == sorted(files["port"]) == [
        "m-0001.params", "m-0001.params.crc32", "m-0001.state",
        "m-0003.params", "m-0003.params.crc32", "m-0003.state",
        "m-0004.params", "m-0004.params.crc32", "m-0004.state",
        "m-last-good", "m-symbol.json"]
    for name in files["jax"]:
        if name.endswith(".state"):
            jst, tst = (pickle.loads(files[s][name]) for s in SIDES)
            assert sorted(jst) == sorted(tst) == ["iter", "rng"]
            assert jst["iter"] == tst["iter"]
            assert sorted(jst["rng"]) == ["key", "seed"]
            assert sorted(tst["rng"]) == ["generators", "seed"]
        else:
            assert files["jax"][name] == files["port"][name], name


def _tear(prefix, ep):
    path = "%s-%04d.params" % (prefix, ep)
    data = _read(path)
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


def _flip(prefix, ep):
    path = "%s-%04d.params" % (prefix, ep)
    data = bytearray(_read(path))
    data[-5] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


def _bad_magic(prefix, ep):
    path = "%s-%04d.params" % (prefix, ep)
    os.remove(path + ".crc32")
    data = bytearray(_read(path))
    data[0] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


def _no_sidecar(prefix, ep):
    os.remove("%s-%04d.params.crc32" % (prefix, ep))


def _mark(pkg, prefix, ep):
    pkg.model._mark_last_good(prefix, ep)


SCENARIOS = {
    # name: (damage(pkg, prefix), expected latest, expected raw newest)
    "intact": (lambda pkg, p: None, 3, 3),
    "torn": (lambda pkg, p: _tear(p, 3), 2, 2),
    "corrupt": (lambda pkg, p: _flip(p, 3), 2, 2),
    "bad_magic": (lambda pkg, p: _bad_magic(p, 3), 2, 2),
    "no_sidecar": (lambda pkg, p: _no_sidecar(p, 3), 3, 3),
    "last_good": (lambda pkg, p: _mark(pkg, p, 1), 1, 3),
    "last_good_corrupt": (lambda pkg, p: (_mark(pkg, p, 2), _flip(p, 2)),
                          3, 3),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("writer", sorted(SIDES))
def test_find_latest_checkpoint_agrees_across_packages(tmp_path, writer,
                                                       scenario):
    pkg = SIDES[writer]
    prefix = str(tmp_path / "ck")
    _save_epochs(pkg, prefix, [1, 2, 3])
    damage, latest, newest = SCENARIOS[scenario]
    damage(pkg, prefix)
    for reader in SIDES.values():
        assert reader.model.find_latest_checkpoint(prefix) == latest
        assert reader.model.find_latest_checkpoint(
            prefix, prefer_last_good=False) == newest
    assert mt.model.find_latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("writer", sorted(SIDES))
def test_each_package_loads_the_others_checkpoint(tmp_path, writer):
    prefix = str(tmp_path / "x")
    _save_epochs(SIDES[writer], prefix, [5])
    ref = _arrays(mx, seed=5)
    for reader in SIDES.values():
        _, args, aux = reader.model.load_checkpoint(prefix, 5)
        assert aux == {}
        for k, v in ref.items():
            assert np.array_equal(args[k].asnumpy(), v.asnumpy())


@pytest.mark.parametrize("writer", sorted(SIDES))
def test_load_checkpoint_state_crosses_but_rng_is_per_package(tmp_path,
                                                              writer):
    prefix = str(tmp_path / "s")
    extra = {"iter": {"cursor": 17, "epoch": 2}, "note": "resume"}
    _save_epochs(SIDES[writer], prefix, [1], {1: {"extra_state": extra}})
    for reader in SIDES.values():
        state = reader.model.load_checkpoint_state(prefix, 1)
        assert {k: state[k] for k in extra} == extra
    assert mt.model.load_checkpoint_state(prefix, 9) is None
    if writer == "jax":
        with pytest.raises(mt.model.ForeignRNGStateError,
                           match="another package's random state"):
            mt.model.load_checkpoint_state(prefix, 1, restore_rng=True)
    else:
        # the JAX package cannot read the port's generator states either
        with pytest.raises(KeyError):
            mx.model.load_checkpoint_state(prefix, 1, restore_rng=True)


def test_restore_rng_replays_the_port_draws_bitwise(tmp_path):
    prefix = str(tmp_path / "r")
    mt.random.seed(123)
    mt.random.uniform(shape=(7,), ctx=mt.cpu())  # move the stream along
    _save_epochs(mt, prefix, [1])
    first = [mt.random.uniform(shape=(16,), ctx=mt.cpu()).asnumpy(),
             mt.random.normal(shape=(4, 4), ctx=mt.cpu()).asnumpy()]
    mt.random.seed(999)
    mt.random.uniform(shape=(3,), ctx=mt.cpu())
    mt.model.load_checkpoint_state(prefix, 1, restore_rng=True)
    again = [mt.random.uniform(shape=(16,), ctx=mt.cpu()).asnumpy(),
             mt.random.normal(shape=(4, 4), ctx=mt.cpu()).asnumpy()]
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
