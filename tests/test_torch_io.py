"""The port's iterators against the JAX package's, on the CPU, from the same
inputs: ``ResizeIter``, ``PrefetchingIter`` (rename, reset, depth, several
sources, a source's error, sources of different lengths, state capture),
``MNISTIter`` on idx-ubyte files the test writes (plain and gzipped,
``flat``, ``shuffle``/``seed``, ``part_index``/``num_parts``) and
``CSVIter`` (``round_batch`` padding), batch by batch and bit for bit.
Batches stay on the host.

Every test that starts prefetching workers closes them, and runs inside
``_bounded``: a hang fails that test after ``TIMEOUT`` seconds instead of
stalling the run.
"""
import gzip
import os
import struct
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TIMEOUT = 20.0


def _bounded(fn, timeout=TIMEOUT):
    """Run ``fn`` in a daemon thread; fail if it has not returned within
    ``timeout`` seconds, and re-raise what it raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # handed to the test thread
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "timed out after %.0f s" % timeout
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _batches(it):
    """Every batch of one epoch as (data, label, pad) numpy lists."""
    return [([d.asnumpy() for d in b.data],
             [lab.asnumpy() for lab in (b.label or [])], b.pad) for b in it]


def _assert_same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, y)


def _both(make):
    """``make(pkg)`` for the JAX package and the port."""
    return make(mx), make(mt)


def _write_mnist(folder, n, gz=False, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    suffix = ".gz" if gz else ""
    opener = gzip.open if gz else open
    img = os.path.join(folder, "images-idx3-ubyte" + suffix)
    lbl = os.path.join(folder, "labels-idx1-ubyte" + suffix)
    with opener(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(images.tobytes())
    with opener(lbl, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return img, lbl, images, labels


def _ndarray_iter(pkg, n=12, width=2, batch=4, label=True):
    X = np.arange(n * width, dtype=np.float32).reshape(n, width)
    return pkg.io.NDArrayIter(X, np.arange(n, dtype=np.float32)
                              if label else None, batch_size=batch)


@pytest.mark.parametrize("size", [2, 5])
def test_resize_iter_matches_jax(size):
    """Shorter than the source stops early; longer restarts it."""
    jit, tit = _both(lambda pkg: pkg.io.ResizeIter(
        _ndarray_iter(pkg, n=12, batch=3), size))
    for _ in range(2):
        got = _batches(tit)
        assert len(got) == size
        _assert_same(got, _batches(jit))
        jit.reset()
        tit.reset()
    assert tit.provide_data == jit.provide_data
    state = tit.state_dict()
    assert state["cur"] == 0


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetching_iter_epochs_reset_and_depth(depth):
    """Three epochs through reset at each queue depth: the source's
    batches, as the JAX package's PrefetchingIter gives them."""
    def body():
        jit, tit = _both(lambda pkg: pkg.io.PrefetchingIter(
            _ndarray_iter(pkg), prefetch_depth=depth))
        with jit, tit:
            for _ in range(3):
                got = _batches(tit)
                assert len(got) == 3
                _assert_same(got, _batches(jit))
                jit.reset()
                tit.reset()
            assert tit.batch_size == 4
    _bounded(body)


def test_prefetching_iter_several_sources_renamed():
    """Two sources, data and label renamed; one batch joins both."""
    def body():
        def make(pkg):
            return pkg.io.PrefetchingIter(
                [_ndarray_iter(pkg, n=8, width=2),
                 _ndarray_iter(pkg, n=8, width=3, label=False)],
                rename_data=[{"data": "d1"}, {"data": "d2"}],
                rename_label=[{"softmax_label": "l1"}, {}])
        jit, tit = _both(make)
        with jit, tit:
            assert [tuple(d) for d in tit.provide_data] == \
                [tuple(d) for d in jit.provide_data] == \
                [("d1", (4, 2)), ("d2", (4, 3))]
            assert [d.name for d in tit.provide_label] == ["l1"]
            got = _batches(tit)
            assert len(got) == 2 and got[0][0][1].shape == (4, 3)
            _assert_same(got, _batches(jit))
    _bounded(body)


class _Boom:
    """A source whose every batch raises."""

    def __init__(self, pkg):
        self.batch_size = 4
        self.provide_data = [pkg.io.DataDesc("data", (4, 2))]
        self.provide_label = []

    def reset(self):
        pass

    def next(self):
        raise ValueError("decode failed")


def test_prefetching_iter_source_error_and_uneven_sources():
    """A source's exception reaches the consumer; sources that end at
    different batch counts raise; past the end ``next`` keeps raising
    StopIteration."""
    def body():
        it = mt.io.PrefetchingIter(_Boom(mt))
        with it, pytest.raises(ValueError, match="decode failed"):
            it.next()
        it = mt.io.PrefetchingIter([_ndarray_iter(mt, n=8),
                                    _ndarray_iter(mt, n=12)])
        with it:
            assert len([it.next() for _ in range(2)]) == 2
            with pytest.raises(RuntimeError, match="different batch counts"):
                it.next()
        it = mt.io.PrefetchingIter(_ndarray_iter(mt, n=8))
        with it:
            assert len(list(it)) == 2
            for _ in range(3):
                with pytest.raises(StopIteration):
                    it.next()
    _bounded(body)


def test_prefetching_iter_state_replays_the_rest_of_the_epoch():
    """``state_dict`` after two batches (the workers read ahead of them),
    restored on a new iterator over a shuffled source, gives the same
    remaining batches."""
    def body():
        X = np.arange(40, dtype=np.float32).reshape(20, 2)

        def make():
            return mt.io.PrefetchingIter(mt.io.NDArrayIter(
                X, np.arange(20, dtype=np.float32), batch_size=4,
                shuffle=True, rng=np.random.RandomState(1)))
        a = make()
        with a:
            a.next()
            a.next()
            state = a.state_dict()
            rest = _batches(a)
        b = mt.io.PrefetchingIter(mt.io.NDArrayIter(
            X, np.arange(20, dtype=np.float32), batch_size=4))
        with b:
            b.set_state(state)
            _assert_same(_batches(b), rest)
    _bounded(body)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("flat", [False, True], ids=["image", "flat"])
def test_mnist_iter_matches_jax(tmp_path, gz, flat):
    """Written idx-ubyte files read by both packages: unshuffled batches
    are the pixels / 255 and the labels, in order; the shuffled order of a
    seed is the JAX package's."""
    img, lbl, images, labels = _write_mnist(str(tmp_path), 23, gz)
    for shuffle in (False, True):
        jit, tit = _both(lambda pkg: pkg.io.MNISTIter(
            image=img, label=lbl, batch_size=5, shuffle=shuffle, flat=flat,
            seed=3))
        got = _batches(tit)
        assert len(got) == 4  # full batches only
        _assert_same(got, _batches(jit))
        assert got[0][0][0].shape == ((5, 784) if flat else (5, 1, 28, 28))
    first = _batches(mt.io.MNISTIter(image=img, label=lbl, batch_size=5,
                                     shuffle=False, flat=flat))[0]
    np.testing.assert_array_equal(first[1][0], labels[:5])
    np.testing.assert_array_equal(
        first[0][0].reshape(5, 28, 28), images[:5].astype(np.float32) / 255)


def test_mnist_iter_parts_and_bad_magic(tmp_path):
    """``part_index``/``num_parts`` give each worker its share, as the JAX
    package splits it; a file of the wrong kind raises."""
    img, lbl, _, _ = _write_mnist(str(tmp_path), 30)
    for part in range(3):
        jit, tit = _both(lambda pkg: pkg.io.MNISTIter(
            image=img, label=lbl, batch_size=5, shuffle=False,
            part_index=part, num_parts=3))
        _assert_same(_batches(tit), _batches(jit))
    with pytest.raises(mt.MXNetError, match="magic"):
        mt.io.MNISTIter(image=lbl, label=lbl)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    """Data and label files read in batches of 4 over 10 rows: the last
    batch padded from the start (``round_batch``) or with zeros, its pad
    counted; with no label file the labels are zeros."""
    rng = np.random.RandomState(4)
    X = rng.randn(10, 6).astype(np.float32)
    Y = rng.randint(0, 3, (10, 1)).astype(np.float32)
    data, label = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(data, X, delimiter=",")
    np.savetxt(label, Y, delimiter=",")
    for label_csv in (label, None):
        jit, tit = _both(lambda pkg: pkg.io.CSVIter(
            data_csv=data, data_shape=(2, 3), label_csv=label_csv,
            batch_size=4, round_batch=round_batch))
        got = _batches(tit)
        assert [p for _, _, p in got] == [0, 0, 2]
        _assert_same(got, _batches(jit))
        assert [tuple(d) for d in tit.provide_data] == \
            [tuple(d) for d in jit.provide_data]
        tit.reset()
        tit.next()
        assert tit.state_dict() == {"cursor": 0}


def test_ndarray_iter_state_dict_matches_jax():
    """``NDArrayIter``'s state (cursor and shuffle order) in the JAX
    package's layout, and restored on an unshuffled iterator."""
    X = np.arange(30, dtype=np.float32).reshape(15, 2)
    np.random.seed(7)
    jit = mx.io.NDArrayIter(X, np.arange(15, dtype=np.float32), 4,
                            shuffle=True)
    np.random.seed(7)
    tit = mt.io.NDArrayIter(X, np.arange(15, dtype=np.float32), 4,
                            shuffle=True)
    jit.next()
    tit.next()
    js, ts = jit.state_dict(), tit.state_dict()
    assert js["cursor"] == ts["cursor"] == 0
    np.testing.assert_array_equal(js["shuffle_perm"], ts["shuffle_perm"])
    fresh = mt.io.NDArrayIter(X, np.arange(15, dtype=np.float32), 4)
    fresh.set_state(ts)
    _assert_same(_batches(fresh), _batches(jit))


def test_batches_stay_on_the_host(tmp_path):
    """Every iterator yields CPU arrays; the executor copies them."""
    img, lbl, _, _ = _write_mnist(str(tmp_path), 10)
    np.savetxt(str(tmp_path / "d.csv"), np.ones((4, 2)), delimiter=",")

    def body():
        its = [mt.io.MNISTIter(image=img, label=lbl, batch_size=5),
               mt.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                             data_shape=(2,), batch_size=2)]
        its.append(mt.io.ResizeIter(its[1], 3))
        pre = mt.io.PrefetchingIter(mt.io.MNISTIter(image=img, label=lbl,
                                                    batch_size=5))
        with pre:
            for it in its + [pre]:
                b = it.next()
                assert all(a.context == mt.cpu() for a in b.data + b.label)
    _bounded(body)
