"""The port's image pipeline (``mxnet_tpu_torch.image``) against the JAX
package's, on the CPU: ``imdecode``/``imresize`` and the crop functions,
every augmenter and ``CreateAugmenter`` chain, ``ImageIter`` and
``ImageRecordIter`` batches (with and without the ``.idx``, sharded,
shuffled, padded or discarded), the detection labels, augmenters and
``ImageDetRecordIter``, the four image-decode ops and ``nd.imdecode``: all
bit for bit, with Python's ``random`` and ``np.random`` seeded alike before
each package (the JAX package draws from them, and so does the port).
Each iterator that starts threads (``PrefetchingIter``, the decode pool of
``_ParallelImageIter``, the native prefetch reader) is closed, inside a
time bound.  A ResNet-18 then trains from a ``.rec`` through ``Module``
in-process, as ``tests/test_real_data_e2e.py`` holds the JAX package."""
import os
import random
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import image as jimage
from mxnet_tpu_torch import image, image_backend, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OpContext, get_op

#: seconds a test's iterator may take before it counts as hung
BOUND_S = 120


def _bounded(fn, *args):
    """``fn(*args)`` in a thread that must finish within BOUND_S."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as exc:  # handed back to the test
            box["exc"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(BOUND_S)
    assert not t.is_alive(), "%s did not finish in %d s" % (fn, BOUND_S)
    if "exc" in box:
        raise box["exc"]
    return box["out"]


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _cls_image(rng, h, w, cls):
    img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
    img[:, :, cls % 3] = np.minimum(img[:, :, cls % 3] + 180, 255)
    return img


def _pack(folder, n=14, fmt=".jpg", sizes=((36, 44), (40, 32)), labels=1,
          idx=True):
    """``n`` class-coloured images (sizes alternating) packed with the
    port's ``MXIndexedRecordIO`` + ``pack_img`` as im2rec packs them;
    returns the .rec path (its .idx removed unless ``idx``)."""
    rng = np.random.RandomState(0)
    prefix = os.path.join(str(folder), "p%s%d" % (fmt[1:], n))
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        h, wd = sizes[i % len(sizes)]
        label = float(i % 2) if labels == 1 else \
            [float(i % 2), float(i % 3), float(i)][:labels]
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, label, i, 0),
            _cls_image(rng, h, wd, i % 2), quality=95, img_fmt=fmt))
    w.close()
    if not idx:
        os.remove(prefix + ".idx")
    return prefix + ".rec"


def _drain(it, close=True):
    """Every batch of ``it`` as (data, label, pad), then ``close``."""
    try:
        return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it]
    finally:
        if close:
            for obj in [it] + list(getattr(it, "iters", [])):
                if hasattr(obj, "close"):
                    obj.close()


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def _both_iters(make, seed=3):
    """``make(pkg)`` drained in each package, seeds set before each."""
    _seed(seed)
    theirs = _bounded(lambda: _drain(make(mx)))
    _seed(seed)
    ours = _bounded(lambda: _drain(make(mt)))
    _same(ours, theirs)
    return ours


# -- functions ----------------------------------------------------------------

@pytest.mark.parametrize("fmt,flag,to_rgb", [(".jpg", 1, True),
                                             (".png", 1, False),
                                             (".png", 0, True)])
def test_imdecode_and_imresize_match_jax(fmt, flag, to_rgb):
    img = _cls_image(np.random.RandomState(1), 21, 17, 1)
    buf = image_backend.encode_image(img, fmt, 90)
    with mt.cpu():
        ours = image.imdecode(buf, flag=flag, to_rgb=to_rgb)
    theirs = jimage.imdecode(buf, flag=flag, to_rgb=to_rgb)
    assert ours.context == mt.cpu() and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours.asnumpy(), theirs.asnumpy())
    for interp in (0, 1, 2, 4):
        r = image.imresize(ours, 9, 13, interp)
        assert r.context == mt.cpu()
        np.testing.assert_array_equal(
            r.asnumpy(), jimage.imresize(theirs, 9, 13, interp).asnumpy())


def test_crop_functions_match_jax():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, (30, 41, 3)).astype(np.uint8)
    assert image.scale_down((41, 30), (50, 20)) == \
        jimage.scale_down((41, 30), (50, 20))
    for fn, args in [("resize_short", (16,)),
                     ("fixed_crop", (3, 4, 20, 10, (8, 9))),
                     ("random_crop", ((16, 12),)),
                     ("center_crop", ((16, 12),)),
                     ("random_size_crop", ((14, 14),)),
                     ("color_normalize", (np.array([1., 2., 3.]),
                                          np.array([2., 3., 4.])))]:
        _seed(5)
        theirs = getattr(jimage, fn)(img, *args)
        _seed(5)
        ours = getattr(image, fn)(img, *args)
        if isinstance(theirs, tuple):
            assert ours[1] == theirs[1]
            ours, theirs = ours[0], theirs[0]
        np.testing.assert_array_equal(ours, theirs, err_msg=fn)
    # an NDArray stays an NDArray on its context
    with mt.cpu():
        nd_img = mt.nd.array(img)
    out = image.center_crop(nd_img, (10, 10))[0]
    assert isinstance(out, mt.nd.NDArray) and out.context == mt.cpu()


EIGVAL = np.array([55.46, 4.794, 1.148])
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])
AUGMENTERS = [
    ("ResizeAug", (20,), "u8"), ("ResizeAug", (20, 2), "u8"),
    ("ForceResizeAug", ((15, 18),), "u8"),
    ("RandomCropAug", ((16, 16),), "u8"),
    ("RandomSizedCropAug", ((16, 16),), "u8"),
    ("CenterCropAug", ((16, 16),), "u8"),
    ("BrightnessJitterAug", (0.3,), "f32"),
    ("ContrastJitterAug", (0.3,), "f32"),
    ("SaturationJitterAug", (0.3,), "f32"),
    ("LightingAug", (0.1, EIGVAL, EIGVEC), "f32"),
    ("ColorNormalizeAug", (np.array([120., 110., 100.]),
                           np.array([50., 55., 60.])), "f32"),
    ("HorizontalFlipAug", (0.5,), "u8"),
    ("CastAug", (), "u8"),
]


@pytest.mark.parametrize("name,args,kind", AUGMENTERS,
                         ids=[a[0] + "-%d" % i
                              for i, a in enumerate(AUGMENTERS)])
def test_augmenter_matches_jax(name, args, kind):
    """Each augmenter, run 4 times under one seed in each package, on numpy
    (the iterators' path) and, once, on an NDArray (the user's path)."""
    img = np.random.RandomState(3).randint(0, 255, (26, 31, 3))
    img = img.astype(np.uint8 if kind == "u8" else np.float32)
    outs = []
    for pkg in (jimage, image):
        aug = getattr(pkg, name)(*args)
        _seed(11)
        outs.append([np.asarray(aug(img)[0]) for _ in range(4)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    with mt.cpu():
        got = getattr(image, name)(*args)(mt.nd.array(img))[0]
    assert isinstance(got, mt.nd.NDArray) and got.context == mt.cpu()


def test_random_order_aug_matches_jax():
    outs = []
    for pkg in (jimage, image):
        aug = pkg.RandomOrderAug([pkg.BrightnessJitterAug(0.2),
                                  pkg.ContrastJitterAug(0.2),
                                  pkg.SaturationJitterAug(0.2)])
        _seed(4)
        img = np.random.RandomState(0).rand(9, 8, 3).astype(np.float32)
        outs.append([aug(img * 100)[0] for _ in range(5)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


CHAINS = [dict(),
          dict(resize=30, rand_crop=True, rand_mirror=True, mean=True,
               std=True),
          dict(rand_crop=True, rand_resize=True, brightness=0.2,
               contrast=0.2, saturation=0.2, pca_noise=0.1,
               mean=np.array([1., 2., 3.]), inter_method=1)]


@pytest.mark.parametrize("kwargs", CHAINS, ids=["default", "resize-crop",
                                                 "jitter-pca"])
def test_create_augmenter_chain_matches_jax(kwargs):
    """The same values as the JAX package's chain; the port's chain is an
    ``_NpSafeAugList`` (the iterators run it numpy to numpy), where the
    JAX package's is a plain list (its iterators pass NDArrays)."""
    assert isinstance(image.CreateAugmenter((3, 24, 24), **kwargs),
                      image._NpSafeAugList)
    img = np.random.RandomState(6).randint(0, 255, (37, 44, 3), np.uint8)
    outs = []
    for pkg in (jimage, image):
        chain = pkg.CreateAugmenter((3, 24, 24), **kwargs)
        _seed(8)
        res = []
        for _ in range(3):
            a = img
            for aug in chain:
                a = aug(a)[0]
            res.append(np.asarray(a))
        outs.append(res)
    for a, b in zip(*outs):
        assert b.shape == (24, 24, 3) and b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


# -- iterators ----------------------------------------------------------------

ITER_CASES = {
    "idx": dict(),
    "no-idx": dict(idx=False),
    "shuffle": dict(shuffle=True),
    "no-idx-shuffle": dict(idx=False, shuffle=True),
    "discard": dict(last_batch_handle="discard"),
    "png-labels3": dict(fmt=".png", labels=3, label_width=3),
    "augmented": dict(aug=True),
}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_image_iter_batches_match_jax(tmp_path, case):
    opts = dict(ITER_CASES[case])
    rec = _pack(tmp_path, fmt=opts.pop("fmt", ".jpg"),
                labels=opts.pop("labels", 1), idx=opts.pop("idx", True))
    aug = opts.pop("aug", False)

    def make(pkg):
        chain = pkg.image.CreateAugmenter(
            (3, 24, 24), resize=28, rand_crop=aug, rand_mirror=aug,
            mean=True if aug else None)
        return pkg.image.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                                   path_imgrec=rec, aug_list=chain, **opts)

    got = _both_iters(make)
    assert len(got) == (3 if case == "discard" else 4)


@pytest.mark.parametrize("idx", [True, False], ids=["idx", "no-idx"])
def test_image_iter_shards_match_jax(tmp_path, idx):
    """Parts of 14 records in 4: the remainder over the first parts (4, 4,
    3, 3), no sample dropped, each part's batches as the JAX package's."""
    rec = _pack(tmp_path, idx=idx)
    counts = []
    for part in range(4):
        def make(pkg):
            return pkg.image.ImageIter(
                batch_size=2, data_shape=(3, 24, 24), path_imgrec=rec,
                part_index=part, num_parts=4, shuffle=not idx,
                aug_list=pkg.image.CreateAugmenter((3, 24, 24), resize=28))
        got = _both_iters(make)
        counts.append(sum(len(d) - p for d, _, p in got))
    assert counts == [4, 4, 3, 3]


def test_image_iter_from_an_image_list_matches_jax(tmp_path):
    """``path_imglist`` + ``path_root`` and ``imglist`` read the files."""
    rng = np.random.RandomState(0)
    lines, items = [], []
    for i in range(6):
        name = "im%d.jpg" % i
        with open(tmp_path / name, "wb") as f:
            f.write(image_backend.encode_image(
                _cls_image(rng, 30, 34, i % 2), ".jpg"))
        lines.append("%d\t%f\t%s" % (i, float(i % 2), name))
        items.append([float(i % 2), str(tmp_path / name)])
    lst = str(tmp_path / "list.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    for kw in (dict(path_imglist=lst, path_root=str(tmp_path)),
               dict(imglist=items, path_root="/")):
        def make(pkg):
            return pkg.image.ImageIter(
                batch_size=4, data_shape=(3, 24, 24), shuffle=True,
                aug_list=pkg.image.CreateAugmenter((3, 24, 24)), **kw)
        got = _both_iters(make)
        assert [p for _, _, p in got] == [0, 2]


@pytest.mark.parametrize("prefetch", [0, 1], ids=["direct", "prefetching"])
def test_image_record_iter_matches_jax(tmp_path, prefetch):
    """``mt.io.ImageRecordIter`` as train_imagenet.get_rec_iter builds it
    (shuffle, rand_crop, rand_mirror, the three means), one decode thread so
    the draws keep their order; JPEGs through the native decoder in both.
    Two epochs (the second after ``reset``)."""
    rec = _pack(tmp_path, n=20)

    def make(pkg):
        return pkg.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 24, 24), batch_size=6,
            shuffle=True, rand_crop=True, rand_mirror=True, mean_r=123.68,
            mean_g=116.779, mean_b=103.939, std_r=58.4, std_g=57.1,
            std_b=57.4, preprocess_threads=1, prefetch_buffer=prefetch)

    def two_epochs(pkg):
        it = make(pkg)
        first = _drain(it, close=False)
        it.reset()
        return first + _drain(it)

    _seed(9)
    theirs = _bounded(two_epochs, mx)
    _seed(9)
    ours = _bounded(two_epochs, mt)
    _same(ours, theirs)
    assert len(ours) == 8 and ours[0][0].shape == (6, 3, 24, 24)


def test_image_record_iter_threads_decode_alike(tmp_path):
    """With 4 decode threads and no random augmenter the batches are the
    JAX package's, whatever order the threads run in."""
    rec = _pack(tmp_path, n=16, sizes=((30, 30), (28, 36)))

    def make(pkg):
        return pkg.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 24, 24), batch_size=8,
            mean_r=123.68, mean_g=116.779, mean_b=103.939,
            preprocess_threads=4)

    _both_iters(make)


# -- detection ----------------------------------------------------------------

def test_detection_labels_match_jax():
    objs = np.array([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.3, 0.3, 0.9, 0.8]],
                    np.float32)
    for hw in (2, 4):
        flat = image._det_encode_label(objs, hw)
        np.testing.assert_array_equal(flat,
                                      jimage._det_encode_label(objs, hw))
        np.testing.assert_array_equal(image._det_parse_label(flat), objs)
    for bad in ([1.0], [1, 5, 0, 0, 0, 0, 0], [2, 4, 0, 0, 0, 0]):
        with pytest.raises(ValueError):
            image._det_parse_label(bad)


DET_AUGS = [("DetHorizontalFlipAug", (0.5,)),
            ("DetRandomCropAug", (0.1, (0.75, 1.33), (0.3, 0.9), 30)),
            ("DetForceResizeAug", ((20, 18),))]


@pytest.mark.parametrize("name,args", DET_AUGS, ids=[a[0] for a in DET_AUGS])
def test_detection_augmenter_matches_jax(name, args):
    img = np.random.RandomState(3).randint(0, 255, (40, 36, 3), np.uint8)
    objs = np.array([[1, 0.3, 0.35, 0.6, 0.7], [0, 0.1, 0.1, 0.4, 0.3]],
                    np.float32)
    outs = []
    for pkg in (jimage, image):
        aug = getattr(pkg, name)(*args)
        _seed(12)
        outs.append([aug(img, objs) for _ in range(4)])
    for (ia, la), (ib, lb) in zip(*outs):
        np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia))
        np.testing.assert_array_equal(lb, la)


def _det_pack(folder, n=12, size=48):
    """One square per image in the channel of its class; labels [2, 5, cls,
    xmin, ymin, xmax, ymax] (a second box on every third image)."""
    rng = np.random.RandomState(0)
    path = os.path.join(str(folder), "det.rec")
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = np.zeros((size, size, 3), np.uint8)
        s = rng.randint(size // 4, size // 2)
        x0, y0 = rng.randint(0, size - s, 2)
        cls = rng.randint(0, 2)
        img[y0:y0 + s, x0:x0 + s, cls % 3] = 255
        label = [2, 5, cls, x0 / size, y0 / size, (x0 + s) / size,
                 (y0 + s) / size]
        if i % 3 == 0:
            label += [1 - cls, 0.05, 0.05, 0.2, 0.25]
        w.write(recordio.pack_img(recordio.IRHeader(0, label, i, 0), img,
                                  quality=95))
    w.close()
    return path


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_image_det_record_iter_matches_jax(tmp_path, augment):
    """``ImageDetRecordIter`` as train_ssd.py builds it (std 255, labels
    padded to 8 rows of -1), through the PrefetchingIter, with and without
    the random crop and mirror."""
    rec = _det_pack(tmp_path)

    def make(pkg):
        return pkg.image.ImageDetRecordIter(
            path_imgrec=rec, data_shape=(3, 40, 40), batch_size=5,
            label_pad_width=8, std_r=255.0, std_g=255.0, std_b=255.0,
            rand_crop=0.5 if augment else 0.0, rand_mirror=augment,
            label_name="label")

    got = _both_iters(make)
    assert [len(d) - p for d, _, p in got] == [5, 5, 2]
    assert got[0][1].shape == (5, 8, 5)


def test_image_det_iter_rejects_too_many_objects(tmp_path):
    rec = _det_pack(tmp_path)
    it = image.ImageDetIter(4, (3, 40, 40), path_imgrec=rec,
                            label_pad_width=1)
    try:
        with pytest.raises(MXNetError, match="label_pad_width"):
            it.next()
    finally:
        it.close()


# -- the image ops ------------------------------------------------------------

def test_image_ops_and_nd_imdecode_match_jax():
    img = _cls_image(np.random.RandomState(5), 13, 11, 0)
    jpg = image_backend.encode_image(img, ".jpg", 90)
    raw = np.frombuffer(jpg, np.uint8)
    with mt.cpu():
        buf = mt.nd.array(raw, dtype=np.uint8)
        ours = {
            "dec": mt.nd._cvimdecode(buf),
            "dec-bgr": mt.nd._cvimdecode(buf, to_rgb=False),
            "resize": mt.nd._cvimresize(mt.nd._cvimdecode(buf), w=7, h=9),
            "border": mt.nd._cvcopyMakeBorder(mt.nd._cvimdecode(buf), top=1,
                                              bot=2, left=3, right=0,
                                              values=(5.0,)),
            "imdecode": mt.nd.imdecode(jpg),
            "imdecode-crop": mt.nd.imdecode(jpg, clip_rect=(2, 1, 9, 10),
                                            mean=mt.nd.array(np.full(
                                                (3, 9, 7), 10.0,
                                                np.float32))),
        }
    jbuf = mx.nd.array(raw, dtype=np.uint8)
    theirs = {
        "dec": mx.nd._cvimdecode(jbuf),
        "dec-bgr": mx.nd._cvimdecode(jbuf, to_rgb=False),
        "resize": mx.nd._cvimresize(mx.nd._cvimdecode(jbuf), w=7, h=9),
        "border": mx.nd._cvcopyMakeBorder(mx.nd._cvimdecode(jbuf), top=1,
                                          bot=2, left=3, right=0,
                                          values=(5.0,)),
        "imdecode": mx.nd.imdecode(jpg),
        "imdecode-crop": mx.nd.imdecode(jpg, clip_rect=(2, 1, 9, 10),
                                        mean=mx.nd.array(np.full(
                                            (3, 9, 7), 10.0, np.float32))),
    }
    for k in theirs:
        assert ours[k].context == mt.cpu(), k
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k].asnumpy(),
                                      theirs[k].asnumpy(), err_msg=k)
    with mt.cpu():
        out = mt.nd.zeros((3, 3, 13, 11))
    mt.nd.imdecode(jpg, out=out, index=1)
    got = out.asnumpy()
    np.testing.assert_array_equal(got[1], theirs["imdecode"].asnumpy())
    assert not got[0].any() and not got[2].any()


@pytest.mark.parametrize("name", ["_cvimdecode", "_cvimresize",
                                  "_cvcopyMakeBorder", "_imdecode"])
def test_image_ops_refuse_meta_tensors(name):
    """A decode's shape depends on the data: on ``meta`` (a symbol's shape
    inference) the ops raise instead of guessing."""
    op = get_op(name)
    attrs = {"_cvimresize": {"w": 2, "h": 2},
             "_cvcopyMakeBorder": {"top": 1, "bot": 1, "left": 1,
                                   "right": 1}}.get(name, {})
    ins = [torch.empty((4, 4, 3), dtype=torch.uint8, device="meta")
           for _ in op.input_names(op.parse_attrs(attrs))]
    with pytest.raises(MXNetError, match="eagerly"):
        op.apply(OpContext(), op.parse_attrs(attrs), ins)


def test_default_context_imdecode_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is usable")
    jpg = image_backend.encode_image(np.zeros((4, 4, 3), np.uint8), ".jpg")
    with pytest.raises(MXNetError):
        mt.nd.imdecode(jpg)
    with pytest.raises(MXNetError):
        image.imdecode(jpg)


# -- training from a pack ------------------------------------------------------

def test_resnet18_trains_from_a_rec(tmp_path):
    """A ResNet-18 (64², 2 classes) trains 5 epochs from a 32-image JPEG
    .rec read by ``mt.io.ImageRecordIter`` as train_imagenet.py reads it,
    batch 8, through ``Module.fit`` with fit.py's SGD and init: the best of
    the last 3 epochs' training accuracy is above 0.75."""
    rec = _pack(tmp_path, n=32, sizes=((72, 72), (70, 80)))
    _seed(0)
    mt.random.seed(0)
    it = mt.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, 64, 64), batch_size=8, shuffle=True,
        rand_crop=True, rand_mirror=True, mean_r=123.68, mean_g=116.779,
        mean_b=103.939, preprocess_threads=4)
    with mt.NameManager():
        net = mt.models.resnet.get_resnet(num_classes=2, num_layers=18,
                                          image_shape=(3, 64, 64))
    accs = []

    def on_batch(param):
        if param.nbatch == 3:
            accs.append(dict(param.eval_metric.get_name_value())["accuracy"])

    def fit():
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.fit(it, num_epoch=5, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                  "wd": 1e-4},
                initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
                eval_metric="acc", batch_end_callback=on_batch)

    try:
        _bounded(fit)
    finally:
        it.close()
        it.iters[0].close()
    assert len(accs) == 5
    assert max(accs[-3:]) > 0.75, accs


def test_without_pil_jpegs_decode_on_the_native_codec(monkeypatch):
    """Where PIL is missing, ``decode_image`` takes a JPEG to the native
    codec (libjpeg here: the same pixels as PIL's libjpeg); encoding and
    resizing then need nvJPEG or PIL and raise without them."""
    img = _cls_image(np.random.RandomState(7), 30, 26, 1)
    jpg = image_backend.encode_image(img, ".jpg", 95)
    with_pil = image_backend.decode_image(jpg)
    monkeypatch.setattr(image_backend, "HAVE_PIL", False)
    np.testing.assert_array_equal(image_backend.decode_image(jpg), with_pil)
    with pytest.raises(RuntimeError, match="PIL missing"):
        image_backend.decode_image(jpg, channels=1)
    with pytest.raises(RuntimeError):
        image_backend.resize_image(img, 10, 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="encode"):
            image_backend.encode_image(img, ".jpg")
