"""The port's data-IO layer against the JAX package's, on the CPU:
``filesystem`` (the scheme registry, CRC sidecars, ``atomic_write``),
``recordio`` (byte-identical packs, dmlc's multi-part framing, every
corruption error with its offset) and ``native`` (the repository's
``src/recordio.cc`` and ``src/imgdecode.cc`` built into the port's own
``_build/``: native and Python readers and writers interoperate, prefetch
keeps order, ``MXNET_USE_NATIVE=0`` falls back).  Packs written by the port
are byte-identical to the JAX package's and to ``tools/im2rec.py``'s, and
each package reads the other's."""
import io as pyio
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import native as jnative
from mxnet_tpu_torch import native, recordio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = struct.pack("<I", 0xced7230a)


class _MemFS:
    """In-memory scheme handler with enough file-like surface for RecordIO
    (read/write/seek/tell/close) in binary and text modes."""

    def __init__(self):
        self.store = {}

    def __call__(self, uri, mode):
        if "w" in mode:
            outer = self

            class _W(pyio.BytesIO):
                def close(inner):
                    outer.store[uri] = inner.getvalue()
                    super().close()

            w = _W()
            return w if "b" in mode else pyio.TextIOWrapper(w)
        data = self.store[uri]
        return (pyio.BytesIO(data) if "b" in mode
                else pyio.StringIO(data.decode()))


def _payloads(n=50, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.bytes(rng.randint(1, 2000)) for _ in range(n)]


def _magic_payloads():
    return [MAGIC, b"abcd" + MAGIC + b"efgh", b"ab" + MAGIC + b"cdef",
            MAGIC + MAGIC + b"tail", b"x" * 8 + MAGIC, b"", b"abc"]


def _write(pkg, path, payloads):
    w = pkg.recordio.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(pkg, path):
    r = pkg.recordio.MXRecordIO(path, "r")
    got = []
    while True:
        s = r.read()
        if s is None:
            break
        got.append(bytes(s))
    r.close()
    return got


# -- filesystem ---------------------------------------------------------------

@pytest.mark.parametrize("uri", ["s3://bucket/train.rec",
                                 "hdfs://nn/train.rec", "weird://x/y"])
def test_unregistered_scheme_raises_the_jax_message(uri):
    with pytest.raises(IOError) as theirs:
        mx.filesystem.open_uri(uri, "rb")
    with pytest.raises(IOError) as ours:
        mt.filesystem.open_uri(uri, "rb")
    assert str(ours.value) == str(theirs.value)
    assert "register_scheme" in str(ours.value)


@pytest.mark.parametrize("bad", ["", "file", "a"])
def test_non_dispatchable_schemes_rejected(bad):
    with pytest.raises(ValueError, match="cannot be registered"):
        mt.filesystem.register_scheme(bad, lambda uri, mode: None)


def test_scheme_of_and_local_paths(tmp_path):
    for uri in ("C://nope", "hdfs://nn/x", "file:///tmp/x", "/tmp/x",
                "S3://b/k"):
        assert mt.filesystem.scheme_of(uri) == mx.filesystem.scheme_of(uri)
        assert mt.filesystem.local_path(uri) == \
            mx.filesystem.local_path(uri)
    p = tmp_path / "x.bin"
    with mt.filesystem.open_uri(str(p), "wb") as f:
        f.write(b"abc")
    with mt.filesystem.open_uri("file://" + str(p), "rb") as f:
        assert f.read() == b"abc"


def test_records_through_a_registered_scheme_cross_packages():
    """The port writes a plain and an indexed pack through a registered
    scheme; the JAX package reads both through its own registration of the
    same opener, and the bytes equal its own pack's."""
    fs = _MemFS()
    mt.filesystem.register_scheme("mem", fs)
    mx.filesystem.register_scheme("mem", fs)
    try:
        payloads = _payloads(8)
        _write(mt, "mem://d/a.rec", payloads)
        assert _read_all(mx, "mem://d/a.rec") == payloads
        w = mt.recordio.MXIndexedRecordIO("mem://d/b.idx", "mem://d/b.rec",
                                          "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
        w.close()
        r = mx.recordio.MXIndexedRecordIO("mem://d/b.idx", "mem://d/b.rec",
                                          "r")
        assert [bytes(r.read_idx(i)) for i in (5, 0, 7)] == \
            [payloads[5], payloads[0], payloads[7]]
        r.close()
        mine = dict(fs.store)
        _write(mx, "mem://d/a.rec", payloads)
        assert fs.store["mem://d/a.rec"] == mine["mem://d/a.rec"]
    finally:
        mt.filesystem.register_scheme("mem", None)
        mx.filesystem.register_scheme("mem", None)


def test_crc_sidecars_and_atomic_write_interoperate(tmp_path):
    """A sidecar written by either package is verified by the other; a
    changed byte fails it; ``atomic_write`` leaves no temporary file and a
    writer's exception leaves the old file in place."""
    path = str(tmp_path / "w.bin")
    mt.filesystem.atomic_write(path, lambda f: f.write(b"hello" * 100),
                               checksum=True)
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    assert mx.filesystem.verify_crc_sidecar(path) is True
    with open(mt.filesystem.crc_sidecar_path(path)) as f:
        ours = f.read()
    mx.filesystem.write_crc_sidecar(path)
    with open(mx.filesystem.crc_sidecar_path(path)) as f:
        assert f.read() == ours
    assert mt.filesystem.verify_crc_sidecar(path) is True
    assert mt.filesystem.file_crc32(path) == mx.filesystem.file_crc32(path)
    with open(path, "r+b") as f:
        f.write(b"J")
    assert mt.filesystem.verify_crc_sidecar(path) is False
    assert mt.filesystem.verify_crc_sidecar(str(tmp_path / "none")) is None

    def broken(f):
        f.write(b"partial")
        raise RuntimeError("writer died")

    with pytest.raises(RuntimeError):
        mt.filesystem.atomic_write(path, broken)
    with open(path, "rb") as f:
        assert f.read(1) == b"J"
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


# -- recordio -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "magic"])
def test_packs_are_byte_identical_and_cross_readable(tmp_path, kind):
    payloads = _payloads() if kind == "random" else _magic_payloads()
    a, b = str(tmp_path / "port.rec"), str(tmp_path / "jax.rec")
    _write(mt, a, payloads)
    _write(mx, b, payloads)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert _read_all(mx, a) == payloads
    assert _read_all(mt, b) == payloads


def test_multipart_records_split_at_aligned_magic(tmp_path):
    """A payload with the magic word at a 4-byte-aligned offset is written
    as parts flagged 1/2/3 (the magic consumed, restored on read); an
    unaligned one is one part."""
    path = str(tmp_path / "m.rec")
    _write(mt, path, [b"abcd" + MAGIC + b"efgh", b"ab" + MAGIC + b"cd"])
    raw = open(path, "rb").read()
    flags = []
    off = 0
    while off < len(raw):
        magic, lrec = struct.unpack("<II", raw[off:off + 8])
        assert magic == 0xced7230a
        length = lrec & ((1 << 29) - 1)
        flags.append(lrec >> 29)
        off += 8 + length + (4 - length % 4) % 4
    assert flags == [1, 3, 0]


def _corrupt(kind):
    good = MAGIC + struct.pack("<I", 4) + b"abcd"
    first = MAGIC + struct.pack("<I", (1 << 29) | 4) + b"abcd"
    middle = MAGIC + struct.pack("<I", (2 << 29) | 4) + b"efgh"
    return {
        "truncated-header": good + MAGIC[:3],
        "bad-magic": good + b"\x00" * 8,
        "truncated-payload": good + MAGIC + struct.pack("<I", 16) + b"ab",
        "unexpected-continuation": good + middle,
        "unterminated-multipart": first + good,
        "truncated-multipart": good + first,
    }[kind]


@pytest.mark.parametrize("kind", ["truncated-header", "bad-magic",
                                  "truncated-payload",
                                  "unexpected-continuation",
                                  "unterminated-multipart",
                                  "truncated-multipart"])
def test_corruption_raises_with_the_offset(tmp_path, kind):
    """Each damaged stream raises ``RecordIOCorruptError`` (an IOError)
    after the good record, with the uri, the offset and the message the
    JAX package gives."""
    path = str(tmp_path / ("%s.rec" % kind))
    with open(path, "wb") as f:
        f.write(_corrupt(kind))
    errs = []
    for pkg in (mx, mt):
        r = pkg.recordio.MXRecordIO(path, "r")
        got = []
        with pytest.raises(pkg.recordio.RecordIOCorruptError) as e:
            while True:
                got.append(bytes(r.read()))
        r.close()
        # a multi-part record's first part is not a record of its own
        assert got == ([] if kind == "unterminated-multipart"
                       else [b"abcd"])
        errs.append(e.value)
    assert isinstance(errs[1], IOError)
    assert (errs[1].uri, errs[1].offset, str(errs[1])) == \
        (errs[0].uri, errs[0].offset, str(errs[0]))


def test_pack_unpack_and_images_match_jax(tmp_path):
    img = np.random.RandomState(0).randint(0, 255, (20, 17, 3), np.uint8)
    for header, payload in [((0, 3.0, 7, 0), b"xyz"),
                            ((0, [1.0, 2.5, -1.0], 9, 2), b"payload")]:
        s = recordio.pack(recordio.IRHeader(*header), payload)
        assert s == mx.recordio.pack(mx.recordio.IRHeader(*header), payload)
        h, body = recordio.unpack(s)
        jh, jbody = mx.recordio.unpack(s)
        assert body == jbody
        np.testing.assert_array_equal(np.asarray(h.label),
                                      np.asarray(jh.label))
        assert (h.flag, h.id, h.id2) == (jh.flag, jh.id, jh.id2)
    for fmt in (".jpg", ".png"):
        s = recordio.pack_img((0, 1.0, 3, 0), img, quality=90, img_fmt=fmt)
        assert s == mx.recordio.pack_img((0, 1.0, 3, 0), img, quality=90,
                                         img_fmt=fmt)
        h, dec = recordio.unpack_img(s)
        np.testing.assert_array_equal(dec, mx.recordio.unpack_img(s)[1])


def test_im2rec_packs_what_the_port_packs(tmp_path):
    """``tools/im2rec.py`` (run as a subprocess) and the port's
    ``MXIndexedRecordIO`` + ``pack_img`` write the same .rec and .idx from
    the same images and list (JPEG at quality 95, resized to a short side
    of 24)."""
    from mxnet_tpu_torch import image_backend

    root = tmp_path / "imgs"
    os.makedirs(root)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(6):
        img = rng.randint(0, 255, (30 + i, 28, 3), np.uint8)
        with open(root / ("im%d.png" % i), "wb") as f:
            f.write(image_backend.encode_image(img, ".png"))
        lines.append("%d\t%f\tim%d.png" % (i, float(i % 3), i))
    prefix = str(tmp_path / "tool")
    with open(prefix + ".lst", "w") as f:
        f.write("\n".join(lines) + "\n")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "im2rec.py"),
                    prefix, str(root), "--resize", "24"], check=True,
                   capture_output=True, timeout=120,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    mine = str(tmp_path / "port")
    w = recordio.MXIndexedRecordIO(mine + ".idx", mine + ".rec", "w")
    for i in range(6):
        with open(root / ("im%d.png" % i), "rb") as f:
            img = image_backend.decode_image(f.read())
        h, w_ = img.shape[:2]
        nw, nh = (24, int(h * 24 / w_)) if h > w_ else (int(w_ * 24 / h), 24)
        img = image_backend.resize_image(img, nw, nh)
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 3), i, 0), img, quality=95))
    w.close()
    for ext in (".rec", ".idx"):
        with open(prefix + ext, "rb") as a, open(mine + ext, "rb") as b:
            assert a.read() == b.read(), ext


# -- native -------------------------------------------------------------------

def test_native_builds_its_own_libraries():
    """The reader and the libjpeg decoder load from the port's _build/ (the
    JAX package's libmxtpu.so is never loaded), with ABI version 2."""
    status = native.native_status()
    assert status["reader"] == "loaded", status
    assert status["decoder"] == "libjpeg", status
    build = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    for name in ("reader", "libjpeg"):
        path = native._library(name)._name
        assert os.path.dirname(path) == build and "libmxtpu" not in path
    assert native.get_lib().rio_abi_version() == 2


@pytest.mark.parametrize("writer", ["python", "native"])
@pytest.mark.parametrize("kind", ["random", "magic"])
def test_native_and_python_interoperate(tmp_path, writer, kind):
    """Records written by one side read back on the other (offset reads
    too), across the packages: the port's native writer's pack equals the
    JAX package's Python pack."""
    path = str(tmp_path / "a.rec")
    payloads = _payloads(seed=1) if kind == "random" else _magic_payloads()
    if writer == "python":
        _write(mx, path, payloads)
        r = native.NativeRecordReader(path)
        got = []
        while True:
            s = r.read()
            if s is None:
                break
            got.append(s)
        r.close()
        assert got == payloads
        return
    w = native.NativeRecordWriter(path)
    offsets = [w.write(p) for p in payloads]
    w.close()
    assert _read_all(mx, path) == payloads
    ref = str(tmp_path / "ref.rec")
    _write(mt, ref, payloads)
    assert open(ref, "rb").read() == open(path, "rb").read()
    nr = native.NativeRecordReader(path)
    assert nr.read_at(offsets[3]) == payloads[3]
    assert nr.read_at(offsets[0]) == payloads[0]
    nr.reset()
    assert nr.read() == payloads[0]
    nr.close()


def test_native_prefetch_keeps_order(tmp_path):
    path = str(tmp_path / "c.rec")
    payloads = _payloads(n=200, seed=2)
    _write(mt, path, payloads)
    pf = native.NativePrefetchReader(path, capacity=4)
    try:
        assert list(pf) == payloads
    finally:
        pf.close()


def test_native_corrupt_stream_raises(tmp_path):
    path = str(tmp_path / "e.rec")
    with open(path, "wb") as f:
        f.write(b"\x00" * 32)
    r = native.NativeRecordReader(path)
    with pytest.raises(IOError):
        r.read()
    r.close()


def test_use_native_0_falls_back(monkeypatch):
    """``MXNET_USE_NATIVE=0`` (read at first use) leaves every library
    unloaded with the reason, and the decoder route None; fresh loader
    state both ways."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_ERRORS", {})
    monkeypatch.setenv("MXNET_USE_NATIVE", "0")
    assert native.get_lib() is None and not native.have_native()
    assert native.decode_jpeg_batch([b"x"]) == [None]
    status = native.native_status()
    assert status["decoder"] is None
    assert "MXNET_USE_NATIVE=0" in status["reader"]
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.delenv("MXNET_USE_NATIVE")
    assert native.get_lib() is not None


def test_decode_jpeg_batch_matches_the_jax_package():
    """The same libjpeg source decodes the same JPEGs to the same pixels in
    both packages; a PNG or garbage comes back None (the caller's PIL
    path)."""
    from mxnet_tpu_torch import image_backend

    rng = np.random.RandomState(4)
    bufs = [image_backend.encode_image(
        rng.randint(0, 255, (16 + i, 20 + 2 * i, 3), np.uint8), ".jpg", 90)
        for i in range(5)]
    bufs += [image_backend.encode_image(
        rng.randint(0, 255, (8, 8, 3), np.uint8), ".png"), b"not a jpeg"]
    ours = native.decode_jpeg_batch(bufs, nthreads=3)
    theirs = jnative.decode_jpeg_batch(bufs, nthreads=3)
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert ours[-1] is None and ours[-2] is None
