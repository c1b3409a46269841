"""RecordIO container format — counterpart of ``mxnet_tpu/recordio.py``:
readers and writers byte-compatible with the JAX package, with
``tools/im2rec.py`` and with the reference (dmlc-core recordio and
python/mxnet/recordio.py), so each package reads the other's packs.

Format (dmlc/recordio.h): each record = kMagic uint32 (0xced7230a) +
lrecord uint32 (upper 3 bits = continue-flag, lower 29 = length) + payload
+ padding to a 4-byte boundary; a payload that holds the magic word at a
4-byte-aligned offset is split there into parts (flags 1 = first, 2 =
middle, 3 = last).  IRHeader packs (flag, label, id, id2) ahead of image
payloads.  Every open goes through ``filesystem.open_uri``.
"""
from __future__ import annotations

import numbers
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "RecordIOCorruptError"]

_KMAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _KMAGIC)
_LFLAG_BITS = 29
_LENGTH_MASK = (1 << _LFLAG_BITS) - 1


class RecordIOCorruptError(IOError):
    """A RecordIO stream is damaged at ``offset`` (truncated trailing
    record from an interrupted writer, bad magic, torn multi-part chain).
    Subclasses IOError, so pre-existing ``except IOError`` handlers keep
    working; the offset lets tooling truncate-and-salvage the prefix."""

    def __init__(self, message, uri, offset):
        super().__init__("%s in %s at byte offset %d"
                         % (message, uri, offset))
        self.uri = uri
        self.offset = offset


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference recordio.py MXRecordIO,
    backed by dmlc::RecordIOWriter/Reader)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.open()

    def open(self):
        from .filesystem import open_uri

        if self.flag == "w":
            self.handle = open_uri(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open_uri(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        self.handle.seek(pos)

    def _write_part(self, cflag, part):
        self.handle.write(struct.pack(
            "<II", _KMAGIC, (cflag << _LFLAG_BITS) | len(part)))
        self.handle.write(part)
        pad = (4 - (len(part) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def write(self, buf):
        """Write one logical record.  dmlc-core multi-part framing: if the
        payload contains the magic word at a 4-byte-aligned offset, split
        there (the magic itself is consumed as the part separator and
        restored on read) with continue-flags 1=first / 2=middle / 3=last."""
        assert self.writable
        if isinstance(buf, str):
            buf = buf.encode("utf-8")
        if len(buf) > _LENGTH_MASK:
            raise ValueError("record too large for RecordIO format")
        # C-speed scan for aligned magic occurrences (bytes.find, not a
        # per-offset Python loop — payloads are ~100KB JPEGs)
        splits = []
        pos = buf.find(_MAGIC_BYTES)
        while pos != -1:
            if pos % 4 == 0:
                splits.append(pos)
                pos = buf.find(_MAGIC_BYTES, pos + 4)
            else:
                pos = buf.find(_MAGIC_BYTES, pos + 1)
        if not splits:
            self._write_part(0, buf)
            return
        begin = 0
        for n, i in enumerate(splits):
            self._write_part(1 if n == 0 else 2, buf[begin:i])
            begin = i + 4
        self._write_part(3, buf[begin:])

    def read(self):
        """Read one logical record, reassembling multi-part continuations
        (continue-flag 1/2/3) with the separator magic restored between
        parts — interchangeable with dmlc-core packs."""
        assert not self.writable
        out = b""
        expect_more = False
        while True:
            rec_off = self.handle.tell()
            head = self.handle.read(8)
            if len(head) < 8:
                if expect_more:
                    raise RecordIOCorruptError(
                        "truncated multi-part record", self.uri, rec_off)
                if head:
                    # a partial header at EOF is a torn trailing record
                    # (writer died mid-append), not a clean end-of-stream —
                    # surface it instead of silently dropping data
                    raise RecordIOCorruptError(
                        "truncated trailing record header (%d of 8 bytes)"
                        % len(head), self.uri, rec_off)
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _KMAGIC:
                raise RecordIOCorruptError(
                    "invalid RecordIO magic %#x" % magic, self.uri, rec_off)
            length = lrec & _LENGTH_MASK
            cflag = lrec >> _LFLAG_BITS
            buf = self.handle.read(length)
            if len(buf) < length:
                raise RecordIOCorruptError(
                    "truncated record payload (%d of %d bytes)"
                    % (len(buf), length), self.uri, rec_off)
            pad = (4 - (length % 4)) % 4
            if pad:
                self.handle.read(pad)
            if cflag in (2, 3):
                if not expect_more:
                    raise RecordIOCorruptError(
                        "unexpected continuation record", self.uri, rec_off)
                out += _MAGIC_BYTES + buf
            else:
                if expect_more:
                    raise RecordIOCorruptError(
                        "unterminated multi-part record", self.uri, rec_off)
                out = buf
            if cflag in (0, 3):
                return out
            expect_more = True


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with a sidecar .idx of "key\\tposition" lines
    (reference recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        from .filesystem import open_uri

        super().open()
        self.idx = {}
        self.keys = []
        try:
            if self.writable:
                self.fidx = open_uri(self.idx_path, "w")
            else:
                self.fidx = open_uri(self.idx_path, "r")
                for line in iter(self.fidx.readline, ""):
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        except Exception:
            # a missing/broken sidecar .idx must not leak the record
            # handle opened above (ImageIter's remote-URI fallback probes
            # this path once per construction)
            if self.fidx is not None:
                try:
                    self.fidx.close()
                finally:
                    self.fidx = None
            super().close()
            raise

    def close(self):
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def seek(self, idx):
        assert not self.writable
        pos = self.idx[idx]
        self.handle.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload into one record string (reference
    recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                    header.id2) + s
    return s


def unpack(s):
    """Unpack a record into (IRHeader, payload) (reference recordio.py
    unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array (HWC uint8) into a record (reference recordio.py
    pack_img; PIL replaces OpenCV)."""
    from .image_backend import encode_image

    buf = encode_image(np.asarray(img, dtype=np.uint8), img_fmt, quality)
    return pack(header, buf)


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, image array) (reference recordio.py
    unpack_img)."""
    from .image_backend import decode_image

    header, s = unpack(s)
    channels = 3 if iscolor != 0 else 1
    img = decode_image(s, channels)
    return header, img
