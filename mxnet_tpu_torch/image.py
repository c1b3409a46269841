"""mx.image — the host image pipeline, counterpart of ``mxnet_tpu/image.py``
(reference: python/mxnet/image.py, backed there by the OpenCV imperative
ops ``_cvimdecode``/``_cvimresize`` from src/io/image_io.cc:269-291).

Decoding and augmentation run on host CPU threads over numpy HWC
uint8/float32 (``image_backend``; batches of JPEGs through the native
decoder, ``native.decode_jpeg_batch``); batches are float32 NCHW host
arrays until the executor copies them to its device, as ``NDArrayIter``'s
are.  Randomness is drawn where the JAX package draws it (Python's
``random`` and ``np.random``), so seeding both gives both packages the same
batches.  The functions and augmenters keep the type they are given: an
NDArray in gives an NDArray on its context out, numpy in gives numpy out.
The four image ops (``_cvimdecode``, ``_cvimresize``, ``_cvcopyMakeBorder``,
``_imdecode``) run eagerly on the host and put their result on the op's
context; their output shape depends on the data, so they raise
``MXNetError`` on ``meta`` tensors (shape inference of a symbol).
"""
from __future__ import annotations

import logging
import os
import random as pyrandom
from typing import List, Optional, Sequence

import numpy as np

from . import image_backend, io as mxio, native, ndarray as nd, recordio
from .base import MXNetError
from .context import cpu

__all__ = [
    "imdecode", "imresize", "scale_down", "resize_short", "fixed_crop",
    "random_crop", "center_crop", "random_size_crop", "color_normalize",
    "ResizeAug", "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
    "CenterCropAug", "RandomOrderAug", "BrightnessJitterAug",
    "ContrastJitterAug", "SaturationJitterAug", "LightingAug",
    "ColorNormalizeAug", "HorizontalFlipAug", "CastAug", "CreateAugmenter",
    "ImageIter", "ImageRecordIter",
]


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode an image buffer to an HWC uint8 NDArray (reference
    image.py imdecode → _cvimdecode)."""
    arr = image_backend.decode_image(buf, channels=3 if flag else 1)
    if not to_rgb:
        arr = arr[:, :, ::-1]
    return nd.array(arr, dtype=np.uint8)


def imresize(src, w, h, interp=1):
    arr = src.asnumpy() if isinstance(src, nd.NDArray) else np.asarray(src)
    out = image_backend.resize_image(arr, w, h, interp)
    ctx = src.context if isinstance(src, nd.NDArray) else None
    return nd.array(out, ctx, dtype=out.dtype)


def _as_np(img):
    return img.asnumpy() if isinstance(img, nd.NDArray) else np.asarray(img)


def _like(src, arr):
    """Type-preserving wrap: NDArray in -> NDArray out on its context
    (reference API parity); numpy in -> numpy out (the iterators' fast path
    — no per-image device round trip through the eager array layer)."""
    if isinstance(src, nd.NDArray):
        return nd.array(arr, src.context, dtype=arr.dtype)
    return arr


def scale_down(src_size, size):
    """Scale (w, h) down to fit in src_size, preserving aspect."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)

def resize_short(src, size, interp=1):
    """Resize so the shorter edge equals ``size``."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    out = image_backend.resize_image(arr, new_w, new_h, interp)
    return _like(src, out)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    arr = _as_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        arr = image_backend.resize_image(arr, size[0], size[1], interp)
    return _like(src, arr)


def random_crop(src, size, interp=1):
    arr = _as_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=1):
    arr = _as_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area=0.08, ratio=(3.0 / 4.0, 4.0 / 3.0),
                     interp=1):
    """Random crop with area and aspect-ratio jitter (Inception-style)."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = pyrandom.uniform(min_area, 1.0) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    arr = _as_np(src).astype(np.float32)
    arr = arr - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return _like(src, arr.astype(np.float32))


class _NpSafeAugList(list):
    """Marker: every augmenter in this list is type-preserving (numpy in ->
    numpy out), so iterators may run the chain GIL-cheaply on raw numpy.
    User-supplied aug_list values keep the reference NDArray contract."""


# -- augmenter callables (reference image.py returns lists of closures) -----

def ResizeAug(size, interp=1):
    def aug(src):
        return [resize_short(src, size, interp)]
    return aug


def ForceResizeAug(size, interp=1):
    def aug(src):
        arr = _as_np(src)
        return [_like(src, image_backend.resize_image(
            arr.astype(np.uint8), size[0], size[1], interp))]
    return aug


def RandomCropAug(size, interp=1):
    def aug(src):
        return [random_crop(src, size, interp)[0]]
    return aug


def RandomSizedCropAug(size, min_area=0.08, ratio=(3 / 4, 4 / 3), interp=1):
    def aug(src):
        return [random_size_crop(src, size, min_area, ratio, interp)[0]]
    return aug


def CenterCropAug(size, interp=1):
    def aug(src):
        return [center_crop(src, size, interp)[0]]
    return aug


def RandomOrderAug(ts):
    def aug(src):
        srcs = [src]
        ts_shuffled = list(ts)
        pyrandom.shuffle(ts_shuffled)
        for t in ts_shuffled:
            srcs = [j for i in srcs for j in t(i)]
        return srcs
    return aug


def BrightnessJitterAug(brightness):
    def aug(src):
        alpha = 1.0 + pyrandom.uniform(-brightness, brightness)
        return [_like(src, _as_np(src).astype(np.float32) * alpha)]
    return aug


def ContrastJitterAug(contrast):
    coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def aug(src):
        alpha = 1.0 + pyrandom.uniform(-contrast, contrast)
        arr = _as_np(src).astype(np.float32)
        gray = (arr * coef).sum() * (3.0 / arr.size) * (1.0 - alpha)
        return [_like(src, arr * alpha + gray)]
    return aug


def SaturationJitterAug(saturation):
    coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def aug(src):
        alpha = 1.0 + pyrandom.uniform(-saturation, saturation)
        arr = _as_np(src).astype(np.float32)
        gray = (arr * coef).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return [_like(src, arr * alpha + gray)]
    return aug


def LightingAug(alphastd, eigval, eigvec):
    """AlexNet-style PCA color noise."""
    def aug(src):
        alpha = np.random.normal(0, alphastd, size=(3,))
        rgb = np.dot(np.asarray(eigvec) * alpha, np.asarray(eigval))
        return [_like(src, _as_np(src).astype(np.float32) + rgb)]
    return aug


def ColorNormalizeAug(mean, std):
    def aug(src):
        return [color_normalize(src, mean, std)]
    return aug


def HorizontalFlipAug(p):
    def aug(src):
        if pyrandom.random() < p:
            return [_like(src, _as_np(src)[:, ::-1].copy())]
        return [src]
    return aug


def CastAug():
    def aug(src):
        return [_like(src, _as_np(src).astype(np.float32))]
    return aug


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Standard augmenter chain (reference image.py CreateAugmenter), as
    an ``_NpSafeAugList``: every augmenter in it keeps numpy as numpy, so
    the iterators run it numpy to numpy.  The JAX package returns a plain
    list here, and its iterators then round-trip each image through the
    array layer at every augmenter, to the same values."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.3, (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        ts = []
        if brightness:
            ts.append(BrightnessJitterAug(brightness))
        if contrast:
            ts.append(ContrastJitterAug(contrast))
        if saturation:
            ts.append(SaturationJitterAug(saturation))
        auglist.append(RandomOrderAug(ts))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return _NpSafeAugList(auglist)


class ImageIter(mxio.DataIter):
    """Image iterator with pluggable augmenters, reading RecordIO packs
    (``path_imgrec``) or an image list + root dir (``path_imglist`` /
    ``imglist``). Reference: python/mxnet/image.py ImageIter; rank sharding
    via part_index/num_parts matches the reference's kv.rank split
    (src/io/iter_image_recordio.cc InputSplit usage)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 last_batch_handle="pad", **kwargs):
        super(ImageIter, self).__init__()
        assert path_imgrec or path_imglist or imglist is not None, \
            "must supply path_imgrec, path_imglist or imglist"
        assert len(data_shape) == 3 and data_shape[0] == 3
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        self.record = None
        self.imglist = None
        self._native_reader = None
        self._native_prefetch = None
        self._rec_path = path_imgrec
        if path_imgrec:
            from .filesystem import local_path

            idx_path = kwargs.get("path_imgidx",
                                  os.path.splitext(path_imgrec)[0] + ".idx")
            lp = local_path(idx_path)
            # local: cheap existence check; remote: attempt the indexed
            # open and fall back only on not-found (auth/transport
            # errors stay LOUD, and an explicitly passed path_imgidx is
            # never silently discarded)
            if lp is None or os.path.exists(lp):
                try:
                    self.record = recordio.MXIndexedRecordIO(
                        idx_path, path_imgrec, "r")
                except (FileNotFoundError, KeyError, IsADirectoryError):
                    if "path_imgidx" in kwargs:
                        raise
                    self.record = None
            if self.record is not None:
                self.seq = list(self.record.keys)
            else:
                self.record = recordio.MXRecordIO(path_imgrec, "r")
                if shuffle or num_parts > 1:
                    # no sidecar .idx: build an in-memory offset index with
                    # one sequential scan so shuffle/sharding still work
                    # (the C++ reference shuffles chunk-wise without one)
                    self._offsets = []
                    while True:
                        pos = self.record.tell()
                        if self.record.read() is None:
                            break
                        self._offsets.append(pos)
                    self.record.reset()
                    self.seq = list(range(len(self._offsets)))
                else:
                    self.seq = None
        else:
            if path_imglist:
                entries = []
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = np.array(parts[1:-1], np.float32)
                        entries.append((parts[-1], label))
                self.imglist = entries
            else:
                self.imglist = [
                    (item[-1], np.array(item[:-1], np.float32).reshape(-1))
                    if not isinstance(item, str) else (item, np.zeros(1))
                    for item in imglist]
            self.path_root = path_root or "."
            self.seq = list(range(len(self.imglist)))
        if self.seq is not None and num_parts > 1:
            # rank sharding: contiguous split like dmlc InputSplit, with the
            # remainder spread over the first parts (no sample dropped)
            n, rem = divmod(len(self.seq), num_parts)
            start = part_index * n + min(part_index, rem)
            stop = start + n + (1 if part_index < rem else 0)
            self.seq = self.seq[start:stop]
        self.shuffle = shuffle
        if last_batch_handle not in ("pad", "discard"):
            raise ValueError("last_batch_handle must be 'pad' or 'discard', "
                             "got %r" % (last_batch_handle,))
        self.last_batch_handle = last_batch_handle
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape)
        self.auglist = aug_list
        self.cur = 0
        self._provide_data = [mxio.DataDesc(data_name,
                                            (batch_size,) + self.data_shape)]
        label_shape = (batch_size,) if label_width == 1 else \
            (batch_size, label_width)
        self._provide_label = [mxio.DataDesc(label_name, label_shape)]
        self.reset()

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def reset(self):
        from .filesystem import scheme_of

        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        # the C++ fast path mmap/reads a local file; registered remote
        # schemes (mx.filesystem) stay on the Python handle, which
        # already resolved through the registry
        native_ok = native.have_native() and \
            scheme_of(self._rec_path or "") == ""
        if self.record is not None and self.seq is None:
            if native_ok:
                # C++ readahead thread (src/recordio.cc prefetcher) for the
                # sequential scan; Python handle untouched
                if self._native_prefetch is not None:
                    self._native_prefetch.close()
                    self._native_prefetch = None
                self._native_prefetch = native.NativePrefetchReader(
                    self._rec_path)
            else:
                self.record.reset()
        elif self.record is not None and native_ok and \
                self._native_reader is None:
            self._native_reader = native.NativeRecordReader(self._rec_path)
        self.cur = 0

    def close(self):
        """Close the record handles and the native readers (a later
        ``reset()`` reopens the native ones)."""
        for name in ("_native_prefetch", "_native_reader"):
            reader = getattr(self, name)
            if reader is not None:
                reader.close()
                setattr(self, name, None)
        if self.record is not None:
            self.record.close()

    def next_sample(self):
        """One (label, encoded image bytes) pair — decode is deferred so
        subclasses can parallelize it (the reference's OMP decode threads,
        iter_image_recordio.cc:140-160)."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.record is not None:
                if getattr(self, "_offsets", None) is not None:
                    pos = self._offsets[idx]
                elif self._native_reader is not None:
                    pos = self.record.idx[idx]
                else:
                    pos = None
                if self._native_reader is not None and pos is not None:
                    s = self._native_reader.read_at(pos)
                elif pos is not None:
                    self.record.seek(pos)
                    s = self.record.read()
                else:
                    s = self.record.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            fname, label = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as fin:
                img = fin.read()
            return label, img
        if self._native_prefetch is not None:
            s = next(self._native_prefetch)
        else:
            s = self.record.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _augment_arr(self, arr):
        """Run the augmenter chain → HWC float32.  Built-in chains
        (_NpSafeAugList) run numpy-to-numpy — no per-image device array;
        user-supplied aug_lists get the reference NDArray contract."""
        a = arr
        if not isinstance(self.auglist, _NpSafeAugList) and \
                not isinstance(a, nd.NDArray):
            a = nd.array(a, cpu())
        for aug in self.auglist:
            a = aug(a)[0]
        return _as_np(a).astype(np.float32)

    def _decode_augment(self, buf):
        """Decode one sample and run the augmenter chain."""
        return self._augment_arr(image_backend.decode_image(buf))

    def _collect_raw(self):
        """Read up to batch_size raw samples; StopIteration if exhausted."""
        samples = []
        try:
            while len(samples) < self.batch_size:
                samples.append(self.next_sample())
        except StopIteration:
            if not samples:
                raise
        return samples

    def _decode_batch(self, samples):
        return [self._decode_augment(buf) for _, buf in samples]

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width), np.float32)
        samples = self._collect_raw()
        decoded = self._decode_batch(samples)
        i = 0
        for (label, _), data in zip(samples, decoded):
            if data.shape[:2] != (h, w):
                if not getattr(self, "_warned_shape", False):
                    logging.warning(
                        "ImageIter: dropping sample with post-augment shape "
                        "%s != %s — add a crop/ForceResize augmenter",
                        data.shape, (h, w))
                    self._warned_shape = True
                continue
            batch_data[i] = data
            lab = np.asarray(label, np.float32).reshape(-1)
            batch_label[i] = lab[:self.label_width]
            i += 1
        if i == 0 or (i < self.batch_size and
                      self.last_batch_handle == "discard"):
            raise StopIteration
        # pad the final partial batch by repeating the last sample
        for j in range(i, self.batch_size):
            batch_data[j] = batch_data[i - 1]
            batch_label[j] = batch_label[i - 1]
        data_nchw = np.transpose(batch_data, (0, 3, 1, 2))
        label_out = batch_label[:, 0] if self.label_width == 1 else batch_label
        return mxio.DataBatch(data=[nd.array(data_nchw, cpu())],
                              label=[nd.array(label_out, cpu())],
                              pad=self.batch_size - i)


class _ParallelImageIter(ImageIter):
    """ImageIter with parallel decode — JPEGs go through the native libjpeg
    thread pool (GIL-free, src/imgdecode.cc; the analogue of the reference's
    preprocess_threads OMP decode, iter_image_recordio.cc:140-160), other
    formats through PIL on Python threads.  Augmenters run on a thread pool
    either way."""

    def __init__(self, *args, preprocess_threads=4, **kwargs):
        from concurrent.futures import ThreadPoolExecutor

        super(_ParallelImageIter, self).__init__(*args, **kwargs)
        self._nthreads = max(1, preprocess_threads)
        self._pool = ThreadPoolExecutor(max_workers=self._nthreads)

    def close(self):
        """Stop the decode threads and close the readers."""
        self._pool.shutdown(wait=True)
        super(_ParallelImageIter, self).close()

    def _decode_batch(self, samples):
        bufs = [buf for _, buf in samples]
        decoded = native.decode_jpeg_batch(bufs, nthreads=self._nthreads) \
            if native.have_native() else [None] * len(bufs)

        def finish(pair):
            arr, buf = pair
            if arr is None:  # non-JPEG or native unavailable: PIL path
                return self._decode_augment(buf)
            return self._augment_arr(arr)

        return list(self._pool.map(finish, zip(decoded, bufs)))


def ImageRecordIter(path_imgrec, data_shape, batch_size, label_width=1,
                    shuffle=False, rand_crop=False, rand_mirror=False,
                    mean_r=0.0, mean_g=0.0, mean_b=0.0,
                    std_r=1.0, std_g=1.0, std_b=1.0, resize=0,
                    part_index=0, num_parts=1, preprocess_threads=4,
                    prefetch_buffer=1, data_name="data",
                    label_name="softmax_label", **kwargs):
    """RecordIO image iterator: threaded decode + augment + prefetch + rank
    sharding (reference: the C++ ImageRecordIter chain
    parser→augmenter→normalize→batch→prefetch, src/io/io.cc:9-23). Returns
    a DataIter yielding NCHW float32 batches."""
    mean = None
    std = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = np.array([std_r, std_g, std_b], np.float32)
    aug_list = CreateAugmenter(data_shape, resize=resize, rand_crop=rand_crop,
                               rand_mirror=rand_mirror, mean=mean, std=std)
    inner = _ParallelImageIter(
        batch_size, data_shape, label_width=label_width,
        path_imgrec=path_imgrec, shuffle=shuffle, part_index=part_index,
        num_parts=num_parts, aug_list=aug_list, data_name=data_name,
        label_name=label_name, preprocess_threads=preprocess_threads,
        **kwargs)
    if prefetch_buffer:
        return mxio.PrefetchingIter(inner)
    return inner


# ---------------------------------------------------------------------------
# Detection pipeline — box-aware augmenters + ImageDetIter/ImageDetRecordIter
# (reference: src/io/iter_image_det_recordio.cc:475-563 + the det augmenter
# src/io/image_det_aug_default.cc).  Record label layout follows the dmlc
# detection pack: [A, B, extra..., (B fields per object)*] where A is the
# header width (>=2), B the per-object width (>=5: id, xmin, ymin, xmax,
# ymax in [0,1] normalized coordinates).
# ---------------------------------------------------------------------------


def _det_parse_label(raw):
    """Flat record label -> (N, B) object array (normalized coords)."""
    raw = np.asarray(raw, np.float32).reshape(-1)
    if raw.size < 2:
        raise ValueError("detection label too short: %r" % (raw,))
    a, b = int(raw[0]), int(raw[1])
    if a < 2 or b < 5:
        raise ValueError(
            "bad detection header A=%d B=%d (need A>=2, B>=5)" % (a, b))
    body = raw[a:]
    n = body.size // b
    return body[:n * b].reshape(n, b).copy()


def _det_encode_label(objects, header_width=2):
    """(N, B) objects -> flat record label (inverse of _det_parse_label)."""
    objects = np.asarray(objects, np.float32)
    b = objects.shape[1] if objects.ndim == 2 else 5
    head = np.zeros(header_width, np.float32)
    head[0], head[1] = header_width, b
    return np.concatenate([head, objects.reshape(-1)])


def DetHorizontalFlipAug(p):
    """Mirror image AND boxes: x' = 1 - x (reference
    image_det_aug_default.cc horizontal flip)."""
    def aug(src, label):
        if pyrandom.random() < p:
            src = _as_np(src)[:, ::-1, :]
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label
    return aug


def DetRandomCropAug(min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                     area_range=(0.3, 1.0), max_attempts=20):
    """Sample a crop keeping objects whose centers stay inside; coordinates
    are clipped and re-normalized to the crop (reference det crop sampler,
    image_det_aug_default.cc crop logic)."""
    def aug(src, label):
        img = _as_np(src)
        h, w = img.shape[:2]
        for _ in range(max_attempts):
            area = pyrandom.uniform(*area_range) * h * w
            ratio = pyrandom.uniform(*aspect_ratio_range)
            cw = int(round(np.sqrt(area * ratio)))
            ch = int(round(np.sqrt(area / ratio)))
            if cw > w or ch > h or cw < 1 or ch < 1:
                continue
            x0 = pyrandom.randint(0, w - cw)
            y0 = pyrandom.randint(0, h - ch)
            nx0, ny0 = x0 / w, y0 / h
            nx1, ny1 = (x0 + cw) / w, (y0 + ch) / h
            cx = (label[:, 1] + label[:, 3]) / 2
            cy = (label[:, 2] + label[:, 4]) / 2
            keep = (cx >= nx0) & (cx < nx1) & (cy >= ny0) & (cy < ny1)
            if not keep.any():
                continue
            kept = label[keep].copy()
            # clip to the crop, re-normalize
            kept[:, 1] = np.clip((kept[:, 1] - nx0) / (nx1 - nx0), 0, 1)
            kept[:, 3] = np.clip((kept[:, 3] - nx0) / (nx1 - nx0), 0, 1)
            kept[:, 2] = np.clip((kept[:, 2] - ny0) / (ny1 - ny0), 0, 1)
            kept[:, 4] = np.clip((kept[:, 4] - ny0) / (ny1 - ny0), 0, 1)
            # min_object_covered: kept boxes must retain enough area
            ow = np.maximum(kept[:, 3] - kept[:, 1], 0) * (nx1 - nx0)
            oh = np.maximum(kept[:, 4] - kept[:, 2], 0) * (ny1 - ny0)
            orig_w = np.maximum(label[keep, 3] - label[keep, 1], 1e-8)
            orig_h = np.maximum(label[keep, 4] - label[keep, 2], 1e-8)
            cov = (ow * oh) / (orig_w * orig_h)
            if (cov >= min_object_covered).all():
                return img[y0:y0 + ch, x0:x0 + cw, :], kept
        return img, label
    return aug


def DetForceResizeAug(size, interp=1):
    """Resize to exact (w, h); normalized box coords are scale-invariant."""
    def aug(src, label):
        return image_backend.resize_image(_as_np(src), size[0], size[1],
                                          interp), label
    return aug


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_mirror=False,
                       mean=None, std=None, min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 1.0), max_attempts=20):
    """Standard detection augmenter chain (reference
    image_det_aug_default.cc defaults): [crop] -> resize -> [flip] ->
    normalize."""
    augs = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                area_range, max_attempts)
        p = float(rand_crop)

        def maybe_crop(src, label, _crop=crop, _p=p):
            if pyrandom.random() < _p:
                return _crop(src, label)
            return _as_np(src), label
        augs.append(maybe_crop)
    augs.append(DetForceResizeAug((data_shape[2], data_shape[1])))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    if mean is not None or std is not None:
        mean = np.zeros(3, np.float32) if mean is None else mean
        std = np.ones(3, np.float32) if std is None else std

        def normalize(src, label, _m=mean, _s=std):
            return (_as_np(src).astype(np.float32) - _m) / _s, label
        augs.append(normalize)
    return _NpSafeAugList(augs)


class ImageDetIter(ImageIter):
    """Detection iterator: variable-object records -> fixed (batch,
    label_pad_width, object_width) labels padded with -1 (the shape
    MultiBoxTarget consumes).  Reference:
    src/io/iter_image_det_recordio.cc:475-563."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 label_pad_width=8, object_width=5, aug_list=None,
                 data_name="data", label_name="label", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        self.label_pad_width = label_pad_width
        self.object_width = object_width
        super(ImageDetIter, self).__init__(
            batch_size, data_shape, label_width=1, path_imgrec=path_imgrec,
            aug_list=aug_list, data_name=data_name, label_name=label_name,
            **kwargs)
        self._provide_label = [mxio.DataDesc(
            label_name, (batch_size, label_pad_width, object_width))]

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, h, w, c), np.float32)
        batch_label = np.full(
            (self.batch_size, self.label_pad_width, self.object_width),
            -1.0, np.float32)
        samples = self._collect_raw()
        i = 0
        for raw_label, buf in samples:
            objects = _det_parse_label(raw_label)
            img = image_backend.decode_image(buf)
            for aug in self.auglist:
                img, objects = aug(img, objects)
            img = np.asarray(img, np.float32)
            if img.shape[:2] != (h, w):
                continue
            if len(objects) > self.label_pad_width:
                raise MXNetError(
                    "record has %d objects but label_pad_width=%d — raise "
                    "label_pad_width to at least the dataset maximum"
                    % (len(objects), self.label_pad_width))
            n = len(objects)
            batch_data[i] = img
            if n:
                batch_label[i, :n] = objects[:n, :self.object_width]
            i += 1
        if i == 0 or (i < self.batch_size and
                      self.last_batch_handle == "discard"):
            raise StopIteration
        for j in range(i, self.batch_size):
            batch_data[j] = batch_data[i - 1]
            batch_label[j] = batch_label[i - 1]
        data_nchw = np.transpose(batch_data, (0, 3, 1, 2))
        return mxio.DataBatch(data=[nd.array(data_nchw, cpu())],
                              label=[nd.array(batch_label, cpu())],
                              pad=self.batch_size - i)


def ImageDetRecordIter(path_imgrec, data_shape, batch_size,
                       label_pad_width=8, object_width=5, shuffle=False,
                       rand_crop=0.0, rand_mirror=False,
                       min_object_covered=0.3, max_attempts=20,
                       area_range=(0.3, 1.0),
                       mean_r=0.0, mean_g=0.0, mean_b=0.0,
                       std_r=1.0, std_g=1.0, std_b=1.0,
                       part_index=0, num_parts=1, prefetch_buffer=1,
                       data_name="data", label_name="label", **kwargs):
    """Detection RecordIO iterator (reference ImageDetRecordIter,
    src/io/iter_image_det_recordio.cc:563 registration): consumes
    ``tools/im2rec.py``-packed detection records (vector labels), applies
    box-aware augmentation, yields (data NCHW, label (B, pad, width))."""
    mean = None
    std = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
    if (std_r, std_g, std_b) != (1.0, 1.0, 1.0):
        std = np.array([std_r, std_g, std_b], np.float32)
    aug_list = CreateDetAugmenter(
        data_shape, rand_crop=rand_crop, rand_mirror=rand_mirror,
        mean=mean, std=std, min_object_covered=min_object_covered,
        area_range=area_range, max_attempts=max_attempts)
    inner = ImageDetIter(
        batch_size, data_shape, path_imgrec=path_imgrec,
        label_pad_width=label_pad_width, object_width=object_width,
        shuffle=shuffle, part_index=part_index, num_parts=num_parts,
        aug_list=aug_list, data_name=data_name, label_name=label_name,
        **kwargs)
    if prefetch_buffer:
        return mxio.PrefetchingIter(inner)
    return inner


# -- imperative decode/resize ops (reference src/io/image_io.cc:269-291:
# _cvimdecode/_cvimresize/_cvcopyMakeBorder backing mx.image) — host-side,
# eager-only: the output shape depends on the data
def _host(opname, t):
    """The op's input as a host numpy array; on ``meta`` (shape inference
    of a symbol) the op cannot run."""
    if t.device.type == "meta":
        raise MXNetError(
            "%s runs only eagerly (nd.%s): its output shape depends on the "
            "data, so it has no symbolic shape inference" % (opname, opname))
    return t.detach().cpu().numpy()


def _on(arr, like):
    import torch

    return torch.tensor(np.ascontiguousarray(arr), device=like.device)


def _register_image_ops():
    from .ops.param import Param
    from .ops.registry import register as reg_op

    @reg_op("_cvimdecode", inputs=("buf",),
            params={"flag": Param(int, default=1),
                    "to_rgb": Param(bool, default=True)},
            hint="cvimdecode")
    def _cvimdecode(opctx, attrs, buf):
        arr = image_backend.decode_image(
            _host("_cvimdecode", buf).tobytes(),
            channels=3 if attrs["flag"] else 1)
        if not attrs["to_rgb"]:
            arr = arr[:, :, ::-1]
        return _on(arr, buf)

    @reg_op("_cvimresize", inputs=("data",),
            params={"w": Param(int, required=True),
                    "h": Param(int, required=True),
                    "interp": Param(int, default=1)},
            infer_shape=lambda attrs, s: (
                s, [(attrs["h"], attrs["w"], s[0][2])] if s[0] else [None], []),
            hint="cvimresize")
    def _cvimresize(opctx, attrs, data):
        arr = image_backend.resize_image(
            _host("_cvimresize", data).astype(np.uint8), attrs["w"],
            attrs["h"], attrs["interp"])
        return _on(arr, data)

    @reg_op("_cvcopyMakeBorder", inputs=("data",),
            params={"top": Param(int, required=True),
                    "bot": Param(int, required=True),
                    "left": Param(int, required=True),
                    "right": Param(int, required=True),
                    "type": Param(int, default=0),
                    "values": Param("float-shape", default=(0.0,))},
            hint="cvcopymakeborder")
    def _cvcopyMakeBorder(opctx, attrs, data):
        arr = _host("_cvcopyMakeBorder", data)
        val = attrs["values"][0] if attrs["values"] else 0.0
        out = np.pad(arr, ((attrs["top"], attrs["bot"]),
                           (attrs["left"], attrs["right"]), (0, 0)),
                     constant_values=val)
        return _on(out, data)

    @reg_op("_imdecode", inputs=("mean", "str_img"),
            params={"index": Param(int, default=0),
                    "x0": Param(int, default=0), "y0": Param(int, default=0),
                    "x1": Param(int, default=0), "y1": Param(int, default=0),
                    "c": Param(int, default=3), "size": Param(int, default=0)},
            hint="imdecode_fun")
    def _imdecode_fun(opctx, attrs, mean, str_img):
        """Registered NDArray function ``_imdecode`` (reference
        src/ndarray/ndarray.cc registered fun ``_imdecode``): decode image
        ``index`` (of byte length ``size``) from a packed uint8 buffer,
        optional crop box, CHW float32 output with an optional CHW mean
        subtracted — the reference's layout contract."""
        buf = _host("_imdecode", str_img).tobytes()
        size = attrs["size"]
        if size > 0:
            buf = buf[attrs["index"] * size:(attrs["index"] + 1) * size]
        arr = image_backend.decode_image(buf, channels=attrs["c"])
        if arr.ndim == 2:
            arr = arr[:, :, None]
        x0, y0, x1, y1 = (attrs[k] for k in ("x0", "y0", "x1", "y1"))
        if x1 > x0 and y1 > y0:
            arr = arr[y0:y1, x0:x1]
        out = np.transpose(arr.astype(np.float32), (2, 0, 1))  # CHW
        m = _host("_imdecode", mean).astype(np.float32)
        # empty mean or scalar 0 means "no subtraction" (ndarray.cc:876-879)
        if m.size and (m.ndim >= 2 or m.size > 1
                       or float(m.reshape(-1)[0]) != 0.0):
            out = out - m  # CHW mean, broadcast rules
        return _on(out, str_img)


_register_image_ops()

# refresh the generated op surfaces (codegen ran before these ops existed)
from . import symbol as _sym_mod  # noqa: E402

nd._init_ops()
_sym_mod._init_symbol_module()
