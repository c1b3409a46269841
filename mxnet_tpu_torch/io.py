"""Data iterators — counterpart of ``mxnet_tpu/io.py``: ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter``, ``ResizeIter``,
``PrefetchingIter``, ``MNISTIter`` (idx-ubyte files, gzipped or not) and
``CSVIter``, and ``ImageRecordIter`` (which delegates to ``image``).

Batches are host data: every iterator yields CPU NDArrays, and the
module copies each batch onto its device when it loads it.  Shuffling draws
from an explicit generator (``rng``: a ``numpy.random.RandomState`` or
``Generator``); without one it uses numpy's global state, as the JAX
package does, so ``np.random.seed(s)`` gives both packages one order.
``MNISTIter`` shuffles by a ``RandomState(seed)``, as the JAX package's.
The cursor-based iterators keep ``state_dict``/``set_state`` (mid-epoch
resume), as the JAX package's do.
"""
from __future__ import annotations

import collections
import gzip
import queue
import struct
import threading
import time

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "ImageRecordIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape (+dtype/layout) of one data stream.  Unpacks like the
    legacy (name, shape) tuple."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: data/label lists of NDArray + pad/index bookkeeping."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base: next/reset/iter protocol with getdata/getlabel/
    getpad/getindex hooks."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError

    def state_dict(self) -> dict:
        """The position (cursor, shuffle order) as plain host data; an
        iterator built from the same inputs and given it by
        :meth:`set_state` yields the same remaining batches."""
        raise NotImplementedError(
            "%s does not support state capture" % type(self).__name__)

    def set_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot."""
        raise NotImplementedError(
            "%s does not support state capture" % type(self).__name__)


def _init_data(data, allow_empty, default_name):
    """Normalize input data to a list of (name, numpy) pairs."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d) for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle and last-batch handling
    ("pad", "discard" or "roll_over")."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", rng=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self._shuffle_perm = None
        if shuffle:
            idx = np.arange(self.num_data)
            (np.random if rng is None else rng).shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
            self._shuffle_perm = idx
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % \
                self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [array(v[self.cursor:self.cursor + self.batch_size], cpu())
                    for _, v in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                      cpu()) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def state_dict(self):
        perm = self._shuffle_perm
        return {"cursor": int(self.cursor),
                "shuffle_perm": None if perm is None else perm.copy()}

    def set_state(self, state):
        perm = state.get("shuffle_perm")
        if perm is not None:
            perm = np.asarray(perm)
            cur = self._shuffle_perm if self._shuffle_perm is not None \
                else np.arange(len(perm))
            if not np.array_equal(perm, cur):
                # undo this instance's own shuffle, then apply the saved one
                inv = np.argsort(cur)
                self.data = [(k, v[inv][perm]) for k, v in self.data]
                self.label = [(k, v[inv][perm]) for k, v in self.label]
                self._shuffle_perm = perm
        self.cursor = int(state["cursor"])


class ResizeIter(DataIter):
    """Another iterator resized to ``size`` batches an epoch: it restarts
    the inner iterator when that ends early, and stops after ``size``
    batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def state_dict(self):
        return {"cur": int(self.cur), "inner": self.data_iter.state_dict()}

    def set_state(self, state):
        self.data_iter.set_state(state["inner"])
        self.cur = int(state["cur"])


#: the global registry's prefetch instruments, made on first use while
#: telemetry is on (telemetry._reset_for_tests drops them)
_PREFETCH_TELEM = None

#: queue item marking a source iterator's end of epoch
_END_OF_EPOCH = object()


class PrefetchingIter(DataIter):
    """Batches of one or more source iterators read ahead by one worker
    thread per source, into a queue of ``prefetch_depth`` batches, so the
    host prepares the next batches while the card computes.  ``next()``
    takes one batch from each source and joins their data and label lists
    (renamed by ``rename_data``/``rename_label``, one dict per source).
    A source's exception reaches the consumer; sources that end at
    different batch counts raise.  ``reset`` stops the workers, resets the
    sources and starts the workers again; ``close`` (or leaving a ``with``
    block) stops them for good, until a ``reset``.  While telemetry is on,
    each pop records the time the consumer blocked on empty queues, the
    queues' fill and the batch count (``mxtpu_prefetch_*``)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        super().__init__()
        self.iters = list(iters) if isinstance(iters, (list, tuple)) \
            else [iters]
        if not self.iters:
            raise ValueError("PrefetchingIter needs at least one source")
        self.n_iter = len(self.iters)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = max(1, int(prefetch_depth))
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = None
        self._queues = []
        self._threads = []
        self._stop = None
        self._exhausted = False
        self._consumed = 0  # batches the consumer has taken this epoch
        self._spin_up()

    # -- the workers -------------------------------------------------------
    def _spin_up(self):
        self._stop = threading.Event()
        self._queues = [queue.Queue(maxsize=self._depth)
                        for _ in range(self.n_iter)]
        self._threads = []
        for src, q in zip(self.iters, self._queues):
            t = threading.Thread(target=self._produce,
                                 args=(src, q, self._stop), daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _produce(src, q, stop):
        while not stop.is_set():
            try:
                item = src.next()
            except StopIteration:
                item = _END_OF_EPOCH
            except Exception as exc:  # handed to the consumer, which raises
                item = exc
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if item is _END_OF_EPOCH or isinstance(item, Exception):
                return

    def _tear_down(self, wait=True):
        if self._stop is None:
            return
        self._stop.set()
        for q in self._queues:  # unblock workers waiting on a full queue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            # the sources are not thread-safe: wait for the workers to
            # leave them before the caller touches them again
            t.join() if wait else t.join(timeout=1.0)
        self._threads = []
        self._queues = []

    def close(self):
        """Stop the workers now (an epoch abandoned midway); a later
        ``reset()`` starts them again."""
        self._tear_down(wait=True)
        self._exhausted = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._tear_down(wait=False)
        except Exception:  # interpreter teardown: globals may be gone
            pass

    # -- the DataIter surface ----------------------------------------------
    def _renamed(self, descs_per_iter, rename):
        if rename is None:
            return [d for descs in descs_per_iter for d in descs]
        out = []
        for mapping, descs in zip(rename, descs_per_iter):
            for d in descs:
                d = d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                out.append(DataDesc(mapping[d.name], d.shape, d.dtype))
        return out

    @property
    def provide_data(self):
        return self._renamed([i.provide_data for i in self.iters],
                             self.rename_data)

    @property
    def provide_label(self):
        return self._renamed([i.provide_label for i in self.iters],
                             self.rename_label)

    def reset(self):
        self._tear_down()
        for src in self.iters:
            src.reset()
        self._exhausted = False
        self._consumed = 0
        self._spin_up()

    def state_dict(self):
        """The sources' states at the batches the consumer has taken (the
        workers read ahead of it): each source needs a ``cursor``."""
        states = []
        for src in self.iters:
            st = dict(src.state_dict())
            if "cursor" not in st:
                raise ValueError(
                    "PrefetchingIter state capture needs cursor-based "
                    "sources; %s has none" % type(src).__name__)
            st["cursor"] = (self._consumed - 1) * src.batch_size
            states.append(st)
        return {"consumed": int(self._consumed), "sources": states}

    def set_state(self, state):
        self._tear_down()
        for src, st in zip(self.iters, state["sources"]):
            src.set_state(st)
        self._consumed = int(state["consumed"])
        self._exhausted = False
        self._spin_up()

    @staticmethod
    def _prefetch_metrics():
        """Lazy global-registry instruments shared by all prefetchers."""
        global _PREFETCH_TELEM
        if _PREFETCH_TELEM is None:
            from . import telemetry as _tm

            reg = _tm.registry()
            _PREFETCH_TELEM = {
                "starved_ms": reg.counter(
                    "mxtpu_prefetch_starvation_ms_total",
                    "Time the consumer blocked on empty prefetch queues."),
                "occupancy": reg.histogram(
                    "mxtpu_prefetch_queue_occupancy",
                    "Prefetch queue fill observed at each batch pop.",
                    start=1.0, factor=2.0, count=8),
                "batches": reg.counter("mxtpu_prefetch_batches_total",
                                       "Batches popped from the pipeline."),
            }
        return _PREFETCH_TELEM

    def iter_next(self):
        if self._exhausted:  # the workers are gone
            return False
        from . import telemetry as _tm

        if _tm.enabled():
            m = self._prefetch_metrics()
            m["occupancy"].observe(sum(q.qsize() for q in self._queues))
            t0 = time.monotonic()
            parts = [q.get() for q in self._queues]
            m["starved_ms"].inc((time.monotonic() - t0) * 1e3)
        else:
            m = None
            parts = [q.get() for q in self._queues]
        for p in parts:
            if isinstance(p, Exception):
                raise p
        ended = [p is _END_OF_EPOCH for p in parts]
        if any(ended):
            if not all(ended):
                raise RuntimeError(
                    "prefetch sources ended at different batch counts")
            self._exhausted = True
            return False
        if m is not None:  # the end-of-epoch pop is not a batch
            m["batches"].inc()
        self._consumed += 1
        first = parts[0]
        if any(p.pad != first.pad for p in parts):
            raise RuntimeError("prefetch sources disagree on batch padding")
        self.current_batch = DataBatch(
            [a for p in parts for a in p.data],
            [a for p in parts for a in (p.label or [])],
            first.pad, first.index)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _read_idx(path, magic, header):
    """The uint8 payload of an idx-ubyte file (gzipped when ``path`` ends
    in .gz) after its big-endian header of ``header`` counts, and the
    counts after the magic."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        fields = struct.unpack(">" + "I" * header, f.read(4 * header))
        if fields[0] != magic:
            raise MXNetError("bad MNIST file magic %d in %s (expected %d)"
                             % (fields[0], path, magic))
        count = int(np.prod(fields[1:]))
        return np.frombuffer(f.read(count), dtype=np.uint8), fields[1:]


class MNISTIter(NDArrayIter):
    """MNIST idx-ubyte reader (images magic 2051, labels 2049): pixels
    scaled to [0, 1], ``flat`` rows or (1, rows, cols) images, the part
    ``part_index`` of ``num_parts`` equal parts, shuffled by
    ``RandomState(seed)``; full batches only."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, part_index=0, num_parts=1,
                 **kwargs):
        pixels, (num, rows, cols) = _read_idx(image, 2051, 4)
        images = pixels.reshape(num, rows, cols).astype(np.float32) / 255.0
        labels = _read_idx(label, 2049, 2)[0].astype(np.float32)
        if flat:
            images = images.reshape(len(images), -1)
        else:
            images = images.reshape(len(images), 1, rows, cols)
        if num_parts > 1:  # one worker's share, as the reference splits it
            part = len(images) // num_parts
            images = images[part_index * part:(part_index + 1) * part]
            labels = labels[part_index * part:(part_index + 1) * part]
        if shuffle:
            idx = np.random.RandomState(seed).permutation(len(images))
            images, labels = images[idx], labels[idx]
        super().__init__(images, labels, batch_size, shuffle=False,
                         last_batch_handle="discard")


class CSVIter(DataIter):
    """Rows of ``data_csv`` (and ``label_csv``, else zero labels) in
    batches of ``batch_size``, each row reshaped to ``data_shape``; the
    last batch is padded, with rows from the start when ``round_batch``,
    else with zeros."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_shape = tuple(label_shape)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        self._data = data.reshape((-1,) + self.data_shape)
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            self._label = label.reshape((-1,) + self.label_shape)
        else:
            self._label = np.zeros((self._data.shape[0],) + self.label_shape,
                                   dtype=np.float32)
        self.num_data = self._data.shape[0]
        self.cursor = -batch_size
        self.round_batch = round_batch

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,) + self.label_shape)]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _slice(self, src):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [array(src[self.cursor:end], cpu())]
        out = np.zeros((self.batch_size,) + src.shape[1:], dtype=src.dtype)
        tail = src[self.cursor:]
        out[:len(tail)] = tail
        if self.round_batch:
            out[len(tail):] = src[:self.batch_size - len(tail)]
        return [array(out, cpu())]

    def getdata(self):
        return self._slice(self._data)

    def getlabel(self):
        return self._slice(self._label)

    def getpad(self):
        end = self.cursor + self.batch_size
        return max(0, end - self.num_data)

    def state_dict(self):
        return {"cursor": int(self.cursor)}

    def set_state(self, state):
        self.cursor = int(state["cursor"])


def ImageRecordIter(**kwargs):
    """RecordIO image iterator (reference: C++ ImageRecordIter registered in
    src/io/io.cc:9-23, exposed as mx.io.ImageRecordIter).  Delegates to the
    host pipeline in ``mxnet_tpu_torch.image``."""
    from . import image

    return image.ImageRecordIter(**kwargs)
