"""Generative serving — counterpart of ``mxnet_tpu/generation/``:
continuous batching over a paged KV cache that lives on the device.

``kv_pool``: fixed-size KV pages + per-sequence page tables, so KV memory
scales with live tokens instead of max_len x batch.  ``engine``:
:class:`DecodeEngine`, iteration-level continuous batching over
fixed-shape per-lane-bucket decode executors (admit/retire every step,
streaming :class:`GenStream` handles), with cross-request prefix caching
and speculative decoding.
"""
from .engine import DecodeEngine, GenStream
from .kv_pool import KVPoolExhaustedError, PagedKVPool

__all__ = ["DecodeEngine", "GenStream", "PagedKVPool",
           "KVPoolExhaustedError"]
