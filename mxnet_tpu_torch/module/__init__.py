"""Module training API — counterpart of ``mxnet_tpu/module/`` for the
training slice: ``BaseModule`` and ``Module`` over one device
(``BucketingModule``, ``SequentialModule`` and ``PythonModule`` are queued
in ROADMAP.md)."""
from .base_module import BaseModule
from .module import Module
