"""Automatic symbol naming (parity: python/mxnet/name.py in the reference).

NameManager hands out ``<op>N`` names; the Prefix variant prepends a scope
prefix.  The counters follow ``mxnet_tpu/name.py`` exactly, so a graph
built under a fresh manager serializes to the same JSON in both packages.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @classmethod
    def current(cls) -> "NameManager":
        if not hasattr(cls._current, "value"):
            cls._current.value = NameManager()
        return cls._current.value


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
