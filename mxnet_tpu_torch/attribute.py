"""Attribute scoping for symbols (parity: python/mxnet/attribute.py:7).

``AttrScope`` attaches string attributes (e.g. ``__ctx_group__``) to every
symbol created inside the scope.
"""
from __future__ import annotations

import threading

from .base import string_types

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, string_types):
                raise ValueError("Attributes need to be string")
        self._old_scope = None
        self._attr = kwargs

    def get(self, attr):
        """Merge user-supplied attrs over the scope attrs."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @classmethod
    def current(cls) -> "AttrScope":
        if not hasattr(cls._current, "value"):
            cls._current.value = AttrScope()
        return cls._current.value
