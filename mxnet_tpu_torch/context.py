"""Device context — the reference's Context (include/mxnet/base.h:124-196)
over ``torch.device``.

``gpu(i)`` is CUDA device ``i`` and is the default context: entry points run
on the card unless the caller asks for ``cpu()``.  Resolving a ``gpu``
context on a machine without CUDA raises instead of falling back.  The
numeric ``device_typeid`` (1 = cpu, 2 = gpu) is what the ``.params`` header
records.
"""
from __future__ import annotations

import threading
from typing import Optional

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]


class Context:
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise ValueError("unknown device type %s" % device_type)
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx: Optional[Context] = None

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def torch_device(self):
        """The ``torch.device`` this context names.  A ``gpu`` context on a
        machine without CUDA raises: nothing falls back to the CPU."""
        import torch

        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but no CUDA device is available; pass "
                "mx.cpu() to run on the CPU" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s requested but only %d CUDA device(s) exist"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    # -- with-scope --------------------------------------------------------
    def __enter__(self):
        self._old_ctx = Context.default_ctx()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def default_ctx(cls) -> "Context":
        if not hasattr(cls._default_ctx, "value"):
            cls._default_ctx.value = Context("gpu", 0)
        return cls._default_ctx.value


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    return Context.default_ctx()


def num_gpus() -> int:
    """The number of CUDA devices (0 without CUDA)."""
    import torch

    return torch.cuda.device_count()
