"""Foundation utilities: the framework error and the typed env-var registry
(counterpart of ``mxnet_tpu/base.py``, carried as its own copy so the port
never imports the JAX package)."""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["MXNetError", "env", "register_env", "string_types", "mx_real_t"]

string_types = (str,)
mx_real_t = np.float32


class MXNetError(Exception):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


_ENV_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_env(name: str, default: Any, typ: Callable = str,
                 doc: str = "") -> None:
    _ENV_REGISTRY[name] = {"default": default, "type": typ, "doc": doc}


def env(name: str, default: Optional[Any] = None,
        typ: Optional[Callable] = None) -> Any:
    """Read a typed environment variable, falling back to the registered
    default."""
    spec = _ENV_REGISTRY.get(name)
    if spec is not None:
        if default is None:
            default = spec["default"]
        if typ is None:
            typ = spec["type"]
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is None or typ is str:
        return raw
    if typ is bool:
        return raw.lower() not in ("0", "false", "")
    return typ(raw)


register_env("CUDA_HOME", "/usr/local/cuda", str,
             "CUDA toolkit root; its bin/nvcc builds the hand-written "
             "kernels when nvcc is not on PATH.")
