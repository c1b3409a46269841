"""Foundation utilities: the framework error and the typed env-var registry
(counterpart of ``mxnet_tpu/base.py``, carried as its own copy so the port
never imports the JAX package)."""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["MXNetError", "env", "register_env", "string_types", "mx_real_t",
           "naive_engine"]

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

# the engine and the backward's knobs (docs/how_to/env_var.md, the JAX
# package's defaults)
register_env("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice", str,
             "Engine facade mode: ThreadedEnginePerDevice (asynchronous "
             "device queue) or NaiveEngine (synchronous, blocks after every "
             "op; debug).")
register_env("MXNET_BACKWARD_DO_MIRROR", 0, int,
             "Enable rematerialisation (torch.utils.checkpoint) in the "
             "backward pass.")


def naive_engine() -> bool:
    """Whether ``MXNET_ENGINE_TYPE`` asks for the NaiveEngine (reference
    src/engine/naive_engine.cc: every operation runs to its end when it
    is pushed)."""
    return env("MXNET_ENGINE_TYPE") == "NaiveEngine"
