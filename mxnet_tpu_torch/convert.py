"""Parameters and optimizer states from the JAX package into the port.

``params_from_numpy`` takes a ``{name: np.ndarray}`` dict — the
``.asnumpy()`` of each of the JAX package's NDArrays, names with or without
``arg:``/``aux:`` prefixes — and returns the port's ``{name: NDArray}`` on
``ctx``, ready for ``Predictor`` or ``Module.init_params``.  The other
route is the ``.params`` file itself: both packages read and write the same
bytes.

``optimizer_states_from_numpy`` takes an updater's states as numpy — the
JAX package's ``Updater.states`` ``{index: state}`` with every NDArray
replaced by its ``.asnumpy()`` (adam: a (mean, var) pair, SGD with
momentum: one array, stateless: None) — and returns the same structure of
the port's NDArrays on ``ctx``, ready for the port's ``Updater.states``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .ndarray import NDArray, array

__all__ = ["params_from_numpy", "optimizer_states_from_numpy"]


def params_from_numpy(params: Dict[str, np.ndarray], ctx) -> Dict[str, NDArray]:
    """Each array keeps its dtype; bfloat16 arrives as ml_dtypes' bfloat16
    and stays bfloat16."""
    out = {}
    for name, value in params.items():
        host = np.asarray(value)
        bf16 = host.dtype.kind == "V"
        out[name] = array(host, ctx, dtype="bfloat16" if bf16 else host.dtype)
    return out


def _state_from_numpy(state, ctx):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_from_numpy(s, ctx) for s in state)
    return array(np.asarray(state), ctx, dtype=np.float32)


def optimizer_states_from_numpy(states, ctx):
    """``{index: state as numpy}`` -> ``{index: state as NDArrays}``."""
    return {int(idx): _state_from_numpy(st, ctx) for idx, st in states.items()}
