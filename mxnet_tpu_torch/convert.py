"""Parameters and optimizer states from the JAX package into the port.

``params_from_numpy`` takes a ``{name: np.ndarray}`` dict — the
``.asnumpy()`` of each of the JAX package's NDArrays, names with or without
``arg:``/``aux:`` prefixes — and returns the port's ``{name: NDArray}`` on
``ctx``, ready for ``Predictor`` or ``Module.init_params``.  The other
route is the ``.params`` file itself: both packages read and write the same
bytes.  Recurrent parameters carry over in each of their forms: a
``FusedRNNCell``'s packed vector, the per-layer arrays its
``unpack_weights`` gives, and the per-gate arrays of each cell's
``unpack_weights``; the cells' ``pack_weights`` turn them back, in either
package, into the same vector.

``optimizer_states_from_numpy`` takes an updater's states as numpy — the
JAX package's ``Updater.states`` ``{index: state}`` with every NDArray
replaced by its ``.asnumpy()`` — and returns the same structure of the
port's NDArrays on ``ctx``, ready for the port's ``Updater.states``.  Every
optimizer's layout carries over: one array (SGD, NAG and ccSGD with
momentum, AdaGrad, Test), a tuple (Adam's (mean, var), AdaDelta's two
accumulators, RMSProp's (n,) or centered (n, g, delta)), a tuple with a
``None`` member (DCASGD without momentum: (None, previous weight); with it:
(momentum, previous weight)), or None (stateless SGD, SGLD).  Each array
keeps its dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .ndarray import NDArray, array

__all__ = ["params_from_numpy", "optimizer_states_from_numpy"]


def params_from_numpy(params: Dict[str, np.ndarray], ctx) -> Dict[str, NDArray]:
    """Each array keeps its dtype; bfloat16 arrives as ml_dtypes' bfloat16
    and stays bfloat16."""
    return {name: _array(value, ctx) for name, value in params.items()}


def _array(value, ctx) -> NDArray:
    host = np.asarray(value)
    bf16 = host.dtype.kind == "V"
    return array(host, ctx, dtype="bfloat16" if bf16 else host.dtype)


def _state_from_numpy(state, ctx):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_from_numpy(s, ctx) for s in state)
    return _array(state, ctx)


def optimizer_states_from_numpy(states, ctx):
    """``{index: state as numpy}`` -> ``{index: state as NDArrays}``."""
    return {int(idx): _state_from_numpy(st, ctx) for idx, st in states.items()}
