"""Parameters from the JAX package into the port.

``params_from_numpy`` takes a ``{name: np.ndarray}`` dict — the
``.asnumpy()`` of each of the JAX package's NDArrays, names with or without
``arg:``/``aux:`` prefixes — and returns the port's ``{name: NDArray}`` on
``ctx``, ready for ``Predictor``.  The other route is the ``.params`` file
itself: both packages read and write the same bytes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .ndarray import NDArray, array

__all__ = ["params_from_numpy"]


def params_from_numpy(params: Dict[str, np.ndarray], ctx) -> Dict[str, NDArray]:
    """Each array keeps its dtype; bfloat16 arrives as ml_dtypes' bfloat16
    and stays bfloat16."""
    out = {}
    for name, value in params.items():
        host = np.asarray(value)
        bf16 = host.dtype.kind == "V"
        out[name] = array(host, ctx, dtype="bfloat16" if bf16 else host.dtype)
    return out
