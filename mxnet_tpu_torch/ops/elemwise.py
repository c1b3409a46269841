"""Elementwise ops of the serving slice: ``broadcast_add`` (alias
``broadcast_plus``) and ``gelu`` in its exact-erf form.

Counterparts of ``mxnet_tpu/ops/elemwise.py`` (``_BROADCAST`` and the
``gelu`` entry of ``_UNARY``), in plain torch.
"""
from __future__ import annotations

import torch

from .registry import register


@register("gelu", inputs=("data",), hint="gelu")
def _gelu(opctx, attrs, x):
    """0.5·x·(1 + erf(x/√2)) — jax.nn.gelu(approximate=False)."""
    return torch.nn.functional.gelu(x)


@register("broadcast_add", inputs=("lhs", "rhs"), aliases=("broadcast_plus",),
          hint="broadcast_add")
def _broadcast_add(opctx, attrs, lhs, rhs):
    return torch.add(lhs, rhs)
