"""Random number handling — counterpart of ``mxnet_tpu/random.py``.

One explicit ``torch.Generator`` per device, seeded by :func:`seed`; the
initializers draw from the generator of the device their array lives on.
The JAX package splits a JAX PRNG key instead, so the two packages give
different numbers from one seed: tests that compare them feed both the
same numpy arrays.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

__all__ = ["seed", "current_seed", "generator", "uniform", "normal"]

_state = threading.local()


def _gens() -> Dict[str, torch.Generator]:
    if not hasattr(_state, "gens"):
        _state.seed = 0
        _state.gens = {}
    return _state.gens


def seed(seed_state: int) -> None:
    """Reseed every device's generator (and numpy's global state, as the
    JAX package does for host-side augmenters)."""
    _gens().clear()
    _state.seed = int(seed_state)
    np.random.seed(int(seed_state) % (2 ** 32))


def current_seed() -> int:
    _gens()
    return _state.seed


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a torch.device), created from the
    current seed at first use."""
    device = torch.device(device)
    key = str(device)
    gens = _gens()
    if key not in gens:
        gen = torch.Generator(device=device)
        gen.manual_seed(_state.seed)
        gens[key] = gen
    return gens[key]


def uniform(low, high, shape, ctx):
    """U(low, high) float32 NDArray of ``shape`` on ``ctx``."""
    from .ndarray import NDArray

    dev = ctx.torch_device()
    data = torch.rand(tuple(shape), generator=generator(dev), device=dev)
    return NDArray(data * (high - low) + low, ctx)


def normal(loc, scale, shape, ctx):
    """N(loc, scale) float32 NDArray of ``shape`` on ``ctx``."""
    from .ndarray import NDArray

    dev = ctx.torch_device()
    data = torch.randn(tuple(shape), generator=generator(dev), device=dev)
    return NDArray(data * scale + loc, ctx)
