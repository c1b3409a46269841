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

__all__ = ["seed", "current_seed", "generator", "optimizer_generator",
           "uniform", "normal", "randint", "get_state", "set_state"]

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


#: the stream of :func:`optimizer_generator`, kept apart from the ops'
_OPTIMIZER_STREAM = "#optimizer"


def optimizer_generator(device) -> torch.Generator:
    """The generator an optimizer draws its noise from on ``device`` (SGLD):
    a second stream per device, seeded from the current seed, so that an
    optimizer's draws never move the generator the ops draw from (whose
    state the fused step keeps to replay dropout in its backward)."""
    device = torch.device(device)
    key = str(device) + _OPTIMIZER_STREAM
    gens = _gens()
    if key not in gens:
        gen = torch.Generator(device=device)
        gen.manual_seed((_state.seed + 0x9E3779B9) % (2 ** 63))
        gens[key] = gen
    return gens[key]


def get_state() -> dict:
    """Snapshot the random state as plain host data: the seed, and each
    device generator's ``get_state()`` bytes by device.  After
    :func:`set_state`, every generator draws what it drew after the
    snapshot."""
    gens = _gens()
    return {"seed": _state.seed,
            "generators": {k: g.get_state().numpy().copy()
                           for k, g in gens.items()}}


def set_state(state: dict) -> None:
    """Restore a :func:`get_state` snapshot.  A device without a
    generator in it starts afresh from the snapshot's seed."""
    gens = _gens()
    gens.clear()
    _state.seed = int(state["seed"])
    for key, data in state["generators"].items():
        gen = torch.Generator(
            device=torch.device(key.partition(_OPTIMIZER_STREAM)[0]))
        gen.set_state(torch.from_numpy(np.asarray(data, np.uint8).copy()))
        gens[key] = gen


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, out=None,
            dtype="float32"):
    """U(low, high) draws of ``shape`` on ``ctx`` (the current context when
    None, or ``out``'s), or into ``out``."""
    from . import ndarray as nd

    return nd.uniform(low=low, high=high, shape=shape, ctx=ctx, out=out,
                      dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, out=None,
           dtype="float32"):
    """N(loc, scale) draws of ``shape`` on ``ctx`` (the current context
    when None, or ``out``'s), or into ``out``."""
    from . import ndarray as nd

    return nd.normal(loc=loc, scale=scale, shape=shape, ctx=ctx, out=out,
                     dtype=dtype)


def randint(low, high, shape=(1,), ctx=None, out=None, dtype="int32"):
    """Integers in [low, high) of ``shape`` on ``ctx``, drawn from that
    device's generator; with ``out`` written into it."""
    from . import ndarray as nd
    from .context import current_context
    from .ops.param import torch_dtype

    if ctx is None:
        ctx = out.context if out is not None else current_context()
    dev = ctx.torch_device()
    if isinstance(shape, int):
        shape = (shape,)
    data = torch.randint(int(low), int(high), tuple(shape),
                         generator=generator(dev), device=dev)
    arr = nd.NDArray(data.to(torch_dtype(dtype)), ctx)
    if out is not None:
        out[:] = arr
        return out
    return arr
