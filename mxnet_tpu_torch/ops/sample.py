"""Sampling ops: ``_sample_uniform``, ``_sample_normal``, ``_sample_gamma``,
``_sample_exponential`` and ``_sample_poisson``, with the names
``uniform``, ``normal`` and ``random_*``.

Counterparts of ``mxnet_tpu/ops/sample.py:18-78``, with the same names,
parameters and shape inference.  Every draw comes from the
``torch.Generator`` in the ``OpContext`` (the device generator of
``mxnet_tpu_torch.random``, which ``seed`` reseeds); the JAX package splits
a threefry key instead, so one seed gives different numbers in the two
packages, from the same distributions.  On ``meta`` tensors nothing is
drawn: the op returns an empty tensor of the output's shape.
"""
from __future__ import annotations

import torch

from .param import Param, torch_dtype
from .registry import register

_SAMPLE_SPEC = {
    "shape": Param("shape", ()),
    "dtype": Param("dtype", "float32"),
    "ctx": Param(str, ""),
}


def _sample_infer(attrs, in_shapes):
    return in_shapes, [tuple(attrs.get("shape") or ())], []


def _draw(opctx, attrs, name, fn):
    """``fn(shape, generator, device)`` drawn in float32 (float64 when the
    op's dtype is float64), then cast to the op's dtype; an empty tensor
    on ``meta``."""
    shape = tuple(attrs.get("shape") or ())
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    device = opctx.source_device(name)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if opctx.generator is None:
        from ..base import MXNetError

        raise MXNetError("%s was given no generator" % name)
    return fn(shape, opctx.generator, device).to(dtype)


def _wide(attrs):
    return torch.float64 if attrs.get("dtype") == "float64" else \
        torch.float32


@register("_sample_uniform", inputs=(),
          params={**_SAMPLE_SPEC, "low": Param(float, 0.0),
                  "high": Param(float, 1.0)},
          stochastic=True, infer_shape=_sample_infer,
          aliases=("uniform", "random_uniform"), hint="uniform")
def _sample_uniform(opctx, attrs, *a):
    low, high = attrs.get("low", 0.0), attrs.get("high", 1.0)
    return _draw(opctx, attrs, "_sample_uniform", lambda s, g, d: torch.rand(
        s, generator=g, device=d, dtype=_wide(attrs)) * (high - low) + low)


@register("_sample_normal", inputs=(),
          params={**_SAMPLE_SPEC, "loc": Param(float, 0.0),
                  "scale": Param(float, 1.0)},
          stochastic=True, infer_shape=_sample_infer,
          aliases=("normal", "random_normal"), hint="normal")
def _sample_normal(opctx, attrs, *a):
    loc, scale = attrs.get("loc", 0.0), attrs.get("scale", 1.0)
    return _draw(opctx, attrs, "_sample_normal", lambda s, g, d: loc + scale
                 * torch.randn(s, generator=g, device=d, dtype=_wide(attrs)))


@register("_sample_gamma", inputs=(),
          params={**_SAMPLE_SPEC, "alpha": Param(float, 1.0),
                  "beta": Param(float, 1.0)},
          stochastic=True, infer_shape=_sample_infer,
          aliases=("random_gamma",), hint="gamma_sample")
def _sample_gamma(opctx, attrs, *a):
    """Gamma(alpha) draws times the scale ``beta``."""
    alpha, beta = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)

    def fn(shape, gen, device):
        conc = torch.full(shape, alpha, dtype=_wide(attrs), device=device)
        return torch._standard_gamma(conc, generator=gen) * beta

    return _draw(opctx, attrs, "_sample_gamma", fn)


@register("_sample_exponential", inputs=(),
          params={**_SAMPLE_SPEC, "lam": Param(float, 1.0)},
          stochastic=True, infer_shape=_sample_infer,
          aliases=("random_exponential",), hint="exponential")
def _sample_exponential(opctx, attrs, *a):
    """Exponential draws of rate ``lam``."""
    lam = attrs.get("lam", 1.0)

    def fn(shape, gen, device):
        return torch.empty(shape, dtype=_wide(attrs), device=device) \
            .exponential_(generator=gen) / lam

    return _draw(opctx, attrs, "_sample_exponential", fn)


@register("_sample_poisson", inputs=(),
          params={**_SAMPLE_SPEC, "lam": Param(float, 1.0)},
          stochastic=True, infer_shape=_sample_infer,
          aliases=("random_poisson",), hint="poisson")
def _sample_poisson(opctx, attrs, *a):
    """Poisson counts of mean ``lam``, cast to the op's dtype."""
    lam = attrs.get("lam", 1.0)

    def fn(shape, gen, device):
        rate = torch.full(shape, lam, dtype=_wide(attrs), device=device)
        return torch.poisson(rate, generator=gen)

    return _draw(opctx, attrs, "_sample_poisson", fn)
