"""Weight initializers — counterpart of ``mxnet_tpu/initializer.py``.

The same surface for the ported slices: ``InitDesc``, name-pattern
dispatch in ``Initializer.__call__`` (and ``__init__`` attrs naming an
initializer), ``Uniform``, ``Normal``, ``Xavier``, ``Zero``/``One``/
``Constant``, ``Load`` and ``Mixed``.  Random draws come from the port's
per-device generator (``random.py``) on the array's own device, so a
full-width model initializes on the card.
"""
from __future__ import annotations

import json
import logging
import re
from math import sqrt
from typing import Dict

import numpy as np

from .base import string_types
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Load", "Mixed", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier", "register"]

_INIT_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name + attrs describing how a variable asked to be initialized."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: dispatches on the parameter name's suffix."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, string_types):
            raise TypeError("desc must be an initialization name (str/InitDesc)")
        name = str(desc)
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(name, arr)
            return
        if name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("moving_avg"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var") or name.endswith("moving_inv_var"):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("virtual _init_weight")

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "covers parameters ending with weight/bias/gamma/beta; name "
            "others explicitly or use Load/Mixed." % name)


@register
class Load:
    """Initialize from an existing dict of arrays, falling back to
    ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = dict(param)
        # accept both raw dicts and arg:/aux: prefixed checkpoint dicts
        for key in list(self.param):
            if key.startswith("arg:") or key.startswith("aux:"):
                self.param[key[4:]] = self.param.pop(key)
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, arr.shape, tuple(src.shape)))
            arr[:] = src
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default initializer provided." % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


@register
class Mixed:
    """Dispatch to different initializers by name regex."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            '".*" pattern at the end with default Initializer.' % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0

    _init_default = _init_weight


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

    _init_default = _init_weight


@register
class Uniform(Initializer):
    """U(-scale, scale) weights."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _random.uniform(-self.scale, self.scale, arr.shape,
                                 arr.context)


@register
class Normal(Initializer):
    """N(0, sigma) weights."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _random.normal(0, self.sigma, arr.shape, arr.context)


@register
class Xavier(Initializer):
    """Variance-scaling init: U(-s, s) or N(0, s) with
    s = sqrt(magnitude / factor), factor the fan-in, fan-out or their mean
    (trailing dims of a >2-d shape count into both fans)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = _random.uniform(-scale, scale, shape, arr.context)
        elif self.rnd_type == "gaussian":
            arr[:] = _random.normal(0, scale, shape, arr.context)
        else:
            raise ValueError("Unknown random type")
