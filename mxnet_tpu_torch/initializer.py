"""Weight initializers — counterpart of ``mxnet_tpu/initializer.py``.

The same surface: ``InitDesc``, name-pattern dispatch in
``Initializer.__call__`` (and ``__init__`` attrs naming an initializer;
``upsampling*`` names get the bilinear kernel, ``stn_loc*`` the identity
affine transform), ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``Zero``/``One``/``Constant``,
``Load``, ``Mixed`` and ``FusedRNN`` (a ``FusedRNNCell``'s packed vector,
initialized per unpacked array).  Random draws come from the port's
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
import torch

from .base import string_types
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Load", "Mixed", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "register"]

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
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.startswith("stn_loc") and name.endswith("weight"):
            self._init_zero(name, arr)
        elif name.startswith("stn_loc") and name.endswith("bias"):
            self._init_loc_bias(name, arr)
        elif name.endswith("bias"):
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

    def _init_bilinear(self, _, arr):
        """The fixed bilinear upsampling kernel over the last two axes:
        (1 - |x / f - c|) (1 - |y / f - c|), computed in float64 on the
        array's device and rounded once to float32, the values the JAX
        package's per-element loop stores."""
        shape = arr.shape
        dev = arr._data.device
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(shape[3], dtype=torch.float64, device=dev)
        y = torch.arange(shape[2], dtype=torch.float64, device=dev)
        kernel = (1 - (y / f - c).abs())[:, None] * \
            (1 - (x / f - c).abs())[None, :]
        arr[:] = kernel.to(torch.float32).expand(shape)

    def _init_loc_bias(self, _, arr):
        """The identity affine transform [1, 0, 0, 0, 1, 0] (a spatial
        transformer's localisation bias)."""
        assert arr.shape[0] == 6
        arr[:] = torch.tensor([1.0, 0, 0, 0, 1.0, 0], dtype=torch.float32)

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


@register
class Orthogonal(Initializer):
    """(Semi-)orthogonal weights (Saxe et al.): a draw from the array's
    device generator, U(-1, 1) or N(0, 1) of (out, in), decomposed by SVD
    on the host, as the JAX package does; its orthonormal factor times
    ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _random.uniform(-1.0, 1.0, (nout, nin), arr.context)
        else:
            tmp = _random.normal(0.0, 1.0, (nout, nin), arr.context)
        u, _v, q = np.linalg.svd(tmp.asnumpy(), full_matrices=False)
        res = u if u.shape == (nout, nin) else q
        arr[:] = (self.scale * res).reshape(arr.shape)


@register
class MSRAPrelu(Xavier):
    """He/MSRA init for PReLU nets: Gaussian Xavier at magnitude
    2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel for every weight."""

    def _init_weight(self, name, arr):
        Initializer._init_bilinear(self, name, arr)


@register
class LSTMBias(Initializer):
    """Zero bias with the forget gate's (the second quarter, gates i, f,
    c, o) set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape, dtype=torch.float32)
        num_hidden = int(arr.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b

    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """Initialize a ``FusedRNNCell``'s packed parameter vector: unpacked
    into its per-layer arrays (``FusedRNNCell.unpack_weights``), each
    initialized by ``init`` (or the global initializer) by its name, then
    packed back.  ``dumps`` writes the JAX package's JSON."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr):
        from .ndarray import array
        from .rnn.rnn_cell import FusedRNNCell

        cell = FusedRNNCell(self._num_hidden, self._num_layers,
                            self._mode, self._bidirectional,
                            forget_bias=self._forget_bias)
        args = {pname: array(parr, arr.context)
                for pname, parr in cell.unpack_weights(
                    {str(name): arr.copy()}).items()}
        for pname, parr in args.items():
            desc = InitDesc(pname, getattr(name, "attrs", {}))
            if self._init is None:
                getattr(name, "global_init", None)(desc, parr)
            else:
                self._init(desc, parr)
        arr[:] = cell.pack_weights(args)[str(name)]
