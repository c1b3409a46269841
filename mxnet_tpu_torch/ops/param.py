"""Declarative op parameters — analogue of ``dmlc::Parameter<T>`` structs.

A copy of ``mxnet_tpu/ops/param.py``'s parsing and stringification rules:
each op registers a spec of typed params with defaults; values arriving as
Python objects or as strings (from graph JSON or kwargs) are coerced to
typed values, and ``attrs_to_strs`` writes them back in the exact string
forms the JAX package writes, so graph JSON matches byte for byte.
"""
from __future__ import annotations

import ast
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Param", "parse_attrs", "attrs_to_strs"]


class Param:
    """One typed op parameter.

    ``typ``: one of int, float, bool, 'shape' (tuple of ints), 'float-shape'
    (tuple of floats), str, 'dtype', 'float-or-none', 'shape-or-none',
    'int-or-none'.
    """

    def __init__(self, typ, default=None, required=False, enum=None, doc=""):
        self.typ = typ
        self.default = default
        self.required = required
        self.enum = enum
        self.doc = doc

    def parse(self, value: Any) -> Any:
        if value is None:
            return None
        t = self.typ
        if t == "shape" or t == "shape-or-none":
            return _parse_shape(value)
        if t == "float-shape":
            return _parse_shape(value, cast=float)
        if t is int or t == "int-or-none":
            if isinstance(value, str):
                if value.lower() == "none":
                    return None
                return int(float(value))
            return int(value)
        if t is float or t == "float-or-none":
            if isinstance(value, str):
                if value.lower() == "none":
                    return None
                return float(value)
            return float(value)
        if t is bool:
            if isinstance(value, str):
                return value.lower() in ("true", "1")
            return bool(value)
        if t == "dtype":
            if isinstance(value, str):
                return value
            if value in (np.float32, float):
                return "float32"
            return np.dtype(value).name
        if t is str:
            v = str(value)
            if self.enum is not None and v not in self.enum:
                raise ValueError(
                    "invalid value %r, expected one of %s" % (v, self.enum))
            return v
        return value


def _parse_shape(value, cast=int):
    if isinstance(value, str):
        value = value.strip()
        if value.lower() in ("none", "()"):
            return tuple() if value == "()" else None
        parsed = ast.literal_eval(value)
        if isinstance(parsed, (int, float)):
            return (cast(parsed),)
        return tuple(cast(x) for x in parsed)
    if isinstance(value, (int, np.integer)):
        return (cast(value),)
    if isinstance(value, (float, np.floating)):
        if cast is not float:
            raise TypeError("expected int or int tuple, got %r" % (value,))
        return (cast(value),)
    return tuple(cast(x) for x in value)


def parse_attrs(spec: Optional[Dict[str, Param]], attrs: Dict[str, Any],
                op_name: str = "") -> Dict[str, Any]:
    """Coerce raw attrs (strings or python values) against the spec.
    Graph-level attrs (``__ctx_group__`` etc.) pass through; unknown plain
    kwargs are rejected like the reference's dmlc::Parameter::Init."""
    out: Dict[str, Any] = {}
    spec = spec or {}
    for key, param in spec.items():
        if key in attrs:
            out[key] = param.parse(attrs[key])
        elif param.required:
            raise ValueError(
                "Required parameter %s of %s is missing" % (key, op_name))
        else:
            out[key] = param.default
    for key, value in attrs.items():
        if key not in out:
            if key.startswith("__") or key in ("ctx", "name"):
                out[key] = value
            else:
                raise ValueError(
                    "unknown argument %r for operator %s" % (key, op_name))
    return out


def attrs_to_strs(attrs: Dict[str, Any]) -> Dict[str, str]:
    """Stringify typed attrs for JSON graph serialization (every attr is a
    string in the reference graph JSON)."""
    out = {}
    for key, value in attrs.items():
        if value is None:
            continue
        if isinstance(value, bool):
            out[key] = "True" if value else "False"
        elif isinstance(value, tuple):
            out[key] = "(" + ", ".join(str(v) for v in value) + ")"
        else:
            out[key] = str(value)
    return out
