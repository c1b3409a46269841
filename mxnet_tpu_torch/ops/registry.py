"""Operator registry — single source of truth for the op surface.

The counterpart of ``mxnet_tpu/ops/registry.py`` with the same single
registration form: a function over tensors plus declarative metadata.
Here the function takes ``torch`` tensors.  The registry drives the
symbolic API (``mx.sym.<op>``), graph JSON round-trip and shape inference
(per-op ``infer_shape``, else the op's own function evaluated on
``torch.device("meta")`` tensors).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["Op", "OpContext", "register", "get_op", "registered_ops"]


class OpContext:
    """Per-invocation context handed to op functions (reference: OpContext
    in include/mxnet/operator.h:60-75).  No op of the serving slice draws
    random numbers, so it carries only ``is_train``."""

    __slots__ = ("is_train",)

    def __init__(self, is_train: bool = False):
        self.is_train = is_train


class Op:
    def __init__(
        self,
        name: str,
        fn: Callable,
        inputs: Any = ("data",),
        params: Optional[Dict[str, Any]] = None,
        num_outputs: Any = 1,
        aux: Sequence[str] = (),
        infer_shape: Optional[Callable] = None,
        hint: Optional[str] = None,
        doc: str = "",
        no_grad_inputs: Sequence[str] = (),
    ):
        self.name = name
        self.fn = fn
        self._inputs = inputs
        self.params = params or {}
        self._num_outputs = num_outputs
        self.aux = tuple(aux)
        self.infer_shape = infer_shape
        self.hint = hint or name.lower().lstrip("_")
        self.doc = doc
        # inputs that never take a gradient (labels, indices): the executor
        # forces their grad_req to "null"
        self.no_grad_inputs = tuple(no_grad_inputs)

    # -- metadata ----------------------------------------------------------
    def input_names(self, attrs: Dict[str, Any]) -> List[str]:
        if callable(self._inputs):
            return list(self._inputs(attrs))
        return list(self._inputs)

    def num_outputs(self, attrs: Dict[str, Any]) -> int:
        if callable(self._num_outputs):
            return int(self._num_outputs(attrs))
        return int(self._num_outputs)

    def output_names(self, attrs: Dict[str, Any], node_name: str) -> List[str]:
        n = self.num_outputs(attrs)
        if n == 1:
            return ["%s_output" % node_name]
        return ["%s_output%d" % (node_name, i) for i in range(n)]

    def aux_names(self, attrs: Dict[str, Any]) -> List[str]:
        return list(self.aux)

    def parse_attrs(self, attrs: Dict[str, Any]) -> Dict[str, Any]:
        from .param import parse_attrs

        return parse_attrs(self.params, attrs, self.name)

    # -- application -------------------------------------------------------
    def apply(self, opctx: OpContext, attrs: Dict[str, Any], inputs, aux=()):
        """Run the op.  Returns (outputs: tuple, aux_updates: tuple)."""
        result = self.fn(opctx, attrs, *inputs, *aux)
        if not isinstance(result, tuple):
            result = (result,)
        n_out = self.num_outputs(attrs)
        if aux and len(result) == n_out + len(aux):
            return result[:n_out], result[n_out:]
        return result, tuple(aux)

    def __repr__(self):
        return "Op(%s)" % self.name


_REGISTRY: Dict[str, Op] = {}


def register(name: str, **kwargs) -> Callable:
    """Decorator registering an op function.  ``aliases`` registers extra
    names pointing at the same Op."""
    aliases = kwargs.pop("aliases", ())

    def deco(fn: Callable) -> Callable:
        op = Op(name, fn, doc=fn.__doc__ or "", **kwargs)
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return deco


def get_op(name: str) -> Op:
    if name not in _REGISTRY:
        raise KeyError("Operator %s is not registered" % name)
    return _REGISTRY[name]


def registered_ops() -> Dict[str, Op]:
    return _REGISTRY
