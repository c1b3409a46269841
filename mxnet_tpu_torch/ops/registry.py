"""Operator registry — single source of truth for the op surface.

The counterpart of ``mxnet_tpu/ops/registry.py`` with the same single
registration form: a function over tensors plus declarative metadata.
Here the function takes ``torch`` tensors.  The registry drives the
imperative API (``mx.nd.<op>``), the symbolic API (``mx.sym.<op>``), graph
JSON round-trip and shape inference
(per-op ``infer_shape``, else the op's own function evaluated on
``torch.device("meta")`` tensors).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["Op", "OpContext", "register", "get_op", "registered_ops",
           "mark_batch_local", "mark_partition", "mark_loss"]


class OpContext:
    """Per-invocation context handed to op functions (reference: OpContext
    in include/mxnet/operator.h:60-75): ``is_train``; for a stochastic op
    the random resource, a ``torch.Generator`` on the op's device that the
    caller hands it (the executor's: ``random.generator(device)``); and the
    op's ``torch.device``, where a source op (``_zeros``, ``_sample_*``),
    which has no input to take a device from, puts its output.  The JAX
    package hands a PRNG key split per stochastic node instead, so the two
    draw different numbers from one seed."""

    __slots__ = ("is_train", "generator", "device")

    def __init__(self, is_train: bool = False, generator=None, device=None):
        self.is_train = is_train
        self.generator = generator
        self.device = device

    def source_device(self, op_name: str):
        """The device a source op writes to.  There is no default: an op
        run without one raises rather than picking the CPU."""
        if self.device is None:
            from ..base import MXNetError

            raise MXNetError("%s has no input to take a device from and was "
                             "given none" % op_name)
        return self.device


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
        key_var_num_args: Optional[str] = None,
        output_names: Optional[Callable] = None,
        allow_extra_attrs: bool = False,
        stochastic: bool = False,
    ):
        self.name = name
        self.fn = fn
        self._inputs = inputs
        self.params = params or {}
        self._num_outputs = num_outputs
        # aux may be a callable(attrs) -> names, for ops whose auxiliary
        # states depend on attrs (Custom: CustomOpProp.list_auxiliary_states)
        self.aux = aux if callable(aux) else tuple(aux)
        self.infer_shape = infer_shape
        # the attr counting variadic inputs (add_n's num_args): its inputs
        # are named arg0, arg1, ...
        self.key_var_num_args = key_var_num_args
        self._output_names = output_names
        # keep attrs outside ``params`` as strings instead of rejecting them
        # (Custom hands them to the CustomOpProp constructor)
        self.allow_extra_attrs = allow_extra_attrs
        self.hint = hint or name.lower().lstrip("_")
        self.doc = doc
        # inputs that never take a gradient (labels, indices): the executor
        # forces their grad_req to "null"
        self.no_grad_inputs = tuple(no_grad_inputs)
        # draws random numbers: the executor hands it a generator
        self.stochastic = stochastic
        # runs on a slice of the batch as on the whole (see
        # ``is_batch_local``), in training and out of it; set by
        # ``mark_batch_local``
        self.batch_local = False
        self.batch_local_eval = False
        # how a partitioned executor splits it beyond the batch; set by
        # ``mark_partition``: "elementwise" (each output element from the
        # same element of its same-shape inputs), "dense" (FullyConnected:
        # column- or row-parallel on its weight's pieces), "reshape" (the
        # identity where its output's shape is its input's); None gathers
        self.partition = None
        # a loss layer: its backward ignores the head gradient and gives
        # its inputs the loss's own gradient; set by ``mark_loss``
        self.loss = False

    # -- metadata ----------------------------------------------------------
    def input_names(self, attrs: Dict[str, Any]) -> List[str]:
        if callable(self._inputs):
            return list(self._inputs(attrs))
        if self.key_var_num_args and self.key_var_num_args in attrs:
            return ["arg%d" % i for i in range(int(attrs[self.key_var_num_args]))]
        return list(self._inputs)

    def num_outputs(self, attrs: Dict[str, Any]) -> int:
        if callable(self._num_outputs):
            return int(self._num_outputs(attrs))
        return int(self._num_outputs)

    def output_names(self, attrs: Dict[str, Any], node_name: str) -> List[str]:
        if self._output_names is not None:
            return ["%s_%s" % (node_name, n) for n in self._output_names(attrs)]
        n = self.num_outputs(attrs)
        if n == 1:
            return ["%s_output" % node_name]
        return ["%s_output%d" % (node_name, i) for i in range(n)]

    def aux_names(self, attrs: Dict[str, Any]) -> List[str]:
        if callable(self.aux):
            return list(self.aux(attrs))
        return list(self.aux)

    def is_batch_local(self, attrs: Dict[str, Any],
                       is_train: bool = True) -> bool:
        """Whether the op, run on equal pieces of the batch (axis 0 of its
        batch-major inputs, the others whole), gives the pieces of its
        whole-batch outputs and gradients: a data-parallel executor then
        runs it once per shard.  In training stochastic ops never are
        (their draws follow the whole batch's); out of it the ops marked
        for inference are too (BatchNorm reading its moving statistics,
        Dropout's identity, a loss layer's forward)."""
        rule = self.batch_local
        if not is_train and self.batch_local_eval:
            rule = self.batch_local_eval
        elif self.stochastic or not rule:
            return False
        return bool(rule(attrs)) if callable(rule) else True

    def parse_attrs(self, attrs: Dict[str, Any]) -> Dict[str, Any]:
        from .param import parse_attrs

        return parse_attrs(self.params, attrs, self.name,
                           allow_extra=self.allow_extra_attrs)

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


def mark_batch_local(names, rule=True, is_train=True) -> None:
    """Mark the ops ``names`` batch-local: ``True``, or ``rule(attrs)`` for
    ops whose answer depends on their attrs (an axis that may be the
    batch's); with ``is_train`` False, only out of training."""
    for name in names:
        setattr(_REGISTRY[name],
                "batch_local" if is_train else "batch_local_eval", rule)


def mark_partition(names, kind) -> None:
    """How a partitioned executor splits the ops ``names`` beyond the
    batch (``Op.partition``)."""
    for name in names:
        _REGISTRY[name].partition = kind


def mark_loss(names) -> None:
    """Mark the ops ``names`` loss layers (``Op.loss``)."""
    for name in names:
        _REGISTRY[name].loss = True


def get_op(name: str) -> Op:
    if name not in _REGISTRY:
        raise KeyError("Operator %s is not registered" % name)
    return _REGISTRY[name]


def registered_ops() -> Dict[str, Op]:
    return _REGISTRY
