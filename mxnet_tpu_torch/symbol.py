"""Symbol — the symbolic graph layer.

Counterpart of ``mxnet_tpu/symbol.py`` for the ported slices.  A Symbol is
a list of output entries of an immutable DAG of ``_Node``s.  Kept surface:
composition with auto-created parameter variables and NameManager naming,
``infer_shape`` with parameter shape filling, ``infer_type`` (no
propagation through ops), ``attr_dict``, ``list_arguments/outputs/
auxiliary_states``, ``Group``, graph JSON save/load identical to the JAX
package's, and ``bind``.  Each registered op is exposed as ``mx.sym.<op>``.

Shape inference runs the per-op ``infer_shape`` rules and, for an op whose
rule leaves an output unknown, the op's own function on tensors of the
``meta`` device: shapes without data, the counterpart of ``jax.eval_shape``.
"""
from __future__ import annotations

import ast
import builtins as _builtins
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .attribute import AttrScope
from .base import MXNetError
from .name import NameManager
from .ops import OpContext, get_op, registered_ops
from .ops.param import attrs_to_strs

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "attr_dict")

    def __init__(self, op, name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]], attr_dict: Dict[str, str]):
        self.op = op  # None for variables
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.attr_dict = dict(attr_dict or {})

    @property
    def is_variable(self) -> bool:
        return self.op is None

    def num_outputs(self) -> int:
        return 1 if self.op is None else self.op.num_outputs(self.attrs)

    def aux_names(self) -> List[str]:
        if self.op is None:
            return []
        return ["%s_%s" % (self.name, a) for a in self.op.aux_names(self.attrs)]


def _topo_sort(heads: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    order: List[_Node] = []
    seen = set()

    def visit(node: _Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for parent, _ in node.inputs:
            visit(parent)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


class Symbol:
    __slots__ = ("_outputs",)

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = list(outputs)

    @property
    def name(self) -> Optional[str]:
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _nodes(self) -> List[_Node]:
        return _topo_sort(self._outputs)

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._nodes() if n.is_variable]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                names.append(node.op.output_names(node.attrs, node.name)[idx])
        return names

    def list_auxiliary_states(self) -> List[str]:
        out = []
        for n in self._nodes():
            out.extend(n.aux_names())
        return out

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError("Cannot find output %s" % index)
            index = names.index(index)
        if isinstance(index, _builtins.slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    def attr(self, key: str) -> Optional[str]:
        return self._outputs[0][0].attr_dict.get(key)

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        """{node name: {attr: string value}} for every node with attrs —
        graph attrs (``__lr_mult__``, ``__init__`` ...) and op params."""
        out = {}
        for n in self._nodes():
            d = dict(n.attr_dict)
            if n.op is not None:
                d.update(attrs_to_strs({k: v for k, v in n.attrs.items()
                                        if k in n.op.params}))
            if d:
                out[n.name] = d
        return out

    # ------------------------------------------------------------------
    # shape inference
    # ------------------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes, positional in ``list_arguments`` order or by name; all
        three are None when any argument or output stays unknown."""
        known: Dict[str, Tuple[int, ...]] = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = tuple(shape)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)
        shapes, aux_shapes = _forward_infer(self, known)
        nodes = self._nodes()
        arg_out = [shapes.get((id(n), 0)) for n in nodes if n.is_variable]
        out_out = [shapes.get((id(node), idx)) for node, idx in self._outputs]
        aux_out = [aux_shapes.get(a) for n in nodes for a in n.aux_names()]
        if any(s is None for s in arg_out + out_out):
            return None, None, None
        return arg_out, out_out, aux_out

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes.  Arguments
        take the given type, else their ``__dtype__`` attr, else float32;
        outputs and aux states are float32 — the port does not propagate
        types through ops (every op of the ported paths keeps float32)."""
        import numpy as np

        names = self.list_arguments()
        known = {n: np.dtype(t) for n, t in zip(names, args) if t is not None}
        known.update({k: np.dtype(v) for k, v in kwargs.items()
                      if v is not None})
        f32 = np.dtype(np.float32)
        attrs = {n.name: n.attr_dict for n in self._nodes() if n.is_variable}
        arg_types = [known.get(n) or np.dtype(attrs[n].get("__dtype__",
                                                           "float32"))
                     for n in names]
        return (arg_types, [f32] * len(self._outputs),
                [f32] * len(self.list_auxiliary_states()))

    # ------------------------------------------------------------------
    # save / load (reference graph JSON format)
    # ------------------------------------------------------------------
    def tojson(self) -> str:
        nodes = self._nodes()
        node_index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        arg_nodes = []
        for i, n in enumerate(nodes):
            if n.is_variable:
                arg_nodes.append(i)
                jnodes.append({"op": "null", "name": n.name,
                               "attr": dict(n.attr_dict), "inputs": []})
            else:
                attr = attrs_to_strs({k: v for k, v in n.attrs.items()
                                      if k in n.op.params})
                attr.update(n.attr_dict)
                jnodes.append({
                    "op": n.op.name, "name": n.name, "attr": attr,
                    "inputs": [[node_index[id(p)], int(idx), 0]
                               for p, idx in n.inputs]})
        heads = [[node_index[id(node)], int(idx), 0]
                 for node, idx in self._outputs]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 901]}},
                          indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)


# ---------------------------------------------------------------------------
# shape inference over the graph
# ---------------------------------------------------------------------------


def _forward_infer(sym: Symbol, known: Dict[str, Tuple]):
    """Propagate shapes through the graph.  ``known`` maps variable name ->
    shape.  Per-op infer_shape rules may fill unknown *input* shapes
    (parameter shape deduction, the reference's bidirectional InferShape
    pass); an op whose rule leaves an output unknown runs on meta
    tensors."""
    nodes = _topo_sort(sym._outputs)
    info: Dict[Tuple[int, int], Tuple] = {}
    aux_shapes: Dict[str, Tuple] = {}

    for n in nodes:
        if n.is_variable:
            shape = known.get(n.name)
            if shape is None and n.attr_dict.get("__shape__"):
                shape = tuple(ast.literal_eval(n.attr_dict["__shape__"]))
            if shape is not None:
                info[(id(n), 0)] = shape

    # iterate to convergence like the reference InferShape pass
    changed = True
    passes = 0
    max_passes = _builtins.max(10, 2 * len(nodes))
    while changed and passes < max_passes:
        changed = False
        passes += 1
        for n in nodes:
            if n.is_variable:
                continue
            in_entries = [(id(p), idx) for p, idx in n.inputs]
            in_shapes = [info.get(e) for e in in_entries]
            nout = n.num_outputs()
            if n.op.infer_shape is not None:
                try:
                    new_in, out_shapes, aux = n.op.infer_shape(n.attrs,
                                                               in_shapes)
                except (TypeError, ValueError, KeyError, IndexError):
                    new_in, out_shapes, aux = in_shapes, [None] * nout, []
                for e, old, new in zip(in_entries, in_shapes, new_in):
                    if new is not None and old is None:
                        info[e] = tuple(new)
                        changed = True
                for i, s in enumerate(out_shapes):
                    if s is not None and (id(n), i) not in info:
                        info[(id(n), i)] = tuple(s)
                        changed = True
                for aname, ashape in zip(n.aux_names(), aux):
                    if ashape is not None and aname not in aux_shapes:
                        aux_shapes[aname] = tuple(ashape)
                        changed = True
            if all((id(n), i) in info for i in range(nout)):
                continue
            in_shapes = [info.get(e) for e in in_entries]
            aux_in = [aux_shapes.get(a) for a in n.aux_names()]
            if any(s is None for s in in_shapes + aux_in):
                continue
            outs = _meta_apply(n.op, n.attrs, in_shapes, aux_in)
            for i in range(nout):
                info[(id(n), i)] = tuple(outs[i].shape)
            changed = True
    return info, aux_shapes


def _meta_apply(op, attrs, shapes, aux_shapes):
    """Run the op on data-free ``meta`` tensors: the output shapes, with no
    memory touched and no kernel launched."""
    import torch

    def meta(shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    outs, _ = op.apply(OpContext(is_train=False), attrs,
                       [meta(s) for s in shapes], [meta(s) for s in aux_shapes])
    return outs


# ---------------------------------------------------------------------------
# symbol creation
# ---------------------------------------------------------------------------


def _create(op_name: str, sym_args: List[Symbol], kwargs: Dict[str, Any],
            name: Optional[str] = None, attr: Optional[Dict[str, str]] = None):
    op = get_op(op_name)
    sym_kwargs = {}
    attrs = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            sym_kwargs[k] = v
        else:
            attrs[k] = v
    parsed = op.parse_attrs(attrs)
    name = NameManager.current().get(name, op.hint)
    input_names = op.input_names(parsed)
    slots: Dict[str, Symbol] = {}
    for iname, s in zip(input_names, sym_args):
        slots[iname] = s
    for k, v in sym_kwargs.items():
        if k not in input_names:
            raise MXNetError("unknown input %s for op %s" % (k, op_name))
        slots[k] = v
    entries: List[Tuple[_Node, int]] = []
    for iname in input_names:
        s = slots.get(iname)
        if s is None:
            # auto-create parameter variable (reference composition semantics)
            vnode = _Node(None, "%s_%s" % (name, iname), {}, [],
                          AttrScope.current().get(None))
            entries.append((vnode, 0))
        else:
            if len(s._outputs) != 1:
                raise MXNetError("Cannot use grouped symbol as input %s of %s"
                                 % (iname, op_name))
            entries.append(s._outputs[0])
    node = _Node(op, name, parsed, entries, AttrScope.current().get(attr))
    return Symbol([(node, i) for i in range(op.num_outputs(parsed))])


def _make_symbol_function(op_name: str, op):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_args = [a for a in args if isinstance(a, Symbol)]
        return _create(op_name, sym_args, kwargs, name=name, attr=attr)

    fn.__name__ = op_name
    fn.__doc__ = op.doc or "Auto-generated symbol function for op %s" % op_name
    return fn


def Variable(name: str, attr=None, shape=None, dtype=None, init=None,
             **kwargs) -> Symbol:
    """Create a named variable (placeholder) symbol."""
    import numpy as np

    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = AttrScope.current().get(attr)
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attr["__dtype__"] = np.dtype(dtype).name
    if init is not None:
        attr["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        attr["__%s__" % k] = str(v)
    return Symbol([(_Node(None, name, {}, [], attr), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """A Symbol from graph JSON, as written by either package.  Keys an op
    declares are its parameters; everything else (AttrScope attrs, dunder
    graph attrs) stays a node attribute."""
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        attr = dict(jn.get("attr", jn.get("attrs", {})) or {})
        attr.update(jn.get("param", {}) or {})  # pre-NNVM graphs
        if jn["op"] == "null":
            nodes.append(_Node(None, jn["name"], {}, [], attr))
            continue
        op = get_op(jn["op"])
        params = {k: v for k, v in attr.items()
                  if not k.startswith("__") and k in op.params}
        graph_attrs = {k: v for k, v in attr.items() if k not in params}
        inputs = [(nodes[i[0]], i[1]) for i in jn["inputs"]]
        nodes.append(_Node(op, jn["name"], op.parse_attrs(params), inputs,
                           graph_attrs))
    heads = [(nodes[h[0]], h[1] if len(h) > 1 else 0) for h in data["heads"]]
    return Symbol(heads)


def _init_symbol_module():
    g = globals()
    for name, op in registered_ops().items():
        if name in g:
            continue
        g[name] = _make_symbol_function(name, op)


_init_symbol_module()
