"""Network visualization (reference python/mxnet/visualization.py):
``print_summary`` table and ``plot_network`` graphviz dot output;
counterpart of ``mxnet_tpu/visualization.py``, whose text it prints
character for character."""
from __future__ import annotations

import json
from typing import Dict, Optional

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a per-layer summary table with output shapes and param counts
    (reference visualization.py print_summary)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {x[0] for x in conf["heads"]}
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    total_params = [0]

    def print_layer_summary(node, out_shape):
        op = node["op"]
        pre_node = []
        pre_filter = 0
        if op != "null":
            inputs = node["inputs"]
            for item in inputs:
                input_node = nodes[item[0]]
                input_name = input_node["name"]
                if input_node["op"] != "null" or item[0] in heads:
                    pre_node.append(input_name)
                    if show_shape:
                        key = input_name + "_output" if input_node["op"] != "null" \
                            else input_name
                        if key in shape_dict:
                            shape = shape_dict[key][1:]
                            pre_filter = pre_filter + int(shape[0]) if shape else 0
        cur_param = 0
        attrs = node.get("attr", {}) or {}
        if op == "Convolution":
            num_filter = int(attrs["num_filter"])
            kernel = eval(attrs["kernel"])
            num_group = int(attrs.get("num_group", "1"))
            cur_param = pre_filter * num_filter // num_group
            for k in kernel:
                cur_param *= k
            cur_param += num_filter
        elif op == "FullyConnected":
            num_hidden = int(attrs["num_hidden"])
            cur_param = (pre_filter + 1) * num_hidden
        elif op == "BatchNorm":
            key = node["name"] + "_output"
            if show_shape and key in shape_dict:
                num_filter = shape_dict[key][1]
                cur_param = int(num_filter) * 2
        if not pre_node:
            first_connection = ""
        else:
            first_connection = pre_node[0]
        fields = [node["name"] + "(" + op + ")",
                  "x".join([str(x) for x in out_shape]),
                  cur_param, first_connection]
        print_row(fields, positions)
        if len(pre_node) > 1:
            for i in range(1, len(pre_node)):
                fields = ["", "", "", pre_node[i]]
                print_row(fields, positions)
        total_params[0] += cur_param

    for i, node in enumerate(nodes):
        out_shape = []
        op = node["op"]
        if op == "null" and i > 0:
            continue
        if op != "null" or i in heads:
            if show_shape:
                key = node["name"] + "_output" if op != "null" else node["name"]
                if key in shape_dict:
                    out_shape = shape_dict[key][1:]
        print_layer_summary(node, out_shape)
        if i == len(nodes) - 1:
            print("=" * line_length)
        else:
            print("_" * line_length)
    print("Total params: %s" % total_params[0])
    print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs={}, hide_weights=True):
    """Build a graphviz Digraph of the network (reference visualization.py
    plot_network).  Requires the ``graphviz`` package only at call time."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("plot_network requires the graphviz python package")
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    draw_shape = False
    shape_dict = {}
    if shape is not None:
        draw_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    # color map mirroring the reference palette
    cm = ("#8dd3c7", "#fb8072", "#ffffb3", "#bebada", "#80b1d3", "#fdb462",
          "#b3de69", "#fccde5")

    def looks_like_weight(name):
        if name.endswith("_weight") or name.endswith("_bias") or \
                name.endswith("_gamma") or name.endswith("_beta") or \
                name.endswith("_moving_var") or name.endswith("_moving_mean"):
            return True
        return False

    hidden_nodes = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        attrs = node.get("attr", {}) or {}
        label = name
        if op == "null":
            if looks_like_weight(name):
                if hide_weights:
                    hidden_nodes.add(name)
                continue
            attr = node_attr.copy()
            attr["shape"] = "oval"
            attr["fillcolor"] = cm[0]
        else:
            attr = node_attr.copy()
            if op == "Convolution":
                label = "Convolution\n%s/%s, %s" % (
                    attrs.get("kernel", "?"), attrs.get("stride", "(1, 1)"),
                    attrs.get("num_filter", "?"))
                attr["fillcolor"] = cm[1]
            elif op == "FullyConnected":
                label = "FullyConnected\n%s" % attrs.get("num_hidden", "?")
                attr["fillcolor"] = cm[1]
            elif op == "BatchNorm":
                attr["fillcolor"] = cm[3]
            elif op == "Activation" or op == "LeakyReLU":
                label = "%s\n%s" % (op, attrs.get("act_type", ""))
                attr["fillcolor"] = cm[2]
            elif op == "Pooling":
                label = "Pooling\n%s, %s/%s" % (
                    attrs.get("pool_type", "?"), attrs.get("kernel", "?"),
                    attrs.get("stride", "(1, 1)"))
                attr["fillcolor"] = cm[4]
            elif op in ("Concat", "Flatten", "Reshape"):
                attr["fillcolor"] = cm[5]
            elif op == "Softmax" or op == "SoftmaxOutput":
                attr["fillcolor"] = cm[6]
            else:
                attr["fillcolor"] = cm[7]
        dot.node(name=name, label=label, **attr)

    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        inputs = node["inputs"]
        for item in inputs:
            input_node = nodes[item[0]]
            input_name = input_node["name"]
            if input_name in hidden_nodes:
                continue
            attr = {"dir": "back", "arrowtail": "open"}
            if draw_shape:
                key = input_name + "_output" if input_node["op"] != "null" \
                    else input_name
                if key in shape_dict:
                    shape = shape_dict[key][1:]
                    label = "x".join([str(x) for x in shape])
                    attr["label"] = label
            dot.edge(tail_name=name, head_name=input_name, **attr)
    return dot
