"""The fused ``RNN`` op and ``_rnn_state_zeros``; counterparts of
``mxnet_tpu/ops/rnn_op.py``, with the same names, parameters, shape rules
and packed parameter layout.

The JAX op runs the recurrence as a ``lax.scan``, which XLA compiles; here
it is a Python loop over time in plain torch, and autograd takes the
gradients through it.  As there, the input projection of the whole
sequence is one product hoisted out of the loop, and each step adds one
(N, H) x (H, G*H) product to it.

  * modes: rnn_relu / rnn_tanh / lstm / gru;
  * several layers, bidirectional, dropout ``p`` between layers (training
    only, drawn from the ``OpContext`` generator, so its masks are not the
    JAX package's threefry masks);
  * inputs: data (T, N, I), parameters (one packed vector), state
    (L*D, N, H), and state_cell for LSTM;
  * outputs: output (T, N, H*D), and the final state(s) with
    ``state_outputs``.  The backward direction's outputs stay at their
    input's time index.

Packed layout (``rnn_unpack_layout``, which ``rnn.FusedRNNCell`` and the
``FusedRNN`` initializer use too): for each layer, for each direction
(forward first), i2h_weight (G*H, in) then h2h_weight (G*H, H); after all
weights, for each layer and direction, i2h_bias (G*H) then h2h_bias (G*H).
Gate order: LSTM [i, f, g, o]; GRU [r, z, n] in the linear-before-reset
form, ``n = tanh(x_n + r * (W_hn h + b_hn))``.
"""
from __future__ import annotations

import numpy as np
import torch

from .param import Param
from .registry import register

__all__ = ["rnn_param_size", "rnn_unpack_layout"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _dirs(attrs):
    return 2 if attrs.get("bidirectional") else 1


def rnn_param_size(input_size, state_size, num_layers, mode,
                   bidirectional=False):
    """Total length of the packed parameter vector."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    total = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        total += d * (g * h * in_sz + g * h * h + 2 * g * h)
    return total


def rnn_unpack_layout(input_size, state_size, num_layers, mode,
                      bidirectional=False):
    """(layer, direction, kind, offset, shape) for every packed chunk, kind
    in {i2h_weight, h2h_weight, i2h_bias, h2h_bias}."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    out = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        for direction in range(d):
            out.append((layer, direction, "i2h_weight", off, (g * h, in_sz)))
            off += g * h * in_sz
            out.append((layer, direction, "h2h_weight", off, (g * h, h)))
            off += g * h * h
    for layer in range(num_layers):
        for direction in range(d):
            out.append((layer, direction, "i2h_bias", off, (g * h,)))
            off += g * h
            out.append((layer, direction, "h2h_bias", off, (g * h,)))
            off += g * h
    return out


def _slice_params(params, layout):
    """Packed vector -> {(layer, dir): {kind: view}}."""
    table = {}
    for layer, direction, kind, off, shape in layout:
        n = int(np.prod(shape))
        table.setdefault((layer, direction), {})[kind] = \
            params.narrow(0, off, n).reshape(shape)
    return table


def _cell_step(mode):
    """f(gates_t, state, wh, bh) -> new state tuple for one time step;
    ``gates_t`` is the step's share of the hoisted input projection."""
    if mode in ("rnn_relu", "rnn_tanh"):
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(gates_t, state, wh, bh):
            (h_prev,) = state
            return (act(gates_t + torch.matmul(h_prev, wh.t()) + bh),)
        return step
    if mode == "lstm":
        def step(gates_t, state, wh, bh):
            h_prev, c_prev = state
            g = gates_t + torch.matmul(h_prev, wh.t()) + bh
            i, f, gg, o = torch.chunk(g, 4, dim=-1)
            c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(gg)
            return torch.sigmoid(o) * torch.tanh(c), c
        return step
    if mode == "gru":
        def step(gates_t, state, wh, bh):
            (h_prev,) = state
            hh = torch.matmul(h_prev, wh.t()) + bh           # (N, 3H)
            ir, iz, inn = torch.chunk(gates_t, 3, dim=-1)
            hr, hz, hn = torch.chunk(hh, 3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)                     # linear-before-reset
            return ((1.0 - z) * n + z * h_prev,)
        return step
    raise ValueError("unknown RNN mode %r" % mode)


def _run_direction(mode, x, p_tab, h0, c0, reverse):
    """One layer, one direction. x: (T, N, in) -> (out (T, N, H), hT, cT)."""
    t, n, _ = x.shape
    # the whole sequence's input projection: one product
    gates = (torch.matmul(x.reshape(t * n, -1), p_tab["i2h_weight"].t())
             + p_tab["i2h_bias"]).reshape(t, n, -1)
    step = _cell_step(mode)
    wh, bh = p_tab["h2h_weight"], p_tab["h2h_bias"]
    state = (h0, c0) if mode == "lstm" else (h0,)
    # one unbind: its backward stacks the steps' gradients once, where an
    # index per step would scatter each into a zero tensor of all T
    steps = gates.unbind(0)
    outs = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        state = step(steps[i], state, wh, bh)
        outs[i] = state[0]
    c_t = state[1] if mode == "lstm" else None
    return torch.stack(outs, dim=0), state[0], c_t


def _rnn_impl(opctx, attrs, data, params, state, state_cell=None):
    mode = attrs["mode"]
    h = attrs["state_size"]
    nl = attrs["num_layers"]
    d = _dirs(attrs)
    p = attrs.get("p", 0.0)
    input_size = data.shape[2]
    table = _slice_params(params, rnn_unpack_layout(input_size, h, nl, mode,
                                                    d == 2))
    drop = (opctx.is_train and p > 0.0 and opctx.generator is not None
            and nl > 1)
    x = data
    h_finals, c_finals = [], []
    for layer in range(nl):
        outs_dir = []
        for direction in range(d):
            idx = layer * d + direction
            outs, h_t, c_t = _run_direction(
                mode, x, table[(layer, direction)], state[idx],
                state_cell[idx] if mode == "lstm" else None,
                reverse=(direction == 1))
            outs_dir.append(outs)
            h_finals.append(h_t)
            if mode == "lstm":
                c_finals.append(c_t)
        x = outs_dir[0] if d == 1 else torch.cat(outs_dir, dim=-1)
        if drop and layer < nl - 1:
            keep = 1.0 - p
            mask = torch.rand(x.shape, generator=opctx.generator,
                              device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))

    outputs = [x]
    if attrs.get("state_outputs"):
        outputs.append(torch.stack(h_finals, dim=0))
        if mode == "lstm":
            outputs.append(torch.stack(c_finals, dim=0))
    return tuple(outputs)


def _rnn_inputs(attrs):
    base = ["data", "parameters", "state"]
    if attrs.get("mode") == "lstm":
        base.append("state_cell")
    return base


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs"):
        return 1
    return 3 if attrs.get("mode") == "lstm" else 2


def _rnn_infer(attrs, in_shapes):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None] * _rnn_num_outputs(attrs), []
    t, n, input_size = dshape
    h = attrs["state_size"]
    nl = attrs["num_layers"]
    d = _dirs(attrs)
    mode = attrs["mode"]
    psize = rnn_param_size(input_size, h, nl, mode, d == 2)
    sshape = (nl * d, n, h)
    args = [tuple(dshape), (psize,), sshape]
    if mode == "lstm":
        args.append(sshape)
    outs = [(t, n, h * d)]
    if attrs.get("state_outputs"):
        outs.append(sshape)
        if mode == "lstm":
            outs.append(sshape)
    return args, outs, []


def _state_zeros_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    batch = d[attrs.get("batch_axis", 0)]
    out = tuple(batch if s == 0 else s for s in attrs["shape"])
    return in_shapes, [out], []


@register("_rnn_state_zeros", inputs=("data",),
          params={"shape": Param("shape", required=True),
                  "batch_axis": Param(int, 0)},
          infer_shape=_state_zeros_infer, hint="rnnstatezeros")
def _rnn_state_zeros(opctx, attrs, data):
    """Zero initial state whose batch dimension (each 0 of ``shape``) is
    read off ``data``'s ``batch_axis``, in ``data``'s dtype and on its
    device."""
    batch = data.shape[attrs.get("batch_axis", 0)]
    shape = tuple(batch if s == 0 else s for s in attrs["shape"])
    return torch.zeros(shape, dtype=data.dtype, device=data.device)


@register("RNN", inputs=_rnn_inputs, num_outputs=_rnn_num_outputs,
          params={
              "state_size": Param(int, required=True),
              "num_layers": Param(int, required=True),
              "bidirectional": Param(bool, False),
              "mode": Param(str, required=True,
                            enum=("rnn_relu", "rnn_tanh", "lstm", "gru")),
              "p": Param(float, 0.0),
              "state_outputs": Param(bool, False),
          },
          infer_shape=_rnn_infer, stochastic=True, hint="rnn",
          output_names=lambda attrs: (
              ["output"] + (["state"] + (["state_cell"]
               if attrs.get("mode") == "lstm" else [])
               if attrs.get("state_outputs") else [])))
def _rnn(opctx, attrs, data, params, state, *rest):
    state_cell = rest[0] if rest else None
    return _rnn_impl(opctx, attrs, data, params, state, state_cell)
