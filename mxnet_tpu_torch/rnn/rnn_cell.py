"""Symbolic RNN cells; counterpart of ``mxnet_tpu/rnn/rnn_cell.py``.

The same cells, names and graphs: ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``FusedRNNCell`` (one ``RNN`` op), ``SequentialRNNCell``,
``BidirectionalCell``, ``DropoutCell``, ``ModifierCell``, ``ZoneoutCell``
and ``ResidualCell``, with ``unroll`` emitting symbol JSON byte for byte
the JAX package's, so an unrolled graph written by one package loads in the
other.

* ``unroll`` with ``begin_state=None`` makes zero states with the
  ``_rnn_state_zeros`` op tied to the input symbol, which reads the batch
  from the input's shape.
* Gate orders match the fused op: LSTM [i, f, g, o]; GRU [r, z, n] with the
  linear-before-reset recurrence, so ``FusedRNNCell.unfuse()`` is exact and
  ``unpack_weights``/``pack_weights`` convert between the packed vector and
  the per-layer (and per-gate) arrays.
"""
from __future__ import annotations

import numpy as np

from .. import symbol
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """Container for cell parameter symbols, shared between cells via the
    ``params`` constructor argument."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract RNN cell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """List of dicts {'shape': tuple (0 = batch), '__layout__': str}."""
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states.  ``func=None`` (default) creates Variable symbols
        (bindable inputs, shapes deduced from the graph); pass
        ``func=mx.sym.zeros`` with a ``batch_size`` kwarg for inline zeros,
        or any symbol-returning callable."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        batch_size = kwargs.pop("batch_size", 0)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            shape = tuple(batch_size if s == 0 else s
                          for s in info["shape"])
            if func is None:
                states.append(symbol.Variable(name))
            elif func is symbol.Variable:
                states.append(func(name, **kwargs))
            else:
                states.append(func(shape=shape, name=name, **kwargs))
        return states

    def _zeros_states(self, data, batch_axis):
        """States-of-zeros whose batch dim follows ``data`` (used by unroll
        when begin_state is None)."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            states.append(symbol._create(
                "_rnn_state_zeros", [data],
                {"shape": info["shape"], "batch_axis": batch_axis},
                name="%sbegin_state_%d" % (self._prefix, self._init_counter)))
        return states

    # -- weight (un)packing ------------------------------------------------
    def unpack_weights(self, args):
        """Split fused gate weights into per-gate entries."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                name = "%s%s_%s" % (self._prefix, group_name, t)
                if name not in args:
                    continue
                arr = args.pop(name).asnumpy() if hasattr(args.get(name), "asnumpy") \
                    else args.pop(name)
                arr = np.asarray(arr)
                for j, gate in enumerate(self._gate_names):
                    wname = "%s%s%s_%s" % (self._prefix, group_name, gate, t)
                    args[wname] = arr[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ("i2h", "h2h"):
            for t in ("weight", "bias"):
                parts = []
                ok = True
                for gate in self._gate_names:
                    wname = "%s%s%s_%s" % (self._prefix, group_name, gate, t)
                    if wname not in args:
                        ok = False
                        break
                    parts.append(np.asarray(
                        args[wname].asnumpy() if hasattr(args[wname], "asnumpy")
                        else args[wname]))
                if not ok:
                    continue
                for gate in self._gate_names:
                    del args["%s%s%s_%s" % (self._prefix, group_name, gate, t)]
                args["%s%s_%s" % (self._prefix, group_name, t)] = \
                    np.concatenate(parts, axis=0)
        return args

    # -- unrolling ---------------------------------------------------------
    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Unroll the cell for ``length`` steps.

        inputs: a single Symbol with layout NTC/TNC, a list of per-step
        Symbols (each (N, C)), or None (creates t%d_data Variables)."""
        self.reset()
        inputs, ref, batch_axis = _normalize_sequence(
            length, inputs, input_prefix, layout)
        if begin_state is None:
            begin_state = self._zeros_states(ref, batch_axis)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states


def _normalize_sequence(length, inputs, input_prefix, layout):
    """-> (list of per-step symbols, the symbol the batch is read from,
    batch_axis)."""
    if inputs is None:
        inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                  for i in range(length)]
        return inputs, inputs[0], 0
    if isinstance(inputs, symbol.Symbol):
        t_axis = layout.find("T")
        batch_axis = layout.find("N")
        ref = inputs
        if length == 1:
            steps = [symbol.Reshape(
                symbol.slice_axis(inputs, axis=t_axis, begin=0, end=1),
                shape=(0, -1))]
        else:
            steps = list(symbol.SliceChannel(
                inputs, num_outputs=length, axis=t_axis, squeeze_axis=True))
        # per-step batch axis after squeezing T
        return steps, ref, 0 if batch_axis > t_axis else batch_axis
    return list(inputs), inputs[0], 0


class RNNCell(BaseRNNCell):
    """Elman RNN cell: h' = act(W x + b_i + U h + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order [i, f, g, o] matching the fused RNN op; its
    i2h bias initializes through ``LSTMBias``."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias

        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slices = symbol.SliceChannel(gates, num_outputs=4, axis=1,
                                     name="%sslice" % name)
        in_gate = symbol.Activation(slices[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slices[1], act_type="sigmoid")
        in_trans = symbol.Activation(slices[2], act_type="tanh")
        out_gate = symbol.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh",
                                              name="%sstate" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order [r, z, n], linear-before-reset recurrence
    matching the fused RNN op."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h_n = symbol.SliceChannel(
            i2h, num_outputs=3, axis=1, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h_n = symbol.SliceChannel(
            h2h, num_outputs=3, axis=1, name="%sh2h_slice" % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_hbar = symbol.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        ones = update * 0.0 + 1.0
        next_h = (ones - update) * next_hbar + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN lowered to the single ``RNN`` op
    (``ops/rnn_op.py``), its parameters one packed vector."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")

    @property
    def _num_gates(self):
        return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[self._mode]

    @property
    def _dir(self):
        return 2 if self._bidirectional else 1

    @property
    def state_info(self):
        n = self._num_layers * self._dir
        infos = [{"shape": (n, 0, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            infos.append({"shape": (n, 0, self._num_hidden),
                          "__layout__": "LNC"})
        return infos

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    def _input_size_from(self, total):
        """Solve the packed-vector length for the layer-0 input size."""
        g, h = self._num_gates, self._num_hidden
        d = self._dir
        rest = 2 * d * g * h * self._num_layers  # all biases
        for layer in range(1, self._num_layers):
            rest += d * (g * h * (h * d) + g * h * h)
        rest += d * g * h * h  # layer-0 h2h
        i = (total - rest) // (d * g * h)
        if i <= 0 or rest + d * g * h * i != total:
            raise MXNetError("packed RNN parameter length %d inconsistent "
                             "with cell config" % total)
        return i

    def unpack_weights(self, args):
        from ..ops.rnn_op import rnn_unpack_layout

        args = dict(args)
        name = self._parameter.name
        arr = args.pop(name)
        arr = np.asarray(arr.asnumpy() if hasattr(arr, "asnumpy") else arr)
        input_size = self._input_size_from(arr.size)
        layout = rnn_unpack_layout(input_size, self._num_hidden,
                                   self._num_layers, self._mode,
                                   self._bidirectional)
        for layer, direction, kind, off, shape in layout:
            n = int(np.prod(shape))
            block = arr[off:off + n].reshape(shape)
            dir_s = ["l", "r"][direction]
            # whole fused gate blocks, named to match the unfuse()d cells
            args["%s%s%d_%s" % (self._prefix, dir_s, layer, kind)] = \
                block.copy()
        return args

    def pack_weights(self, args):
        from ..ops.rnn_op import rnn_unpack_layout, rnn_param_size

        args = dict(args)
        h = self._num_hidden
        # deduce input size from the layer-0 i2h weight
        probe = "%sl0_i2h_weight" % self._prefix
        input_size = np.asarray(
            args[probe].asnumpy() if hasattr(args[probe], "asnumpy")
            else args[probe]).shape[1]
        total = rnn_param_size(input_size, h, self._num_layers, self._mode,
                               self._bidirectional)
        layout = rnn_unpack_layout(input_size, h, self._num_layers,
                                   self._mode, self._bidirectional)
        out = np.zeros(total, np.float32)
        for layer, direction, kind, off, shape in layout:
            dir_s = ["l", "r"][direction]
            pname = "%s%s%d_%s" % (self._prefix, dir_s, layer, kind)
            block = np.asarray(
                args.pop(pname).asnumpy()
                if hasattr(args.get(pname), "asnumpy") else args.pop(pname))
            out[off:off + block.size] = block.reshape(-1)
        args[self._parameter.name] = out
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        if isinstance(inputs, (list, tuple)):
            inputs = symbol.Concat(
                *[symbol.expand_dims(i, axis=0) for i in inputs], dim=0)
            tnc = inputs
            batch_axis = 1
        else:
            if layout == "NTC":
                tnc = symbol.SwapAxis(inputs, dim1=0, dim2=1)
            elif layout == "TNC":
                tnc = inputs
            else:
                raise MXNetError("unsupported layout %s" % layout)
            batch_axis = 1
        if begin_state is None:
            begin_state = self._zeros_states(tnc, batch_axis)
        states = list(begin_state)
        kwargs = {}
        if self._mode == "lstm":
            kwargs["state_cell"] = states[1]
        rnn = symbol._create(
            "RNN",
            [tnc, self._parameter, states[0]] +
            ([states[1]] if self._mode == "lstm" else []),
            {"state_size": self._num_hidden,
             "num_layers": self._num_layers,
             "bidirectional": self._bidirectional,
             "mode": self._mode, "p": self._dropout,
             "state_outputs": self._get_next_state},
            name="%srnn" % self._prefix)
        if self._get_next_state:
            outputs = rnn[0]
            if self._mode == "lstm":
                final = [rnn[1], rnn[2]]
            else:
                final = [rnn[1]]
        else:
            outputs = rnn if not isinstance(rnn, list) else rnn[0]
            final = []
        if layout == "NTC":
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            t_axis = 0 if layout == "TNC" else 1
            outputs = list(symbol.SliceChannel(
                outputs, num_outputs=length, axis=t_axis, squeeze_axis=True))
        return outputs, final

    def unfuse(self):
        """Equivalent SequentialRNNCell of unfused cells (exact: gate order
        and GRU recurrence match the fused op)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p,
                                       forget_bias=self._forget_bias),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout, prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            cell.params._params.update(self.params._params)
            self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def _zeros_states(self, data, batch_axis):
        return sum([c._zeros_states(data, batch_axis)
                    for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        # per-cell unroll so FusedRNNCell members stay fused
        num_cells = len(self._cells)
        if begin_state is not None:
            p = 0
            cell_begin = []
            for cell in self._cells:
                n = len(cell.state_info)
                cell_begin.append(begin_state[p:p + n])
                p += n
        else:
            cell_begin = [None] * num_cells
        states = []
        for i, cell in enumerate(self._cells):
            merge = merge_outputs if i == num_cells - 1 else True
            inputs, cell_states = cell.unroll(
                length, inputs=inputs, begin_state=cell_begin[i],
                input_prefix=input_prefix, layout=layout,
                merge_outputs=merge)
            layout = "NTC" if merge else layout
            states.extend(cell_states)
        return inputs, states


class DropoutCell(BaseRNNCell):
    """Applies dropout to the input."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def _zeros_states(self, data, batch_axis):
        self.base_cell._modified = False
        out = self.base_cell._zeros_states(data, batch_axis)
        self.base_cell._modified = True
        return out

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (Krueger et al.): randomly preserves previous
    state values."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(data=like * 0.0 + 1.0, p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else next_output * 0.0
        if p_outputs != 0.0:
            output = mask(p_outputs, next_output) * \
                (next_output - prev_output) + prev_output
        else:
            output = next_output
        if p_states != 0.0:
            states = [mask(p_states, ns) * (ns - s) + s
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the output (He et al.): o' = cell(x) + x."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(BaseRNNCell):
    """Runs l_cell forward and r_cell backward over the sequence; only
    supports unroll."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped; use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def _zeros_states(self, data, batch_axis):
        return sum([c._zeros_states(data, batch_axis)
                    for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        inputs, ref, batch_axis = _normalize_sequence(
            length, inputs, input_prefix, layout)
        if begin_state is None:
            begin_state = self._zeros_states(ref, batch_axis)
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout="NTC", merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout="NTC",
            merge_outputs=False)
        outputs = [
            symbol.Concat(l_o, r_o, dim=1,
                          name="%st%d" % (self._output_prefix, i))
            for i, (l_o, r_o) in enumerate(
                zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, l_states + r_states
