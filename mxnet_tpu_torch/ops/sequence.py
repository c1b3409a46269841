"""Sequence ops: ``SequenceLast``, ``SequenceMask`` and ``SequenceReverse``.

Counterparts of ``mxnet_tpu/ops/sequence.py``, with the same names,
parameters and shape rule.  Data is time-major (T, N, ...);
``use_sequence_length`` adds the per-sample length input, which takes no
gradient.  Lengths are truncated toward zero, as ``astype(int32)`` does in
the JAX package.  A length past T reads step T - 1 and gives that read no
gradient, as the JAX package's gathers do (they clamp the index, and their
transpose drops what lies out of range); a kept reference defect.
"""
from __future__ import annotations

import torch

from .param import Param
from .registry import register


def _seq_inputs(attrs):
    if attrs.get("use_sequence_length"):
        return ["data", "sequence_length"]
    return ["data"]


_SEQ_SPEC = {"use_sequence_length": Param(bool, False)}


def _seq_last_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if attrs.get("use_sequence_length"):
        return [d, (d[1],)], [tuple(d[1:])], []
    return in_shapes, [tuple(d[1:])], []


def _lengths(seq_len):
    return seq_len.to(torch.int64)


def _steps(data, src, batch):
    """``data[src, batch]`` with ``src`` clamped to the last step; a read
    past it takes no gradient."""
    last = data.shape[0] - 1
    out = data[torch.clamp(src, max=last), batch]
    inside = (src <= last).reshape(tuple(src.shape) + (1,) * (out.ndim -
                                                              src.ndim))
    return torch.where(inside, out, out.detach())


@register("SequenceLast", inputs=_seq_inputs, params=dict(_SEQ_SPEC),
          infer_shape=_seq_last_infer, no_grad_inputs=("sequence_length",),
          hint="sequencelast")
def _sequence_last(opctx, attrs, data, *rest):
    """Each sample's last valid step: ``data[length - 1, n]`` (step 0 for a
    length of 0)."""
    if not attrs.get("use_sequence_length") or not rest:
        return data[-1]
    idx = torch.clamp(_lengths(rest[0]) - 1, min=0)
    batch = torch.arange(data.shape[1], device=data.device)
    return _steps(data, idx, batch)


@register("SequenceMask", inputs=_seq_inputs,
          params={**_SEQ_SPEC, "value": Param(float, 0.0)},
          no_grad_inputs=("sequence_length",), hint="sequencemask")
def _sequence_mask(opctx, attrs, data, *rest):
    """Steps at or past each sample's length set to ``value``."""
    if not attrs.get("use_sequence_length") or not rest:
        return data
    t = torch.arange(data.shape[0], device=data.device)
    mask = t[:, None] < _lengths(rest[0])[None, :]  # (T, N)
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    fill = torch.full((), attrs.get("value", 0.0), dtype=data.dtype,
                      device=data.device)
    return torch.where(mask, data, fill)


@register("SequenceReverse", inputs=_seq_inputs, params=dict(_SEQ_SPEC),
          no_grad_inputs=("sequence_length",), hint="sequencereverse")
def _sequence_reverse(opctx, attrs, data, *rest):
    """Each sample's first ``length`` steps reversed; the steps past its
    length stay where they are."""
    if not attrs.get("use_sequence_length") or not rest:
        return torch.flip(data, dims=(0,))
    seq_len = _lengths(rest[0])[None, :]
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    # the step that lands at position t after the per-sample reversal
    src = torch.where(t < seq_len, seq_len - 1 - t, t)  # (T, N)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return _steps(data, src, batch)
