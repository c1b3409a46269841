"""``WarpCTC``, the CTC loss layer; counterpart of ``mxnet_tpu/ops/ctc.py``.

The forward is ``softmax(data)`` over the alphabet; the backward is the
CTC gradient with respect to the pre-softmax rows, with the head gradient
ignored (the op is the loss), and a zero gradient for the label.

  * data: 2-D ``(input_length * batch, alphabet)``, time-major rows;
  * label: ``batch * label_length`` ids, blank = 0; the zeros of each row
    are moved to its tail by a stable sort, leaving the label sequence in
    front, as the warp-ctc plugin's blank removal does.

The JAX package runs optax's CTC dynamic program.  ``_ctc_losses`` is the
port's own copy of it in plain torch, with optax's conventions: a log-space
recursion over blank and label states, ``log_epsilon = -1e5`` standing for
log 0 (so a label longer than the frames allow gives a large finite loss,
not inf or NaN), per-sample losses over ``log_softmax`` in float32.  The
gradient is autograd's through that recursion, of the losses' sum, in
data's dtype.
"""
from __future__ import annotations

import torch

from .param import Param
from .registry import register

LOG_EPSILON = -1e5


def _compact_labels(label, n, label_length):
    """(N, L) int64 labels with each row's blanks moved to its tail, the
    others in order."""
    lab = label.reshape(n, label_length).to(torch.int64)
    order = torch.argsort((lab == 0).to(torch.int64), dim=1, stable=True)
    return torch.gather(lab, 1, order)


def _phi_update(phi, added):
    """``phi[:, 1:]`` log-added to ``added``; ``phi[:, 0]`` kept."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)


def _ctc_losses(data, label, input_length, label_length):
    """Per-sample CTC losses (N,), float32. data: (T*N, P) time-major;
    label: N * label_length ids."""
    tn, p = data.shape
    n = tn // input_length
    logprobs = torch.log_softmax(
        data.reshape(input_length, n, p).to(torch.float32), dim=-1)  # (T,N,P)
    lab = _compact_labels(label, n, label_length)                   # (N, L)
    labellens = label_length - (lab == 0).sum(dim=1)
    repeat = torch.zeros(n, label_length, dtype=torch.float32,
                         device=data.device)
    repeat[:, :-1] = (lab[:, :-1] == lab[:, 1:]).to(torch.float32)
    logprobs_phi = logprobs[:, :, 0:1]                               # (T,N,1)
    logprobs_emit = torch.gather(
        logprobs, 2, lab.unsqueeze(0).expand(input_length, n, label_length))

    phi = torch.full((n, label_length + 1), LOG_EPSILON, dtype=torch.float32,
                     device=data.device)
    phi[:, 0] = 0.0
    emit = torch.full((n, label_length), LOG_EPSILON, dtype=torch.float32,
                      device=data.device)
    eps_repeat = LOG_EPSILON * repeat
    eps_other = LOG_EPSILON * (1.0 - repeat)
    for t in range(input_length):
        # emit-to-blank epsilon transition, unless the next label repeats
        prev_phi = _phi_update(phi, emit + eps_repeat)
        lp_emit, lp_phi = logprobs_emit[t], logprobs_phi[t]
        # blank-to-label and label self-loop
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        # blank self-loop; label-to-blank only where the next label repeats
        phi = _phi_update(prev_phi + lp_phi, emit + lp_phi + eps_other)
        emit = next_emit
    last = _phi_update(phi, emit)
    return -torch.gather(last, 1, labellens.unsqueeze(1)).squeeze(1)


class _WarpCTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, input_length, label_length):
        ctx.save_for_backward(data, label)
        ctx.lengths = (input_length, label_length)
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        del ct  # a loss op: the head gradient is ignored
        data, label = ctx.saved_tensors
        with torch.enable_grad():
            x = data.detach().to(torch.float32).requires_grad_(True)
            loss = _ctc_losses(x, label, *ctx.lengths).sum()
            grad, = torch.autograd.grad(loss, x)
        return grad.to(data.dtype), torch.zeros_like(label), None, None


def _warpctc_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    n = d[0] // int(attrs["input_length"])
    lshape = in_shapes[1] if in_shapes[1] is not None \
        else (n, int(attrs["label_length"]))
    return [tuple(d), tuple(lshape)], [tuple(d)], []


@register("WarpCTC", inputs=("data", "label"),
          params={"label_length": Param(int, required=True),
                  "input_length": Param(int, required=True)},
          infer_shape=_warpctc_infer, no_grad_inputs=("label",),
          hint="warpctc")
def _warpctc(opctx, attrs, data, label):
    return _WarpCTC.apply(data, label, int(attrs["input_length"]),
                          int(attrs["label_length"]))
