"""The port's ``WarpCTC`` against the JAX package's, on the CPU, from the same
seeded numpy inputs (mirrors tests/test_ctc.py).

The port writes its own CTC dynamic program (``ops/ctc._ctc_losses``); the
JAX package runs optax's.  Losses and gradients are held within 1e-4 of
the largest |reference|, over labels with repeats, blanks inside the
label row, an all-blank row and labels too long for the frames (a large
finite loss, as optax's log_epsilon gives; their gradients are held to a
float64 run, see the test).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-4


def _close(got, ref, tol=TOL):
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() <= tol * scale


def _net(pkg, T, L):
    return pkg.sym.WarpCTC(data=pkg.sym.Variable("data"),
                           label=pkg.sym.Variable("label"),
                           label_length=L, input_length=T)


def _forward_backward(pkg, data, label, T, L):
    """softmax and the data gradient, with a head gradient that must be
    ignored."""
    ex = _net(pkg, T, L).bind(
        pkg.cpu(), {"data": pkg.nd.array(data, pkg.cpu()),
                    "label": pkg.nd.array(label, pkg.cpu())},
        args_grad={"data": pkg.nd.zeros(data.shape, pkg.cpu())})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(pkg.nd.array(np.full(data.shape, 3.0, np.float32),
                             pkg.cpu()))
    return out, ex.grad_dict["data"].asnumpy()


LABELS = {
    "plain": ([[1, 2, 3, 0], [3, 0, 0, 0], [2, 1, 0, 0]], 8),
    "repeats": ([[1, 1, 2, 2], [3, 3, 3, 0], [4, 4, 0, 0]], 9),
    "interior_zeros": ([[0, 1, 0, 2], [1, 0, 0, 3], [0, 0, 0, 4]], 7),
    "all_blank": ([[0, 0, 0, 0], [2, 0, 0, 0], [1, 2, 0, 0]], 5),
    "infeasible": ([[1, 1, 1, 1], [1, 2, 2, 3], [2, 0, 0, 0]], 4),
}


def _float64_gradient(data, label, T, L):
    """optax's CTC gradient in float64 (jax's x64 mode), the labels
    compacted as the op compacts them."""
    import jax
    import jax.numpy as jnp
    import optax

    n = data.shape[0] // T
    lab = label.reshape(n, L).astype(np.int64)
    lab = np.take_along_axis(lab, np.argsort(lab == 0, axis=1,
                                             kind="stable"), axis=1)
    with jax.enable_x64(True):
        def total(d):
            logits = d.reshape(T, n, -1).transpose(1, 0, 2)
            return jnp.sum(optax.ctc_loss(
                logits, jnp.zeros((n, T)), jnp.asarray(lab),
                jnp.asarray((lab == 0).astype(np.float64)), blank_id=0))

        return np.asarray(jax.grad(total)(jnp.asarray(data, jnp.float64)))


@pytest.mark.parametrize("case", sorted(LABELS))
def test_warpctc_losses_and_gradients_match_jax(case):
    """Losses within 1e-4, softmax and gradients within 1e-4 of the JAX
    package's.  A label too long for its frames has a loss near 1e5, where
    float32 keeps steps of 0.008: its gradient rows are held to optax's in
    float64 instead, within 1e-3 and no further than the JAX package's own
    float32 gradient lies from it."""
    from mxnet_tpu.ops.ctc import _ctc_losses as jax_losses
    from mxnet_tpu_torch.ops.ctc import _ctc_losses
    import jax.numpy as jnp
    import torch

    labels, T = LABELS[case]
    N, L, P = len(labels), 4, 5
    rng = np.random.RandomState(0)
    data = rng.randn(T * N, P).astype(np.float32)
    label = np.asarray(labels, np.float32)
    ref_loss = np.asarray(jax_losses(jnp.asarray(data), jnp.asarray(label),
                                     T, L))
    got_loss = _ctc_losses(torch.tensor(data), torch.tensor(label), T,
                           L).numpy()
    assert np.isfinite(got_loss).all()
    _close(got_loss, ref_loss)
    infeasible = got_loss > 1e4
    assert infeasible.any() == (case == "infeasible")
    ref_out, ref_grad = _forward_backward(mx, data, label, T, L)
    got_out, got_grad = _forward_backward(mt, data, label, T, L)
    _close(got_out, ref_out)
    assert np.isfinite(got_grad).all()
    rows = np.tile(infeasible, T)  # row t * N + n belongs to sample n
    _close(got_grad[~rows], ref_grad[~rows])
    if infeasible.any():
        g64 = _float64_gradient(data, label, T, L)[rows]
        got_err = np.abs(got_grad[rows] - g64).max()
        assert got_err <= 1e-3
        assert got_err <= np.abs(ref_grad[rows] - g64).max()


def _ctc_loss_np(logp, labels):
    """Dense CTC forward (log domain) for one sample: logp (T, P), labels
    without blanks."""
    ext = [0]
    for lab in labels:
        ext += [lab, 0]
    S, T = len(ext), logp.shape[0]
    alpha = np.full((T, S), -np.inf)
    alpha[0, 0] = logp[0, ext[0]]
    if S > 1:
        alpha[0, 1] = logp[0, ext[1]]
    for t in range(1, T):
        for s in range(S):
            cands = [alpha[t - 1, s]]
            if s >= 1:
                cands.append(alpha[t - 1, s - 1])
            if s >= 2 and ext[s] != 0 and ext[s] != ext[s - 2]:
                cands.append(alpha[t - 1, s - 2])
            alpha[t, s] = np.logaddexp.reduce(cands) + logp[t, ext[s]]
    return -np.logaddexp.reduce(alpha[T - 1, max(0, S - 2):])


def test_warpctc_gradient_matches_dense_oracle():
    """The port's gradient against central differences of a numpy CTC."""
    T, N, P, L = 6, 2, 5, 3
    rng = np.random.RandomState(1)
    data = (rng.randn(T * N, P) * 0.5).astype(np.float32)
    labels = [[2, 3, 0], [1, 0, 0]]
    _, got = _forward_backward(mt, data, np.array(labels, np.float32), T, L)

    def total(flat):
        x = flat.reshape(T, N, P)
        logp = x - x.max(-1, keepdims=True)
        logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
        return sum(_ctc_loss_np(logp[:, n], [v for v in labels[n] if v])
                   for n in range(N))

    flat = data.reshape(-1).astype(np.float64)
    num = np.zeros_like(flat)
    for i in range(flat.size):
        up, dn = flat.copy(), flat.copy()
        up[i] += 1e-4
        dn[i] -= 1e-4
        num[i] = (total(up) - total(dn)) / 2e-4
    np.testing.assert_allclose(got.reshape(-1), num, rtol=1e-2, atol=1e-3)


def test_warpctc_label_takes_no_gradient_and_infers_its_shape():
    for pkg in (mx, mt):
        net = _net(pkg, 5, 3)
        arg_shapes, out_shapes, _ = net.infer_shape(data=(10, 4))
        assert arg_shapes == [(10, 4), (2, 3)] and out_shapes == [(10, 4)]
        ex = net.simple_bind(pkg.cpu(), data=(10, 4))
        assert "label" not in ex.grad_dict


def test_warpctc_training_drives_loss_down():
    """Gradient descent on the rows themselves halves the loss."""
    from mxnet_tpu_torch.ops.ctc import _ctc_losses
    import torch

    T, N, P, L = 8, 4, 4, 2
    rng = np.random.RandomState(3)
    data = mt.nd.array((rng.randn(T * N, P) * 0.1).astype(np.float32),
                       mt.cpu())
    label = mt.nd.array(np.tile([1, 2], (N, 1)).astype(np.float32), mt.cpu())
    grad = mt.nd.zeros((T * N, P), mt.cpu())
    ex = _net(mt, T, L).bind(mt.cpu(), {"data": data, "label": label},
                             args_grad={"data": grad})

    def loss_now():
        return float(_ctc_losses(data._data, label._data, T, L).sum())

    before = loss_now()
    for _ in range(30):
        ex.forward(is_train=True)
        ex.backward()
        data[:] = data - 0.5 * grad
    assert loss_now() < before * 0.5


def _ocr_net(pkg, T, L, H, classes):
    """examples/warpctc/lstm_ocr.py's graph."""
    with pkg.NameManager():
        cell = pkg.rnn.LSTMCell(num_hidden=H, prefix="lstm_")
        outputs, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                 layout="NTC", merge_outputs=True)
        tm = pkg.sym.transpose(outputs, axes=(1, 0, 2))
        pred = pkg.sym.Reshape(tm, shape=(-1, H))
        pred = pkg.sym.FullyConnected(pred, num_hidden=classes + 1,
                                      name="pred")
        return pkg.sym.WarpCTC(data=pred, label=pkg.sym.Variable("label"),
                               label_length=L, input_length=T)


def test_lstm_ocr_net_trains_like_jax():
    """The OCR net through Module: symbol JSON equal, and the parameters
    after 3 SGD steps from one init within 1e-4."""
    T, L, H, C, F, N = 10, 3, 12, 5, 6, 4
    rng = np.random.RandomState(2)
    X = rng.randn(3, N, T, F).astype(np.float32)
    Y = np.zeros((3, N, L), np.float32)
    for b in range(3):
        for n in range(N):
            k = rng.randint(1, L + 1)
            Y[b, n, :k] = rng.randint(1, C + 1, size=k)
    params = None
    result = {}
    for pkg in (mx, mt):
        net = _ocr_net(pkg, T, L, H, C)
        mod = pkg.mod.Module(net, data_names=("data",), label_names=("label",),
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", (N, T, F))],
                 label_shapes=[("label", (N, L))])
        if params is None:
            arg_shapes = dict(zip(net.list_arguments(),
                                  net.infer_shape(data=(N, T, F))[0]))
            params = {k: (0.3 * rng.randn(*arg_shapes[k])).astype(np.float32)
                      for k in net.list_arguments()
                      if k not in ("data", "label")}
        mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in params.items()},
                        aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05})
        for b in range(3):
            mod.forward_backward(pkg.io.DataBatch(
                data=[pkg.nd.array(X[b], pkg.cpu())],
                label=[pkg.nd.array(Y[b], pkg.cpu())]))
            mod.update()
        result[pkg] = (net.tojson(), {k: v.asnumpy()
                                      for k, v in mod.get_params()[0].items()})
    assert result[mt][0] == result[mx][0]
    for k, v in result[mx][1].items():
        _close(result[mt][1][k], v)
        assert not np.array_equal(v, params[k])
