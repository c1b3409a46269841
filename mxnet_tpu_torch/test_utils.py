"""Numerics test harness — counterpart of ``mxnet_tpu/test_utils.py``
(the reference's ``python/mxnet/test_utils.py``): array comparisons,
random inputs, central-difference gradients and the symbolic checks
``check_numeric_gradient``, ``check_symbolic_forward``,
``check_symbolic_backward`` and ``check_consistency``, on the port's
executor, whose gradients are torch autograd's.

``default_context()`` is the current context: the card, unless the caller
sets the CPU (``with mt.cpu():``); without CUDA, work on it raises like
every other default-context call.  ``check_consistency`` runs a graph in
several dtypes, as the JAX package's does, and also (``ctx_list``, the
reference's form) on several contexts, such as ``[cpu(), gpu(0)]``.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from .context import Context, current_context
from .ndarray import NDArray
from .symbol import Symbol

__all__ = [
    "default_context", "same", "reldiff", "almost_equal",
    "assert_almost_equal", "rand_shape_nd", "rand_ndarray",
    "numeric_grad", "check_numeric_gradient", "check_symbolic_forward",
    "check_symbolic_backward", "check_consistency",
]

_RTOL = 1e-5
_ATOL = 1e-7


def default_context() -> Context:
    return current_context()


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def same(a, b) -> bool:
    return np.array_equal(_as_numpy(a), _as_numpy(b))


def reldiff(a, b) -> float:
    a = _as_numpy(a).astype(np.float64)
    b = _as_numpy(b).astype(np.float64)
    diff = np.abs(a - b).sum()
    norm = np.abs(a).sum() + np.abs(b).sum()
    if norm == 0:
        return 0.0 if diff == 0 else float("inf")
    return float(diff / norm)


def almost_equal(a, b, rtol=_RTOL, atol=_ATOL) -> bool:
    return np.allclose(_as_numpy(a), _as_numpy(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=_RTOL, atol=_ATOL, names=("a", "b")):
    a_np, b_np = _as_numpy(a), _as_numpy(b)
    if not np.allclose(a_np, b_np, rtol=rtol, atol=atol):
        idx = np.unravel_index(
            np.argmax(np.abs(a_np.astype(np.float64) -
                             b_np.astype(np.float64))),
            a_np.shape) if a_np.shape else ()
        raise AssertionError(
            "Arrays %s, %s not almost equal (rtol=%g atol=%g); worst at %s: "
            "%r vs %r" % (names[0], names[1], rtol, atol, idx,
                          a_np[idx] if a_np.shape else a_np,
                          b_np[idx] if b_np.shape else b_np))


def rand_shape_nd(ndim, dim=6):
    return tuple(np.random.randint(1, dim + 1, size=ndim).tolist())


def rand_ndarray(shape, ctx=None, dtype=np.float32, scale=1.0):
    return nd.array(np.random.uniform(-scale, scale, size=shape).astype(dtype),
                    ctx=ctx)


# ---------------------------------------------------------------------------
# finite differences
# ---------------------------------------------------------------------------


def numeric_grad(f, arrays, eps=1e-4):
    """Central-difference gradient of the scalar ``f(dict of numpy)`` with
    respect to each array: a dict of the same names and shapes."""
    arrays = {k: np.asarray(v, dtype=np.float64).copy()
              for k, v in arrays.items()}
    grads = {}
    for name, arr in arrays.items():
        g = np.zeros_like(arr)
        flat, gflat = arr.reshape(-1), g.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            fp = f(arrays)
            flat[i] = orig - eps
            fm = f(arrays)
            flat[i] = orig
            gflat[i] = (fp - fm) / (2 * eps)
        grads[name] = g
    return grads


def _bind_with(sym: Symbol, location, aux_states=None, grad_req="write",
               ctx=None, dtype=np.float32):
    ctx = ctx or default_context()
    args = {k: nd.array(np.asarray(v, dtype=dtype), ctx=ctx)
            for k, v in location.items()}
    aux = None
    if aux_states:
        aux = {k: nd.array(np.asarray(v, dtype=dtype), ctx=ctx)
               for k, v in aux_states.items()}
    grads = None
    if grad_req != "null":
        grads = {k: nd.zeros(np.asarray(v).shape, ctx, dtype=dtype)
                 for k, v in location.items()}
    return sym.bind(ctx, args, args_grad=grads, grad_req=grad_req,
                    aux_states=aux)


def _normalize_location(sym: Symbol, location):
    if isinstance(location, dict):
        return dict(location)
    return dict(zip(sym.list_arguments(), location))


def check_numeric_gradient(sym: Symbol, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=1e-3,
                           grad_nodes=None, ctx=None):
    """The executor's gradients (autograd) of the summed outputs against
    central differences of them, for each of ``grad_nodes`` (every
    argument by default)."""
    ctx = ctx or default_context()
    location = _normalize_location(sym, location)
    location = {k: np.asarray(v, dtype=np.float64)
                for k, v in location.items()}
    grad_nodes = list(grad_nodes or location.keys())

    exe = _bind_with(sym, location, aux_states, ctx=ctx)
    outs = exe.forward(is_train=True)
    exe.backward([nd.ones(o.shape, ctx, dtype="float32") for o in outs])
    sym_grads = {k: exe.grad_dict[k].asnumpy() for k in grad_nodes}

    def f(arrs):
        e = _bind_with(sym, arrs, aux_states, grad_req="null", ctx=ctx)
        outs = e.forward(is_train=True)
        return float(sum(o.asnumpy().astype(np.float64).sum() for o in outs))

    for name in grad_nodes:
        arr = location[name].copy()
        num = np.zeros_like(arr)
        flat, nflat = arr.reshape(-1), num.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps
            fp = f(location | {name: arr})
            flat[i] = orig - numeric_eps
            fm = f(location | {name: arr})
            flat[i] = orig
            nflat[i] = (fp - fm) / (2 * numeric_eps)
        assert_almost_equal(sym_grads[name], num, rtol=rtol, atol=atol,
                            names=("symbolic[%s]" % name,
                                   "numeric[%s]" % name))


def check_symbolic_forward(sym: Symbol, location, expected, rtol=1e-5,
                           atol=1e-6, aux_states=None, ctx=None):
    location = _normalize_location(sym, location)
    exe = _bind_with(sym, location, aux_states, grad_req="null", ctx=ctx)
    outs = exe.forward(is_train=False)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    assert len(outs) == len(expected), \
        "output count %d != expected %d" % (len(outs), len(expected))
    for i, (o, e) in enumerate(zip(outs, expected)):
        assert_almost_equal(o, e, rtol=rtol, atol=atol,
                            names=("output[%d]" % i, "expected[%d]" % i))
    return outs


def check_symbolic_backward(sym: Symbol, location, out_grads, expected,
                            rtol=1e-5, atol=1e-6, aux_states=None,
                            grad_req="write", ctx=None):
    ctx = ctx or default_context()
    location = _normalize_location(sym, location)
    exe = _bind_with(sym, location, aux_states, grad_req=grad_req, ctx=ctx)
    exe.forward(is_train=True)
    exe.backward([nd.array(np.asarray(g, dtype=np.float32), ctx)
                  for g in out_grads])
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    for name, e in expected.items():
        assert_almost_equal(exe.grad_dict[name], e, rtol=rtol, atol=atol,
                            names=("grad[%s]" % name, "expected[%s]" % name))
    return exe.grad_dict


def check_consistency(sym: Symbol, location, dtypes=(np.float32, "bfloat16"),
                      rtol=2e-2, atol=1e-2, aux_states=None, ctx_list=None):
    """Run the graph's forward in each dtype of ``dtypes`` on each context
    of ``ctx_list`` (the default context alone when None) and hold every
    run's outputs to the first run's.  Returns the outputs, as float64
    numpy, per run."""
    location = _normalize_location(sym, location)
    runs = [(ctx, dt) for ctx in (ctx_list or [None]) for dt in dtypes]
    results = []
    for ctx, dt in runs:
        exe = _bind_with(sym, location, aux_states, grad_req="null",
                         ctx=ctx, dtype=dt)
        outs = exe.forward(is_train=False)
        results.append([o.asnumpy().astype(np.float64) for o in outs])
    base = results[0]
    for (ctx, dt), res in zip(runs[1:], results[1:]):
        for i, (a, b) in enumerate(zip(base, res)):
            assert_almost_equal(a, b, rtol=rtol, atol=atol,
                                names=("%s %s[%d]" % (runs[0][0], dtypes[0],
                                                      i),
                                       "%s %s[%d]" % (ctx, dt, i)))
    return results
