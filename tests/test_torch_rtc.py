"""``mt.rtc.MXRtc`` against ``mxnet_tpu.rtc.MXRtc`` on the CPU: the JAX
package's own kernel source run verbatim through both (JAX in Pallas
interpret mode, the port on ``mt.cpu()``), the same errors, the CUDA source
the card's route generates, the route rule, and the user kernels of
``rtc_kernels`` (Python-source route) against the port's plain ops and the
JAX package.  The CUDA route itself compiles and runs only on the card:
``chip_smoke.py`` holds it against these plain versions there.

Tolerances: the axpy and sgd kernels are exact (the same float32 operations
in the same order); gelu and its derivative within 1e-6 of the largest
value, float32 erf and exp evaluated by different libraries."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import cuda_rtc, rtc_kernels as rk
from mxnet_tpu_torch.rtc import cuda_source, is_python_source, launch_dims

# mxnet_tpu/rtc.py's own example, as tests/test_rtc_torch_models.py runs it
AXPY_SRC = """
    def kernel(x_ref, y_ref, out_ref):
        out_ref[...] = 2.0 * x_ref[...] + y_ref[...]
    """


def _both(np_arrays):
    return ([mx.nd.array(a) for a in np_arrays],
            [mt.nd.array(a, mt.cpu()) for a in np_arrays])


def test_axpy_source_verbatim_in_both_packages():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4).astype(np.float32)
    y = rng.randn(2, 4).astype(np.float32)
    (jx, jy, jo), (tx, ty, to) = _both([x, y, np.zeros((2, 4), np.float32)])
    jk = mx.rtc.MXRtc("axpy", [("x", jx), ("y", jy)], [("out", jo)], AXPY_SRC)
    tk = mt.rtc.MXRtc("axpy", [("x", tx), ("y", ty)], [("out", to)], AXPY_SRC)
    assert tk.route == "python"
    jk.push([jx, jy], [jo])
    assert tk.push([tx, ty], [to]) == [to]
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())
    np.testing.assert_array_equal(to.asnumpy(), 2 * x + y)
    # a second push on other arrays reuses the compiled kernel (__call__)
    jk([jy, jy], [jo])
    tk([ty, ty], [to])
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())


def test_python_route_sees_inputs_before_an_aliased_output_is_written():
    """push([w, g], [w]) in place: the kernel reads w as it was."""
    src = """
    def kernel(w_ref, g_ref, out_ref):
        out_ref[...] = g_ref[...]
        out_ref[...] = out_ref[...] + 10.0 * w_ref[...]
    """
    w = mt.nd.array(np.arange(4, dtype=np.float32), mt.cpu())
    g = mt.nd.ones((4,), mt.cpu())
    mt.rtc.MXRtc("upd", [("w", w), ("g", g)], [("out", w)], src).push(
        [w, g], [w])
    np.testing.assert_array_equal(w.asnumpy(), 1 + 10 * np.arange(4))


@pytest.mark.parametrize("src", ["def kernel(: syntax",
                                 "def a(x, o):\n    pass\ndef b(x, o):\n    pass"],
                         ids=["syntax", "two-functions"])
def test_bad_source_raises_in_both(src):
    x = np.ones((2,), np.float32)
    (jx,), (tx,) = _both([x])
    with pytest.raises(mx.base.MXNetError) as jerr:
        mx.rtc.MXRtc("bad", [("x", jx)], [("o", jx)], src)
    with pytest.raises(mt.MXNetError) as terr:
        mt.rtc.MXRtc("bad", [("x", tx)], [("o", tx)], src)
    if "syntax" in src:
        assert "compile" in str(jerr.value) and "compile" in str(terr.value)
    else:
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["n_inputs", "input_shape", "n_outputs",
                                  "output_shape"])
def test_prototype_errors_match(case):
    x = np.ones((2, 4), np.float32)
    bad = np.ones((3, 4), np.float32)
    (jx, jbad), (tx, tbad) = _both([x, bad])
    pushes = {"n_inputs": lambda x_, b_: ([x_], [x_]),
              "input_shape": lambda x_, b_: ([x_, b_], [x_]),
              "n_outputs": lambda x_, b_: ([x_, x_], [x_, x_]),
              "output_shape": lambda x_, b_: ([x_, x_], [b_])}[case]
    errors = []
    for pkg, xx, bb in ((mx, jx, jbad), (mt, tx, tbad)):
        krnl = pkg.rtc.MXRtc("axpy", [("x", xx), ("y", xx)], [("out", xx)],
                             AXPY_SRC)
        with pytest.raises(Exception) as err:
            krnl.push(*pushes(xx, bb))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "axpy" in errors[1]


def test_cuda_signature_for_f32_and_bf16_prototypes():
    src = cuda_source("scale", [("x", (2, 3), torch.bfloat16),
                                ("s", (), torch.float32)],
                      [("y", (2, 3), torch.float32)],
                      "\n    y[0] = s[0];\n")
    assert src == (
        "#include <cuda_bf16.h>\n"
        'extern "C" __global__ void scale(const __nv_bfloat16* x, '
        "const float* s, float* y) {\n"
        "  const int x_ndim = 2;\n"
        "  const int x_dims[] = {2, 3};\n"
        "  const long long x_size = 6LL;\n"
        "  const int s_ndim = 0;\n"
        "  const int s_dims[] = {1};\n"
        "  const long long s_size = 1LL;\n"
        "  const int y_ndim = 2;\n"
        "  const int y_dims[] = {2, 3};\n"
        "  const long long y_size = 6LL;\n"
        "  y[0] = s[0];\n"
        "}\n")
    f32 = cuda_source("k", [("a", (4,), torch.float32)],
                      [("b", (4,), torch.float32)], "b[0] = a[0];")
    assert "#include" not in f32
    assert 'extern "C" __global__ void k(const float* a, float* b) {' in f32


def test_mxrtc_builds_the_cuda_source_from_its_prototypes():
    x = mt.nd.zeros((2, 4), mt.cpu(), dtype="bfloat16")
    out = mt.nd.zeros((2, 4), mt.cpu())
    krnl = mt.rtc.MXRtc("axpy", [("x", x), ("y", out)], [("out", out)],
                        rk.AXPY_CUDA)
    assert krnl.route == "cuda"
    assert krnl.source == cuda_source(
        "axpy", [("x", (2, 4), torch.bfloat16), ("y", (2, 4), torch.float32)],
        [("out", (2, 4), torch.float32)], rk.AXPY_CUDA)
    with pytest.raises(mt.MXNetError, match="not a C identifier"):
        mt.rtc.MXRtc("bad name", [("x", x)], [("out", out)], rk.AXPY_CUDA)
    with pytest.raises(mt.MXNetError, match="dtype"):
        mt.rtc.MXRtc("k", [("x", mt.nd.zeros((2,), mt.cpu(), "int64"))],
                     [("out", out)], rk.AXPY_CUDA)


def test_cuda_source_pushed_on_cpu_raises_and_never_falls_back():
    x = mt.nd.ones((2, 4), mt.cpu())
    out = mt.nd.zeros((2, 4), mt.cpu())
    krnl = mt.rtc.MXRtc("axpy", [("x", x), ("y", x)], [("out", out)],
                        rk.AXPY_CUDA)
    with pytest.raises(mt.MXNetError, match="CUDA arrays only"):
        krnl.push([x, x], [out])
    np.testing.assert_array_equal(out.asnumpy(), 0)
    assert "rtc:axpy" not in mt.kernels.LAUNCHES or \
        mt.kernels.LAUNCHES["rtc:axpy"] == 0


def test_python_source_pushed_off_the_cpu_raises():
    """The Python route runs on CPU arrays only (here a meta tensor stands
    in for one on the card)."""
    x = mt.nd.ones((2, 4), mt.cpu())
    krnl = mt.rtc.MXRtc("axpy", [("x", x), ("y", x)], [("out", x)], AXPY_SRC)
    off = mt.nd.NDArray(torch.empty((2, 4), device="meta"), mt.cpu())
    with pytest.raises(mt.MXNetError, match="CPU arrays only.*meta"):
        krnl.push([off, x], [x])
    with pytest.raises(mt.MXNetError, match="dtype"):
        krnl.push([x, x], [mt.nd.zeros((2, 4), mt.cpu(), dtype="float16")])


@pytest.mark.parametrize("src,python", [
    (AXPY_SRC, True),
    ("\n# a comment\n\ndef k(x, o):\n    o[...] = x[...]\n", True),
    ("def\tk(x, o):\n    o[...] = x[...]\n", True),
    (rk.AXPY_CUDA, False),
    ("// defines\nout[0] = x[0];\n", False),
    ("#include <cuda_fp16.h>\ndefault_value();\n", False),
    ("", False),
])
def test_route_rule(src, python):
    assert is_python_source(src) is python


def test_launch_dims():
    assert launch_dims(1000) == ((4, 1, 1), (256, 1, 1))
    assert launch_dims(256) == ((1, 1, 1), (256, 1, 1))
    assert launch_dims(0)[0][0] == 0
    assert launch_dims(10, (3, 2), (32, 8)) == ((3, 2, 1), (32, 8, 1))
    for grid, block in (((1,), None), ((0,), (1,)), ((1,), (2048,)),
                        ((1, 70000), (1,)), ((1,), (1, 1, 1, 1))):
        with pytest.raises(mt.MXNetError):
            launch_dims(10, grid, block)


def test_missing_nvrtc_names_where_it_looked(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    dirs, names = cuda_rtc.nvrtc_search()
    assert dirs[0] == str(tmp_path / "lib64")
    assert names[-4:] == ["libnvrtc.so", "libnvrtc.so.13", "libnvrtc.so.12",
                          "libnvrtc.so.11.2"]
    with pytest.raises(mt.MXNetError) as err:
        cuda_rtc._load("libnvrtc", ["libnvrtc-missing.so.0"], dirs)
    assert str(tmp_path / "lib64") in str(err.value)
    assert "loader" in str(err.value)


def test_axpy_user_kernel_python_route_matches_plain_and_jax():
    rng = np.random.RandomState(1)
    x, y = (rng.randn(37, 29).astype(np.float32) for _ in range(2))
    out = torch.zeros(37, 29)
    rk.axpy(torch.tensor(x), torch.tensor(y), out)
    np.testing.assert_array_equal(out.numpy(), rk.axpy_plain(
        torch.tensor(x), torch.tensor(y)).numpy())
    assert rk.axpy_dims((37, 29)) == ((1, 5, 1), (32, 8, 1))


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_sgd_user_kernel_matches_port_and_jax(wd):
    """Two in-place pushes against the port's sgd_update (bit-exact) and
    the JAX package's sgd_update (within 1 float32 ulp)."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(513).astype(np.float32) * 0.1
    g = rng.randn(513).astype(np.float32)
    w = torch.tensor(w0)
    ref = torch.tensor(w0)
    jw = mx.nd.array(w0)
    hp = rk.sgd_hyper(0.05, 0.5, wd)
    for _ in range(2):
        rk.sgd_update(w, torch.tensor(g), hp)
        mt.nd.sgd_update(ref, torch.tensor(g), out=ref, lr=0.05,
                         rescale_grad=0.5, wd=wd)
        mx.nd.sgd_update(jw, mx.nd.array(g), out=jw, lr=0.05,
                         rescale_grad=0.5, wd=wd)
    assert torch.equal(w, ref)
    np.testing.assert_allclose(w.numpy(), jw.asnumpy(), rtol=2e-7, atol=0)


def test_gelu_user_kernels_match_jax():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    x = (rng.randn(33, 65) * 3).astype(np.float32)
    dy = rng.randn(33, 65).astype(np.float32)
    y = rk.gelu_forward(torch.tensor(x)).numpy()
    dx = rk.gelu_backward(torch.tensor(x), torch.tensor(dy)).numpy()
    jy, vjp = jax.vjp(lambda v: jax.nn.gelu(v, approximate=False),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    for got, ref in ((y, np.asarray(jy)), (dx, np.asarray(jdx))):
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_array_equal(y, rk.gelu_plain(torch.tensor(x)).numpy())
    np.testing.assert_array_equal(dx, rk.gelu_grad_plain(
        torch.tensor(x), torch.tensor(dy)).numpy())
    # bf16 in and out, arithmetic in float32: the plain version's bits
    xb = torch.tensor(x).to(torch.bfloat16)
    assert torch.equal(rk.gelu_forward(xb), rk.gelu_plain(xb))
    assert rk.gelu_forward(xb).dtype == torch.bfloat16


def test_user_kernels_count_no_launch_on_the_cpu():
    """LAUNCHES counts kernel launches on the card: the CPU route is the
    plain version and adds nothing."""
    mt.kernels.reset_launches()
    before = dict(mt.kernels.LAUNCHES)
    rk.gelu_forward(torch.ones(4))
    assert mt.kernels.LAUNCHES == before
    mt.kernels.count("rtc:probe")
    assert mt.kernels.LAUNCHES["rtc:probe"] == 1
    mt.kernels.reset_launches()
    assert mt.kernels.LAUNCHES["rtc:probe"] == 0


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [0, 1, 7, 2048, 2049, 16384 * 8192,
                               16384 * 8192 + 1])
def test_gelu_dims_cover_n_at_the_vector_width(n, itemsize):
    """256-thread blocks, one 16-byte vector (8 bf16, 4 float) a thread
    per pass: a short input gets just the blocks that cover it in one
    pass, a long one ``GELU_BLOCKS_PER_SM`` blocks per SM that the
    grid-stride loop walks over it."""
    sms = 132
    grid, block = rk.gelu_dims(n, itemsize, sms)
    assert block == (256, 1, 1) and grid[1:] == (1, 1)
    per_pass = grid[0] * 256 * (16 // itemsize)
    cap = rk.GELU_BLOCKS_PER_SM * sms
    assert 1 <= grid[0] <= cap
    if grid[0] < cap:
        assert per_pass >= n and (grid[0] - 1) * 256 * (16 // itemsize) < max(n, 1)
    else:
        assert n > (cap - 1) * 256 * (16 // itemsize)
    assert launch_dims(n, *rk.gelu_dims(n, itemsize, sms)) == (grid, block)


def test_gelu_forward_cpu_route_on_odd_and_misaligned_views():
    """The edges the card's vector loop leaves to its scalar loop: an odd
    length and a contiguous view 2 (bf16) or 4 (float32) bytes past a
    16-byte boundary.  The CPU route gives ``gelu_plain``'s bits and the
    JAX package's exact gelu within 1e-6 of the largest value."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    flat = torch.tensor((rng.randn(1001) * 3).astype(np.float32))
    for x in (flat, flat[1:], flat[1:].view(40, 25)):
        for t in (x, x.to(torch.bfloat16)):
            y = rk.gelu_forward(t)
            assert y.dtype == t.dtype and y.shape == t.shape
            assert torch.equal(y, rk.gelu_plain(t))
        ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()),
                                     approximate=False))
        got = rk.gelu_forward(x).numpy()
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert flat[1:].data_ptr() % 16 == 4
    assert flat.to(torch.bfloat16)[1:].data_ptr() % 16 == 2


def test_gelu_backward_cpu_route_on_odd_and_misaligned_views():
    """``gelu_backward`` on the views its vector loop leaves to the scalar
    loop on the card: an odd length, and x and dy 2 (bf16) or 4 (float32)
    bytes past a 16-byte boundary.  The CPU route gives
    ``gelu_grad_plain``'s bits, and in float32 the JAX package's gradient
    of the exact gelu within 1e-6 of the largest value."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    f32 = (torch.tensor((rng.randn(1001) * 3).astype(np.float32)),
           torch.tensor(rng.randn(1001).astype(np.float32)))
    for dtype in (torch.float32, torch.bfloat16):
        fx, fdy = (t.to(dtype) for t in f32)
        for x, dy in ((fx, fdy), (fx[1:], fdy[1:]), (fx[1:], fdy[:-1]),
                      (fx[1:].view(40, 25), fdy[1:].view(40, 25))):
            got = rk.gelu_backward(x, dy)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(got, rk.gelu_grad_plain(x, dy))
            if dtype == torch.bfloat16:
                continue
            _, vjp = jax.vjp(lambda v: jax.nn.gelu(v, approximate=False),
                             jnp.asarray(x.numpy()))
            (ref,) = vjp(jnp.asarray(dy.numpy()))
            ref = np.asarray(ref)
            assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        assert fx[1:].data_ptr() % 16 == fx.element_size()


# -- the CUDA route's launch plan, with libcuda and the card stood in for --
#
# ``MXRtc``'s CUDA route builds one launch plan per device at its first
# push (the function and the kernelParams block) and then checks, fills
# and launches.  These tests run that path on the
# CPU: ``_FakeCuda`` records what would reach libcuda, ``_FakeTensor`` is
# an array on the card (its device, dtype, shape and data pointer).

class _FakeTensor:
    is_cuda = True

    def __init__(self, ptr, shape, dtype=torch.float32, index=0,
                 contiguous=True):
        self._ptr, self.shape, self.dtype = ptr, torch.Size(shape), dtype
        self.device = torch.device("cuda", index)
        self._contiguous = contiguous

    @property
    def _data(self):  # as an NDArray hands MXRtc its tensor
        return self

    def data_ptr(self):
        return self._ptr

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return self._contiguous

    def contiguous(self):
        assert self._contiguous
        return self

    def to(self, dtype):
        assert dtype == self.dtype
        return self

    def element_size(self):
        return torch.tensor([], dtype=self.dtype).element_size()


class _FakeCuda:
    """libcuda's entries the CUDA route calls, recording them; the launch
    reads kernelParams value by value, yielding between the reads."""

    def __init__(self, n_args):
        self.n_args = n_args
        self.current = None
        self.calls, self.launches = [], []

    def cuDeviceGet(self, ref, device):
        ref._obj.value = device
        return 0

    def cuDevicePrimaryCtxRetain(self, ref, dev):
        ref._obj.value = 0x1000 + dev.value
        return 0

    def cuCtxGetCurrent(self, ptr):
        self.calls.append("get")
        ptr.contents.value = self.current
        return 0

    def cuCtxSetCurrent(self, ctx):
        self.calls.append("set")
        self.current = ctx.value
        return 0

    def cuLaunchKernel(self, func, gx, gy, gz, bx, by, bz, shmem, stream,
                       params, extra):
        import ctypes
        import time

        values = []
        for i in range(self.n_args):
            values.append(ctypes.c_void_p.from_address(params[i]).value)
            time.sleep(0)
        self.launches.append((func, (gx, gy, gz), (bx, by, bz), stream,
                              tuple(values)))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """(the fake libcuda for 3-argument kernels, the function lookups)."""
    import ctypes

    from mxnet_tpu_torch import rtc

    lib = _FakeCuda(3)
    lookups = []

    def function(source, name, device):
        lookups.append((name, device))
        return ctypes.c_void_p(0xF00 + device)

    monkeypatch.setattr(cuda_rtc, "_libcuda", lambda: lib)
    monkeypatch.setattr(cuda_rtc, "_PRIMARY", {})
    monkeypatch.setattr(cuda_rtc, "function", function)
    monkeypatch.setattr(rtc, "_current_device", lambda: 0)
    monkeypatch.setattr(rtc, "_stream", lambda index: 0x5000 + index)
    mt.kernels.reset_launches()
    return lib, lookups


def _axpy_on_card(n=1000):
    x, y, out = (_FakeTensor(0x100 * (i + 1), (n,)) for i in range(3))
    return mt.rtc.MXRtc("axpy", [("x", x), ("y", y)], [("out", out)],
                        rk.AXPY_CUDA), (x, y, out)


def test_push_plan_looks_the_function_up_once(fake_card):
    lib, lookups = fake_card
    krnl, (x, y, out) = _axpy_on_card()
    for i in range(5):
        arrays = [_FakeTensor(0x10000 * (i + 1) + j, (1000,))
                  for j in range(3)]
        krnl.push(arrays[:2], arrays[2:])
    assert lookups == [("axpy", 0)]
    assert len(lib.launches) == 5
    assert mt.kernels.LAUNCHES["rtc:axpy"] == 5


def test_push_plan_sets_the_context_only_when_another_is_current(fake_card):
    lib, _ = fake_card
    krnl, (x, y, out) = _axpy_on_card()
    krnl.push([x, y], [out])  # no context current yet: set it
    assert lib.calls == ["get", "set"] and lib.current == 0x1000
    krnl.push([x, y], [out])
    krnl.push([x, y], [out])
    assert lib.calls == ["get", "set", "get", "get"]
    lib.current = 0x2000  # another context made current meanwhile
    krnl.push([x, y], [out])
    assert lib.calls[-2:] == ["get", "set"] and lib.current == 0x1000


def test_push_plan_passes_pointers_in_argument_order(fake_card):
    lib, _ = fake_card
    krnl, (x, y, out) = _axpy_on_card(1000)
    krnl.push([x, y], [out])
    krnl.push([y, out], [x])
    krnl.push([x, y], [out], grid_dims=(3, 2), block_dims=(32, 8))
    (f0, g0, b0, s0, v0), (_, _, _, _, v1), (_, g2, b2, _, _) = lib.launches
    assert f0.value == 0xF00 and s0 == 0x5000
    assert (g0, b0) == ((4, 1, 1), (256, 1, 1))  # 1000 elements
    assert v0 == (0x100, 0x200, 0x300) and v1 == (0x200, 0x300, 0x100)
    assert (g2, b2) == ((3, 2, 1), (32, 8, 1))


def test_push_plan_threads_never_mix_their_pointers(fake_card):
    import sys
    import threading

    lib, _ = fake_card
    krnl, _ = _axpy_on_card()
    sets = [tuple(0x100000 * (t + 1) + 0x100 * j for j in range(3))
            for t in range(2)]
    arrays = [[_FakeTensor(p, (1000,)) for p in s] for s in sets]
    errors = []

    def pusher(a):
        try:
            for _ in range(200):
                krnl.push(a[:2], a[2:])
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=pusher, args=(a,))
                   for a in arrays]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert len(lib.launches) == 400
    assert {launch[4] for launch in lib.launches} == set(sets)


@pytest.mark.parametrize("case", ["input_shape", "output_shape"])
def test_push_plan_keeps_the_prototype_errors(fake_card, case):
    """After the plan is built, a push that breaks a prototype still raises
    the JAX package's text; a dtype, a device or a layout the CUDA route
    does not take raises the port's, and nothing launches."""
    lib, _ = fake_card
    krnl, (x, y, out) = _axpy_on_card(8)
    krnl.push([x, y], [out])
    bad = _FakeTensor(0x900, (9,))
    jx = mx.nd.zeros((8,))
    jbad = mx.nd.zeros((9,))
    jk = mx.rtc.MXRtc("axpy", [("x", jx), ("y", jx)], [("out", jx)],
                      AXPY_SRC)
    port, jax_ = {"input_shape": (([x, bad], [out]), ([jx, jbad], [jx])),
                  "output_shape": (([x, y], [bad]), ([jx, jx], [jbad]))}[case]
    with pytest.raises(mt.MXNetError) as err:
        krnl.push(*port)
    with pytest.raises(mx.base.MXNetError) as jerr:
        jk.push(*jax_)
    assert str(err.value) == str(jerr.value)
    for other, text in (
            (_FakeTensor(0x900, (8,), torch.bfloat16), "the prototype"),
            (_FakeTensor(0x900, (8,), index=1), "the prototype"),
            (_FakeTensor(0x900, (8,), contiguous=False), "not contiguous")):
        with pytest.raises(mt.MXNetError, match=text):
            krnl.push([x, other], [out])
    assert len(lib.launches) == 1


def test_user_kernel_cache_refuses_an_input_off_its_prototype():
    """``rtc_kernels`` caches a kernel by its output's device, shape and
    dtype; an input of another shape meets the prototype check."""
    w, g = torch.zeros(6), torch.ones(6)
    hp = rk.sgd_hyper(0.5)
    rk.sgd_update(w, g, hp)
    assert torch.equal(w, torch.full((6,), -0.5))
    with pytest.raises(mt.MXNetError, match="input g shape .*prototype"):
        rk.sgd_update(w, torch.ones(3), hp)


def test_user_kernel_cache_keys_the_inputs_dtypes(fake_card, monkeypatch):
    """A float32 and a bfloat16 gradient of one weight shape each get a
    kernel of their own C types on the card, whichever came first, and go
    through on the CPU alike."""
    lib, lookups = fake_card
    lib.n_args = 4
    monkeypatch.setattr(rk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(rk, "_CACHE", {})
    w, hp = _FakeTensor(0x1000, (100,)), _FakeTensor(0x30, (3,))
    for i, dtype in enumerate((torch.float32, torch.bfloat16,
                               torch.float32, torch.bfloat16)):
        rk.sgd_update(w, _FakeTensor(0x2000 + 0x100 * i, (100,), dtype), hp)
    assert lookups == [("sgd_update", 0)] * 2
    assert [v[1] for *_, v in lib.launches] == [0x2000, 0x2100, 0x2200,
                                                0x2300]
    g_args = sorted(line for krnl, _ in rk._CACHE.values()
                    for line in krnl.source.splitlines() if "void" in line)
    assert len(g_args) == 2
    assert "const __nv_bfloat16* g" in g_args[0]
    assert "const float* g" in g_args[1]
    w, hp = torch.zeros(6), rk.sgd_hyper(0.5)
    rk.sgd_update(w, torch.ones(6), hp)
    rk.sgd_update(w, torch.ones(6, dtype=torch.bfloat16), hp)
    assert torch.equal(w, torch.full((6,), -1.0))


def test_sgd_update_on_the_card_pushes_w_g_hp_w_with_stride_dims(
        fake_card, monkeypatch):
    """``rtc_kernels.sgd_update`` through the plan: one lookup per output
    shape, the pointers (w, g, hp, w) in argument order, and the
    grid-stride dims of ``sgd_dims``."""
    lib, lookups = fake_card
    lib.n_args = 4
    monkeypatch.setattr(rk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(rk, "_CACHE", {})
    hp = _FakeTensor(0x30, (3,))
    for n, base in ((100, 0x1000), (10 ** 7, 0x2000), (100, 0x3000)):
        w, g = _FakeTensor(base, (n,)), _FakeTensor(base + 8, (n,))
        rk.sgd_update(w, g, hp)
    assert lookups == [("sgd_update", 0)] * 2  # two output shapes
    (_, g0, b0, _, v0), (_, g1, _, _, _), (_, _, _, _, v2) = lib.launches
    assert (g0, b0) == ((1, 1, 1), (256, 1, 1))
    assert g1 == (rk.GELU_BLOCKS_PER_SM * 132, 1, 1)
    assert v0 == (0x1000, 0x1008, 0x30, 0x1000)
    assert v2 == (0x3000, 0x3008, 0x30, 0x3000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_backward_on_the_card_pushes_x_dy_dx_with_gelu_dims(
        fake_card, monkeypatch, dtype):
    """``rtc_kernels.gelu_backward`` through the plan: one lookup per output
    shape, the pointers (x, dy, dx) in argument order, the grid-stride dims
    of ``gelu_dims`` (one 16-byte vector a thread per pass), and the body
    with the vector loop."""
    lib, lookups = fake_card
    monkeypatch.setattr(rk, "_sm_count", lambda device: 132)
    monkeypatch.setattr(rk, "_CACHE", {})
    made = []

    def empty_like(t):
        made.append(_FakeTensor(0x9000 + 0x1000 * len(made), t.shape,
                                t.dtype))
        return made[-1]

    monkeypatch.setattr(rk, "torch", SimpleNamespace(empty_like=empty_like))
    shapes = ((100,), (16384, 8192), (100,))
    for i, shape in enumerate(shapes):
        x = _FakeTensor(0x100000 * (i + 1), shape, dtype)
        dy = _FakeTensor(0x100000 * (i + 1) + 0x10, shape, dtype)
        assert rk.gelu_backward(x, dy) is made[i]
    assert lookups == [("gelu_bwd", 0)] * 2  # two output shapes
    itemsize = 2 if dtype == torch.bfloat16 else 4
    for i, (shape, (_, grid, block, stream, ptrs)) in enumerate(
            zip(shapes, lib.launches)):
        n = int(np.prod(shape))
        assert (grid, block) == rk.gelu_dims(n, itemsize, 132)
        assert ptrs == (0x100000 * (i + 1), 0x100000 * (i + 1) + 0x10,
                        made[i].data_ptr())
        assert stream == 0x5000
    assert lib.launches[1][1] == (rk.GELU_BLOCKS_PER_SM * 132, 1, 1)
    assert lib.launches[0][1] == (-(-100 // (256 * 16 // itemsize)), 1, 1)
    assert mt.kernels.LAUNCHES["rtc:gelu_bwd"] == 3
    source = next(iter(rk._CACHE.values()))[0].source
    assert "reinterpret_cast<const uint4*>(dy)[i]" in source


@pytest.mark.parametrize("n", [0, 1, 256, 257, 32 * 132 * 256,
                               32 * 132 * 256 + 1])
def test_sgd_dims_cover_n_one_element_a_thread(n):
    grid, block = rk.sgd_dims(n, 132)
    assert block == (256, 1, 1) and grid[1:] == (1, 1)
    assert grid[0] == max(1, min(-(-n // 256), rk.GELU_BLOCKS_PER_SM * 132))
    assert launch_dims(n, grid, block) == (grid, block)
