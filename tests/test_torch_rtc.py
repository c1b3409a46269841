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
