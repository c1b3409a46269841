"""The serving slice end to end: one checkpoint written by
``mxnet_tpu.model.save_checkpoint`` for a small transformer LM (flash
attention) is served by both packages' ``Predictor`` and the outputs agree
within 1e-4; ``.params`` bytes cross packages unchanged; the port imports
neither JAX nor the JAX package; and nothing falls back to the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models.transformer import get_transformer_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32, seq_len=32)
SHAPES = {"data": (2, 32), "softmax_label": (2, 32)}
TOL = 1e-4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Small LM checkpoint from the JAX package, random weights from a
    numpy seed (scaled so attention is far from uniform)."""
    with mx.NameManager():
        net = get_transformer_lm(**LM)
    arg_shapes, _, _ = net.infer_shape(**SHAPES)
    rng = np.random.RandomState(0)
    args = {n: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.3, mx.cpu())
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in SHAPES}
    prefix = str(tmp_path_factory.mktemp("ckpt") / "lm")
    mx.model.save_checkpoint(prefix, 1, net, args, {})
    tokens = [rng.randint(0, LM["vocab_size"], SHAPES["data"])
              .astype(np.float32) for _ in range(2)]
    return prefix, args, tokens


def test_predictor_matches_jax(checkpoint):
    prefix, _, tokens = checkpoint
    jp = mx.Predictor.from_checkpoint(prefix, 1, SHAPES, ctx=mx.cpu())
    tp = mt.Predictor.from_checkpoint(prefix, 1, SHAPES, ctx=mt.cpu())
    for tok in tokens:  # two requests through the same bound predictors
        ref = jp.forward(data=tok)[0].asnumpy()
        out = tp.forward(data=tok)[0].asnumpy()
        assert out.shape == ref.shape == (64, LM["vocab_size"])
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert tp.get_output(0).context == mt.cpu()


def test_params_from_numpy_matches_file(checkpoint):
    prefix, args, tokens = checkpoint
    from_file = mt.Predictor.from_checkpoint(prefix, 1, SHAPES, ctx=mt.cpu())
    params = mt.convert.params_from_numpy(
        {"arg:" + k: v.asnumpy() for k, v in args.items()}, mt.cpu())
    net = mt.sym.load("%s-symbol.json" % prefix)
    from_np = mt.Predictor(net, params, SHAPES, ctx=mt.cpu())
    a = from_file.forward(data=tokens[0])[0].asnumpy()
    b = from_np.forward(data=tokens[0])[0].asnumpy()
    np.testing.assert_array_equal(a, b)
    # unprefixed names work the same
    bare = mt.convert.params_from_numpy(
        {k: v.asnumpy() for k, v in args.items()}, mt.cpu())
    c = mt.Predictor(net, bare, SHAPES, ctx=mt.cpu()).forward(
        data=tokens[0])[0].asnumpy()
    np.testing.assert_array_equal(a, c)


def test_params_bytes_cross_packages(checkpoint, tmp_path):
    prefix, _, _ = checkpoint
    src = "%s-0001.params" % prefix
    raw = open(src, "rb").read()
    port_copy = str(tmp_path / "port.params")
    mt.nd.save(port_copy, mt.nd.load(src))
    assert open(port_copy, "rb").read() == raw
    jax_copy = str(tmp_path / "jax.params")
    mx.nd.save(jax_copy, mx.nd.load(port_copy))
    assert open(jax_copy, "rb").read() == raw


def test_params_dtypes_and_lists_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    arrays = [rng.randn(3, 4).astype(np.float32),
              rng.randint(-5, 5, (7,)).astype(np.int32),
              rng.randn(2, 2).astype(np.float16),
              np.arange(6, dtype=np.uint8).reshape(2, 3)]
    port_file = str(tmp_path / "p.params")
    mt.nd.save(port_file, [mt.nd.array(a, mt.cpu(), dtype=a.dtype)
                           for a in arrays])
    jax_file = str(tmp_path / "j.params")
    mx.nd.save(jax_file, [mx.nd.array(a, mx.cpu(), dtype=a.dtype)
                          for a in arrays])
    assert open(port_file, "rb").read() == open(jax_file, "rb").read()
    for a, b in zip(arrays, mt.nd.load(jax_file)):
        assert b.dtype == a.dtype and b.context == mt.cpu()
        np.testing.assert_array_equal(b.asnumpy(), a)
    bf = mt.nd.array(arrays[0], mt.cpu(), dtype="bfloat16")
    mt.nd.save(port_file, {"w": bf})  # bf16 widens to float32 on save
    back = mx.nd.load(port_file)["w"].asnumpy()
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, bf.asnumpy())


def test_predictor_reshape_shares_params(checkpoint):
    prefix, _, tokens = checkpoint
    with mt.NameManager():
        net = mt.models.transformer.get_transformer_lm(**LM)
    params = mt.nd.load("%s-0001.params" % prefix)
    tp = mt.Predictor(net, params, SHAPES, ctx=mt.cpu())
    small = tp.reshape({"data": (1, 32), "softmax_label": (1, 32)})
    w = "tok_embed_weight"
    assert small._exec.arg_dict[w] is tp._exec.arg_dict[w]
    full = tp.forward(data=tokens[0])[0].asnumpy()
    one = small.forward(data=tokens[0][:1])[0].asnumpy()
    np.testing.assert_allclose(one, full[:32], rtol=TOL, atol=TOL)


def test_default_context_is_the_card(checkpoint):
    """Without CUDA a default-context entry point raises; nothing falls
    back to the CPU."""
    import torch

    prefix, _, _ = checkpoint
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default context works")
    assert mt.current_context() == mt.gpu(0)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.Predictor.from_checkpoint(prefix, 1, SHAPES)
    with pytest.raises(mt.MXNetError):
        mt.nd.zeros((2, 2))
    with pytest.raises(mt.MXNetError):
        mt.nd.array([1.0, 2.0])
    with mt.cpu():
        assert mt.nd.zeros((2, 2)).context == mt.cpu()


def test_executor_is_inference_only(checkpoint):
    """The executor trains too (it once was inference only): binding with
    grad_req="write" (the default), backward fills grad_dict for every
    parameter and none for the token ids; forward(is_train=True) and backward run; a
    grad_req="null" bind still serves."""
    prefix, _, _ = checkpoint
    net = mt.sym.load("%s-symbol.json" % prefix)
    params = mt.nd.load("%s-0001.params" % prefix, mt.cpu())
    args = {n: params.get("arg:" + n, mt.nd.zeros(s, mt.cpu())) for n, s in
            zip(net.list_arguments(), net.infer_shape(**SHAPES)[0])}
    ex = net.bind(mt.cpu(), args)  # grad_req defaults to "write"
    tokens = np.ones(SHAPES["data"], np.float32)
    out = ex.forward(is_train=True, data=tokens)[0]
    assert out.shape == (64, LM["vocab_size"])
    ex.backward()
    assert "data" not in ex.grad_dict
    assert "tok_embed_weight" in ex.grad_dict
    g = ex.grad_dict["lm_head_weight"].asnumpy()
    assert g.shape == (LM["vocab_size"], 32) and np.abs(g).max() > 0
    ex = net.bind(mt.cpu(), args, grad_req="null")
    assert ex.grad_dict == {}
    out = ex.forward(data=tokens)[0]
    assert out.shape == (64, LM["vocab_size"])
    assert list(ex.output_dict) == net.list_outputs()


@pytest.mark.parametrize("module", ["mxnet_tpu_torch", "chip_smoke"])
def test_port_imports_no_jax(module):
    code = ("import sys, %s\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n" % module)
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_port_source_reaches_no_library_attention():
    """The port never calls library attention or a compiler of the plain
    version; only chip_smoke.py times SDPA, as a yardstick."""
    import re

    banned = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                        r"flash_attn|^\s*(import|from)\s+(jax|mxnet_tpu)\b",
                        re.M)
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # compiled kernels
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(dirpath, name)).read()
                hit = banned.search(text)
                assert hit is None, (name, hit and hit.group(0))
