"""``mt.operator`` against ``mxnet_tpu.operator`` on the CPU: the
counterparts of ``tests/test_custom_op.py``, each run through both packages
on identical numpy inputs from a seed, plus training through ``Module``
from one init, ``declare_backward_dependency``, ``assign``'s requests and
aux states.  The props are registered under names the JAX tests do not use.

Tolerance: float32 1e-5 relative (one computation in numpy, the rest in
each package's float32 ops, summed in another order); 3 epochs of SGD
parameters within 1e-5 of the largest parameter."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-5


def _register_props(pkg, prefix):
    """The sigmoid, softmax-loss and scale props of tests/test_custom_op.py,
    registered in ``pkg`` under ``prefix``-ed names."""

    @pkg.operator.register(prefix + "sigmoid")
    class SigmoidProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super(SigmoidProp, self).__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Sigmoid(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    y = 1.0 / (1.0 + np.exp(-x))
                    self.assign(out_data[0], req[0], y.astype(x.dtype))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    y = out_data[0].asnumpy()
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                (g * y * (1.0 - y)).astype(y.dtype))

            return Sigmoid()

    @pkg.operator.register(prefix + "softmax_loss")
    class SoftmaxLossProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super(SoftmaxLossProp, self).__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class SoftmaxLoss(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    e = np.exp(x - x.max(axis=1, keepdims=True))
                    self.assign(out_data[0], req[0],
                                (e / e.sum(axis=1, keepdims=True))
                                .astype(x.dtype))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    lab = in_data[1].asnumpy().astype(np.int64)
                    y = out_data[0].asnumpy().copy()
                    y[np.arange(lab.shape[0]), lab] -= 1.0
                    self.assign(in_grad[0], req[0], y)
                    self.assign(in_grad[1], req[1],
                                np.zeros_like(in_data[1].asnumpy()))

            return SoftmaxLoss()

    @pkg.operator.register(prefix + "scale")
    class ScaleProp(pkg.operator.CustomOpProp):
        def __init__(self, scale):
            super(ScaleProp, self).__init__(need_top_grad=True)
            self.scale = float(scale)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self.scale

            class Scale(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0].asnumpy() * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0].asnumpy() * scale)

            return Scale()


_register_props(mx, "_torchtest_")
_register_props(mt, "_torchtest_")
PKGS = {"jax": mx, "port": mt}


def test_custom_imperative_forward():
    x = np.array([[0.0, 1.0], [-1.0, 2.0]], np.float32)
    got = mt.nd.Custom(mt.nd.array(x, mt.cpu()), op_type="_torchtest_sigmoid")
    ref = mx.nd.Custom(mx.nd.array(x), op_type="_torchtest_sigmoid")
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=TOL)
    np.testing.assert_allclose(got.asnumpy(), 1.0 / (1.0 + np.exp(-x)),
                               rtol=TOL)


def test_custom_symbolic_forward_backward():
    rng = np.random.RandomState(0)
    xe = rng.uniform(-2, 2, (4, 5)).astype(np.float32)
    head = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
    res = {}
    for key, pkg in PKGS.items():
        net = pkg.sym.Custom(data=pkg.sym.Variable("data"),
                             op_type="_torchtest_sigmoid", name="sig")
        exe = net.simple_bind(pkg.cpu(), data=(4, 5), grad_req="write")
        exe.arg_dict["data"][:] = xe
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(pkg.nd.array(head, pkg.cpu()))
        res[key] = (out, exe.grad_dict["data"].asnumpy())
    expect = 1.0 / (1.0 + np.exp(-xe))
    np.testing.assert_allclose(res["port"][0], expect, rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(res["port"][1], head * expect * (1 - expect),
                               rtol=1e-4, atol=1e-6)
    for a, b in zip(res["port"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-7)


def _softmax_data(n=128, d=10, k=3):
    rng = np.random.RandomState(0)
    w_true = rng.randn(d, k).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    lab = (x @ w_true).argmax(axis=1).astype(np.float32)
    init = {"fc_weight": (rng.randn(k, d) * 0.1).astype(np.float32),
            "fc_bias": np.zeros(k, np.float32)}
    return x, lab, init


def _train_softmax(pkg, x, lab, init, epochs):
    data, label = pkg.sym.Variable("data"), pkg.sym.Variable("label")
    net = pkg.sym.FullyConnected(data=data, num_hidden=3, name="fc")
    net = pkg.sym.Custom(data=net, label=label,
                         op_type="_torchtest_softmax_loss", name="loss")
    mod = pkg.mod.Module(net, data_names=("data",), label_names=("label",),
                         context=pkg.cpu())
    it = pkg.io.NDArrayIter(data=x, label=lab, batch_size=32, shuffle=False,
                            label_name="label")
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            arg_params={k: pkg.nd.array(v, pkg.cpu())
                        for k, v in init.items()})
    return mod


def test_custom_softmax_trains():
    """A net with the custom softmax loss learns the separable toy problem
    (tests/test_custom_op.py's gate) in the port."""
    x, lab, init = _softmax_data()
    mod = _train_softmax(mt, x, lab, init, 10)
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("label",
                                                             lab.shape)],
             for_training=False, force_rebind=True)
    probs = mod.predict(mt.io.NDArrayIter(data=x, label=lab,
                                          batch_size=len(x),
                                          label_name="label")).asnumpy()
    acc = (probs.argmax(axis=1) == lab).mean()
    assert acc > 0.9, "custom softmax failed to train: acc=%.3f" % acc


def test_custom_softmax_training_matches_jax():
    """3 epochs of SGD through Module from one init give the JAX
    package's parameters."""
    x, lab, init = _softmax_data()
    got = {k: v.asnumpy() for k, v in
           _train_softmax(mt, x, lab, init, 3).get_params()[0].items()}
    ref = {k: v.asnumpy() for k, v in
           _train_softmax(mx, x, lab, init, 3).get_params()[0].items()}
    scale = max(np.abs(v).max() for v in ref.values())
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= TOL * scale, k
        assert np.abs(got[k] - init[k]).max() > 1e-2, k


@pytest.mark.parametrize("key", ["jax", "port"])
def test_ndarray_op_legacy(key):
    pkg = PKGS[key]

    class Square(pkg.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * in_data[0]

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * in_data[0] * 2.0

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]]

    net = Square().get_symbol(pkg.sym.Variable("data"), name="sq")
    xe = np.random.RandomState(1).uniform(-2, 2, (3, 4)).astype(np.float32)
    exe = net.simple_bind(pkg.cpu(), data=(3, 4), grad_req="write")
    exe.arg_dict["data"][:] = xe
    out = exe.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(out, xe * xe, rtol=TOL)
    exe.backward(pkg.nd.array(np.ones((3, 4), np.float32), pkg.cpu()))
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(), 2 * xe,
                               rtol=TOL)


@pytest.mark.parametrize("key", ["jax", "port"])
def test_python_op_legacy_numpy(key):
    pkg = PKGS[key]

    class AddOne(pkg.operator.PythonOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] + 1.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0]

    net = AddOne().get_symbol(pkg.sym.Variable("data"), name="addone")
    exe = net.simple_bind(pkg.cpu(), data=(2, 2), grad_req="write")
    exe.arg_dict["data"][:] = np.zeros((2, 2), np.float32)
    out = exe.forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(out, np.ones((2, 2), np.float32))
    exe.backward(pkg.nd.array(np.full((2, 2), 3.0, np.float32), pkg.cpu()))
    np.testing.assert_array_equal(exe.grad_dict["data"].asnumpy(), 3.0)


def test_custom_json_round_trip():
    """User kwargs survive tojson/load_json, and the JSON is the JAX
    package's."""
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3)).astype(np.float32)
    outs = {}
    for key, pkg in PKGS.items():
        with pkg.NameManager():
            net = pkg.sym.Custom(data=pkg.sym.Variable("data"),
                                 op_type="_torchtest_scale", scale="3.0",
                                 name="sc")
        js = net.tojson()
        outs[key + "_json"] = js
        exe = pkg.sym.load_json(js).simple_bind(pkg.cpu(), data=(2, 3),
                                                grad_req="write")
        exe.arg_dict["data"][:] = x
        outs[key] = exe.forward(is_train=False)[0].asnumpy()
    assert outs["port_json"] == outs["jax_json"]
    assert mt.sym.load_json(outs["jax_json"]).tojson() == outs["jax_json"]
    np.testing.assert_allclose(outs["port"], x * 3.0, rtol=TOL)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=TOL)


def test_custom_op_attrscope_json_roundtrip(tmp_path):
    """Scope attrs of a Custom node stay graph attrs through save/load."""
    data = mt.sym.Variable("data")
    with mt.AttrScope(ctx_group="dev1", lr_mult="0.5"):
        net = mt.sym.Custom(data, op_type="_torchtest_sigmoid")
    net = mt.sym.FullyConnected(net, num_hidden=2, name="fc")
    path = str(tmp_path / "custom-attr.json")
    net.save(path)
    loaded = mt.sym.load(path)
    assert loaded.list_arguments() == net.list_arguments()
    attrs = loaded.attr_dict()
    assert any(v.get("ctx_group") == "dev1" for v in attrs.values())
    jloaded = mx.sym.load(path)
    assert jloaded.list_arguments() == net.list_arguments()


def test_custom_forward_wraps_the_device_tensors():
    """The counterpart of test_custom_op_eager_no_callback: forward gets
    NDArrays over the op's own tensors, with no host copy."""
    seen = {}

    @mt.operator.register("_torchtest_probe")
    class ProbeProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            seen["ctx"] = ctx

            class Probe(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    seen["ptr"] = in_data[0]._data.data_ptr()
                    self.assign(out_data[0], req[0], in_data[0] * 2.0)

            return Probe()

    x = mt.nd.array(np.arange(4, dtype=np.float32), mt.cpu())
    out = mt.nd.Custom(x, op_type="_torchtest_probe")
    assert seen["ptr"] == x._data.data_ptr() and seen["ctx"] == mt.cpu()
    np.testing.assert_array_equal(out.asnumpy(), 2 * np.arange(4))


def test_backward_dependency_requests_and_aux():
    """Only declared arrays reach backward (the rest are zeros); req is
    "null" for an input without a gradient; assign honours "add"; aux
    states are updated by forward and written back by the executor."""
    seen = {}

    @mt.operator.register("_torchtest_deps")
    class DepsProp(mt.operator.CustomOpProp):
        def __init__(self):
            super(DepsProp, self).__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data", "other"]

        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [[1]]

        def declare_backward_dependency(self, out_grad, in_data, out_data):
            return [out_grad[0], in_data[0]]  # not "other", not the output

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Deps(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[1])
                    self.assign(aux[0], "add", np.ones(1, np.float32))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    seen["req"] = list(req)
                    seen["other"] = in_data[1].asnumpy()
                    seen["out"] = out_data[0].asnumpy()
                    self.assign(in_grad[0], req[0], out_grad[0] * 3.0)
                    self.assign(in_grad[0], "add", in_data[0])
                    self.assign(in_grad[1], req[1], out_grad[0])

            return Deps()

    net = mt.sym.Custom(mt.sym.Variable("data"), mt.sym.Variable("other"),
                        op_type="_torchtest_deps", name="deps")
    assert net.list_auxiliary_states() == ["deps_count"]
    x = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    exe = net.simple_bind(mt.cpu(), data=(2, 3), other=(2, 3),
                          grad_req={"data": "write", "other": "null"})
    exe.arg_dict["data"][:] = x
    exe.arg_dict["other"][:] = 5.0
    exe.forward_backward(out_grads=mt.nd.ones((2, 3), mt.cpu()))
    assert seen["req"] == ["write", "null"]
    assert (seen["other"] == 0).all() and (seen["out"] == 0).all()
    np.testing.assert_array_equal(exe.grad_dict["data"].asnumpy(), 3.0 + x)
    assert "other" not in exe.grad_dict
    np.testing.assert_array_equal(exe.aux_dict["deps_count"].asnumpy(), [1])
    exe.forward(is_train=True)
    np.testing.assert_array_equal(exe.aux_dict["deps_count"].asnumpy(), [2])
    exe.forward(is_train=False)
    np.testing.assert_array_equal(exe.aux_dict["deps_count"].asnumpy(), [2])
    # imperative: the aux array passed in is written back
    count = mt.nd.zeros((1,), mt.cpu())
    out = mt.nd.Custom(mt.nd.array(x, mt.cpu()), mt.nd.ones((2, 3), mt.cpu()),
                       count, op_type="_torchtest_deps")
    np.testing.assert_array_equal(out.asnumpy(), x)
    np.testing.assert_array_equal(count.asnumpy(), [1])


def test_legacy_callback_stubs_load_and_refuse_to_run():
    js = mx.sym.Variable("data").tojson()
    node = {"op": "_Native", "name": "nat", "attr": {"info": "0x1234"},
            "inputs": [[0, 0, 0]]}
    import json

    graph = json.loads(js)
    graph["nodes"].append(node)
    graph["heads"] = [[1, 0, 0]]
    graph["node_row_ptr"] = [0, 1, 2]
    net = mt.sym.load_json(json.dumps(graph))
    assert net.list_arguments() == ["data"]
    exe = net.bind(mt.cpu(), {"data": mt.nd.ones((2,), mt.cpu())})
    with pytest.raises(mt.MXNetError, match="callback pointers"):
        exe.forward()
