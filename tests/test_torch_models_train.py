"""Module training of small ResNets in the port against the JAX package on
the CPU, from identical numpy inputs (the half of
``tests/test_torch_models.py`` that trains ResNet-50, split off so that the
two files take about equal time; the helpers are that file's).

- 3 SGD-momentum steps (lr 0.01, momentum 0.9, wd 1e-4, rescale 1/batch)
  of small ResNets from the zero-γ init: float32 parameters and aux states
  within 1e-4 of the largest of each, losses 1e-4 relative; bf16 losses
  2e-2, and the change of the parameters and of the aux states within
  ``BF16_CHANGE_LIMIT`` of its norm, as the LM's bf16 training is held
  (``tests/test_torch_train.py``).
- ROADMAP C.7: the float32 ResNet-50 at lr 0.1 climbs alike in both
  packages."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_models import (BF16_CHANGE_LIMIT, _distances, _init, _nets,
                               _resnet_case, _train)


@pytest.mark.parametrize("name,dtype", [
    ("resnet50-cifar", None), ("resnet50-cifar", "bfloat16"),
    ("resnet18-imagenet-stem", None), ("resnet18-imagenet-stem",
                                       "bfloat16")],
    ids=["resnet50-cifar-f32", "resnet50-cifar-bf16", "resnet18-f32",
         "resnet18-bf16"])
def test_resnet_module_training_matches_jax(name, dtype):
    """3 steps through bind / init_params / init_optimizer /
    forward_backward / update (the fused step in both packages)."""
    jn, tn, args, aux, X, Y, lr = _resnet_case(name)
    ref = _train(mx, jn, args, aux, X, Y, dtype, lr)
    got = _train(mt, tn, args, aux, X, Y, dtype, lr)
    assert got[0][-1] < got[0][0]
    assert all(got[2][k].dtype == np.float32 for k in aux)
    moved = [k for k in aux if not np.array_equal(got[2][k], aux[k])]
    assert sorted(moved) == sorted(aux)  # every moving statistic moved
    loss, params, auxes, change, aux_change = _distances(got, ref, args, aux)
    if dtype is None:
        assert loss <= 1e-4 and params <= 1e-4 and auxes <= 1e-4, \
            (loss, params, auxes)
    else:
        assert loss <= 2e-2, loss
        assert change <= BF16_CHANGE_LIMIT and \
            aux_change <= BF16_CHANGE_LIMIT, (change, aux_change)


def test_float32_resnet50_at_lr_0_1_climbs_alike_in_both_packages():
    """ROADMAP C.7: chip_smoke's float32 ResNet-50 run (lr 0.1, momentum
    0.9, wd 1e-4, rescale 1/batch, Xavier-in init at unit γ, 1000 classes,
    the imagenet stem) climbs after its first step on the card; the JAX
    package climbs the same way.  At 96², batch 8 (the full 224², batch 32
    is the chip's to run; the chip has no JAX), from one numpy init and
    batch: the port's CPU route and the JAX package both fall at step 1
    and climb at step 2; at each of the port's first 3 states the JAX
    package's training forward gives the port's loss within 1e-4; trained
    free, the packages lie within 4x the distance one float32 ulp of the
    init moves the port (the run is chaotic at unit γ, as the card's is)."""
    size, batch = 96, 8
    shape = (batch, 3, size, size)
    jn, tn = _nets("get_resnet", num_layers=50, num_classes=1000,
                   image_shape=(3, size, size))
    arg_shapes, _, aux_shapes = jn.infer_shape(data=shape)
    rng = np.random.RandomState(0)
    args = _init(jn.list_arguments(), arg_shapes, rng)
    aux = {n: (np.zeros if n.endswith("mean") else np.ones)(s, np.float32)
           for n, s in zip(jn.list_auxiliary_states(), aux_shapes)}
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    Y = rng.randint(0, 1000, (batch,)).astype(np.float32)
    sgd = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
               rescale_grad=1.0 / batch)

    def module(pkg, net, a, x):
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (batch,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in a.items()},
                        aux_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in x.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=sgd)
        return mod, pkg.io.DataBatch([pkg.nd.array(X, pkg.cpu())],
                                     [pkg.nd.array(Y, pkg.cpu())])

    def loss(mod):
        p = mod.get_outputs()[0].asnumpy().astype(np.float64)
        return float(-np.log(p[np.arange(batch), Y.astype(int)]).mean())

    def train(pkg, net, a, states=None):
        mod, b = module(pkg, net, a, aux)
        out = []
        for _ in range(3):
            if states is not None:
                got = mod.get_params()
                states.append(tuple({k: v.asnumpy() for k, v in d.items()}
                                    for d in got))
            mod.forward_backward(b)
            mod.update()
            out.append(loss(mod))
        return out

    states = []
    port = train(mt, tn, args, states)
    jax_free = train(mx, jn, args)
    nudged = {k: np.nextafter(v, np.float32(np.inf)).astype(np.float32)
              if k.endswith("weight") else v for k, v in args.items()}
    spread = train(mt, tn, nudged)
    for run in (port, jax_free):
        assert run[1] < run[0] and run[2] > run[1], run  # falls, climbs
    jmod, jbatch = module(mx, jn, args, aux)
    anchored = []
    for a, x in states:
        jmod.set_params({k: mx.nd.array(v, mx.cpu()) for k, v in a.items()},
                        {k: mx.nd.array(v, mx.cpu()) for k, v in x.items()})
        jmod.forward(jbatch, is_train=True)
        anchored.append(loss(jmod))

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    assert max(rel(anchored, port)) <= 1e-4, (anchored, port)
    free, ulp = rel(jax_free, port), rel(spread, port)
    assert free[0] <= 1e-4
    assert all(f <= 4 * u for f, u in zip(free[1:], ulp[1:])), (free, ulp)
