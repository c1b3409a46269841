"""The port's serving tier (``mxnet_tpu_torch.serving``: ``InferenceServer``
over ``MicroBatcher``) against the JAX package's (tests/test_serving.py), on
the CPU.

Both packages' servers serve the same checkpoint, written by the JAX
package's ``save_checkpoint``, and take the same requests: outputs agree
within 1e-5; bucket histograms, error types and messages, ready states,
HTTP status codes and JSON bodies, and metric series names are equal.
Queues are filled under ``start=False`` and deadlines set to expire before
the batcher's flush, so no case races the wall clock; every wait is
bounded and every server binds port 0."""
import gc
import json
import os
import threading
import time
import urllib.error
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import serving as tserving

IN_DIM, HID, OUT = 6, 5, 3
TOL = dict(rtol=1e-5, atol=1e-5)
WAIT = 60
SIDES = {"jax": (mx, jserving), "port": (mt, tserving)}


def _mlp(pkg):
    with pkg.NameManager():
        x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=HID,
                                   name="fc1")
        x = pkg.sym.Activation(x, act_type="relu", name="relu1")
        return pkg.sym.FullyConnected(x, num_hidden=OUT, name="fc2")


def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(HID, IN_DIM).astype(np.float32),
            "fc1_bias": rng.randn(HID).astype(np.float32),
            "fc2_weight": rng.randn(OUT, HID).astype(np.float32),
            "fc2_bias": rng.randn(OUT).astype(np.float32)}


def _save(prefix, epoch, seed=0):
    """An MLP checkpoint written by the JAX package's save_checkpoint."""
    mx.model.save_checkpoint(
        prefix, epoch, _mlp(mx),
        {k: mx.nd.array(v) for k, v in _np_params(seed).items()}, {})


def _reference(X, seed=0):
    """The JAX package's batch-1 Predictor on the same weights."""
    pred = mx.Predictor(_mlp(mx), {k: mx.nd.array(v) for k, v
                                   in _np_params(seed).items()},
                        {"data": (1, IN_DIM)})
    return np.stack([pred.forward(data=X[i:i + 1])[0].asnumpy()[0]
                     for i in range(len(X))])


def _server(side, batch=4, **kw):
    """A server of ``side`` over the MLP (weights in memory); the port's
    on ``mt.cpu()``."""
    pkg, serving = SIDES[side]
    kw.setdefault("max_wait_us", 1000)
    kw.setdefault("warmup", False)
    if side == "port":
        kw.setdefault("ctx", mt.cpu())
        params = {k: mt.nd.array(v, mt.cpu()) for k, v in _np_params().items()}
    else:
        params = {k: mx.nd.array(v) for k, v in _np_params().items()}
    return serving.InferenceServer(_mlp(pkg), params,
                                   {"data": (batch, IN_DIM)}, **kw)


def _both(**kw):
    return {side: _server(side, **kw) for side in SIDES}


def _stop_all(servers):
    for srv in servers.values():
        srv.stop(drain=False)


def _x(n, seed=1):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


# -- outputs -----------------------------------------------------------------
def test_bucketed_predictor_padding_matches_jax():
    X = _x(5)
    got = {}
    for side, (pkg, serving) in SIDES.items():
        ctx = {"ctx": mt.cpu()} if side == "port" else {}
        params = {k: pkg.nd.array(v, **ctx) for k, v in _np_params().items()}
        bp = serving.BucketedPredictor(_mlp(pkg), params, {"data": (IN_DIM,)},
                                       buckets=(1, 2, 4, 8), **ctx)
        assert [bp.bucket_for(n) for n in (1, 3, 8)] == [1, 4, 8]
        with pytest.raises(pkg.base.MXNetError, match="exceeds largest"):
            bp.bucket_for(9)
        got[side] = bp.forward_batch([{"data": X[i]} for i in range(5)])
        assert bp.compiled_entries() == []
    assert got["jax"][0] == got["port"][0] == 8
    for a, b in zip(got["jax"][1], got["port"][1]):
        np.testing.assert_allclose(b[0], a[0], **TOL)


def test_checkpoint_from_jax_served_by_both(tmp_path):
    prefix = str(tmp_path / "mlp")
    _save(prefix, 1)
    X = _x(12)
    ref = _reference(X)
    outs = {}
    for side, (pkg, serving) in SIDES.items():
        kw = {"ctx": mt.cpu()} if side == "port" else {}
        srv = serving.InferenceServer.from_checkpoint(
            prefix, 1, {"data": (4, IN_DIM)}, max_wait_us=1000, **kw)
        try:
            with ThreadPoolExecutor(max_workers=6) as pool:
                futs = list(pool.map(lambda i: srv.submit(data=X[i]),
                                     range(len(X))))
            outs[side] = np.stack([f.result(timeout=WAIT)[0] for f in futs])
            assert srv.cold_bucket_runs() == 0
            assert set(srv.metrics.snapshot()["batch_size_hist"]) <= \
                set(srv.buckets)
        finally:
            srv.stop()
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)
    np.testing.assert_allclose(outs["port"], ref, **TOL)


def test_concurrent_submits_coalesce_into_buckets():
    srv = _server("port", batch=16, max_wait_us=20000, max_queue=256,
                  warmup=True)
    X = _x(64, seed=2)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = list(pool.map(lambda i: srv.submit(data=X[i]),
                                 range(64)))
        got = np.stack([f.result(timeout=WAIT)[0] for f in futs])
        snap = srv.metrics.snapshot()
        calls = sum(rep.executor_calls for rep in srv._replicas)
    finally:
        srv.stop()
    np.testing.assert_allclose(got, _reference(X), **TOL)
    hist = snap["batch_size_hist"]
    assert set(hist) <= set(srv.buckets)
    assert sum(hist.values()) == snap["batches_total"] == calls < 64
    assert sum(n * c for n, c in snap["occupancy_hist"].items()) == 64
    assert snap["requests_completed"] == 64
    assert srv.cold_bucket_runs() == 0


def test_queued_then_started_gives_the_same_histogram():
    """11 requests queued under ``start=False``, then ``start()``: the one
    worker flushes 4, 4 and 3 in both packages."""
    servers = _both(batch=4, start=False, max_wait_us=2000)
    X = _x(11, seed=3)
    got = {}
    try:
        for side, srv in servers.items():
            futs = [srv.submit(data=X[i]) for i in range(len(X))]
            assert srv.queue_depth() == 11
            srv.start()
            got[side] = np.stack([f.result(timeout=WAIT)[0] for f in futs])
    finally:
        _stop_all(servers)
    snaps = {s: srv.metrics.snapshot() for s, srv in servers.items()}
    for key in ("batch_size_hist", "occupancy_hist", "batches_total",
                "padded_items_total", "requests_completed",
                "queue_depth_peak"):
        assert snaps["jax"][key] == snaps["port"][key], key
    assert snaps["port"]["batch_size_hist"] == {4: 3}
    assert snaps["port"]["occupancy_hist"] == {4: 2, 3: 1}
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)


# -- errors ------------------------------------------------------------------
def _deadline(srv):
    fut = srv.submit(deadline_ms=0, data=np.zeros(IN_DIM, np.float32))
    srv.start()
    return [fut], srv.metrics.snapshot


def _queue_full(srv):
    futs = [srv.submit(data=np.zeros(IN_DIM, np.float32)) for _ in range(4)]
    try:
        srv.submit(data=np.zeros(IN_DIM, np.float32))
    except Exception as exc:  # the rejection itself is the error
        srv.start()
        for f in futs:
            assert len(f.result(timeout=WAIT)) == 1
        return exc
    raise AssertionError("a fifth request was admitted")


def _drain(srv):
    srv.start()
    futs = [srv.submit(data=_x(6)[i]) for i in range(6)]
    srv.stop(drain=True)
    outs = [f.result(timeout=1)[0] for f in futs]
    np.testing.assert_allclose(np.stack(outs), _reference(_x(6)), **TOL)
    try:
        srv.submit(data=np.zeros(IN_DIM, np.float32))
    except Exception as exc:
        return exc
    raise AssertionError("a stopped server admitted a request")


def _no_drain(srv):
    fut = srv.submit(data=np.zeros(IN_DIM, np.float32))
    srv.stop(drain=False)
    return [fut], None


def _force_cancel(srv):
    wedge = threading.Event()
    real = srv._replicas[0].forward_batch

    def wedged(items):
        wedge.wait(WAIT)
        return real(items)

    srv._replicas[0].forward_batch = wedged
    srv.start()
    futs = [srv.submit(data=np.zeros(IN_DIM, np.float32)) for _ in range(6)]
    t0 = time.monotonic()
    srv.stop(drain=True, timeout_ms=300)
    assert time.monotonic() - t0 < 10.0
    assert all(f.done() for f in futs)
    wedge.set()
    return futs, None


ERROR_CASES = {
    "deadline": (dict(start=False), _deadline),
    "queue_full": (dict(start=False, max_queue=4, batch=8), _queue_full),
    "drain": (dict(start=False, max_wait_us=500000, batch=8), _drain),
    "no_drain": (dict(start=False), _no_drain),
    "force_cancel": (dict(start=False), _force_cancel),
}


def _outcome(case, side):
    kw, drive = ERROR_CASES[case]
    srv = _server(side, **kw)
    try:
        res = drive(srv)
        if isinstance(res, Exception):
            errors = [res]
        else:
            futs, _ = res
            errors = []
            for f in futs:
                with pytest.raises(Exception) as info:
                    f.result(timeout=WAIT)
                errors.append(info.value)
        snap = srv.metrics.snapshot()
    finally:
        srv.stop(drain=False)
    return ([(type(e).__name__, str(e)) for e in errors],
            {k: snap[k] for k in ("requests_rejected", "requests_expired",
                                  "requests_failed")})


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_jax(case):
    jax_out, port_out = (_outcome(case, side) for side in SIDES)
    assert port_out == jax_out
    names = {n for n, _ in port_out[0]}
    assert names == {"deadline": {"DeadlineExceededError"},
                     "queue_full": {"QueueFullError"},
                     "drain": {"ServerClosedError"},
                     "no_drain": {"ServerClosedError"},
                     "force_cancel": {"DrainTimeoutError"}}[case]


INVALID = {
    "wrong_shape": {"data": np.zeros(IN_DIM + 1, np.float32)},
    "unknown_input": {"bogus": np.zeros(IN_DIM, np.float32)},
    "missing_input": {},
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_input_validation_messages_match_jax(case):
    servers = _both(batch=2)
    try:
        msgs = {}
        for side, srv in servers.items():
            with pytest.raises(SIDES[side][0].base.MXNetError) as info:
                srv.submit(**INVALID[case])
            msgs[side] = str(info.value)
        assert msgs["port"] == msgs["jax"]
        # a unit batch axis is accepted and squeezed
        out = servers["port"].predict(data=np.zeros((1, IN_DIM), np.float32))
        assert out[0].shape == (OUT,)
    finally:
        _stop_all(servers)


def _series(text):
    """Every exposition line without its value."""
    return [line.rsplit(" ", 1)[0] if not line.startswith("#") else line
            for line in text.strip().splitlines()]


def test_metrics_text_series_match_jax():
    servers = _both()
    try:
        for srv in servers.values():
            srv.predict(data=np.zeros(IN_DIM, np.float32))
        texts = {s: srv.metrics_text() for s, srv in servers.items()}
    finally:
        _stop_all(servers)
    assert _series(texts["port"]) == _series(texts["jax"])
    assert "mxtpu_serving_requests_total 1" in texts["port"]
    assert 'mxtpu_serving_batch_size{bucket="1"} 1' in texts["port"]
    assert "mxtpu_serving_requests_completed 1" in \
        mt.telemetry.render_prometheus()
    snap = servers["port"].metrics.snapshot()
    assert snap["qps"] > 0 and snap["latency_ms_p50"] > 0


# -- lifecycle ---------------------------------------------------------------
def test_multi_replica_dispatch():
    srv = _server("port", ctx=[mt.cpu(0), mt.cpu(1)], max_wait_us=2000)
    X = _x(12, seed=4)
    try:
        assert len(srv._replicas) == 2
        futs = [srv.submit(data=X[i]) for i in range(12)]
        got = np.stack([f.result(timeout=WAIT)[0] for f in futs])
        assert srv.metrics.snapshot()["requests_completed"] == 12
    finally:
        srv.stop()
    np.testing.assert_allclose(got, _reference(X), **TOL)


def _lifecycle(srv):
    states = [srv.ready_state(), srv.ready()]
    srv.start()
    states += [srv.ready_state(), srv.ready()]
    srv._warmed = False
    states += [srv.ready_state(), srv.ready(), srv.health()]
    srv.warmup()
    states += [srv.ready_state(), srv.cold_bucket_runs()]
    fut = srv.submit(data=np.zeros(IN_DIM, np.float32))
    srv.begin_drain()
    states += [srv.ready_state(), srv.ready(), srv.health()]
    assert fut.result(timeout=WAIT) is not None  # in-flight work completes
    srv.stop()
    states += [srv.ready_state(), srv.ready()]
    srv.stop(drain=False)  # idempotent
    srv.stop()
    return states


def test_ready_lifecycle_and_begin_drain_match_jax():
    servers = _both(start=False)
    try:
        got = {side: _lifecycle(srv) for side, srv in servers.items()}
    finally:
        _stop_all(servers)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ["starting", False]
    assert got["port"][-2:] == ["stopped", False]


def test_stop_is_idempotent():
    srv = _server("port", batch=8, max_wait_us=500000)
    X = _x(3, seed=6)
    futs = [srv.submit(data=X[i]) for i in range(3)]
    srv.stop(drain=True)
    assert len([f.result(timeout=1) for f in futs]) == 3
    srv.stop(drain=False)
    srv.stop()
    assert all(f.exception() is None for f in futs)
    with pytest.raises(tserving.ServerClosedError):
        srv.submit(data=X[0])


def test_stop_releases_the_replicas():
    """After ``stop`` no executor, parameter or output tensor of the server
    is alive: weak references to them die, ``resident_bytes()`` is 0 and
    ``cold_bucket_runs()`` survives."""
    srv = _server("port", warmup=True)
    srv.submit(data=np.zeros(IN_DIM, np.float32)).result(timeout=WAIT)
    assert srv.resident_bytes() > 0
    base = srv._replicas[0]._preds[4]
    refs = [weakref.ref(a._data) for a in base._exec.arg_dict.values()]
    refs.append(weakref.ref(base._exec))
    refs.append(weakref.ref(srv._replicas[0]))
    del base
    cold = srv.cold_bucket_runs()
    srv.stop(drain=True)
    gc.collect()
    assert srv.resident_bytes() == 0
    assert srv.cold_bucket_runs() == cold
    assert [r() for r in refs] == [None] * len(refs)


def _crash_worker(srv):
    def boom():
        raise RuntimeError("injected worker crash")

    prev = threading.excepthook
    threading.excepthook = lambda args: None
    try:
        srv._batcher._collect = boom
        srv.predict(data=np.zeros(IN_DIM, np.float32))
        deadline = time.monotonic() + 10.0
        while not srv._batcher.dead_workers():
            assert time.monotonic() < deadline, "the worker never died"
            time.sleep(0.01)
    finally:
        threading.excepthook = prev


def test_healthz_degraded_after_worker_death_matches_jax():
    servers = _both()
    got = {}
    try:
        for side, srv in servers.items():
            host, port = srv.serve_http()
            ok = _http("http://%s:%d/healthz" % (host, port))
            _crash_worker(srv)
            got[side] = (ok, srv.health(), _http(
                "http://%s:%d/healthz" % (host, port)),
                srv.metrics.snapshot()["worker_crashes"], srv.ready_state())
    finally:
        _stop_all(servers)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (200, "ok")
    assert got["port"][2][0] == 503
    assert json.loads(got["port"][2][1])["status"] == "degraded"


def test_inplace_swap_over_http_on_a_cpu_built_server(tmp_path):
    """A server built under ``with mt.cpu():`` (no ``ctx``) keeps that
    context for the HTTP thread that runs ``POST /swap``; the answers flip
    to the new epoch, readiness never drops, as in the JAX package."""
    prefix = str(tmp_path / "swap")
    _save(prefix, 1, seed=12)
    _save(prefix, 2, seed=13)
    X = _x(4, seed=8)
    got = {}
    for side, (pkg, serving) in SIDES.items():
        if side == "port":
            with mt.cpu():
                srv = serving.InferenceServer.from_checkpoint(
                    prefix, 1, {"data": (4, IN_DIM)}, max_wait_us=1000)
        else:
            srv = serving.InferenceServer.from_checkpoint(
                prefix, 1, {"data": (4, IN_DIM)}, max_wait_us=1000)
        try:
            before = srv.predict(data=X[0])[0]
            host, port = srv.serve_http()
            code, body = _http("http://%s:%d/swap" % (host, port),
                               {"prefix": prefix, "epoch": 2})
            got[side] = (code, body, srv.ready(), srv.cold_bucket_runs(),
                         before, srv.predict(data=X[0])[0])
            if side == "port":
                assert srv.swap_config()["ctx"] == [mt.cpu()]
        finally:
            srv.stop()
    assert got["port"][:4] == got["jax"][:4] == (
        200, '{"swapped": true, "epoch": 2}', True, 0)
    np.testing.assert_allclose(got["port"][4], _reference(X, 12)[0], **TOL)
    np.testing.assert_allclose(got["port"][5], _reference(X, 13)[0], **TOL)
    np.testing.assert_allclose(got["port"][5], got["jax"][5], **TOL)


# -- HTTP --------------------------------------------------------------------
def _http(url, payload=None, headers=None, raw=None):
    """(status, body text) of one request; POST when a body is given."""
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        exc.close()
        return exc.code, body


HTTP_CASES = {
    "predict": ("/predict", {"inputs": {"data": list(range(IN_DIM))}}, None,
                None),
    "healthz": ("/healthz", None, None, None),
    "readyz": ("/readyz", None, None, None),
    "metrics": ("/metrics", None, None, None),
    "unknown_get": ("/nope", None, None, None),
    "unknown_post": ("/nope", {"inputs": {}}, None, None),
    "bad_shape": ("/predict", {"inputs": {"data": [1.0]}}, None, None),
    "bad_json": ("/predict", None, None, b"{not json"),
    "deadline_header": ("/predict", {"inputs": {"data": [0.0] * IN_DIM}},
                        {"X-Deadline-Ms": "1"}, None),
    "generate_404": ("/generate", {"prompt": [1], "max_new_tokens": 2},
                     None, None),
}


@pytest.fixture(scope="module")
def http_pair():
    # a flush deadline of 50 ms: a request with a 1 ms deadline expires
    # in the queue before its batch runs
    servers = _both(batch=8, max_wait_us=50000)
    addrs = {side: "http://%s:%d" % srv.serve_http()[:2]
             for side, srv in servers.items()}
    yield servers, addrs
    _stop_all(servers)


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_http_status_and_bodies_match_jax(http_pair, case):
    servers, addrs = http_pair
    path, payload, headers, raw = HTTP_CASES[case]
    got = {side: _http(addrs[side] + path, payload, headers, raw)
           for side in SIDES}
    (jcode, jbody), (tcode, tbody) = got["jax"], got["port"]
    assert tcode == jcode
    if case == "predict":
        assert tcode == 200
        np.testing.assert_allclose(
            np.asarray(json.loads(tbody)["outputs"][0]),
            np.asarray(json.loads(jbody)["outputs"][0]), **TOL)
        np.testing.assert_allclose(
            np.asarray(json.loads(tbody)["outputs"][0]),
            _reference(np.arange(IN_DIM, dtype=np.float32)[None])[0], **TOL)
        assert servers["port"].http_json_ms()["requests"] >= 1
    elif case == "metrics":
        assert tcode == 200
        assert _series(tbody) == _series(jbody)
    else:
        assert tbody == jbody
    assert tcode == {"predict": 200, "healthz": 200, "readyz": 200,
                     "metrics": 200, "unknown_get": 404, "unknown_post": 404,
                     "bad_shape": 400, "bad_json": 400,
                     "deadline_header": 504, "generate_404": 404}[case]


# -- compile-once -----------------------------------------------------------
def test_save_aot_bundle_raises_the_jax_error(tmp_path):
    servers = _both()
    try:
        msgs = {}
        for side, srv in servers.items():
            assert srv.compiled_entries() == []
            with pytest.raises(SIDES[side][0].base.MXNetError) as info:
                srv.save_aot_bundle(str(tmp_path / side), 1)
            msgs[side] = str(info.value)
    finally:
        _stop_all(servers)
    assert msgs["port"] == msgs["jax"]
    assert "no cached executables" in msgs["port"]


def test_attach_aot_refuses_a_bundle_it_cannot_read(tmp_path):
    prefix = str(tmp_path / "aot")
    _save(prefix, 1)
    srv = tserving.InferenceServer.from_checkpoint(
        prefix, 1, {"data": (4, IN_DIM)}, ctx=mt.cpu())  # no bundle: serves
    srv.stop()
    # a bundle the JAX package wrote (its manifest's envelope has no
    # "framework": "torch"): refused, even on the CPU where the topology
    # keys of the two envelopes can match
    from mxnet_tpu import compile_cache as jcc

    jcc.save_bundle(prefix + "-0001.aot", entries=[])
    with pytest.raises(mt.base.MXNetError, match="framework"):
        tserving.InferenceServer.from_checkpoint(
            prefix, 1, {"data": (4, IN_DIM)}, ctx=mt.cpu())
    srv = tserving.InferenceServer.from_checkpoint(
        prefix, 1, {"data": (4, IN_DIM)}, ctx=mt.cpu(), attach_aot=False)
    try:
        np.testing.assert_allclose(srv.predict(data=_x(1)[0])[0],
                                   _reference(_x(1))[0], **TOL)
    finally:
        srv.stop()


def test_exports():
    for name in jserving.__all__:
        assert hasattr(tserving, name), name
    assert set(tserving.__all__) == set(jserving.__all__)
    for name in ("find_latest_checkpoint", "load_checkpoint_state"):
        assert callable(getattr(mt.model, name))
