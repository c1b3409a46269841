"""The port's ``Router`` (``mxnet_tpu_torch.serving.router``) against the JAX
package's (tests/test_router.py), and the generation half of the serving
tier (tests/test_generation.py's HTTP and router tests), on the CPU.

Dispatch answers equal the direct answers within 1e-5; error types,
messages, status codes and JSON bodies equal the JAX router's.  A port
router fronts a JAX server over HTTP and a JAX router a port server.  The
small LM's ``POST /generate`` NDJSON stream equals the JAX server's token
for token under the near-tie rule of tests/test_torch_generation.py.
Failures and slow replicas come from ``faults`` rules, breaker cooldowns
are stepped by moving the breaker's clock, registry syncs are forced: no
case races the wall clock.  Every wait is bounded; servers bind port 0."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import faults
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.serving import router as trouter

IN_DIM, HID = 6, 3
TOL = dict(rtol=1e-5, atol=1e-5)
WAIT = 60
SIDES = {"jax": (mx, jserving), "port": (mt, tserving)}


def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.randn(HID, IN_DIM).astype(np.float32),
            "fc_bias": rng.randn(HID).astype(np.float32)}


def _net(pkg):
    with pkg.NameManager():
        return pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                      num_hidden=HID, name="fc")


def _reference(X, seed=0):
    pred = mx.Predictor(_net(mx), {k: mx.nd.array(v) for k, v
                                   in _np_params(seed).items()},
                        {"data": (1, IN_DIM)})
    return np.stack([pred.forward(data=X[i:i + 1])[0].asnumpy()[0]
                     for i in range(len(X))])


def _server(side="port", **kw):
    pkg, serving = SIDES[side]
    kw.setdefault("max_wait_us", 1000)
    kw.setdefault("warmup", False)
    if side == "port":
        kw.setdefault("ctx", mt.cpu())
        params = {k: mt.nd.array(v, mt.cpu()) for k, v in _np_params().items()}
    else:
        params = {k: mx.nd.array(v) for k, v in _np_params().items()}
    return serving.InferenceServer(_net(pkg), params, {"data": (4, IN_DIM)},
                                   **kw)


def _servers(n=2, side="port", **kw):
    return [_server(side, **kw) for _ in range(n)]


def _x(n, seed=1):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


def _http(url, payload=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        hdrs = dict(exc.headers)
        exc.close()
        return exc.code, body, hdrs


def _expire_cooldown(router, name):
    """Step an open breaker past its cooldown without sleeping."""
    rep = next(r for r in router.replicas() if r.name == name)
    rep._opened_at -= router.breaker_cooldown_s + 1.0


# -- dispatch ----------------------------------------------------------------
def test_dispatch_matches_reference_and_jax_metrics():
    X = _x(10)
    ref = _reference(X)
    snaps = {}
    for side, (pkg, serving) in SIDES.items():
        srvs = _servers(2, side)
        router = serving.Router(srvs, seed=1)
        try:
            futs = [router.submit(data=X[i]) for i in range(10)]
            got = np.stack([f.result(timeout=WAIT)[0] for f in futs])
            np.testing.assert_allclose(got, ref, **TOL)
            snaps[side] = router.metrics.snapshot()
            assert sum(d["calls"] for d in router.describe()) == 10
            assert router.metrics.latency_quantile(0.5) > 0
        finally:
            router.close(stop_backends=True)
    for key in ("requests", "completed", "failed", "shed", "retries",
                "hedges", "swaps", "breaker_transitions"):
        assert snaps["port"][key] == snaps["jax"][key], key
    assert sorted(snaps["port"]) == sorted(snaps["jax"])
    assert snaps["port"]["completed"] == {"interactive": 10}


def test_router_validates_inputs():
    msgs = {}
    for side, (pkg, serving) in SIDES.items():
        router = serving.Router(_servers(1, side))
        try:
            with pytest.raises(pkg.base.MXNetError) as info:
                router.submit(slo="no-such-class", data=np.zeros(IN_DIM))
            msgs[side] = str(info.value)
            with pytest.raises(ValueError):
                serving.Router([])
        finally:
            router.close(stop_backends=True)
        with pytest.raises(serving.ServerClosedError):
            router.submit(data=np.zeros(IN_DIM, np.float32))
        router.close()  # idempotent
    assert msgs["port"] == msgs["jax"]


def test_failover_zero_failed_requests_and_breaker_recovery():
    X = _x(12, seed=2)
    ref = _reference(X)
    router = tserving.Router(_servers(2), seed=3, retries=2,
                             breaker_threshold=3, breaker_cooldown_ms=80)
    try:
        with faults.inject("serving.replica.r1.call:ioerr=1", seed=7):
            got = np.stack([router.predict(data=X[i])[0] for i in range(12)])
        np.testing.assert_allclose(got, ref, **TOL)
        snap = router.metrics.snapshot()
        assert snap["failed"] == {}
        assert snap["completed"] == {"interactive": 12}
        assert snap["retries"] >= 3
        assert snap["replica_failures"]["r1"] >= 3
        assert snap["breaker_transitions"]["open"] >= 1
        states = {d["name"]: d["state"] for d in router.describe()}
        assert states == {"r0": trouter.BREAKER_CLOSED,
                          "r1": trouter.BREAKER_OPEN}
        # the fault cleared and the cooldown passed: one half-open probe
        # through r1 succeeds and closes its breaker
        _expire_cooldown(router, "r1")
        for i in range(6):
            router.predict(data=X[i])
        snap = router.metrics.snapshot()
        assert snap["failed"] == {}
        assert snap["breaker_transitions"]["half_open"] >= 1
        assert snap["breaker_transitions"]["closed"] >= 1
        assert {d["name"]: d["state"] for d in router.describe()}["r1"] == \
            trouter.BREAKER_CLOSED
    finally:
        router.close(stop_backends=True)


def test_all_replicas_down_is_a_typed_503_like_jax():
    got = {}
    for side, (pkg, serving) in SIDES.items():
        router = serving.Router(_servers(1, side), seed=0, retries=2,
                                breaker_threshold=1)
        host, port = router.serve_http()
        try:
            with pkg.faults.inject("serving.replica.*.call:ioerr=1", seed=1):
                fut = router.submit(data=np.zeros(IN_DIM, np.float32))
                with pytest.raises(serving.NoReplicaAvailableError) as info:
                    fut.result(timeout=WAIT)
                _expire_cooldown(router, "r0")
                code, body, _ = _http(
                    "http://%s:%d/predict" % (host, port),
                    {"inputs": {"data": [0.0] * IN_DIM}},
                    {"X-Request-Id": "req-http"})
            got[side] = (str(info.value), code, body,
                         router.metrics.snapshot()["failed"])
        finally:
            router.close(stop_backends=True)
    assert got["port"] == got["jax"]
    assert got["port"][1] == 503
    assert got["port"][3] == {"interactive": 2}


def test_hedging_with_an_injected_slow_replica():
    """A call stuck on r0 (a 300 ms ``faults`` delay) is duplicated onto r1
    after the 40 ms hedge delay and r1's answer wins."""
    X = _x(6, seed=4)
    ref = _reference(X)
    router = tserving.Router(_servers(2), seed=5, hedge_ms=40)
    try:
        with faults.inject("serving.replica.r0.call:delay=1@300ms", seed=2):
            got = np.stack([router.predict(data=X[i])[0] for i in range(6)])
        np.testing.assert_allclose(got, ref, **TOL)
        snap = router.metrics.snapshot()
        assert snap["failed"] == {}
        assert snap["hedges"] >= 1 and snap["hedge_wins"] >= 1
    finally:
        router.close(stop_backends=True)


def test_slo_shedding_under_pressure():
    router = tserving.Router(_servers(1), shed_pressure=0.75)
    try:
        router.pressure = lambda: 0.9
        with pytest.raises(tserving.RouterOverloadError) as err:
            router.submit(slo="batch", data=np.zeros(IN_DIM, np.float32))
        assert err.value.retry_after > 0
        assert str(err.value) == "shedding 'batch' traffic at 90% queue " \
            "pressure"
        out = router.predict(data=np.zeros(IN_DIM, np.float32))
        assert out[0].shape == (HID,)
        snap = router.metrics.snapshot()
        assert snap["shed"] == {"batch": 1}
        assert snap["completed"] == {"interactive": 1}
        assert router.signals()["shed_total"] == 1
    finally:
        router.close(stop_backends=True)


def test_pressure_reflects_real_backlog():
    """Four requests queued on a server that has not started fill its
    queue of 4: pressure 1.0; started, it drains to 0."""
    srvs = _servers(1, max_queue=4, start=False)
    router = tserving.Router(srvs)
    try:
        assert router.pressure() == 0.0
        futs = [srvs[0].submit(data=np.zeros(IN_DIM, np.float32))
                for _ in range(4)]
        assert router.pressure() == 1.0
        assert router.signals()["pressure"] == 1.0
        srvs[0].start()
        for f in futs:
            f.result(timeout=WAIT)
        assert router.pressure() == 0.0
    finally:
        router.close(stop_backends=True)


def test_slo_class_deadline_budget_like_jax():
    """A class deadline of 20 ms on a server that flushes every 300 ms:
    the request expires in the queue, as in the JAX package."""
    got = {}
    for side, (pkg, serving) in SIDES.items():
        classes = serving.router.default_slo_classes()
        classes["interactive"] = serving.SLOClass("interactive",
                                                  deadline_ms=20)
        router = serving.Router(_servers(1, side, max_wait_us=300000),
                                slo_classes=classes)
        try:
            fut = router.submit(data=np.zeros(IN_DIM, np.float32))
            with pytest.raises(serving.DeadlineExceededError) as info:
                fut.result(timeout=WAIT)
            got[side] = (str(info.value),
                         router.metrics.snapshot()["expired"])
        finally:
            router.close(stop_backends=True)
    assert got["port"] == got["jax"] == (
        "request waited past its deadline", {"interactive": 1})
    assert repr(tserving.router.default_slo_classes()["batch"]) == \
        repr(jserving.router.default_slo_classes()["batch"])


def _save(prefix, epoch, seed):
    mx.model.save_checkpoint(prefix, epoch, _net(mx),
                             {k: mx.nd.array(v)
                              for k, v in _np_params(seed).items()}, {})


def test_hot_swap_under_load_zero_downtime(tmp_path):
    prefix = str(tmp_path / "swapm")
    _save(prefix, 1, 10)
    _save(prefix, 2, 11)
    X = _x(8, seed=6)
    ref1, ref2 = _reference(X, 10), _reference(X, 11)
    srvs = [tserving.InferenceServer.from_checkpoint(
        prefix, 1, {"data": (4, IN_DIM)}, max_wait_us=1000, ctx=mt.cpu())
        for _ in range(2)]
    router = tserving.Router(srvs, seed=7)
    stop_evt = threading.Event()
    swapped_at = [None]
    failures, outputs = [], []

    def load():
        i = 0
        while not stop_evt.is_set() and i < 2000:
            t_submit = time.monotonic()
            try:
                out = router.predict(data=X[i % len(X)])
                outputs.append((i % len(X), t_submit, out[0]))
            except Exception as exc:
                failures.append(exc)
            i += 1

    threads = [threading.Thread(target=load, daemon=True) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        while len(outputs) < 20 and not failures:
            time.sleep(0.005)
        swapped = router.swap(prefix, 2)
        swapped_at[0] = time.monotonic()
        n_before = len(outputs)
        while len(outputs) < n_before + 20 and not failures:
            time.sleep(0.005)
        stop_evt.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert swapped == 2
        assert not failures, failures[:3]
        for idx, t_submit, out in outputs:
            new = np.allclose(out, ref2[idx], **TOL)
            assert new or np.allclose(out, ref1[idx], **TOL)
            if t_submit > swapped_at[0]:
                assert new
        assert router.cold_bucket_runs() == 0
        snap = router.metrics.snapshot()
        assert snap["failed"] == {} and snap["swaps"] == 2
        np.testing.assert_allclose(router.predict(data=X[0])[0], ref2[0],
                                   **TOL)
    finally:
        stop_evt.set()
        router.close(stop_backends=True)
        for s in srvs:
            s.stop()


# -- HTTP front door ---------------------------------------------------------
def test_router_http_front_door_matches_jax():
    X = _x(2, seed=9)
    ref = _reference(X)
    got = {}
    for side, (pkg, serving) in SIDES.items():
        router = serving.Router(_servers(2, side), seed=2)
        try:
            host, port = router.serve_http()
            base = "http://%s:%d" % (host, port)
            code, body, _ = _http(base + "/predict",
                                  {"inputs": {"data": X[0].tolist()}},
                                  {"X-SLO-Class": "interactive",
                                   "X-Request-Id": "req-http-1"})
            assert code == 200
            np.testing.assert_allclose(
                np.asarray(json.loads(body)["outputs"][0]), ref[0], **TOL)
            metrics = _http(base + "/metrics")
            assert "mxtpu_router_requests_total" in metrics[1]
            assert "mxtpu_router_latency_ms" in metrics[1]
            reps = json.loads(_http(base + "/replicas")[1])
            assert all(d["state"] == "closed" and d["ready"] for d in reps)
            router.pressure = lambda: 1.0
            shed = _http(base + "/predict",
                         {"inputs": {"data": X[0].tolist()}},
                         {"X-SLO-Class": "batch"})
            got[side] = (metrics[0], _http(base + "/healthz")[:2],
                         _http(base + "/readyz")[:2],
                         sorted((d["name"], sorted(d)) for d in reps),
                         shed[:2], shed[2]["Retry-After"],
                         _http(base + "/nope")[:2],
                         _http(base + "/nope", {})[:2])
        finally:
            router.close(stop_backends=True)
    assert got["port"] == got["jax"]
    assert got["port"][4][0] == 429 and float(got["port"][5]) > 0


def test_port_router_over_a_jax_server_and_jax_router_over_a_port_server():
    X = _x(3, seed=10)
    ref = _reference(X)
    for front, back in (("port", "jax"), ("jax", "port")):
        srv = _server(back)
        host, port = srv.serve_http()
        router = SIDES[front][1].Router(["%s:%d" % (host, port)], seed=4)
        try:
            got = np.stack([router.predict(data=X[i])[0] for i in range(3)])
            np.testing.assert_allclose(got, ref, **TOL)
            d = router.describe()[0]
            assert d["kind"] == "remote" and d["ready"]
            assert router.metrics.snapshot()["completed"] == \
                {"interactive": 3}
        finally:
            router.close()
            srv.stop()


def test_breaker_half_open_admits_exactly_one_concurrent_probe():
    router = tserving.Router(_servers(1))
    try:
        rep = router.replicas()[0]
        rep.state = trouter.BREAKER_HALF_OPEN
        rep._probe_inflight = False
        wins = []
        barrier = threading.Barrier(8)

        def contender():
            barrier.wait(WAIT)
            if rep.try_reserve():
                wins.append(1)

        threads = [threading.Thread(target=contender) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert len(wins) == 1
        assert not rep.try_reserve()
        rep.release()
        assert rep.try_reserve()
        rep.end_call(True, 1.0)
        assert rep.state == trouter.BREAKER_CLOSED
        assert rep.try_reserve()
    finally:
        router.close(stop_backends=True)


def test_remote_probe_debounce(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_PROBE_FAILURES", "3")
    srv = _server()
    host, port = srv.serve_http()
    router = tserving.Router(["%s:%d" % (host, port)], seed=5)
    try:
        rep = router.replicas()[0]
        rep._probe()
        assert rep.ready() and rep.alive()
        good = rep._base
        rep._base = "http://127.0.0.1:1"   # nothing listens here
        for _ in range(2):
            rep._probe()
            assert rep.ready() and rep.alive()   # debounced
        rep._probe()
        assert not rep.ready() and not rep.alive()
        rep._base = good
        rep._probe()
        assert rep.ready() and rep.alive()
        dead = trouter._RemoteReplica("dead", "127.0.0.1:1", router)
        dead._probe()   # first contact: a miss counts at once
        assert not dead.ready() and not dead.alive()
    finally:
        router.close()
        srv.stop()


def test_router_dynamic_add_remove_replica():
    router = tserving.Router(_servers(1), seed=6)
    extra = _server()
    try:
        name = router.add_replica(extra)
        assert len(router.replicas()) == 2
        with pytest.raises(mt.base.MXNetError, match="already in rotation"):
            router.add_replica(extra, name=name)
        X = _x(12, seed=2)
        for i in range(12):
            router.predict(data=X[i])
        assert {d["name"]: d["calls"] for d in router.describe()}[name] > 0
        assert router.remove_replica(name, drain_timeout_ms=5000) is extra
        assert len(router.replicas()) == 1
        assert router.remove_replica("ghost") is None
        router.predict(data=X[0])
    finally:
        extra.stop()
        router.close(stop_backends=True)


def test_router_registry_sync_converges():
    srvs = _servers(2)
    registry = tserving.ReplicaRegistry(ttl_ms=60000)
    registry.register("a", srvs[0])
    routers = [tserving.Router(registry=registry, registry_sync_ms=60000,
                               seed=i) for i in range(2)]

    def names(r):
        return {d["name"] for d in r.describe()}

    try:
        assert all(names(r) == {"a"} for r in routers)
        registry.register("b", srvs[1])
        for r in routers:
            r.sync_registry()
        assert all(names(r) == {"a", "b"} for r in routers)
        for r in routers:
            r.predict(data=np.zeros(IN_DIM, np.float32))
        registry.deregister("b")
        for r in routers:
            r.sync_registry()   # drains b out in a background thread
        deadline = time.monotonic() + WAIT
        while any(names(r) != {"a"} for r in routers):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        for r in routers:
            r.predict(data=np.zeros(IN_DIM, np.float32))
    finally:
        for r in routers:
            r.close()
        for s in srvs:
            s.stop()


# -- generation: POST /generate and streams through the router ---------------
V, LAYERS, HEADS, LM_HID, S = 64, 2, 2, 32, 32
SPEC = dict(vocab_size=V, num_layers=LAYERS, num_heads=HEADS, hidden=LM_HID,
            max_seq_len=S, lane_buckets=(1, 2), page_size=4, num_pages=48,
            prefill_len_buckets=(16, 32), prefill_batch_buckets=(1, 2))
NEAR_TIE = 1e-4
LM_SHAPES = {"data": (2, S), "softmax_label": (2, S)}


def _lm_np(seed=0):
    """tests/test_generation.py's ``_lm_params`` weights, as numpy."""
    net = mt.models.transformer.get_transformer_lm(
        vocab_size=V, num_layers=LAYERS, num_heads=HEADS, hidden=LM_HID,
        seq_len=S)
    arg_shapes, _, _ = net.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(seed)
    return {name: rng.randn(*shp).astype(np.float32) * 0.05
            for name, shp in zip(net.list_arguments(), arg_shapes)
            if name not in ("data", "softmax_label")}


_LM = _lm_np()


def _lm_server(side="port", generator=True, **kw):
    pkg, serving = SIDES[side]
    with pkg.NameManager():
        net = pkg.models.transformer.get_transformer_lm(
            vocab_size=V, num_layers=LAYERS, num_heads=HEADS, hidden=LM_HID,
            seq_len=S)
    if side == "port":
        kw.setdefault("ctx", mt.cpu())
        params = {k: mt.nd.array(v, mt.cpu()) for k, v in _LM.items()}
    else:
        params = {k: mx.nd.array(v) for k, v in _LM.items()}
    if generator:
        kw["generator_spec"] = dict(SPEC)
    return serving.InferenceServer(net, params, LM_SHAPES, **kw)


_LOGITS = {}


def _logits_at(tokens):
    """The JAX package's dense prefill logits after ``tokens``."""
    if "pred" not in _LOGITS:
        from mxnet_tpu.models.transformer import get_transformer_lm_prefill

        _LOGITS["pred"] = mx.Predictor(
            get_transformer_lm_prefill(V, LAYERS, HEADS, LM_HID, seq_len=S,
                                       max_seq_len=S),
            {k: mx.nd.array(v) for k, v in _LM.items()}, {"data": (1, S)})
    buf = np.zeros((1, S), np.float32)
    buf[0, :len(tokens)] = tokens
    return _LOGITS["pred"].forward(data=buf)[0].asnumpy()[0, len(tokens) - 1]


def _near_tie_equal(got, ref, prompt):
    """``got`` equals ``ref``, or splits from it only where the reference's
    top-2 logits tie within NEAR_TIE of the largest |logit|."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            logits = _logits_at(list(prompt) + list(ref[:i]))
            top2 = np.sort(logits)[-2:]
            gap = float(top2[1] - top2[0]) / float(np.abs(logits).max())
            assert gap <= NEAR_TIE, "split at %d, top-2 gap %.3g" % (i, gap)
            return False
    assert len(got) == len(ref)
    return True


def _stream(url, payload):
    """(token list, final record, content type) of one NDJSON stream."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, final = [], None
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        ctype = resp.headers["Content-Type"]
        for line in resp:
            obj = json.loads(line)
            if "token" in obj:
                toks.append(obj["token"])
            else:
                final = obj
                break
    return toks, final, ctype


PROMPTS = [[3, 11, 7], [5, 9, 2, 40, 1], [17, 60, 33, 8]]


def test_http_generate_streams_ndjson_like_jax():
    got = {}
    for side in SIDES:
        srv = _lm_server(side)
        try:
            host, port = srv.serve_http()
            got[side] = []
            for prompt in PROMPTS:
                ref = srv.submit_generate(prompt, 8).result(timeout=WAIT)
                toks, final, ctype = _stream(
                    "http://%s:%d/generate" % (host, port),
                    {"prompt": prompt, "max_new_tokens": 8})
                assert toks == ref
                assert ctype == "application/x-ndjson"
                assert sorted(final) == ["done", "n", "ttft_ms"]
                assert final["done"] is True and final["n"] == len(ref)
                assert final["ttft_ms"] > 0
                got[side].append(toks)
        finally:
            srv.stop()
    ties = sum(not _near_tie_equal(t, j, p)
               for t, j, p in zip(got["port"], got["jax"], PROMPTS))
    print("%d of %d streams split at a near tie" % (ties, len(PROMPTS)))


def test_http_generate_404_without_a_generator_like_jax():
    got = {}
    for side in SIDES:
        srv = _lm_server(side, generator=False, warmup=False)
        try:
            host, port = srv.serve_http()
            got[side] = _http("http://%s:%d/generate" % (host, port),
                              {"prompt": [1], "max_new_tokens": 2})[:2]
            with pytest.raises(SIDES[side][0].base.MXNetError,
                               match="no generator attached"):
                srv.submit_generate([1], 2)
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 404


def _sequential(prompts, n):
    srv = _lm_server("port", warmup=False)
    try:
        return [srv.submit_generate(p, n).result(timeout=WAIT)
                for p in prompts]
    finally:
        srv.stop()


def test_router_generate_stream_parity():
    refs = _sequential(PROMPTS, 7)
    srvs = [_lm_server() for _ in range(2)]
    router = tserving.Router(srvs, seed=2)
    try:
        for p, ref in zip(PROMPTS, refs):
            assert list(router.generate(p, 7)) == ref
        assert router.metrics.snapshot()["streams"].get("generate") == 3
        host, port = router.serve_http()
        toks, final, _ = _stream("http://%s:%d/generate" % (host, port),
                                 {"prompt": PROMPTS[0],
                                  "max_new_tokens": 7})
        assert toks == refs[0] and final == {"done": True, "n": 7}
    finally:
        router.close()
        for s in srvs:
            s.stop()


def test_router_resumes_stream_after_replica_kill():
    prompt = [5, 9, 2]
    ref = _sequential([prompt], 12)[0]
    srvs = [_lm_server() for _ in range(2)]
    router = tserving.Router(srvs, seed=3)
    try:
        out, killed = [], None
        for tok in router.generate(prompt, 12):
            out.append(tok)
            if len(out) == 4 and killed is None:
                killed = next(s for s in srvs
                              if s._generator.active_lanes() > 0)
                killer = threading.Thread(target=killed.stop,
                                          kwargs={"drain": False})
                killer.start()
        killer.join(WAIT)
        assert out == ref
        assert router.metrics.snapshot()["stream_resumes"] == 1
        assert killed.ready_state() == "stopped"
    finally:
        router.close()
        for s in srvs:
            s.stop()
