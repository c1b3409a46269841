"""The port's ``Autoscaler``, ``ReplicaRegistry``/``RegistryClient``,
heartbeater, preemption handler and ``ProcessProvider`` against the JAX
package's (tests/test_autoscaler.py), on the CPU.

The same signal traces, replayed on a fake clock against a fake router,
give the same decisions from both packages' autoscalers; the registry's
generations, heartbeats and stale eviction run on a fake clock too; its
HTTP face works with the other package's client in both directions.  The
flash crowd drives a real router and warm in-process replicas, with the
load made by queueing on a server that has not started, so no case races
the wall clock.  One subprocess test: a ``python -m
mxnet_tpu_torch.serving.launch`` replica on the CPU that registers,
answers and exits 0 on SIGTERM."""
import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import registry as jregistry
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.serving import registry as tregistry

IN_DIM, HID = 6, 3
TOL = dict(rtol=1e-5, atol=1e-5)
WAIT = 60
SIDES = {"jax": (mx, jserving), "port": (mt, tserving)}


# -- fakes: the state machine needs signals, not servers ---------------------
class FakeRouter:
    def __init__(self):
        self.sig = dict(pressure=0.0, replicas=1, ready=1, draining=0,
                        breakers_open=0, shed_total=0, expired_total=0,
                        p99_ms={}, deadline_ms={})
        self.added = []
        self.removed = []

    def signals(self):
        return dict(self.sig)

    def add_replica(self, backend, name=None):
        self.added.append(name)
        self.sig["replicas"] += 1
        return name

    def remove_replica(self, name, drain=True, drain_timeout_ms=None,
                       wait=True):
        self.removed.append(name)
        self.sig["replicas"] -= 1
        return "backend"

    def describe(self):
        return [{"name": n, "draining": False, "inflight": 0,
                 "queue_depth": 0}
                for n in self.added if n not in self.removed]


class FakeProvider:
    self_registering = False

    def __init__(self):
        self.n = 0
        self.retired = []

    def spawn(self):
        self.n += 1
        return "a%d" % self.n, object()

    def retire(self, name, backend):
        self.retired.append(name)


def _hot(sig):
    sig["pressure"] = 1.0


def _cold(sig):
    sig["pressure"] = 0.0


def _mid(sig):
    sig["pressure"] = 0.2


def _slo_hot(sig):
    sig.update(p99_ms={"interactive": 90.0}, deadline_ms={"interactive": 50.0})


def _slo_ok(sig):
    sig.update(p99_ms={"interactive": 30.0}, deadline_ms={"interactive": 50.0},
               pressure=0.2)


def _breaker(sig):
    sig["breakers_open"] = 1


def _shed(sig):
    sig["shed_total"] += 5


# each trace: (Autoscaler kwargs, [(clock, signal change or None)])
TRACES = {
    "hysteresis": (dict(hysteresis=3), [
        (0.0, _hot), (0.0, None), (0.0, _mid), (0.0, _hot), (0.0, None),
        (0.0, None)]),
    "cooldown": (dict(cooldown_ms=1000), [
        (0.0, _hot), (0.0, None)] + [(0.0, None)] * 5 + [
        (0.999, None), (1.001, None), (1.5, None)]),
    "band_and_ownership": (dict(max_replicas=2, cooldown_ms=100), [
        (0.0, _hot), (0.0, None)] + [(1.0, None)] * 5 + [
        (2.0, _cold), (2.0, None)] + [(3.0, None)] * 5),
    "slo_vote": (dict(), [(0.0, None), (0.0, _slo_hot), (0.0, None)]),
    "breaker_vote": (dict(), [(0.0, None), (0.0, _breaker), (0.0, None)]),
    "shed_vote": (dict(), [(0.0, None), (0.0, _shed), (0.0, _shed)]),
    "slo_under_budget": (dict(), [(0.0, _slo_ok)] + [(0.0, None)] * 4),
    "in_and_out": (dict(cooldown_ms=10), [
        (0.0, _hot), (0.0, None), (0.1, _cold), (0.1, None), (0.2, _hot),
        (0.3, None), (0.4, _cold), (0.5, None), (0.6, None)]),
}


def _replay(serving, faults, trace, fault_steps=()):
    kw, steps = trace
    kw = dict(dict(min_replicas=1, max_replicas=3, hysteresis=2,
                   cooldown_ms=1000), **kw)
    t = [0.0]
    router, provider = FakeRouter(), FakeProvider()
    asc = serving.Autoscaler(router, provider, clock=lambda: t[0], **kw)
    decisions = []
    for i, (now, change) in enumerate(steps):
        t[0] = now
        if change is not None:
            change(router.sig)
        if i in fault_steps:
            with faults.inject("serving.autoscaler.scale_out:ioerr=1",
                               seed=0):
                ev = asc.tick()
        else:
            ev = asc.tick()
        decisions.append(ev)
    return decisions, router.added, router.removed, provider.retired, \
        sorted(asc.owned()), _series(asc.metrics_text())


def _series(text):
    return sorted(line.rsplit(" ", 1)[0] if not line.startswith("#") else
                  line for line in text.strip().splitlines())


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_same_trace_same_decisions(trace):
    got = {side: _replay(serving, pkg.faults, TRACES[trace])
           for side, (pkg, serving) in SIDES.items()}
    assert repr(got["port"]) == repr(got["jax"])
    assert any(got["port"][0]) != (trace == "slo_under_budget")


def test_decisions_are_fault_injectable_in_both():
    trace = (dict(cooldown_ms=100), [(0.0, _hot), (0.0, None), (1.0, None),
                                     (1.0, None)])
    got = {side: _replay(serving, pkg.faults, trace, fault_steps=(0, 1))
           for side, (pkg, serving) in SIDES.items()}
    assert repr(got["port"]) == repr(got["jax"])
    failed = got["port"][0][1]
    assert failed["op"] == "scale_out" and not failed["ok"]
    assert "InjectedIOError" in failed["error"]
    assert got["port"][0][3]["ok"] and got["port"][1] == ["a1"]


# -- the registry: membership on a fake clock --------------------------------
class FakeTime:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


def _membership(module, serving, monkeypatch):
    clock = FakeTime()
    monkeypatch.setattr(module, "time", clock)
    reg = serving.ReplicaRegistry(ttl_ms=80)
    out = [reg.gen(), reg.register("a", "127.0.0.1:1", {"v": 1}),
           reg.register("a", "127.0.0.1:1"), reg.heartbeat("a"),
           reg.heartbeat("ghost"), reg.register("dead", "y"), reg.live()]
    clock.now += 0.05
    out += [reg.heartbeat("a"), reg.live()["replicas"]]
    clock.now += 0.05          # "dead" is 100 ms stale, "a" 50 ms
    out += [reg.live(), reg.gen()]
    out += [reg.deregister("a"), reg.deregister("a"), reg.live()]
    return out


def test_registry_generations_heartbeat_and_eviction(monkeypatch):
    got = {"jax": _membership(jregistry, jserving, monkeypatch),
           "port": _membership(tregistry, tserving, monkeypatch)}
    assert got["port"] == got["jax"]
    live = got["port"][9]
    assert live["replicas"] == {"a": "127.0.0.1:1"}
    assert live["meta"] == {"a": {}}


@pytest.mark.parametrize("pair", ["port_client_jax_registry",
                                  "jax_client_port_registry"])
def test_registry_http_face_across_packages(pair):
    client_pkg = tserving if pair.startswith("port") else jserving
    registry_pkg = jserving if pair.startswith("port") else tserving
    reg = registry_pkg.ReplicaRegistry(ttl_ms=60000)
    try:
        reg.serve_http()
        cli = client_pkg.RegistryClient(reg.addr)
        g = cli.register("web", "127.0.0.1:9", {"model": "mlp"})
        assert cli.live() == {"gen": g, "replicas": {"web": "127.0.0.1:9"},
                              "meta": {"web": {"model": "mlp"}}}
        assert cli.gen() == g
        assert cli.heartbeat("web") and not cli.heartbeat("ghost")
        assert cli.deregister("web") == g + 1
        assert cli.live()["replicas"] == {}
        with pytest.raises(urllib.error.HTTPError) as info:
            cli.register("bad", {"not": "a string"})
        assert info.value.code == 400
        info.value.close()
    finally:
        reg.close()


@pytest.mark.parametrize("where", ["port_registry", "jax_registry_http"])
def test_heartbeater_reregisters_after_an_eviction(where):
    reg = (tserving if where == "port_registry" else
           jserving).ReplicaRegistry(ttl_ms=60000)
    target = reg
    if where == "jax_registry_http":
        reg.serve_http()
        target = tserving.RegistryClient(reg.addr)
    stop = tserving.start_heartbeater(target, "r0", "127.0.0.1:5",
                                      interval_ms=10)
    try:
        assert "r0" in reg.live()["replicas"]
        reg.deregister("r0")       # what an eviction leaves behind
        deadline = time.monotonic() + WAIT
        while "r0" not in reg.live()["replicas"]:
            assert time.monotonic() < deadline, "never re-registered"
            time.sleep(0.005)
    finally:
        stop()
    assert "r0" not in reg.live()["replicas"]   # stop() deregistered
    reg.close()


# -- the preemption handler --------------------------------------------------
def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.randn(HID, IN_DIM).astype(np.float32),
            "fc_bias": rng.randn(HID).astype(np.float32)}


def _net(pkg):
    with pkg.NameManager():
        return pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                      num_hidden=HID, name="fc")


def _server(**kw):
    kw.setdefault("max_wait_us", 1000)
    kw.setdefault("warmup", False)
    kw.setdefault("ctx", mt.cpu())
    params = {k: mt.nd.array(v, mt.cpu()) for k, v in _np_params().items()}
    return tserving.InferenceServer(_net(mt), params, {"data": (4, IN_DIM)},
                                    **kw)


def _reference(x):
    pred = mx.Predictor(_net(mx), {k: mx.nd.array(v)
                                   for k, v in _np_params().items()},
                        {"data": (1, IN_DIM)})
    return pred.forward(data=np.asarray(x, np.float32)[None])[0].asnumpy()[0]


def test_preemption_handler_drains_and_deregisters():
    srv = _server()
    calls = []
    handler = tserving.install_preemption_handler(
        srv, deregister=lambda: calls.append("dereg"), exit_process=False)
    fut = srv.submit(data=np.zeros(IN_DIM, np.float32))
    handler(signal.SIGTERM, None)
    assert calls == ["dereg"]
    assert srv.ready_state() == "stopped"
    assert fut.result(timeout=WAIT) is not None   # drained, not dropped
    handler(signal.SIGTERM, None)                 # idempotent
    assert calls == ["dereg"]
    assert srv.resident_bytes() == 0


# -- a flash crowd in-process -------------------------------------------------
def test_flash_crowd_scales_out_and_back(tmp_path):
    """A seed server that has not started takes a crowd of 8 queued
    requests (pressure 1.0): two hot ticks spawn a warm replica from the
    checkpoint; routed traffic runs on both with zero failures; once the
    crowd drains two cold ticks retire the spawned replica, and the seed is
    never retired.  The provider, built under ``with mt.cpu():``, spawns on
    the CPU from a thread outside that block."""
    prefix = str(tmp_path / "crowd")
    mx.model.save_checkpoint(prefix, 1, _net(mx),
                             {k: mx.nd.array(v)
                              for k, v in _np_params().items()}, {})
    seed = _server(start=False, max_queue=8)
    router = tserving.Router([seed], seed=1)
    with mt.cpu():  # the provider keeps this context for its spawns
        provider = tserving.LocalCheckpointProvider(
            prefix, 1, {"data": (4, IN_DIM)}, max_wait_us=1000)
    t = [0.0]
    asc = tserving.Autoscaler(router, provider, min_replicas=1,
                              max_replicas=3, hysteresis=2, cooldown_ms=1000,
                              clock=lambda: t[0])
    X = np.random.RandomState(3).randn(40, IN_DIM).astype(np.float32)
    try:
        crowd = [seed.submit(data=X[i]) for i in range(8)]
        assert router.pressure() == 1.0
        assert asc.tick() is None
        ev = asc.tick()
        assert ev["op"] == "scale_out" and ev["ok"], ev
        spawned = router.replicas()[1].server
        assert spawned.ready() and spawned.cold_bucket_runs() == 0
        seed.start()
        failures, outs = [], {}

        def client(k):
            for i in range(k, 32, 4):
                try:
                    outs[i] = router.predict(data=X[8 + i])[0]
                except Exception as exc:
                    failures.append(exc)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
        assert not failures, failures[:3]
        for i, out in outs.items():
            np.testing.assert_allclose(out, _reference(X[8 + i]), **TOL)
        for f in crowd:
            f.result(timeout=WAIT)
        assert spawned.cold_bucket_runs() == 0
        assert {d["name"]: d["calls"] > 0 for d in router.describe()} == \
            {"r0": True, "auto0": True}
        t[0] = 2.0
        assert router.pressure() == 0.0
        assert asc.tick() is None
        ev = asc.tick()
        assert ev["op"] == "scale_in" and ev["replica"] == "auto0", ev
        assert spawned.ready_state() == "stopped"
        t[0] = 4.0
        assert asc.tick() is None and asc.tick() is None  # the seed stays
        assert [d["name"] for d in router.describe()] == ["r0"]
        assert router.metrics.snapshot()["failed"] == {}
    finally:
        asc.stop(retire_owned=True)
        router.close(stop_backends=True)


# -- one replica process -----------------------------------------------------
def test_process_provider_replica_registers_answers_and_exits_on_sigterm(
        tmp_path, monkeypatch):
    prefix = str(tmp_path / "proc")
    mt.model.save_checkpoint(prefix, 1, _net(mt),
                             {k: mt.nd.array(v, mt.cpu())
                              for k, v in _np_params().items()}, {})
    reg = tserving.ReplicaRegistry(ttl_ms=60000)
    reg.serve_http()
    monkeypatch.setenv("MXNET_SERVING_CTX", "cpu")  # the child inherits it
    provider = tserving.ProcessProvider(reg.addr, prefix, 1,
                                        {"data": (4, IN_DIM)})
    name, proc = provider.spawn()
    try:
        deadline = time.monotonic() + WAIT
        while name not in reg.live()["replicas"]:
            assert proc.poll() is None, "the replica exited %s" % proc.poll()
            assert time.monotonic() < deadline, "never registered"
            time.sleep(0.05)
        addr = reg.live()["replicas"][name]
        x = np.arange(IN_DIM, dtype=np.float32)
        req = urllib.request.Request(
            "http://%s/predict" % addr,
            data=json.dumps({"inputs": {"data": x.tolist()}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            out = np.asarray(json.loads(resp.read())["outputs"][0],
                             np.float32)
        np.testing.assert_allclose(out, _reference(x), **TOL)
        t0 = time.monotonic()
        provider.retire(name, proc)
        assert proc.returncode == 0
        assert time.monotonic() - t0 < WAIT
        assert name not in reg.live()["replicas"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        reg.close()
