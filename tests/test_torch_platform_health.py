"""The port's failure-domain platform against the JAX package's
(tests/test_platform_health.py), on the CPU, case for case: the health
plane's debounce, replica spread over domains, the degradation ladder (reap,
re-fault, brownout, graceful page-out), leak-free fault-in failure, 503 +
Retry-After during the fault-in window, and page-out racing live traffic.

Both packages run each scenario on checkpoints written by the JAX package's
``save_checkpoint``, with ``MXNET_COMPILE_CACHE_DIR`` unset (no AOT bundles);
the port's managers are built under ``with mt.cpu():``.
Equal: health states and transitions after the same injected faults,
placements, the ladder's ``platform_*`` event kinds in order with their plan
generations, error types and messages; outputs within 1e-5.  Registry TTLs
run on a fake clock, so no count depends on the wall clock; every wait is
bounded.  Host death is simulated by stopping heartbeats or injected probe
faults, never by killing a process."""
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import platform as jplat
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.serving import registry as jregistry
from mxnet_tpu.serving import router as jrouter
from mxnet_tpu_torch import platform as tplat
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.serving import registry as tregistry
from mxnet_tpu_torch.serving import router as trouter

IN_DIM = 4
TOL = dict(rtol=1e-5, atol=1e-5)
WAIT = 30
SIDES = {"jax": (mx, jplat, jserving), "port": (mt, tplat, tserving)}
REGISTRY = {"jax": jregistry, "port": tregistry}
ROUTER = {"jax": jrouter, "port": trouter}


@pytest.fixture(autouse=True)
def _platform_env(monkeypatch):
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setenv("MXNET_PLATFORM_MIN_RESIDENT_S", "0")
    jtelemetry._reset_for_tests()
    monkeypatch.setattr(mt.telemetry, "_registry", None)
    monkeypatch.setattr(mt.telemetry, "_event_log", None)
    monkeypatch.setattr(mt.telemetry, "_collectors", [])
    yield
    jtelemetry._reset_for_tests()


def _events_on(monkeypatch):
    """Structured events on in both packages (each starts empty)."""
    jtelemetry.enable()
    monkeypatch.setattr(mt.telemetry, "_ENABLED", True)


class FakeTime:
    """A ``time`` stand-in for the registry module: members go stale only
    when a test advances ``now``."""

    def __init__(self, now=100.0):
        self.now = now

    def monotonic(self):
        return self.now


def _registry_clock(monkeypatch):
    clock = FakeTime()
    for module in REGISTRY.values():
        monkeypatch.setattr(module, "time", clock)
    return clock


def _manager(side, pool, **kw):
    plat = SIDES[side][1]
    if side == "port":
        with mt.cpu():
            return plat.ModelManager(pool, **kw)
    return plat.ModelManager(pool, **kw)


def _error(exc):
    return type(exc).__name__, str(exc)


def _save_fc(tmp_path, name, seed=0, in_dim=IN_DIM, hid=2):
    rng = np.random.RandomState(seed)
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=hid,
                                name="fc")
    params = {
        "fc_weight": mx.nd.array(rng.randn(hid, in_dim).astype(np.float32)),
        "fc_bias": mx.nd.array(rng.randn(hid).astype(np.float32)),
    }
    prefix = str(tmp_path / name)
    mx.model.save_checkpoint(prefix, 1, net, params, {})
    return prefix


def _fc_spec(plat, tmp_path, name, **kw):
    prefix = str(tmp_path / name)
    if not os.path.exists(prefix + "-0001.params"):
        _save_fc(tmp_path, name, seed=sum(map(ord, name)) % 97)
    kw.setdefault("param_bytes", 1000)
    kw.setdefault("server_kwargs", {"buckets": (1,)})
    return plat.ModelSpec(name, prefix, 1, {"data": (1, IN_DIM)}, **kw)


def _spec(plat, name, pbytes=100, **kw):
    return plat.ModelSpec(name, "/nonexistent/%s" % name, 1,
                          {"data": (1, IN_DIM)}, param_bytes=pbytes, **kw)


def _tiny_server(side, seed=0):
    pkg, _, serving = SIDES[side]
    kw = {"ctx": mt.cpu()} if side == "port" else {}
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    rng = np.random.RandomState(seed)
    params = {"fc_weight": pkg.nd.array(rng.randn(2, IN_DIM)
                                        .astype(np.float32), **kw),
              "fc_bias": pkg.nd.array(rng.randn(2).astype(np.float32),
                                      **kw)}
    return serving.InferenceServer(net, params, {"data": (1, IN_DIM)},
                                   buckets=(1,), warmup=False, **kw)


def _both(fn):
    got = {side: fn(side, *SIDES[side]) for side in SIDES}
    assert got["port"] == got["jax"]
    return got["port"]


def _both_served(fn):
    """``fn`` returns (observations, output): observations equal, outputs
    within 1e-5."""
    got = {side: fn(side, *SIDES[side]) for side in SIDES}
    assert got["port"][0] == got["jax"][0]
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **TOL)
    return got["port"][0]


X = np.array([0.5, -1.0, 2.0, 0.25], np.float32)


# -- device pool domains ------------------------------------------------------

def test_pool_failure_domains():
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=5, bytes_per_device=100,
                               devices_per_host=2)
        with pytest.raises(pkg.MXNetError) as a:
            plat.DevicePool(num_devices=0, bytes_per_device=1)
        with pytest.raises(pkg.MXNetError) as b:
            plat.DevicePool(num_devices=2, bytes_per_device=1,
                            devices_per_host=-1)
        return (pool.num_domains, [pool.domain_of(d) for d in range(5)],
                pool.devices_in(1), pool.devices_in(2), pool.describe(),
                pool.total_bytes(),
                plat.DevicePool(num_devices=4, bytes_per_device=1)
                .num_domains, _error(a.value), _error(b.value))
    got = _both(run)
    assert got[:4] == (3, [0, 0, 1, 1, 2], [2, 3], [4]) and got[6] == 1


# -- health plane -------------------------------------------------------------

def test_healthplane_registry_debounce_and_recovery(monkeypatch):
    """K empty probes flip a domain whose heartbeats stopped; recovery needs
    a replica heartbeating from it again; an idle domain is not dead."""
    clock = _registry_clock(monkeypatch)

    def run(side, pkg, plat, serving):
        clock.now = 100.0
        pool = plat.DevicePool(num_devices=2, bytes_per_device=100,
                               devices_per_host=1)
        reg = serving.ReplicaRegistry(ttl_ms=80)
        srv = _tiny_server(side)
        seen = []
        hp = plat.HealthPlane(pool, registry=reg, probe_fails=2,
                              on_change=lambda d, up: seen.append((d, up)))
        out = []
        try:
            reg.register("m/r1", srv, meta={"model": "m", "device": 0})
            out += [hp.probe(), hp.alive_devices()]
            clock.now += 0.12  # the heartbeats stop: the entry goes stale
            out += [hp.probe(), hp.probe(), hp.dead_domains(),
                    hp.alive_devices(), hp.is_alive(0), hp.is_alive(1),
                    hp.probe()]
            reg.register("m/r2", srv, meta={"model": "m", "device": 0})
            out += [hp.probe(), hp.alive_devices(), seen, hp.describe()]
        finally:
            reg.close()
            srv.stop(drain=False)
        return out
    out = _both(run)
    assert out[:2] == [[], [0, 1]]
    assert out[2:9] == [[], [(0, False)], [0], [1], False, True, []]
    assert out[9:12] == [[(0, True)], [0, 1], [(0, False), (0, True)]]


def test_healthplane_fault_injected_domain_kill_and_marks():
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=4, bytes_per_device=100,
                               devices_per_host=2)
        hp = plat.HealthPlane(pool, probe_fails=1)
        with pkg.faults.inject("platform.health.domain.1:ioerr=1", seed=7):
            out = [hp.probe(), hp.alive_devices(), hp.describe()]
        out.append(hp.probe())  # no registry: a clean sweep recovers
        hp.mark_down(0)
        out += [hp.dead_domains(), hp.alive_devices()]
        hp.mark_down(0)  # no second transition
        hp.mark_up(0)
        out += [hp.dead_domains(), hp.describe()]
        return out
    out = _both(run)
    assert out[0] == [(1, False)] and out[1] == [0, 1]
    assert out[3] == [(1, True)] and out[4] == [0] and out[6] == []
    assert out[7]["domains"][0]["alive"]


def test_healthplane_probe_loop_starts_and_closes():
    """The background loop probes on its own thread and stops on close."""
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=2, bytes_per_device=100,
                               devices_per_host=1)
        seen = []
        hp = plat.HealthPlane(pool, probe_fails=1,
                              on_change=lambda d, up: seen.append((d, up)))
        with pkg.faults.inject("platform.health.domain.0:ioerr=1", seed=1):
            with hp.start(probe_ms=5):
                t_end = time.monotonic() + WAIT
                while not seen and time.monotonic() < t_end:
                    time.sleep(0.005)
        return seen[:1], hp._loop_thread, hp.dead_domains()
    assert _both(run) == ([(0, False)], None, [0])


# -- planner: replica spread + dead capacity ----------------------------------

def test_planner_spreads_replicas_across_domains():
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=4, bytes_per_device=300,
                               devices_per_host=2)
        specs = {"m": _spec(plat, "m", pbytes=160, replicas=2)}
        a = plat.PlacementPlanner(pool).plan(specs, {"m": 1.0})
        b = plat.PlacementPlanner(pool).plan(specs, {"m": 1.0},
                                             alive_devices=[0, 1])
        return a.describe(), b.describe()
    a, b = _both(run)
    pool_dom = [0, 0, 1, 1]
    assert {pool_dom[d] for d in a["replica_devices"]["m"].values()} \
        == {0, 1}
    assert all("replica" in act for act in a["actions"])
    assert {pool_dom[d] for d in b["replica_devices"]["m"].values()} == {0}


def test_planner_excludes_dead_devices_and_migrates_off_them():
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=2, bytes_per_device=300,
                               devices_per_host=1)
        specs = {"a": _spec(plat, "a", pbytes=160)}
        return [plat.PlacementPlanner(pool).plan(
            specs, {"a": 1.0}, current={"a": 0}, alive_devices=alive)
            .describe() for alive in ([1], [])]
    moved, none = _both(run)
    assert moved["resident"] == {"a": 1}
    assert {"op": "migrate", "model": "a", "src": 0, "dst": 1} \
        in moved["actions"]
    assert none["paged"] == ["a"]


# -- manager: multi-replica lifecycle -----------------------------------------

def test_manager_two_replicas_and_selective_page_out(tmp_path):
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=2, bytes_per_device=1 << 20,
                               devices_per_host=1)
        with _manager(side, pool) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "dup", replicas=2))
            s0 = mgr.fault_in("dup", 0, replica=0)
            s1 = mgr.fault_in("dup", 1, replica=1)
            assert s0 is not s1
            out = [mgr.replica_placement(), mgr.placement(),
                   mgr.registry.live()["meta"]]
            mgr.page_out("dup", replica=1)
            out += [mgr.replica_placement(), mgr.server_for("dup") is s0,
                    sorted(mgr.registry.live()["replicas"])]
            y = np.asarray(s0.submit(data=X).result(WAIT)[0])
            mgr.page_out("dup")
            out += [mgr.resident_bytes(), mgr.server_for("dup"),
                    mgr.describe()["replica_placement"]]
        return out, y
    out = _both_served(run)
    assert out[0] == {"dup": {0: 0, 1: 1}} and out[1] == {"dup": 0}
    assert {m["device"] for m in out[2].values()} == {0, 1}
    assert out[3] == {"dup": {0: 0}} and out[4] and len(out[5]) == 1
    assert out[6:] == [0, None, {}]


def test_manager_kill_replica_leaves_control_plane_stale(tmp_path,
                                                         monkeypatch):
    """A killed replica's heartbeats stop without a deregister: the manager
    still lists it until the health plane reaps it, and only the corpse
    goes stale in the registry."""
    monkeypatch.setenv("MXNET_SERVING_REGISTRY_HEARTBEAT_MS", "20")
    clock = _registry_clock(monkeypatch)

    def run(side, pkg, plat, serving):
        clock.now = 100.0
        pool = plat.DevicePool(num_devices=2, bytes_per_device=1 << 20,
                               devices_per_host=1)
        reg = serving.ReplicaRegistry(ttl_ms=150)
        with _manager(side, pool, registry=reg) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "vic", replicas=2))
            mgr.fault_in("vic", 0, replica=0)
            s1 = mgr.fault_in("vic", 1, replica=1)
            out = [mgr.kill_replica("vic", replica=0),
                   mgr.kill_replica("ghost"), mgr.replica_placement(),
                   mgr.server_for("vic") is s1]
            clock.now += 0.25  # only the survivor beats past this
            t_end = time.monotonic() + WAIT
            while set(reg.live()["replicas"]) != {"vic/r2"}:
                assert time.monotonic() < t_end, reg.live()
                time.sleep(0.005)
            out.append(sorted(reg.live()["replicas"]))
        reg.close()
        return out
    out = _both(run)
    assert out == [True, False, {"vic": {0: 0, 1: 1}}, True, ["vic/r2"]]


# -- fault-in failure leaks nothing -------------------------------------------

def test_fault_in_failure_releases_partial_allocation(tmp_path):
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        out = []
        with _manager(side, pool) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "torn"))
            baseline = mgr.resident_bytes()
            for spec in ("serving.server.warmup:ioerr=1",
                         "checkpoint.aot.attach:ioerr=1"):
                with pkg.faults.inject(spec, seed=3):
                    with pytest.raises(OSError) as info:
                        mgr.fault_in("torn")
                out += [type(info.value).__name__,
                        mgr.resident_bytes() == baseline,
                        mgr.server_for("torn"), mgr.fault_in_window("torn"),
                        mgr.registry.live()["replicas"]]
            srv = mgr.fault_in("torn")
            y = np.asarray(srv.submit(data=X).result(WAIT)[0])
            out.append(mgr.resident_bytes() > baseline)
        text = pkg.telemetry.render_prometheus()
        out.append([line for line in text.splitlines()
                    if line.startswith("mxtpu_platform_fault_in")])
        return out, y
    out = _both_served(run)
    assert out[:5] == ["InjectedIOError", True, None, None, {}]
    assert out[5:10] == ["InjectedIOError", True, None, None, {}]
    assert out[10] is True
    assert 'mxtpu_platform_fault_in_failures_total{model="torn"} 2' \
        in out[11]


# -- 503 + Retry-After during the fault-in window -----------------------------

def test_frontdoor_rejects_during_fault_in_window(tmp_path, monkeypatch):
    _events_on(monkeypatch)
    got = {}
    for side, (pkg, plat, serving) in SIDES.items():
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        with _manager(side, pool) as mgr, plat.FrontDoor(mgr) as door:
            mgr.register_model(_fc_spec(plat, tmp_path, "slowm"))
            errs = []
            hold = threading.Event()

            def owner():
                try:
                    with pkg.faults.inject("platform.fault_in:delay=1@0.6",
                                           seed=1):
                        mgr.fault_in("slowm")
                except Exception as exc:  # pragma: no cover
                    errs.append(exc)
                finally:
                    hold.set()

            t = threading.Thread(target=owner)
            t.start()
            try:
                t_end = time.monotonic() + WAIT
                while mgr.fault_in_window("slowm") is None:
                    assert time.monotonic() < t_end, "window never opened"
                    time.sleep(0.005)
                with pytest.raises(plat.FaultInProgressError) as info:
                    door.predict("slowm", data=X)
                rejected = (type(info.value).__name__,
                            str(info.value).split("; retry in")[0],
                            info.value.retry_after > 0)
            finally:
                t.join(WAIT)
            assert hold.is_set() and not errs
            out = [rejected, mgr.fault_in_window("slowm")]
            y = np.asarray(door.predict("slowm", data=X)[0])
            evs = pkg.telemetry.events_of("platform_faultin_wait")
            out.append([(e["decision"], e["gen"], e["retry_after"] > 0)
                        for e in evs])
        got[side] = (out, y)
    assert got["port"][0] == got["jax"][0]
    np.testing.assert_allclose(got["port"][1], got["jax"][1], **TOL)
    out = got["port"][0]
    assert out[0][0] == "FaultInProgressError" and out[0][2]
    assert out[1] is None and out[2] == [("rejected", 0, True)]


# -- the degradation ladder ---------------------------------------------------

_LADDER_KINDS = ("platform_plan", "platform_plan_actuate",
                 "platform_domain_transition", "platform_domain_health",
                 "platform_replica_reap", "platform_replica_kill",
                 "platform_brownout", "platform_fault_in",
                 "platform_page_out", "platform_quota_shed",
                 "platform_register")


def _ladder_events(pkg):
    out = []
    for e in pkg.telemetry.events():
        if e.get("kind") in _LADDER_KINDS:
            out.append((e["kind"], e.get("gen"), e.get("model"),
                        e.get("domain"), e.get("engaged")))
    return out


def test_degradation_ladder_brownout_and_recovery(tmp_path, monkeypatch):
    """Host 0 dies: the interactive model re-faults onto host 1 (rung 1),
    the batch model pages out (rung 3), the door browns the batch class out
    (rung 2) until the host returns — the same events, in the same order,
    with the same plan generations, in both packages."""
    _events_on(monkeypatch)
    got = {}
    for side, (pkg, plat, serving) in SIDES.items():
        pool = plat.DevicePool(num_devices=2, bytes_per_device=1300,
                               devices_per_host=1)
        reg = serving.ReplicaRegistry(ttl_ms=60_000)
        out, ys = [], []
        with _manager(side, pool, registry=reg) as mgr, \
                plat.FrontDoor(mgr) as door:
            hp = mgr.attach_health(plat.HealthPlane(pool, registry=reg,
                                                    probe_fails=1))
            mgr.register_model(_fc_spec(plat, tmp_path, "gold",
                                        slo="interactive", tenant="gold"))
            mgr.register_model(_fc_spec(plat, tmp_path, "bulk", slo="batch",
                                        tenant="bulk"))
            mgr.record_demand("gold", 5)
            mgr.record_demand("bulk", 1)
            out.append(mgr.replan().describe())
            out += [mgr.placement(), mgr.plan_generation()]
            mgr.kill_replica("gold")
            hp.mark_down(0)  # the ladder runs inline
            out += [mgr.plan_generation(), mgr.placement(),
                    mgr.server_for("gold").cold_bucket_runs(),
                    mgr.server_for("bulk"), door.quotas.brownout()]
            ys.append(door.predict("gold", tenant="gold", data=X)[0])
            with pytest.raises(plat.BrownoutError) as info:
                door.predict("bulk", tenant="bulk", slo="batch", data=X)
            out += [_error(info.value), info.value.retry_after,
                    door.quotas.snapshot()["bulk"]["browned"]]
            hp.mark_up(0)
            out += [door.quotas.brownout(), mgr.placement(),
                    mgr.plan_generation()]
            ys.append(door.predict("bulk", tenant="bulk", slo="batch",
                                   data=X)[0])
            out.append(_ladder_events(pkg))
        reg.close()
        got[side] = (out, [np.asarray(y) for y in ys])
    assert got["port"][0] == got["jax"][0]
    for a, b in zip(got["jax"][1], got["port"][1]):
        np.testing.assert_allclose(b, a, **TOL)
    out = got["port"][0]
    assert out[1] == {"gold": 0, "bulk": 1}
    assert out[3] > out[2] and out[4] == {"gold": 1} and out[5] == 0
    assert out[6] is None and out[7][0] == 1
    assert out[8][0] == "BrownoutError" and out[9] > 0 and out[10] == 1
    assert out[11] is None and "bulk" in out[12]
    kinds = [e[0] for e in out[14]]
    assert [e[1:4] for e in out[14] if e[0] == "platform_replica_reap"] \
        == [(out[2] + 1, "gold", 0)]
    assert [e[4] for e in out[14] if e[0] == "platform_brownout"] \
        == [True, False]
    gens = [e[1] for e in out[14] if e[0] == "platform_plan_actuate"]
    assert gens == sorted(gens) and "platform_domain_transition" in kinds


def test_replan_loop_and_migrate(tmp_path):
    """The background replan loop brings a demanded model in; ``migrate``
    moves a replica and counts it — alike in both packages."""
    def run(side, pkg, plat, serving):
        pool = plat.DevicePool(num_devices=2, bytes_per_device=1300,
                               devices_per_host=1)
        with _manager(side, pool) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "m"))
            mgr.record_demand("m", 1.0)
            mgr.start(replan_ms=10)
            t_end = time.monotonic() + WAIT
            while mgr.server_for("m") is None:
                assert time.monotonic() < t_end
                time.sleep(0.005)
            mgr.close()  # stops the loop and pages out
            out = [mgr.server_for("m"), mgr.plan_generation() >= 1]
        with _manager(side, pool) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "m"))
            mgr.fault_in("m", 0)
            srv = mgr.migrate("m", 1)
            y = np.asarray(srv.submit(data=X).result(WAIT)[0])
            text = pkg.telemetry.render_prometheus()
            out += [mgr.placement(), [line for line in text.splitlines()
                                      if "migrations_total" in line
                                      or "page_outs_total" in line]]
        return out, y
    out = _both_served(run)
    assert out[:2] == [None, True] and out[2] == {"m": 1}
    assert 'mxtpu_platform_migrations_total{model="m"} 1' in out[3]


# -- page-out racing live traffic ---------------------------------------------

def test_concurrent_page_out_vs_inflight_infer(tmp_path):
    """Predict storms race a graceful page-out in both packages: every
    request completes or fails with the retryable family, never a hang, and
    the model demand-pages back in with no cold bucket run."""
    ys = {}
    for side, (pkg, plat, serving) in SIDES.items():
        retryable = (serving.batcher.ServerClosedError,
                     ROUTER[side].NoReplicaAvailableError,
                     plat.FaultInProgressError)
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        with _manager(side, pool) as mgr, plat.FrontDoor(mgr) as door:
            mgr.register_model(_fc_spec(plat, tmp_path, "race"))
            door.predict("race", data=X)
            stop = threading.Event()
            oks, fails, bad = [0], [0], []

            def storm():
                while not stop.is_set():
                    try:
                        door.predict("race", data=X)
                        oks[0] += 1
                    except retryable:
                        fails[0] += 1
                    except Exception as exc:  # pragma: no cover
                        bad.append(exc)
                        return

            threads = [threading.Thread(target=storm) for _ in range(4)]
            for t in threads:
                t.start()
            try:
                for _ in range(3):
                    time.sleep(0.05)
                    mgr.page_out("race", graceful=True)
            finally:
                stop.set()
                for t in threads:
                    t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
            assert not bad, bad
            assert oks[0] > 0
            ys[side] = np.asarray(door.predict("race", data=X)[0])
            assert mgr.server_for("race").cold_bucket_runs() == 0
    np.testing.assert_allclose(ys["port"], ys["jax"], **TOL)


def test_concurrent_page_out_vs_inflight_generate(tmp_path):
    """A live generate stream races a graceful page-out of its only replica:
    it finishes or surfaces the retryable family; the unraced transcripts
    before and after are equal across the packages."""
    V, S = 16, 16
    net = mx.models.get_transformer_lm(vocab_size=V, num_layers=1,
                                       num_heads=2, hidden=16, seq_len=S)
    arg_shapes, _, _ = net.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(2)
    params = {n: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.05)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / "lm")
    mx.model.save_checkpoint(prefix, 1, net, params, {})
    gspec = dict(vocab_size=V, num_layers=1, num_heads=2, hidden=16,
                 max_seq_len=S, lane_buckets=(1,), page_size=4,
                 num_pages=16, prefill_len_buckets=(8,),
                 prefill_batch_buckets=(1,))
    got = {}
    for side, (pkg, plat, serving) in SIDES.items():
        retryable = (serving.batcher.ServerClosedError,
                     ROUTER[side].NoReplicaAvailableError,
                     plat.FaultInProgressError)
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        with _manager(side, pool) as mgr, plat.FrontDoor(mgr) as door:
            mgr.register_model(plat.ModelSpec(
                "lm", prefix, 1, {"data": (1, S), "softmax_label": (1, S)},
                slo="generate", generator_spec=gspec,
                server_kwargs={"buckets": (1,)}))
            first = list(door.generate("lm", [3, 1, 4], 4))
            done = threading.Event()
            bad = []

            def streamer():
                try:
                    for _ in range(20):
                        list(door.generate("lm", [3, 1, 4], 8))
                except retryable:
                    pass
                except Exception as exc:  # pragma: no cover
                    bad.append(exc)
                finally:
                    done.set()

            t = threading.Thread(target=streamer)
            t.start()
            time.sleep(0.05)
            mgr.page_out("lm", graceful=True)
            assert done.wait(timeout=60), "stream hung across page-out"
            t.join(timeout=5)
            assert not bad, bad
            again = list(door.generate("lm", [3, 1, 4], 4))
        got[side] = (first, again)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 4 and got["port"][0] == got["port"][1]


# -- the router's probe debounce knob -----------------------------------------

def test_router_probe_fails_env(monkeypatch):
    def run(side, pkg, plat, serving):
        reg = serving.ReplicaRegistry(ttl_ms=60_000)
        r = serving.Router(registry=reg, registry_sync_ms=10_000)
        remote = ROUTER[side]._RemoteReplica
        try:
            monkeypatch.delenv("MXNET_ROUTER_PROBE_FAILS", raising=False)
            monkeypatch.delenv("MXNET_SERVING_PROBE_FAILURES",
                               raising=False)
            out = [remote("a", "http://127.0.0.1:9", r)._probe_k]
            monkeypatch.setenv("MXNET_ROUTER_PROBE_FAILS", "1")
            out.append(remote("b", "http://127.0.0.1:9", r)._probe_k)
            monkeypatch.setenv("MXNET_ROUTER_PROBE_FAILS", "0")
            monkeypatch.setenv("MXNET_SERVING_PROBE_FAILURES", "5")
            out.append(remote("c", "http://127.0.0.1:9", r)._probe_k)
        finally:
            r.close()
            reg.close()
        return out
    assert _both(run) == [3, 1, 5]
