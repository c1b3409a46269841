"""The port's multi-model platform (``mxnet_tpu_torch.platform``) against the
JAX package's (tests/test_platform.py), on the CPU, case for case.

Both packages run the same scenario on the same checkpoints, written by the
JAX package's ``save_checkpoint`` (the same ``.params`` bytes, so
``param_footprint`` agrees exactly), with ``MXNET_COMPILE_CACHE_DIR`` unset so
neither writes an AOT bundle (the port's bundle steps are held in
tests/test_torch_compile_cache.py).  The port's managers are built under ``with mt.cpu():``.  Equal: plans
and their actions, quota decisions and ``Retry-After`` under a fake clock,
error types and messages, HTTP codes and JSON bodies, ``mxtpu_platform_*``
series; served outputs within 1e-5 and generated transcripts equal.  Every
wait is bounded and every server binds port 0.  Added for the port:
``resident_bytes()`` falls to 0 and weak references to a paged-out server's
executors die; a fault-in started on another thread lands on the manager's
context; the platform and ``get_dlrm`` import no JAX; ``get_dlrm``'s JSON is
byte-equal at the test and the MLPerf widths and a JAX-written checkpoint
scores alike."""
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import platform as jplat
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.platform import quotas as jquotas
from mxnet_tpu_torch import platform as tplat
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.platform import quotas as tquotas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM = 4
V, LAYERS, HEADS, HID, S = 32, 1, 2, 16, 16
LM_SPEC = dict(vocab_size=V, num_layers=LAYERS, num_heads=HEADS, hidden=HID,
               max_seq_len=S, lane_buckets=(1,), page_size=4, num_pages=16,
               prefill_len_buckets=(8,), prefill_batch_buckets=(1,))
TOL = dict(rtol=1e-5, atol=1e-5)
SIDES = {"jax": (mx, jplat, jserving), "port": (mt, tplat, tserving)}
QUOTAS = {"jax": jquotas, "port": tquotas}


@pytest.fixture(autouse=True)
def _platform_env(monkeypatch):
    """No compile cache (no bundles on either side), no anti-thrash guard,
    and fresh telemetry in both packages."""
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setenv("MXNET_PLATFORM_MIN_RESIDENT_S", "0")
    jtelemetry._reset_for_tests()
    monkeypatch.setattr(mt.telemetry, "_registry", None)
    monkeypatch.setattr(mt.telemetry, "_event_log", None)
    monkeypatch.setattr(mt.telemetry, "_collectors", [])
    yield
    jtelemetry._reset_for_tests()


class FakeTime:
    """A ``time`` stand-in for the quota module: the token buckets refill
    and the rate EWMA moves only when a test advances ``now``."""

    def __init__(self, now=100.0):
        self.now = now

    def monotonic(self):
        return self.now


def _clock(monkeypatch):
    clock = FakeTime()
    for module in QUOTAS.values():
        monkeypatch.setattr(module, "time", clock)
    return clock


def _manager(side, pool, **kw):
    """A ModelManager of ``side``; the port's resolves ``mt.cpu()``."""
    plat = SIDES[side][1]
    if side == "port":
        with mt.cpu():
            return plat.ModelManager(pool, **kw)
    return plat.ModelManager(pool, **kw)


def _error(exc):
    return type(exc).__name__, str(exc)


# -- checkpoint builders (the JAX package writes every checkpoint) ------------

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
    return prefix, {"data": (1, in_dim)}


def _save_resnet(tmp_path, name):
    net = mx.models.get_resnet(num_classes=4, num_layers=18,
                               image_shape=(1, 8, 8))
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1, 1, 8, 8),
                                                softmax_label=(1,))
    rng = np.random.RandomState(0)
    args = {n: mx.nd.array(rng.uniform(-0.05, 0.05, s).astype(np.float32))
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n != "data" and not n.endswith("_label")}
    auxs = {n: mx.nd.array((np.zeros if n.endswith("mean") else np.ones)
                           (s, np.float32))
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / name)
    mx.model.save_checkpoint(prefix, 1, net, args, auxs)
    return prefix, {"data": (1, 1, 8, 8)}


DLRM_SMALL = dict(num_slots=2, vocab_sizes=[16, 16], embed_dim=4,
                  capacity=16, bag_len=2, dense_dim=4, bottom_hidden=(8,),
                  top_hidden=(8,))


def _save_dlrm(tmp_path, name):
    net, _slots = mx.models.get_dlrm(**DLRM_SMALL)
    shapes = {"dense": (1, 4), "slot0_indices": (1, 2),
              "slot1_indices": (1, 2)}
    arg_shapes, _, _ = net.infer_shape(
        dense=(1, 4), slot0_indices=(1, 2), slot1_indices=(1, 2),
        ctr_label=(1,))
    rng = np.random.RandomState(1)
    params = {n: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.05)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in shapes and not n.endswith("_label")}
    prefix = str(tmp_path / name)
    mx.model.save_checkpoint(prefix, 1, net, params, {})
    return prefix, shapes


def _save_lm(tmp_path, name):
    net = mx.models.get_transformer_lm(vocab_size=V, num_layers=LAYERS,
                                       num_heads=HEADS, hidden=HID,
                                       seq_len=S)
    arg_shapes, _, _ = net.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(2)
    params = {n: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.05)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / name)
    mx.model.save_checkpoint(prefix, 1, net, params, {})
    return prefix, {"data": (1, S), "softmax_label": (1, S)}


def _fc_spec(plat, tmp_path, name, **kw):
    prefix = str(tmp_path / name)
    if not os.path.exists(prefix + "-0001.params"):
        _save_fc(tmp_path, name, seed=sum(map(ord, name)) % 97)
    kw.setdefault("param_bytes", 1000)
    kw.setdefault("server_kwargs", {"buckets": (1,)})
    return plat.ModelSpec(name, prefix, 1, {"data": (1, IN_DIM)}, **kw)


def _spec(plat, name, pbytes=100, **kw):
    """A planner-only spec: no checkpoint on disk, explicit footprint."""
    return plat.ModelSpec(name, "/nonexistent/%s" % name, 1,
                          {"data": (1, IN_DIM)}, param_bytes=pbytes, **kw)


# -- spec and planner ---------------------------------------------------------

def test_spec_validation_and_footprint(tmp_path):
    prefix, _ = _save_fc(tmp_path, "ck")
    got = {}
    for side, (pkg, plat, _) in SIDES.items():
        errs = []
        for args, kw in ((("", "p", 1, {}), {}), (("a/b", "p", 1, {}), {}),
                         (("m", "p", 1, {}), {"slo": "gold"}),
                         (("m", "p", 1, {}), {"replicas": 0})):
            with pytest.raises(pkg.MXNetError) as info:
                plat.ModelSpec(*args, **kw)
            errs.append(_error(info.value))
        s = _spec(plat, "m", pbytes=100)
        fp = [s.footprint()]
        g = _spec(plat, "g", pbytes=100, slo="generate",
                  generator_spec=dict(num_layers=1, num_heads=2, hidden=8,
                                      page_size=4, num_pages=2))
        fp.append(g.footprint())
        s.observe_exec_bytes(7)
        fp.append(s.footprint())
        disk = plat.ModelSpec("d", prefix, 1, {"data": (1, IN_DIM)})
        fp.append(disk.footprint())
        got[side] = (errs, fp, disk.describe(), repr(disk),
                     dict(plat.spec.SLO_RANK))
    assert got["port"] == got["jax"]
    errs, fp, _, _, _ = got["port"]
    assert fp[0] == {"param_bytes": 100, "kv_bytes": 0, "exec_bytes": 25,
                     "total": 125}
    assert fp[1]["kv_bytes"] == 2 * 1 * 2 * 4 * 2 * 4 * 4
    assert fp[2]["exec_bytes"] == 7
    assert fp[3]["param_bytes"] == os.path.getsize(prefix + "-0001.params")


def _plans(fn):
    got = {}
    for side, (pkg, plat, _) in SIDES.items():
        got[side] = fn(pkg, plat)
    assert got["port"] == got["jax"]
    return got["port"]


def test_planner_packs_by_demand():
    """10 models, room for 4: the highest-demand models win residency."""
    def run(pkg, plat):
        pool = plat.DevicePool(num_devices=1, bytes_per_device=510)
        specs = {("m%d" % i): _spec(plat, "m%d" % i) for i in range(10)}
        demand = {"m2": 9.0, "m5": 8.0, "m7": 7.0, "m0": 6.0, "m1": 0.1}
        return plat.PlacementPlanner(pool).plan(specs, demand).describe()
    plan = _plans(run)
    assert sorted(plan["resident"]) == ["m0", "m2", "m5", "m7"]
    assert len(plan["paged"]) == 6
    assert all(a["op"] == "fault_in" for a in plan["actions"])
    assert plan["free_bytes"][0] == 510 - 4 * 125


def test_planner_slo_breaks_demand_ties():
    def run(pkg, plat):
        pool = plat.DevicePool(num_devices=1, bytes_per_device=130)
        specs = {"b": _spec(plat, "b", slo="batch"), "i": _spec(plat, "i")}
        return plat.PlacementPlanner(pool).plan(
            specs, {"b": 1.0, "i": 1.0}).describe()
    plan = _plans(run)
    assert plan["resident"] == {"i": 0} and plan["paged"] == ["b"]


def test_planner_sticky_placement_and_action_diff():
    def run(pkg, plat):
        pool = plat.DevicePool(num_devices=2, bytes_per_device=300)
        specs = {n: _spec(plat, n) for n in ("a", "b", "c")}
        demand = {"a": 3.0, "b": 2.0, "c": 1.0}
        return plat.PlacementPlanner(pool).plan(
            specs, demand, current={"b": 1, "gone": 0}).describe()
    plan = _plans(run)
    assert plan["resident"]["b"] == 1
    assert {"op": "page_out", "model": "gone", "device": 0} \
        in plan["actions"]
    assert {a["op"] for a in plan["actions"]} >= {"fault_in", "page_out"}


def test_planner_rejects_model_larger_than_any_device():
    def run(pkg, plat):
        pool = plat.DevicePool(num_devices=2, bytes_per_device=100)
        with pytest.raises(pkg.MXNetError) as info:
            plat.PlacementPlanner(pool).plan(
                {"big": _spec(plat, "big", pbytes=200)}, {})
        return _error(info.value)
    assert "cannot fit any device" in _plans(run)[1]


def test_device_pool_counts_cuda_cards_not_the_cpu(monkeypatch):
    """The JAX pool counts JAX devices; the port's counts CUDA cards and,
    with none, raises rather than plan over the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="counts CUDA cards"):
        tplat.DevicePool()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("MXNET_PLATFORM_DEVICE_BYTES", raising=False)
    pool = tplat.DevicePool()
    assert pool.describe() == {"num_devices": 4,
                               "bytes_per_device": 16 << 30,
                               "devices_per_host": 4, "num_domains": 1}


# -- quotas (a fake clock: refills and rates move only when told) -------------

def _rate_run(pkg, plat, clock):
    q = plat.TenantQuotas(pressure_fn=lambda: 0.0)
    q.set_quota("noisy", rate=1.0, burst=1.0)
    q.set_quota("good", rate=1000.0, burst=1000.0)
    out = []

    def admit(tenant):
        try:
            q.admit(tenant)
            out.append((tenant, "ok"))
        except plat.TenantQuotaExceededError as exc:
            out.append((tenant,) + _error(exc) + (exc.retry_after,))

    for _ in range(5):
        admit("noisy")
    for _ in range(5):
        admit("good")
    clock.now += 0.5
    admit("noisy")
    clock.now += 0.5
    admit("noisy")
    return out, q.snapshot()


def test_quota_rate_limit_sheds_only_the_offender(monkeypatch):
    clock = _clock(monkeypatch)
    got = {}
    for side, (pkg, plat, _) in SIDES.items():
        clock.now = 100.0
        got[side] = _rate_run(pkg, plat, clock)
    assert got["port"] == got["jax"]
    out, snap = got["port"]
    noisy = [o for o in out[:5]]
    assert noisy[0] == ("noisy", "ok")
    assert all(o[1] == "TenantQuotaExceededError" and o[3] > 0
               for o in noisy[1:])
    assert out[10][3] == pytest.approx(0.5) and out[11] == ("noisy", "ok")
    assert snap["noisy"]["shed"] == 5
    assert snap["good"]["shed"] == 0 and snap["good"]["admitted"] == 5


def test_quota_fair_share_sheds_heavy_tenant_under_pressure(monkeypatch):
    clock = _clock(monkeypatch)
    got = {}
    for side, (pkg, plat, _) in SIDES.items():
        clock.now = 100.0
        pressure = [0.0]
        q = plat.TenantQuotas(pressure_fn=lambda: pressure[0])
        q.set_quota("heavy", weight=1.0)
        q.set_quota("light", weight=1.0)
        for _ in range(200):
            clock.now += 0.001
            q.admit("heavy")
        for _ in range(5):
            clock.now += 0.05
            q.admit("light")
        pressure[0] = 1.0  # the fleet saturates: fair sharing engages
        shed_at = None
        for i in range(50):
            clock.now += 0.001
            try:
                q.admit("heavy")
            except plat.TenantQuotaExceededError as exc:
                shed_at = (i,) + _error(exc) + (exc.retry_after,)
                break
        clock.now += 0.05
        q.admit("light")  # inside its share: never shed by the neighbour
        got[side] = (shed_at, q.snapshot())
    assert got["port"] == got["jax"]
    assert got["port"][0] is not None
    assert "over fair share" in got["port"][0][2]


# -- registry meta + model-scoped routers -------------------------------------

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


def test_registry_meta_and_model_scoped_router_views():
    got = {}
    for side, (pkg, plat, serving) in SIDES.items():
        reg = serving.ReplicaRegistry(ttl_ms=60_000)
        servers = [_tiny_server(side, i) for i in range(3)]
        routers = []
        try:
            reg.register("a/r1", servers[0],
                         meta={"model": "a", "tenant": "t0"})
            reg.register("b/r1", servers[1], meta={"model": "b"})
            reg.register("legacy", servers[2])  # pre-meta wire format
            meta = reg.live()["meta"]
            routers = [serving.Router(registry=reg, model=m,
                                      registry_sync_ms=10_000)
                       for m in ("a", "b", None, "default")]
            names = [sorted(r.name for r in router.replicas())
                     for router in routers]
            out = routers[0].submit(
                data=np.arange(IN_DIM, dtype=np.float32)).result(60)
            reg.deregister("a/r1")
            routers[0].sync_registry()
            got[side] = (meta, names, np.asarray(out[0]),
                         routers[0].replicas())
        finally:
            for r in routers:
                r.close()
            reg.close()
            for s in servers:
                s.stop(drain=False)
    jm, jn, jo, jr = got["jax"]
    tm, tn, to, tr = got["port"]
    assert (tm, tn, tr) == (jm, jn, jr)
    assert tm["a/r1"] == {"model": "a", "tenant": "t0"} and tm["legacy"] == {}
    assert tn == [["a/r1"], ["b/r1"], ["a/r1", "b/r1", "legacy"], ["legacy"]]
    assert tr == []
    np.testing.assert_allclose(to, jo, **TOL)


# -- manager: paging lifecycle ------------------------------------------------

def test_manager_fault_in_page_out_releases_memory(tmp_path):
    x = np.arange(IN_DIM, dtype=np.float32)
    got = {}
    for side, (pkg, plat, _) in SIDES.items():
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        obs = []
        with _manager(side, pool) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "solo"))
            for bad in (lambda: mgr.register_model(
                            _fc_spec(plat, tmp_path, "solo")),
                        lambda: mgr.spec("nope")):
                with pytest.raises(pkg.MXNetError) as info:
                    bad()
                obs.append(_error(info.value))
            srv = mgr.fault_in("solo")
            assert mgr.fault_in("solo") is srv  # idempotent
            out = np.asarray(srv.submit(data=x).result(60)[0])
            assert mgr.fault_in_latency_ms("solo") > 0
            obs += [mgr.resident_bytes(), mgr.registry.live()["meta"],
                    mgr.placement()]
            mgr.page_out("solo")
            obs += [mgr.resident_bytes(), mgr.server_for("solo"),
                    mgr.registry.live()["replicas"]]
            mgr.page_out("solo")  # no-op on non-resident
            srv2 = mgr.fault_in("solo")
            out2 = np.asarray(srv2.submit(data=x).result(60)[0])
            obs.append(srv2.cold_bucket_runs())
        obs.append(mgr.server_for("solo"))  # close() pages everything out
        got[side] = (obs, out, out2)
    assert got["port"][0] == got["jax"][0]
    obs = got["port"][0]
    assert obs[2] > 0 and obs[3]["solo/r1"]["model"] == "solo"
    assert obs[5:] == [0, None, {}, 0, None]
    for i in (1, 2):
        np.testing.assert_allclose(got["port"][i], got["jax"][i], **TOL)


def _platform_series(text):
    return sorted(line for line in text.splitlines()
                  if "mxtpu_platform_" in line)


def test_platform_metrics_render(tmp_path):
    texts = {}
    for side, (pkg, plat, _) in SIDES.items():
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        with _manager(side, pool) as mgr:
            mgr.register_model(_fc_spec(plat, tmp_path, "m0"))
            mgr.fault_in("m0")
            mgr.page_out("m0")
            texts[side] = pkg.telemetry.render_prometheus()
    assert _platform_series(texts["port"]) == _platform_series(texts["jax"])
    text = texts["port"]
    assert 'mxtpu_platform_fault_ins_total{model="m0"} 1' in text
    assert 'mxtpu_platform_page_outs_total{model="m0"} 1' in text
    assert "mxtpu_platform_registered_models 1" in text
    assert "mxtpu_platform_resident_models 0" in text


# -- the acceptance path ------------------------------------------------------

def _acceptance(side, tmp_path, ckpts, clock):
    """tests/test_platform.py's acceptance scenario on one package."""
    pkg, plat, _ = SIDES[side]
    (rn_prefix, rn_shapes), (dl_prefix, dl_shapes), (lm_prefix, lm_shapes) \
        = ckpts
    specs = [
        plat.ModelSpec("resnet", rn_prefix, 1, rn_shapes, tenant="vision",
                       slo="interactive", param_bytes=7554,
                       server_kwargs={"buckets": (1,)}),
        plat.ModelSpec("dlrm", dl_prefix, 1, dl_shapes, tenant="ads",
                       slo="interactive", param_bytes=7554,
                       server_kwargs={"buckets": (1,)}),
        plat.ModelSpec("lm", lm_prefix, 1, lm_shapes, tenant="chat",
                       slo="generate", param_bytes=1000,
                       generator_spec=dict(LM_SPEC),
                       server_kwargs={"buckets": (1,)}),
    ]
    for i in range(7):
        specs.append(_fc_spec(plat, tmp_path, "fc%d" % i, param_bytes=7554,
                              tenant="t%d" % (i % 3),
                              slo="batch" if i >= 5 else "interactive"))
    totals = {s.footprint()["total"] for s in specs}
    assert len(totals) == 1, totals
    pool = plat.DevicePool(num_devices=1,
                           bytes_per_device=4 * totals.pop() + 1)
    rng = np.random.RandomState(5)
    image = rng.uniform(-1, 1, (1, 8, 8)).astype(np.float32)
    dense = rng.randn(4).astype(np.float32)
    ids = rng.randint(0, 16, (2, 2)).astype(np.float32)
    x = rng.randn(IN_DIM).astype(np.float32)
    obs, outs = {}, {}
    with _manager(side, pool) as mgr, plat.FrontDoor(mgr) as door:
        for s in specs:
            mgr.register_model(s)
        for name, d in (("resnet", 9), ("dlrm", 8), ("lm", 7), ("fc0", 6)):
            mgr.record_demand(name, d)
        obs["plan1"] = mgr.replan().describe()
        obs["placement1"] = mgr.placement()
        outs["resnet"] = door.predict("resnet", tenant="vision", data=image)
        outs["dlrm"] = door.predict("dlrm", tenant="ads", dense=dense,
                                    slot0_indices=ids[0],
                                    slot1_indices=ids[1])
        obs["tokens"] = list(door.generate("lm", [3, 1, 4], 4,
                                           tenant="chat"))
        outs["fc0"] = door.predict("fc0", data=x)
        peak = mgr.resident_bytes()
        obs["peak"] = peak
        for name in ("resnet", "dlrm", "lm", "fc0"):
            mgr.record_demand(name, -mgr.demand()[name])
        for i, d in zip(range(1, 5), (9, 8, 7, 6)):
            mgr.record_demand("fc%d" % i, d)
        obs["plan2"] = mgr.replan().describe()
        obs["fell"] = mgr.resident_bytes() < peak
        outs["fc3"] = door.predict("fc3", data=x)
        outs["fc0 again"] = door.predict("fc0", data=x)  # demand paging
        obs["fc0 cold"] = mgr.server_for("fc0").cold_bucket_runs()
        obs["fc0 meta"] = sorted(m["replica"] for m in
                                 mgr.registry.live()["meta"].values()
                                 if m.get("model") == "fc0")
        door.quotas.set_quota("noisy", rate=1.0, burst=2.0)
        flood = []
        for _ in range(8):
            try:
                door.predict("fc1", tenant="noisy", data=x)
                flood.append("ok")
            except plat.TenantQuotaExceededError as exc:
                flood.append(_error(exc) + (exc.retry_after,))
        obs["flood"] = flood
        outs["resnet again"] = door.predict("resnet", tenant="vision",
                                            data=image)
        d = door.describe()
        obs["describe"] = (sorted(d["models"]), d["resident"], d["paged"],
                           {t: (v["admitted"], v["shed"], v["browned"])
                            for t, v in d["tenants"].items()},
                           sorted(d["routers"]))
    return obs, {k: [np.asarray(o) for o in v] for k, v in outs.items()}


def test_platform_acceptance_ten_models_room_for_four(tmp_path, monkeypatch):
    """10 heterogeneous models on room for 4 in both packages: equal plans,
    outputs within 1e-5, equal transcripts, the same tenant decisions."""
    monkeypatch.setattr(jplat.ModelSpec, "observe_exec_bytes",
                        lambda self, nbytes: None)
    clock = _clock(monkeypatch)
    # the demand EWMA on the same frozen clock: zeroing a model's demand
    # leaves exactly 0, not a residue whose sign orders the paged list
    for plat in (jplat, tplat):
        monkeypatch.setattr(plat.manager, "time", clock)
    ckpts = (_save_resnet(tmp_path, "rn"), _save_dlrm(tmp_path, "dlrm"),
             _save_lm(tmp_path, "lm"))
    got = {side: _acceptance(side, tmp_path, ckpts, clock)
           for side in SIDES}
    jobs, jouts = got["jax"]
    tobs, touts = got["port"]
    assert tobs == jobs
    for key in jouts:
        for a, b in zip(jouts[key], touts[key]):
            np.testing.assert_allclose(b, a, err_msg=key, **TOL)
    first_four = {"resnet", "dlrm", "lm", "fc0"}
    assert set(tobs["plan1"]["resident"]) == first_four
    assert len(tobs["plan1"]["paged"]) == 6
    assert set(tobs["plan2"]["resident"]) == {"fc1", "fc2", "fc3", "fc4"}
    assert len(tobs["tokens"]) == 4 and all(0 <= t < V
                                            for t in tobs["tokens"])
    assert tobs["fell"] and tobs["fc0 cold"] == 0
    assert sum(f != "ok" for f in tobs["flood"]) >= 5
    _, resident, paged, tenants, _ = tobs["describe"]
    assert "fc0" in resident and "resnet" in resident and "lm" in paged
    assert tenants["noisy"][1] == sum(f != "ok" for f in tobs["flood"])
    assert tenants["vision"][1] == 0
    assert touts["resnet"][0].shape == (4,) and touts["dlrm"][0].shape == (1,)


def _post(base, path, body, headers=()):
    """(code, parsed JSON body, Retry-After) of one POST."""
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **dict(headers)),
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), None
    except urllib.error.HTTPError as exc:
        out = exc.code, json.loads(exc.read()), exc.headers["Retry-After"]
        exc.close()
        return out


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_frontdoor_http_multi_model(tmp_path, monkeypatch):
    """The HTTP face in both packages: model from the path or the header,
    tenant from X-Tenant, equal codes, bodies and Retry-After."""
    clock = _clock(monkeypatch)
    got = {}
    for side, (pkg, plat, _) in SIDES.items():
        clock.now = 100.0
        pool = plat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
        replies = []
        with _manager(side, pool) as mgr, plat.FrontDoor(mgr) as door:
            mgr.register_model(_fc_spec(plat, tmp_path, "alpha"))
            mgr.register_model(_fc_spec(plat, tmp_path, "beta"))
            door.quotas.set_quota("noisy", rate=0.5, burst=1.0)
            host, port = door.serve_http()
            base = "http://%s:%d" % (host, port)
            x = {"inputs": {"data": [0.5, -1.0, 2.0, 0.25]}}
            for path, headers in (
                    ("/v1/alpha/predict", ()),
                    ("/predict", [("X-MXNet-Model", "beta")]),
                    ("/v1/alpha/predict", [("X-Tenant", "noisy")]),
                    ("/v1/alpha/predict", [("X-Tenant", "noisy")]),
                    ("/v1/ghost/predict", ()),
                    ("/v1/alpha/score", ()),
                    ("/predict", ()),
                    ("/v1/alpha/predict", [("X-Tenant", "t1")])):
                replies.append(_post(base, path, x, headers))
            replies.append(_post(base, "/v1/alpha/predict",
                                 {"inputs": {"data": [0.0] * 3}}))
            code, body = _get(base, "/models")
            cat = json.loads(body)
            cat.pop("demand")
            replies.append((code, cat))
            replies.append(_get(base, "/healthz"))
            code, text = _get(base, "/metrics")
            replies.append((code, _platform_series(text)))
            try:
                urllib.request.urlopen(base + "/nope", timeout=30)
            except urllib.error.HTTPError as exc:
                replies.append((exc.code, json.loads(exc.read())))
                exc.close()
        got[side] = replies
    assert len(got["port"]) == len(got["jax"])
    for i, (j, t) in enumerate(zip(got["jax"], got["port"])):
        if i in (0, 1, 2, 7):  # served: equal codes, outputs within 1e-5
            assert t[0] == j[0] == 200 and t[2] is j[2] is None
            np.testing.assert_allclose(t[1]["outputs"], j[1]["outputs"],
                                       **TOL)
        else:
            assert t == j, i
    replies = got["port"]
    assert replies[3][0] == 429 and float(replies[3][2]) > 0
    assert replies[4][0] == 400 and "unknown model" in replies[4][1]["error"]
    assert replies[5][0] == 404 and replies[6][0] == 404
    assert replies[8][0] == 503 and "has shape (3,)" in replies[8][1]["error"]
    assert set(replies[9][1]["models"]) == {"alpha", "beta"}
    assert "noisy" in replies[9][1]["tenants"]
    assert 'mxtpu_platform_fault_ins_total{model="alpha"} 1' in replies[11][1]


# -- added for the port -------------------------------------------------------

def test_page_out_releases_the_servers_executors(tmp_path):
    """``resident_bytes()`` falls to 0, and once paged out nothing keeps the
    server's bucket executors, parameter arrays or KV pool alive."""
    prefix, shapes = _save_lm(tmp_path, "lm")
    pool = tplat.DevicePool(num_devices=1, bytes_per_device=1 << 30)
    with _manager("port", pool) as mgr:
        mgr.register_model(tplat.ModelSpec(
            "lm", prefix, 1, shapes, slo="generate",
            generator_spec=dict(LM_SPEC), server_kwargs={"buckets": (1,)}))
        srv = mgr.fault_in("lm")
        assert mgr.resident_bytes() == srv.resident_bytes() > 0
        assert len(list(srv.submit_generate([3, 1, 4], 3))) == 3
        rep = srv._replicas[0]
        refs = [weakref.ref(srv), weakref.ref(rep),
                weakref.ref(srv._generator), weakref.ref(srv._generator.pool)]
        refs += [weakref.ref(p._exec) for p in rep._preds.values()]
        refs += [weakref.ref(a._data) for a in
                 rep._preds[1]._exec.arg_dict.values()]
        del rep
        mgr.page_out("lm")
        assert srv.resident_bytes() == 0 and mgr.resident_bytes() == 0
        del srv
        gc.collect()
        alive = [r() for r in refs if r() is not None]
        assert alive == []


def test_fault_in_on_another_thread_lands_on_the_managers_context(tmp_path):
    """The default context is per thread: a fault-in on a thread that never
    entered ``with mt.cpu():`` (a front door handler, the replan loop, the
    health plane's callback) still builds on the manager's context; a manager
    built outside it resolves ``gpu(0)`` and, without CUDA, raises."""
    pool = tplat.DevicePool(num_devices=1, bytes_per_device=1 << 20)
    x = {"inputs": {"data": [0.0] * IN_DIM}}
    with _manager("port", pool) as mgr, tplat.FrontDoor(mgr) as door:
        mgr.register_model(_fc_spec(tplat, tmp_path, "a"))
        mgr.register_model(_fc_spec(tplat, tmp_path, "b"))
        box = {}
        t = threading.Thread(target=lambda: box.update(
            srv=mgr.fault_in("a")))
        t.start()
        t.join(60)
        assert box["srv"].swap_config()["ctx"] == [mt.cpu()]
        host, port = door.serve_http()  # "b" demand-pages on a handler
        code, _, _ = _post("http://%s:%d" % (host, port), "/v1/b/predict", x)
        assert code == 200
        assert mgr.server_for("b").swap_config()["ctx"] == [mt.cpu()]
        mgr.page_out("b")
        mgr.start(replan_ms=10)  # the replan loop faults "b" back in
        for _ in range(3000):
            if mgr.server_for("b") is not None:
                break
            time.sleep(0.01)
        assert mgr.server_for("b").swap_config()["ctx"] == [mt.cpu()]
    pinned = _fc_spec(tplat, tmp_path, "p",
                      server_kwargs={"buckets": (1,), "ctx": mt.cpu()})
    gpu_mgr = tplat.ModelManager(pool)
    try:
        assert gpu_mgr._ctx == mt.gpu(0)
        gpu_mgr.register_model(_fc_spec(tplat, tmp_path, "a"))
        gpu_mgr.register_model(pinned)
        if not __import__("torch").cuda.is_available():
            with pytest.raises(mt.MXNetError):
                gpu_mgr.fault_in("a")
            assert gpu_mgr.resident_bytes() == 0
        # a spec that names its context keeps it
        assert gpu_mgr.fault_in("p").swap_config()["ctx"] == [mt.cpu()]
    finally:
        gpu_mgr.close()


def test_platform_and_dlrm_import_no_jax():
    code = ("import sys, mxnet_tpu_torch.platform, "
            "mxnet_tpu_torch.models.dlrm\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


MLPERF_DLRM = dict(num_slots=26, embed_dim=128, capacity=16384, bag_len=8,
                   dense_dim=13, bottom_hidden=(512, 256, 128),
                   top_hidden=(1024, 1024, 512, 256))


@pytest.mark.parametrize("kw", [DLRM_SMALL, MLPERF_DLRM, {}],
                         ids=["test", "mlperf", "defaults"])
def test_get_dlrm_json_and_slots_are_the_jax_packages(kw):
    with mx.NameManager():
        jnet, jslots = mx.models.get_dlrm(**kw)
    with mt.NameManager():
        tnet, tslots = mt.models.get_dlrm(**kw)
    assert tnet.tojson() == jnet.tojson()
    assert tslots == jslots
    assert mt.sym.load_json(jnet.tojson()).tojson() == jnet.tojson()
    with pytest.raises(ValueError, match="one vocab size per slot"):
        mt.models.get_dlrm(num_slots=2, vocab_sizes=[3])


def test_dlrm_checkpoint_from_jax_scores_alike(tmp_path):
    """A JAX-written DLRM checkpoint through both packages' Predictor, ids
    drawn in [0, capacity)."""
    prefix, _ = _save_dlrm(tmp_path, "dlrm")
    n = 6
    rng = np.random.RandomState(3)
    feed = {"dense": rng.randn(n, 4).astype(np.float32),
            "slot0_indices": rng.randint(0, 16, (n, 2)).astype(np.float32),
            "slot1_indices": rng.randint(0, 16, (n, 2)).astype(np.float32)}
    shapes = {k: v.shape for k, v in feed.items()}
    jpred = mx.Predictor.from_checkpoint(prefix, 1, shapes)
    tpred = mt.Predictor.from_checkpoint(prefix, 1, shapes, ctx=mt.cpu())
    j = jpred.forward(**feed)[0].asnumpy()
    t = tpred.forward(**feed)[0].asnumpy()
    assert t.shape == (n, 1) and np.all((t > 0) & (t < 1))
    np.testing.assert_allclose(t, j, **TOL)
