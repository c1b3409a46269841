"""The port's telemetry core and profiler (``mxnet_tpu_torch.telemetry``,
``mxnet_tpu_torch.profiler``) against the JAX package's, on the CPU.

The counterparts of ``tests/test_telemetry.py``'s cases, each run in both
packages on the same inputs where the JAX package has the case:

* ONE merged trace: a short ``fit``, comm-engine traffic and a serving
  batch give the same span names in both packages, on distinct named
  thread tracks, schema-valid (``validate_trace``), through
  ``dump_trace`` and back;
* the step monitor's counts and report keys, ``summary()``; the
  recompile detector fires once per new shape and never across epochs;
* telemetry off: nothing is built — no StepMonitor, no tracer buffer, no
  prefetch instruments, no structured events, a plain kvstore envelope
  (the JAX package's "disabled overhead under 2%" held structurally);
* the profiler: real per-thread ids, ``dump_profile`` mid-run, and on
  'run' a ``torch.profiler`` trace beside the file whose ranges are the
  ``Frame`` spans (the JAX package's ``jax.profiler`` trace's place);
* PrefetchingIter's instruments, Speedometer's data wait, the event tool
  (``python -m mxnet_tpu_torch.tools.telemetry_dump``).
"""
import json
import os
import re
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler, telemetry

import mxnet_tpu as mx
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import telemetry as jtelemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": mt, "jax": mx}


# bench.py (collected by tests/test_bench.py) sets MXNET_TELEMETRY=1 for the
# rest of the process, and a worker that imports the port after it starts
# the port's telemetry at import: excepthooks chained onto the session's,
# spans recorded.  Collection imports every file before any case runs, so
# this puts the port's telemetry off for the whole worker.
telemetry._reset_for_tests()


def _reset_both():
    """Both packages' telemetry off.  Each flight recorder chains onto the
    hook it finds and puts it back when it uninstalls, so the package whose
    hook is on top goes first."""
    top = getattr(threading.excepthook, "__module__", "") or ""
    first, second = (jtelemetry, telemetry) if top.startswith("mxnet_tpu.") \
        else (telemetry, jtelemetry)
    first._reset_for_tests()
    second._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset_both()
    yield
    _reset_both()


def _ctx(S):
    return mt.cpu() if S is mt else None


def _fit_small(S, epochs=1, bs=10, n=50, speedometer=None, seed=0):
    rng = np.random.RandomState(seed)
    data = rng.uniform(size=(n, 10)).astype(np.float32)
    label = rng.randint(0, 2, (n,)).astype(np.float32)
    it = S.io.NDArrayIter(data, label, batch_size=bs)
    x = S.sym.Variable("data")
    net = S.sym.FullyConnected(x, num_hidden=2, name="fc")
    net = S.sym.SoftmaxOutput(net, name="softmax")
    mod = S.mod.Module(net, label_names=("softmax_label",), context=_ctx(S))
    cbs = [speedometer] if speedometer is not None else None
    mod.fit(it, num_epoch=epochs, batch_end_callback=cbs,
            optimizer_params={"learning_rate": 0.1})
    return mod, it


def _layers(S):
    """A fit, comm-engine pushes and pulls, and one serving request."""
    _fit_small(S)
    ctx = _ctx(S)
    arr = (lambda a: S.nd.array(a, ctx)) if ctx else S.nd.array
    kv = S.comm_engine.make_async(S.kv.create("local"), num_threads=2,
                                  bucket_bytes=0)
    try:
        kv.init(1, arr(np.ones(8, np.float32)))
        kv.push(1, arr(np.ones(8, np.float32)))
        out = arr(np.zeros(8, np.float32))
        kv.pull(1, out)
        kv.wait()
    finally:
        kv.close()
    rng = np.random.RandomState(0)
    net = S.sym.FullyConnected(S.sym.Variable("data"), num_hidden=3,
                               name="fc")
    params = {"fc_weight": arr(rng.randn(3, 6).astype(np.float32)),
              "fc_bias": arr(rng.randn(3).astype(np.float32))}
    kw = {"ctx": ctx} if ctx else {}
    srv = S.serving.InferenceServer(net, params, {"data": (4, 6)},
                                    max_wait_us=1000, max_queue=16, **kw)
    try:
        srv.submit(data=rng.randn(6).astype(np.float32)).result(30)
    finally:
        srv.stop(drain=True)


def _names(events):
    return sorted({e["name"] for e in events if e.get("ph") == "X"})


def test_merged_trace_spans_every_layer_as_the_jax_package(tmp_path):
    """The names are the telemetry buffer's (the spans since ``enable``):
    the merged trace also holds the profiler's own events, which keep the
    last profiler run's, another test's."""
    got = {}
    for name, S in PKGS.items():
        S.telemetry.enable(trace=True)
        _layers(S)
        payload = S.telemetry.merged_trace()
        S.telemetry.validate_trace(payload)
        got[name] = payload, _names(S.telemetry.tracer.events())
        S.telemetry.disable()
    assert got["port"][1] == got["jax"][1] == [
        "Executor.forward", "Executor.fused_step", "Module.fit:epoch0",
        "Module.fit:step", "comm.pull", "comm.push", "serving/batch[n=1]"]
    payload = got["port"][0]
    spans = [e for e in payload["traceEvents"] if e.get("ph") == "X"]
    by_cat = {}
    for e in spans:
        by_cat.setdefault(e["cat"], set()).add(e["tid"])
    assert {"fit", "exec", "comm", "serving"} <= set(by_cat)
    assert not (by_cat["fit"] & by_cat["comm"])
    assert not (by_cat["fit"] & by_cat["serving"])
    named = {e["tid"]: e["args"]["name"] for e in payload["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert all(e["tid"] in named for e in spans)
    assert any("kvcomm" in v for v in named.values())
    # comm ops draw a flow arrow from the submitting thread
    flows = {}
    for e in payload["traceEvents"]:
        if e.get("ph") in ("s", "f"):
            flows.setdefault(e["id"], set()).add(e["ph"])
    assert flows and all(v == {"s", "f"} for v in flows.values())
    out = tmp_path / "merged.json"
    telemetry.dump_trace(str(out))
    reloaded = json.loads(out.read_text())
    telemetry.validate_trace(reloaded)


@pytest.mark.parametrize("bad", [
    {"traceEvents": {}},
    {"traceEvents": [1]},
    {"traceEvents": [{"name": "x"}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 0,
                      "tid": 0}]},
    {"traceEvents": [{"name": "x", "ph": "B", "pid": 0, "tid": 0}]},
])
def test_validate_trace_refuses_as_the_jax_package(bad):
    for tm in (telemetry, jtelemetry):
        with pytest.raises(ValueError):
            tm.validate_trace(bad)


def test_step_monitor_counts_and_report_as_the_jax_package():
    got = {}
    for name, S in PKGS.items():
        S.telemetry.enable(trace=False)
        mod, _ = _fit_small(S, bs=10, n=50)  # the module owns the monitor
        mon = S.telemetry.current_step_monitor()
        rep = mon.report()
        got[name] = (mon.c_steps.value, mon.c_samples.value, sorted(rep),
                     rep["steps"], rep["recompiles"],
                     S.telemetry.summary()["counters"]["mxtpu_steps_total"])
        assert rep["avg_step_ms"] > 0 and rep["samples_per_sec"] > 0
        assert rep["flops_per_step"] > 0
        S.telemetry.disable()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (5, 50)


def test_recompile_detector_fires_once_per_new_shape():
    got = {}
    for name, S in PKGS.items():
        S.telemetry.enable(trace=False)
        mod, _ = _fit_small(S, bs=10, n=50)
        mon = S.telemetry.current_step_monitor()
        rng = np.random.RandomState(1)
        it9 = S.io.NDArrayIter(rng.uniform(size=(45, 10)).astype(np.float32),
                               rng.randint(0, 2, (45,)).astype(np.float32),
                               batch_size=9)
        batch = next(iter(it9))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mod.forward_backward(batch)  # batch 10 -> 9: a new signature
            # dropped unrun (the port runs a pending batch before taking
            # the next; its bound shape is 10)
            mod._fused_pending = None
            mod.forward_backward(batch)  # the same again: no new warning
            mod._fused_pending = None
        rws = [str(x.message) for x in w
               if issubclass(x.category, S.telemetry.RecompileWarning)]
        got[name] = (rws, mon.c_recompiles.value,
                     [e["diff"] for e in S.telemetry.events_of("recompile")])
        S.telemetry.disable()
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 1 and got["port"][1] == 1
    assert "(10, 10)->(9, 10)" in got["port"][0][0]


def test_recompile_detector_silent_across_epochs():
    telemetry.enable(trace=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mod, _ = _fit_small(mt, epochs=3)
    assert not [x for x in w
                if issubclass(x.category, telemetry.RecompileWarning)]
    assert telemetry.current_step_monitor().c_recompiles.value == 0
    assert mod._tm_mon is telemetry.current_step_monitor()


def test_telemetry_off_builds_nothing():
    """Off, every hook is one flag read: a fit, a prefetching iterator, a
    comm engine and a kvstore RPC build no monitor, no span buffer, no
    instruments and no events, in both packages."""
    from mxnet_tpu import kvstore_server as jkvs
    from mxnet_tpu_torch import kvstore_server as kvs

    for S, srv_mod in ((mt, kvs), (mx, jkvs)):
        assert not S.telemetry.enabled()
        mod, _ = _fit_small(S)
        assert mod._tm_mon is None
        assert S.telemetry.current_step_monitor() is None
        assert not S.telemetry.tracer.active()
        base = S.io.NDArrayIter(np.zeros((20, 2), np.float32), batch_size=5)
        assert sum(1 for _ in S.io.PrefetchingIter(base)) == 4
        assert S.io._PREFETCH_TELEM is None
        assert S.telemetry.events() == []
        assert S.telemetry.log_event("x", a=1) is None
        srv = srv_mod.start_server(num_workers=1)
        try:
            with srv_mod.ServerClient(*srv.addr) as cli:
                ent = cli._submit(("membership",))
                ent["event"].wait()
                assert len(ent["env"]) == 4  # no trace context
            assert srv_mod._TELEM is None
        finally:
            srv.stop()
        assert S.profiler._sink is None


def test_prefetch_iter_instrumented():
    got = []
    for S in (mt, mx):
        S.telemetry.enable(trace=False)
        base = S.io.NDArrayIter(np.arange(40, dtype=np.float32).reshape(
            20, 2), batch_size=5)
        assert sum(1 for _ in S.io.PrefetchingIter(base)) == 4
        text = S.telemetry.render_prometheus()
        got.append([line for line in text.splitlines()
                    if line.startswith("mxtpu_prefetch_batches_total") or
                    line.startswith("mxtpu_prefetch_queue_occupancy_count")])
        S.telemetry.disable()
    assert got[0] == got[1]
    assert "mxtpu_prefetch_batches_total 4" in got[0]


@pytest.mark.parametrize("on", [True, False])
def test_speedometer_data_wait(on):
    got = []
    for S in (mt, mx):
        if on:
            S.telemetry.enable(trace=False)
        spd = S.callback.Speedometer(batch_size=10, frequent=2)
        _fit_small(S, speedometer=spd)
        assert spd.last_speed is not None and spd.last_speed > 0
        got.append(spd.last_data_wait_ms is None)
        if on:
            assert spd.last_data_wait_ms >= 0.0
        S.telemetry.disable()
    assert got == [not on, not on]


def test_summary_and_peak_flops(monkeypatch):
    telemetry.enable(trace=False)
    telemetry.counter("mxtpu_x_total").inc(3)
    assert telemetry.summary() == {"counters": {"mxtpu_x_total": 3}}
    assert telemetry.peak_flops() == 989e12
    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_FLOPS", "1e12")
    assert telemetry.peak_flops() == jtelemetry.peak_flops() == 1e12
    assert telemetry.dump_dir().endswith("mxnet_tpu_torch-artifacts")


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------
def _two_thread_spans(P):
    with P.Frame("main.span", "test"):
        pass

    def worker():
        with P.Frame("worker.span", "test"):
            pass

    t = threading.Thread(target=worker, name="tele-test-worker")
    t.start()
    t.join()


def test_profiler_records_real_thread_ids_and_dumps_mid_run(tmp_path):
    got = []
    for P in (profiler, jprofiler):
        out = tmp_path / ("%s.json" % P.__name__.split(".")[0])
        P.profiler_set_config(mode="all", filename=str(out))
        P.profiler_set_state("run")
        try:
            _two_thread_spans(P)
            P.dump_profile()  # mid-run, without stop
        finally:
            P.profiler_set_state("stop")
        events = json.loads(out.read_text())["traceEvents"]
        mine = [e for e in events if e["name"].endswith(".span")]
        assert all(e["ph"] == "X" and "dur" in e for e in events)
        got.append((sorted(e["name"] for e in mine),
                    len({e["tid"] for e in mine})))
    assert got[0] == got[1] == (["main.span", "worker.span"], 2)


def test_profiler_run_writes_a_torch_trace_of_the_frames(tmp_path):
    """The JAX package writes its jax.profiler trace to <stem>_xplane/;
    the port writes its torch.profiler trace to <stem>_kineto.json, and
    a Frame's span is a range in it."""
    out = tmp_path / "prof.json"
    profiler.profiler_set_config(mode="all", filename=str(out))
    profiler.profiler_set_state("run")
    try:
        with profiler.Frame("Executor.fused_step", "exec"):
            _fit_small(mt)
    finally:
        profiler.profiler_set_state("stop")
    path = profiler.device_trace_path()
    assert path == str(tmp_path / "prof_kineto.json")
    events = json.load(open(path))["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"Executor.fused_step", "Module.fit:step"} <= ranges
    assert any(re.match(r"aten::(mm|addmm)", e.get("name", ""))
               for e in events)


def test_telemetry_never_starts_the_torch_profiler():
    telemetry.enable(trace=True)
    with telemetry.span("host-only"):
        pass
    assert profiler._state["torch_prof"] is None
    assert any(e["name"] == "host-only" for e in telemetry.tracer.events())


def test_telemetry_dump_tool(tmp_path):
    telemetry.enable(trace=True)
    with telemetry.span("tool.span", "test"):
        pass
    trace_a = tmp_path / "a.json"
    telemetry.dump_trace(str(trace_a))
    events = tmp_path / "events.jsonl"
    events.write_text(json.dumps({"ts": 1.0, "kind": "step", "n": 1}) +
                      "\n" + json.dumps({"ts": 2.5, "kind": "compile"}) +
                      "\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m",
                        "mxnet_tpu_torch.tools.telemetry_dump", "events",
                        str(events), "--tail", "5"], capture_output=True,
                       text=True, env=env, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "step" in r.stdout and "2 event(s)" in r.stdout
    merged = tmp_path / "merged.json"
    r = subprocess.run([sys.executable, "-m",
                        "mxnet_tpu_torch.tools.telemetry_dump", "trace",
                        str(trace_a), str(trace_a), "-o", str(merged)],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    payload = json.loads(merged.read_text())
    telemetry.validate_trace(payload)
    assert any(e.get("name") == "tool.span" for e in payload["traceEvents"])
