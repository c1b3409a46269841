"""The port's cluster-wide observability against the JAX package's, on the
CPU: trace contexts through kvstore RPC envelopes, the fleet aggregator,
trace merging, straggler events, and the flight recorder.

The counterparts of ``tests/test_telemetry_dist.py``'s cases, side by side
where the JAX package has the case:

* the port's client stamps the JAX client's trace context, field for
  field, and a port client talking to a JAX server (the wire is shared)
  gives handler spans with the client spans' trace ids; off, the envelope
  stays the plain four fields;
* ``FleetAggregator`` pages byte for byte the JAX package's for the same
  pushes; ``proc_identity`` follows the DMLC contract as the JAX
  package's does; ``python -m mxnet_tpu_torch.tools.trace_merge`` merges
  a port dump and a JAX dump into one fleet timeline;
* flight-recorder postmortems: contents, off is a no-op, a fault-injected
  ``kill`` (a subprocess), the kvstore and serving preemption handlers,
  an unhandled thread exception, and a membership eviction.
"""
import glob
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch import kvstore_server as kvs
from mxnet_tpu_torch.telemetry.distributed import FleetAggregator

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu import kvstore_server as jkvs
from mxnet_tpu.telemetry.distributed import FleetAggregator as JAggregator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _plain_env():
    """The environment for a child process: this repository on the path
    and no DMLC role (a server role would serve at import)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DMLC_")}
    env["PYTHONPATH"] = REPO
    return env


def _traced_session(client_mod, server_mod):
    srv = server_mod.start_server(port=0, num_workers=1)
    try:
        with client_mod.ServerClient("127.0.0.1", srv.addr[1]) as cli:
            cli.init("w", np.zeros(4, np.float32))
            cli.push("w", np.ones(4, np.float32))
            cli.pull("w")
            cli.multi([("init", "a", np.ones(2, np.float32)),
                       ("init", "b", np.ones(2, np.float32))])
    finally:
        srv.stop()


def _spans(tm, cat):
    return {e["args"]["trace"]: e for e in tm.tracer.events()
            if e.get("cat") == cat and e.get("args")}


@pytest.mark.parametrize("server", ["port", "jax"])
def test_rpc_trace_ids_shared_between_client_and_server_spans(server):
    telemetry.enable(trace=True)
    server_mod = kvs
    server_tm = telemetry
    if server == "jax":
        jtelemetry.enable(trace=True)
        server_mod, server_tm = jkvs, jtelemetry
    _traced_session(kvs, server_mod)
    client = _spans(telemetry, "kvclient")
    handler = _spans(server_tm, "kvserver")
    assert client and set(client) <= set(handler)
    assert "kv.client.multi" in {e["name"] for e in client.values()}
    assert all(e["args"]["src"] for e in handler.values())
    flows = {}
    for tm in {telemetry, server_tm}:
        for e in tm.tracer.events():
            if e.get("ph") in ("s", "f") and e.get("cat") == "flow" and \
                    e["name"] == "kv.rpc":
                flows.setdefault(e["id"], set()).add(e["ph"])
    assert any(v == {"s", "f"} for v in flows.values())


def test_envelope_carries_the_jax_clients_trace_context(monkeypatch):
    telemetry.enable(trace=False)
    jtelemetry.enable(trace=False)
    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.setenv("DMLC_WORKER_ID", "3")
    envs = []
    for mod in (kvs, jkvs):
        srv = mod.start_server(port=0, num_workers=1)
        try:
            with mod.ServerClient("127.0.0.1", srv.addr[1]) as cli:
                sent = []
                orig = cli._submit

                def spy(msg, retries=None, ctx=None, orig=orig, sent=sent):
                    ent = orig(msg, retries=retries, ctx=ctx)
                    sent.append(ent["env"])
                    return ent

                cli._submit = spy
                cli.init("w", np.zeros(2, np.float32))
                envs.append(sent[0])
        finally:
            srv.stop()
    port, ref = envs
    assert len(port) == len(ref) == 5
    assert port[0] == ref[0] == "req" and port[3][0] == ref[3][0] == "init"
    assert sorted(port[4]) == sorted(ref[4]) == ["parent", "rank", "role",
                                                 "trace"]
    assert (port[4]["role"], port[4]["rank"]) == \
        (ref[4]["role"], ref[4]["rank"]) == ("worker", 3)
    assert port[4]["trace"] == port[4]["parent"]
    assert port[4]["trace"].startswith(port[1][:8] + "-")


def test_telemetry_off_keeps_plain_envelope():
    assert not telemetry.enabled()
    srv = kvs.start_server(port=0, num_workers=1)
    try:
        with kvs.ServerClient("127.0.0.1", srv.addr[1]) as cli:
            ent = cli._submit(("pull_part", "nope", 0, 1))
            ent["event"].wait()
            assert len(ent["env"]) == 4
    finally:
        srv.stop()
    assert telemetry.tracer.events() == []


# ---------------------------------------------------------------------------
# fleet: aggregator, identity, trace merge
# ---------------------------------------------------------------------------
def _push(agg, role, rank, body):
    req = urllib.request.Request(
        "http://%s/push?role=%s&rank=%d" % (agg.addr, role, rank),
        data=body.encode(), method="POST")
    urllib.request.urlopen(req, timeout=5).close()


def _get(agg, path):
    return urllib.request.urlopen("http://%s%s" % (agg.addr, path),
                                  timeout=5).read().decode()


PAGES = [("worker", 0, 'mxtpu_step_last_ms 5\nmxtpu_x_total{k="a"} 2\n'),
         ("worker", 1, "mxtpu_step_last_ms 9\n"),
         ("server", 0, "mxtpu_kvsrv_round_skew_ms 3.5\n"),
         ("serving", 0, 'mxtpu_platform_fault_ins_total{model="resnet"} 3\n'
          'mxtpu_requests_total{model="resnet",tenant="acme"} 10\n'),
         ("serving", 1, 'mxtpu_platform_fault_ins_total{model="lm"} 2\n')]


def test_aggregator_pages_match_the_jax_package():
    got = []
    for cls in (FleetAggregator, JAggregator):
        agg = cls().start()
        try:
            for role, rank, body in PAGES:
                _push(agg, role, rank, body)
            got.append((_get(agg, "/metrics"), json.loads(
                _get(agg, "/healthz")), agg.processes()))
        finally:
            agg.stop()
    assert got[0] == got[1]
    page = got[0][0]
    assert 'mxtpu_x_total{k="a",role="worker",rank="0"} 2' in page
    assert 'mxtpu_fleet_step_ms{stat="median"} 7' in page
    assert "mxtpu_fleet_sync_skew_ms 3.5" in page
    assert "mxtpu_fleet_models 2" in page
    assert got[0][1] == {"status": "ok", "processes": 5}


def test_pusher_lands_on_the_aggregator(monkeypatch):
    agg = FleetAggregator().start()
    try:
        monkeypatch.setenv("MXNET_TELEMETRY_AGG_ADDR", agg.addr)
        monkeypatch.setenv("DMLC_ROLE", "worker")
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        telemetry.gauge("mxtpu_step_last_ms").set(4.0)
        assert telemetry.distributed.push_once()
        assert agg.processes() == [("worker", "1")]
        assert 'mxtpu_step_last_ms{role="worker",rank="1"} 4' in \
            agg.render()
    finally:
        agg.stop()
    assert not telemetry.distributed.push_once(addr="127.0.0.1:1",
                                               timeout=0.2)


@pytest.mark.parametrize("envs", [
    {"DMLC_ROLE": "server", "DMLC_SERVER_ID": "2"},
    {"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "1"},
    {"DMLC_WORKER_ID": "4"},
    {"MXNET_TELEMETRY_ROLE": "evaluator"},
    {"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "x"},
])
def test_proc_identity_matches_the_jax_package(monkeypatch, envs):
    for k in ("DMLC_ROLE", "DMLC_SERVER_ID", "DMLC_WORKER_ID",
              "MXNET_TELEMETRY_ROLE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    from mxnet_tpu.telemetry import distributed as jd
    from mxnet_tpu_torch.telemetry import distributed as d

    assert d.proc_identity() == jd.proc_identity()
    assert d.proc_label() == jd.proc_label()


def test_trace_merge_stitches_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    telemetry.enable(trace=True)
    jtelemetry.enable(trace=True)
    _traced_session(kvs, jkvs)  # port client, JAX server
    a, b = tmp_path / "trace-worker0.json", tmp_path / "trace-server0.json"
    telemetry.dump_trace(str(a))
    monkeypatch.setenv("DMLC_ROLE", "server")
    monkeypatch.setenv("DMLC_SERVER_ID", "0")
    jtelemetry.dump_trace(str(b))
    out = tmp_path / "fleet.json"
    r = subprocess.run([sys.executable, "-m",
                        "mxnet_tpu_torch.tools.trace_merge", "-o", str(out),
                        str(a), str(b)], capture_output=True, text=True,
                       env=_plain_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "process tracks: server0, worker0" in r.stdout
    evs = json.loads(out.read_text())["traceEvents"]
    telemetry.validate_trace({"traceEvents": evs})
    # a flow id with its start on the worker's track and its finish on
    # the server's: the arrow crosses processes
    by_id = {}
    for e in evs:
        if e.get("ph") in ("s", "f") and e["name"] == "kv.rpc":
            by_id.setdefault(e["id"], {})[e["ph"]] = e["pid"]
    assert any(v.get("s") == 0 and v.get("f") == 1 for v in by_id.values())


def test_straggler_event_on_a_delayed_rank(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_STRAGGLER_MULT", "1.5")
    monkeypatch.setenv("MXNET_TELEMETRY_STRAGGLER_MIN_MS", "50")
    telemetry.enable(trace=False)
    srv = kvs.KVStoreServer(port=0, num_workers=2, sync_mode=True)
    try:
        srv._dispatch(("init", "w", np.zeros(4, np.float32)))
        srv._dispatch(("push", "w", np.ones(4, np.float32), 0))
        time.sleep(0.25)
        srv._dispatch(("push", "w", np.ones(4, np.float32), 1))
        evs = telemetry.events_of("straggler")
        assert len(evs) == 1 and evs[0]["rank"] == 1
        mon = telemetry.StepMonitor(telemetry)
        assert mon.report()["stragglers"] == {"1": 1}
    finally:
        srv._server.server_close()


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def test_flight_recorder_dump_contents_as_the_jax_package(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_POSTMORTEM_DIR", str(tmp_path))
    posts = []
    for tm in (telemetry, jtelemetry):
        tm.enable(trace=True)
        with tm.span("doomed-step"):
            pass
        tm.log_event("last-words", detail=42)
        tm.counter("mxtpu_doom_total").inc()
        path = tm.flight_recorder.dump("unit-test", extra={"k": "v"})
        assert path and tm.flight_recorder.last_path() == path
        posts.append(json.load(open(path)))
        tm.disable()
    port, ref = posts
    assert sorted(port) == sorted(ref)
    for post in posts:
        assert post["reason"] == "unit-test" and post["extra"] == {"k": "v"}
        assert post["pid"] == os.getpid()
        assert [s["name"] for s in post["spans"]] == ["doomed-step"]
        assert [e["kind"] for e in post["events"]] == ["last-words"]
        assert post["metrics"]["mxtpu_doom_total"] == 1


def test_flight_recorder_noop_when_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_POSTMORTEM_DIR", str(tmp_path))
    assert telemetry.flight_recorder.dump("nope") is None
    assert not list(tmp_path.iterdir())


def test_fault_kill_leaves_postmortem(tmp_path):
    env = dict(_plain_env(), MXNET_TELEMETRY="1",
               MXNET_TELEMETRY_DIR=str(tmp_path),
               MXNET_FAULTS_SPEC="boom.op:kill=1@#1", MXNET_FAULTS_SEED="0")
    r = subprocess.run(
        [sys.executable, "-c",
         "from mxnet_tpu_torch import faults, telemetry\n"
         "with telemetry.span('pre-crash'):\n"
         "    pass\n"
         "faults.fire('boom.op')\n"],
        env=env, cwd=REPO, timeout=120)
    assert r.returncode == 137
    pm = glob.glob(str(tmp_path / "postmortem-*.json"))
    assert len(pm) == 1
    post = json.load(open(pm[0]))
    assert post["reason"] == "fault-kill:boom.op"
    assert any(s["name"] == "pre-crash" for s in post["spans"])


def test_preemption_handlers_dump_postmortems(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_POSTMORTEM_DIR", str(tmp_path))
    telemetry.enable(trace=False)
    from mxnet_tpu_torch.kvstore import install_preemption_handler
    from mxnet_tpu_torch.serving.server import \
        install_preemption_handler as serving_handler

    calls = []

    class _KV:
        def drain(self, timeout=None):
            calls.append("drain")
            return True

        def leave(self):
            calls.append("leave")

    class _Server:
        def begin_drain(self):
            calls.append("begin_drain")

        def stop(self, drain=True, timeout_ms=None):
            calls.append("stop")

    reasons = []
    # each postmortem read as it lands: two dumps in one millisecond share
    # a file name
    for handler in (install_preemption_handler(_KV(), exit_process=False),
                    serving_handler(_Server(), exit_process=False)):
        handler()
        path = telemetry.flight_recorder.last_path()
        assert os.path.dirname(path) == str(tmp_path)
        reasons.append(json.load(open(path))["reason"])
    assert calls == ["drain", "leave", "begin_drain", "stop"]
    assert reasons == ["preemption-sigterm", "preemption-sigterm-serving"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_excepthook_dump_on_unhandled_thread_exception(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_POSTMORTEM_DIR", str(tmp_path))
    telemetry.enable(trace=False)

    def boom():
        raise RuntimeError("thread went sideways")

    t = threading.Thread(target=boom, name="doomed-thread")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    pm = glob.glob(str(tmp_path / "postmortem-*.json"))
    assert len(pm) == 1
    post = json.load(open(pm[0]))
    assert post["reason"] == "thread-exception:RuntimeError"
    assert post["extra"]["thread"] == "doomed-thread"
    telemetry.disable()
    assert threading.excepthook is threading.__excepthook__ or \
        threading.excepthook.__module__ != \
        "mxnet_tpu_torch.telemetry.flight_recorder"


def test_eviction_dumps_the_servers_postmortem(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_POSTMORTEM_DIR", str(tmp_path))
    telemetry.enable(trace=False)
    srv = kvs.KVStoreServer(port=0, num_workers=2, sync_mode=True)
    try:
        with srv._barrier_cv:
            srv._members.update({0, 1})
            srv._evict_members_locked([1], "timeout")
        pm = glob.glob(str(tmp_path / "postmortem-*.json"))
        assert len(pm) == 1
        post = json.load(open(pm[0]))
        assert post["reason"] == "evict:timeout"
        assert post["extra"]["evicted"] == [1]
        assert post["extra"]["live"] == [0]
    finally:
        srv._server.server_close()
