"""The port's compile-once tier (``mxnet_tpu_torch.compile_cache``,
``artifact_store``, the AOT half of ``checkpoint``, ``Predictor.export``)
against the JAX package's, on the CPU.

The counterparts of the 15 cases of ``tests/test_compile_cache.py`` held
to what those assert (several of them fail on the JAX side on the CPU;
the port is held to the assertions, not to how the reference fails them):
in-process and cross-process reuse (a second process starts warm: hits,
no misses, no build time, the same bits), the signature keying, the
``MIN_MS`` threshold, stale-env invalidation as an event, a hot swap under
a warm cache, the AOT bundle round trip and its topology refusal, the
admin surface and CLI, and the chaos cases (corrupt, injected I/O error,
torn store, strict).  Side by side with the JAX package: ``digest_of``,
entry headers each package reads from the other's, a JAX ``.mxc`` entry
in the port's directory (and the reverse) is a stale-env miss, a
JAX-written bundle is refused, and ``Predictor.export`` round trips within
1e-4 of the JAX package's exported predictor; each refuses the other's
artifact.  Plus what is the port's own: the generation engine's entries
and bundle (draft and resolved k), the training kinds, the CUDA graph
wrapper's replay (copy-in, launches), the library and cubin blobs.

Cross-process reuse runs this file as a script (``--worker``): one
cold and one warm process over one cache directory.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import compile_cache as cc
from mxnet_tpu_torch import faults, telemetry
from mxnet_tpu_torch.base import MXNetError

if __name__ != "__main__":
    import mxnet_tpu as mx
    from mxnet_tpu import compile_cache as jcc
    from mxnet_tpu import telemetry as jtelemetry

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))

IN_DIM, HID, OUT, BATCH = 6, 8, 3, 4
TOL = dict(rtol=1e-4, atol=1e-6)


def _reset():
    """Zero the port's counters, drop its in-memory entries and bundles
    (the next build must go through the disk or an attached bundle)."""
    cc.reset_stats()
    mt.autotune.reset_for_tests()


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "cc")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", d)
    monkeypatch.delenv("MXNET_AUTOTUNE", raising=False)
    _reset()
    yield d
    _reset()


@pytest.fixture
def events(monkeypatch):
    """The port's structured events, recorded for the test."""
    monkeypatch.setattr(telemetry, "_ENABLED", True)
    return lambda: [e["kind"] for e in telemetry.events()]


# -- one small net ---------------------------------------------------------
def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=HID,
                                 name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=OUT, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _params(seed=5):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(HID, IN_DIM).astype(np.float32) * 0.3,
            "fc1_bias": rng.randn(HID).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(OUT, HID).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(OUT, np.float32)}


def _x(n=2, seed=3):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


def _predict(X, seed=5):
    pred = mt.Predictor(_mlp(mt), {k: mt.nd.array(v, mt.cpu())
                                   for k, v in _params(seed).items()},
                        {"data": X.shape}, ctx=mt.cpu())
    return pred.forward(data=X)[0].asnumpy()


def _save(prefix, epoch, seed=5):
    mt.model.save_checkpoint(prefix, epoch, _mlp(mt),
                             {k: mt.nd.array(v, mt.cpu())
                              for k, v in _params(seed).items()}, {})


def _server(prefix, epoch, **kw):
    return mt.serving.InferenceServer.from_checkpoint(
        prefix, epoch, {"data": (BATCH, IN_DIM)}, ctx=mt.cpu(),
        max_wait_us=1000, **kw)


def _flip_tail(path, n=4):
    with open(path, "r+b") as f:
        f.seek(-n, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef"[:n])


# ---------------------------------------------------------------------------
# the shared grammar, side by side
# ---------------------------------------------------------------------------

PARTS = [{"schema": 1, "kind": "fwd", "sig": {"args": [["data", [2, 6],
                                                         "float32"]]}},
         {"b": [1, 2, {"x": None}], "a": "é", "n": 1.5},
         {"schema": 1, "blob": "lib", "name": "libflash_fwd-0123.so"}]


@pytest.mark.parametrize("parts", PARTS)
def test_digest_of_is_equal_in_both_packages(parts):
    from mxnet_tpu.artifact_store import digest_of as jdigest

    assert mt.artifact_store.digest_of(parts) == jdigest(parts)


def test_entry_headers_each_package_reads_from_the_other(tmp_path):
    from mxnet_tpu.artifact_store import EntryStore as JStore

    tstore = mt.artifact_store.EntryStore(b"MXTPUCC1", ".mxc",
                                          "compile-cache", "compile_cache")
    jstore = JStore(b"MXTPUCC1", ".mxc", "compile-cache", "compile_cache")
    meta = {"digest": "d0", "kind": "fwd", "env": {"framework": "torch"}}
    path = tstore.write_entry(str(tmp_path / "t"), "d0", meta, b"\x00pay")
    assert jstore.entry_meta(path) == meta
    assert jstore.read_payload(path) == (meta, b"\x00pay")
    meta2 = {"digest": "d1", "kind": "fused", "env": {"jax": "x"}}
    path2 = jstore.write_entry(str(tmp_path / "j"), "d1", meta2, b"xla")
    assert tstore.read_payload(path2) == (meta2, b"xla")
    # both CRC sidecars are the same file format
    from mxnet_tpu.filesystem import verify_crc_sidecar as jverify
    assert jverify(path) is True
    assert mt.filesystem.verify_crc_sidecar(path2) is True


def test_env_fingerprint_is_torch_terms():
    fp = cc.env_fingerprint()
    assert set(fp) == {"schema", "framework", "torch", "cuda", "platform",
                       "device_kind", "device_count", "process_count"}
    assert fp["framework"] == "torch" and fp["platform"] == "cpu"
    import importlib

    atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")
    assert atdb.topology_fingerprint() == {
        k: fp[k] for k in ("platform", "device_kind", "device_count",
                           "process_count")}


def test_off_by_default_the_callable_is_untouched(monkeypatch):
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    _reset()

    def fn():
        return 1

    assert cc.maybe_cached(fn, "fwd", ("fwd", False), None) is fn
    pred = mt.Predictor(_mlp(mt), {k: mt.nd.array(v, mt.cpu())
                                   for k, v in _params().items()},
                        {"data": (2, IN_DIM)}, ctx=mt.cpu())
    pred.forward(data=_x())
    assert pred._exec._jit_cache == {}
    assert cc.stats()["misses"] == 0 and cc.stats()["hits"] == 0


# ---------------------------------------------------------------------------
# in-process roundtrip + keying
# ---------------------------------------------------------------------------

def test_predictor_roundtrip_in_process(cache_dir):
    """First build runs cold and stores; after dropping the in-memory
    entries a fresh executor loads the disk entry — a hit, no build —
    and gives the same bits."""
    X = _x()
    out_cold = _predict(X)
    s = cc.stats()
    assert s["misses"] >= 1 and s["stores"] >= 1 and s["hits"] == 0
    assert cc.ls_entries(cache_dir), "store left no entry on disk"
    _reset()
    out_warm = _predict(X)
    s = cc.stats()
    assert s["hits"] >= 1 and s["misses"] == 0 and s["errors"] == 0
    assert s["compile_ms"] == 0.0
    np.testing.assert_array_equal(out_cold, out_warm)


def test_second_executor_of_the_same_symbol_and_signature_hits(cache_dir):
    _predict(_x())
    before = cc.stats()
    _predict(_x())  # a new Predictor: same graph, same signature
    after = cc.stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]


def test_signature_change_is_a_new_entry(cache_dir):
    _predict(np.zeros((2, IN_DIM), np.float32))
    n1 = len(cc.ls_entries(cache_dir))
    _predict(np.zeros((4, IN_DIM), np.float32))
    assert len(cc.ls_entries(cache_dir)) > n1, \
        "shape change reused the same cache entry"


def test_min_ms_threshold_skips_store(cache_dir, monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_MIN_MS", "1e9")
    _predict(_x())
    s = cc.stats()
    assert s["misses"] >= 1 and s["stores"] == 0
    assert not cc.ls_entries(cache_dir)


def test_version_mismatch_invalidates_with_event(cache_dir, monkeypatch,
                                                 events):
    """An entry recorded under another torch version is a miss with a
    ``compile_cache_invalidate`` event — never served, never a crash."""
    X = _x()
    _predict(X)
    assert cc.stats()["stores"] >= 1
    _reset()
    fake = dict(cc.env_fingerprint())
    fake["torch"] = "0.0.0-stale-test"
    monkeypatch.setattr(cc, "_env_fp_cache", fake)
    out = _predict(X)
    s = cc.stats()
    assert s["hits"] == 0 and s["misses"] >= 1 and s["errors"] == 0
    assert "compile_cache_invalidate" in events()
    assert out.shape == (2, OUT)


def test_jax_entries_and_port_entries_are_stale_env_misses(
        cache_dir, monkeypatch, events):
    """Same magic, same suffix, another envelope: a JAX-written ``.mxc``
    under the port's digest is a miss with an invalidate event, and the
    port's entry under the JAX package's digest is one for the JAX
    package (no crash on either side)."""
    X = _x()
    _predict(X)
    entry = cc.ls_entries(cache_dir)[0]
    digest = entry["digest"]
    # a JAX-written entry (its envelope, a pickled payload) in its place
    meta = {"digest": digest, "kind": "fwd", "env": jcc.env_fingerprint(),
            "compile_ms": 1.0, "cost": None}
    for p in (entry["path"], entry["path"] + ".crc32"):
        os.remove(p)
    jcc._write_entry(cache_dir, digest, meta, b"\x80\x04N.")
    assert cc.ls_entries(cache_dir)[0]["env_ok"] is False
    _reset()
    out = _predict(X)
    s = cc.stats()
    assert s["hits"] == 0 and s["misses"] == 1 and s["errors"] == 0
    assert "compile_cache_invalidate" in events()
    np.testing.assert_array_equal(out, _predict(X))
    # the reverse: the port's entry where the JAX package looks
    port_entry = cc.ls_entries(cache_dir)
    jtelemetry._reset_for_tests()
    jcc.reset_stats()
    jtelemetry.enable(trace=False)
    try:
        assert jcc._load(port_entry[0]["digest"]) is None
        kinds = [e["kind"] for e in jtelemetry.events()]
        assert "compile_cache_invalidate" in kinds
        assert jcc.stats()["errors"] == 0
    finally:
        jtelemetry._reset_for_tests()
        jcc.reset_stats()


# ---------------------------------------------------------------------------
# cross-process reuse: one cold and one warm process (this file, run as a
# script)
# ---------------------------------------------------------------------------

def _run_worker(cache):
    env = dict(os.environ, MXNET_COMPILE_CACHE_DIR=cache,
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("MXNET_AUTOTUNE", None)
    proc = subprocess.run([sys.executable, HERE, "--worker"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xproc") / "cc")
    return _run_worker(d), _run_worker(d)


def test_cross_process_predictor_reuse(two_processes):
    a, b = two_processes
    assert a["predict"]["misses"] >= 1 and a["predict"]["stores"] >= 1
    assert b["predict"]["hits"] >= 1, b
    assert b["predict"]["misses"] == 0, \
        "second process ran cold: %s" % b["predict"]
    assert b["predict"]["compile_ms"] == 0.0
    assert b["predict_digest"] == a["predict_digest"], \
        "cache-served outputs are not bit-identical"


def test_cross_process_fused_train_reuse(two_processes):
    """The training kinds are entries too: the second process trains to
    the same weights with every step's entry a hit."""
    a, b = two_processes
    assert "fused" in a["kinds"]
    assert a["train"]["misses"] >= 1 and a["train"]["stores"] >= 1
    assert b["train"]["hits"] >= 1 and b["train"]["misses"] == 0, b
    assert b["train_digest"] == a["train_digest"], \
        "warm-start training diverged from the cold-start run"


def _worker():
    import hashlib

    out = {}
    X = np.linspace(-1.0, 1.0, 2 * IN_DIM, dtype=np.float32).reshape(
        2, IN_DIM)
    got = _predict(X)
    out["predict_digest"] = hashlib.sha256(
        np.ascontiguousarray(got).tobytes()).hexdigest()
    out["predict"] = cc.stats()
    cc.reset_stats()  # zero the counters; the disk is what the next reads
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, IN_DIM))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in _params().items()},
                    aux_params={})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(11)
    for _ in range(3):
        batch = mt.io.DataBatch(
            [mt.nd.array(rng.randn(BATCH, IN_DIM).astype(np.float32),
                         mt.cpu())],
            [mt.nd.array(rng.randint(0, OUT, BATCH).astype(np.float32),
                         mt.cpu())])
        mod.forward_backward(batch)
        mod.update()
    final, _ = mod.get_params()
    h = hashlib.sha256()
    for name in sorted(final):
        h.update(name.encode())
        h.update(np.ascontiguousarray(final[name].asnumpy()).tobytes())
    out["train_digest"] = h.hexdigest()
    out["train"] = cc.stats()
    out["kinds"] = sorted({e.get("kind") for e in
                           cc.ls_entries(cc.cache_dir())})
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# serving: warm swap + AOT bundles
# ---------------------------------------------------------------------------

def test_hot_swap_warm_cache_zero_compiles(cache_dir, tmp_path):
    """swap() under a warm cache: the shadow replica's warm-up is served
    from the cache — no cold-bucket runs, no new misses — and the answers
    carry the NEW params (the entry is reused, the weights are not)."""
    prefix = str(tmp_path / "swapcc")
    _save(prefix, 1, seed=12)
    _save(prefix, 2, seed=13)
    X = _x(4, seed=8)
    srv = _server(prefix, 1)
    try:
        before = cc.stats()
        assert before["misses"] >= 1
        srv.swap(prefix, 2)
        after = cc.stats()
        assert srv.cold_bucket_runs() == 0
        assert after["misses"] == before["misses"], \
            "swap shadow built cold instead of inheriting the entries"
        assert after["compile_ms"] == before["compile_ms"]
        assert after["hits"] > before["hits"]
        np.testing.assert_allclose(srv.predict(data=X[0])[0],
                                   _predict(X[:1], seed=13)[0], **TOL)
    finally:
        srv.stop()


def test_aot_bundle_roundtrip(cache_dir, tmp_path, monkeypatch):
    """save_aot_bundle beside the checkpoint, then restore with NO cache
    dir: from_checkpoint attaches the bundle and the whole warm-up is
    served from it."""
    prefix = str(tmp_path / "aot")
    _save(prefix, 1, seed=4)
    X = _x(4, seed=5)
    srv = _server(prefix, 1)
    try:
        entries = srv.compiled_entries()
        assert entries and {e.cache_state for e in entries} == {"miss"}
        ref = srv.predict(data=X[0])[0]
        bundle = srv.save_aot_bundle(prefix, 1)
    finally:
        srv.stop()
    assert bundle == mt.checkpoint.aot_bundle_path(prefix, 1)
    manifest = cc.read_manifest(bundle)
    assert manifest["entries"], "bundle saved no entries"
    assert manifest["warmup"]["buckets"] == [1, 2, 4]
    assert manifest["env"] == cc.env_fingerprint()

    _reset()  # also detaches bundles + drops the memory entries
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", "")
    srv2 = _server(prefix, 1)
    try:
        s = cc.stats()
        assert s["hits"] >= 1 and s["misses"] == 0, \
            "bundle-attached warm-up still built cold: %s" % s
        assert {e.cache_state for e in srv2.compiled_entries()} == {"hit"}
        np.testing.assert_array_equal(srv2.predict(data=X[0])[0], ref)
        assert srv2.cold_bucket_runs() == 0
    finally:
        srv2.stop()


def test_aot_bundle_topology_mismatch_refused(cache_dir, tmp_path):
    """A bundle built for another device topology (or another card), and
    one the JAX package wrote, are refused loudly at attach time;
    attach_aot=False still serves."""
    prefix = str(tmp_path / "aotbad")
    _save(prefix, 1, seed=4)
    srv = _server(prefix, 1)
    try:
        bundle = srv.save_aot_bundle(prefix, 1)
    finally:
        srv.stop()
    mpath = os.path.join(bundle, cc.MANIFEST_NAME)
    good = cc.read_manifest(bundle)
    for key, value, match in (
            ("device_count", good["env"]["device_count"] + 8,
             "device_count"),
            ("device_kind", "NVIDIA H100 80GB HBM3", "device_kind")):
        manifest = json.loads(json.dumps(good))
        manifest["env"][key] = value
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        _reset()
        with pytest.raises(MXNetError, match=match):
            _server(prefix, 1)
    # a JAX-shaped manifest: the JAX package's envelope, no framework key
    manifest = json.loads(json.dumps(good))
    manifest["env"] = jcc.env_fingerprint()
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    _reset()
    with pytest.raises(MXNetError, match="framework"):
        _server(prefix, 1)
    srv3 = _server(prefix, 1, attach_aot=False)
    try:
        np.testing.assert_allclose(srv3.predict(data=_x(1)[0])[0],
                                   _predict(_x(1), seed=4)[0], **TOL)
    finally:
        srv3.stop()


def test_a_jax_written_bundle_raises_in_the_port(cache_dir, tmp_path):
    prefix = str(tmp_path / "jaxbundle")
    _save(prefix, 1)
    jcc.save_bundle(mt.checkpoint.aot_bundle_path(prefix, 1), entries=[])
    with pytest.raises(MXNetError, match="framework"):
        mt.checkpoint.attach_aot_bundle(prefix, 1)
    assert mt.checkpoint.attach_aot_bundle(prefix, 2) is None  # none there


def test_engine_bundle_carries_the_draft_and_the_resolved_k(
        cache_dir, tmp_path, monkeypatch):
    """The generator's prefill/decode/draft/verify entries ride in the AOT
    bundle under their own kinds; the manifest carries the draft
    checkpoint (a sidecar ``.draft.params``) and the RESOLVED k; a
    replica restored from the bundle speculates at once, with no cold
    build, and says the same tokens."""
    V, L, H, D, S = 32, 1, 2, 16, 16
    net = mt.models.get_transformer_lm(vocab_size=V, num_layers=L,
                                       num_heads=H, hidden=D, seq_len=S)
    arg_shapes, _, _ = net.infer_shape(data=(2, S), softmax_label=(2, S))
    rng = np.random.RandomState(0)
    params = {n: mt.nd.array(rng.randn(*s).astype(np.float32) * 0.3,
                             mt.cpu())
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / "gen")
    mt.model.save_checkpoint(prefix, 1, net, dict(params), {})
    spec = dict(vocab_size=V, num_layers=L, num_heads=H, hidden=D,
                max_seq_len=S, lane_buckets=(1, 2), prefill_len_buckets=(8,),
                prefill_batch_buckets=(1,), num_pages=16, page_size=4,
                draft={"params": dict(params), "num_layers": L,
                       "num_heads": H, "hidden": D})
    monkeypatch.setenv("MXNET_AUTOTUNE", "record")
    _reset()
    srv = mt.serving.InferenceServer(
        net, dict(params), {"data": (1, S), "softmax_label": (1, S)},
        ctx=mt.cpu(), generator_spec=spec)
    try:
        ref = srv.submit_generate([6, 3, 9], 5).result(timeout=120)
        k = srv._generator.spec()["draft"]["k"]
        assert k == 1  # the draft_k site's analytic winner at hint 0.8
        kinds = {e._kind for e in srv.compiled_entries()}
        assert {"fwd", "gen-prefill", "gen-step", "gen-draft-prefill",
                "gen-draft-step", "gen-verify"} <= kinds, kinds
        bundle = srv.save_aot_bundle(prefix, 1)
    finally:
        srv.stop()
    gen_spec = cc.read_manifest(bundle)["warmup"]["generator"]
    assert gen_spec["draft"]["k"] == k
    assert gen_spec["draft"]["params"].endswith(".draft.params")
    assert os.path.exists(gen_spec["draft"]["params"])
    ls = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.compile_cache_admin",
         "ls", "--dir", cache_dir, "--json"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert ls.returncode == 0, ls.stderr[-2000:]
    ls_kinds = {e.get("kind") for e in json.loads(ls.stdout)}
    assert {"gen-step", "gen-prefill", "gen-verify"} <= ls_kinds, ls_kinds

    _reset()
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", "")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "empty"))
    srv2 = mt.serving.InferenceServer.from_checkpoint(
        prefix, 1, {"data": (1, S), "softmax_label": (1, S)}, ctx=mt.cpu())
    try:
        s = cc.stats()
        assert s["hits"] >= 1 and s["misses"] == 0, \
            "bundle-attached generator warm-up still built cold: %s" % s
        eng = srv2._generator
        assert eng is not None and eng.spec()["draft"]["k"] == k
        st = srv2.submit_generate([6, 3, 9], 5)
        assert st.result(timeout=120) == ref
        assert st.draft_proposed > 0
        assert srv2.cold_bucket_runs() == 0
        assert mt.autotune.stats()["tuning_ms"] == 0
    finally:
        srv2.stop()


def test_training_kinds_are_entries_without_graphs(cache_dir):
    ex = _mlp(mt).simple_bind(mt.cpu(), data=(BATCH, IN_DIM))
    for k, v in _params().items():
        ex.arg_dict[k][:] = v
    ex.forward_backward(data=_x(BATCH),
                        softmax_label=np.array([0, 1, 2, 0], np.float32))
    got = cc.entries_of(ex)
    assert [e._kind for e in got] == ["fwdbwd"]
    assert got[0].records[0]["graph"] is False
    assert got[0].cache_state == "miss"


def test_platform_bundles_at_first_build_and_faults_in_warm(
        cache_dir, tmp_path, monkeypatch):
    """The manager's three bundle steps: a cold fault-in writes the
    model's bundle at once (bundle-on-first-build), a page-out refreshes
    it before the server stops, and the next fault-in attaches it — every
    entry a hit, no cold bucket run.  On the CPU there is no CUDA graph,
    so no entry reports bytes and the estimate stays the env fraction."""
    from mxnet_tpu_torch.platform import DevicePool, ModelManager, ModelSpec

    monkeypatch.setenv("MXNET_PLATFORM_MIN_RESIDENT_S", "0")
    prefix = str(tmp_path / "solo")
    _save(prefix, 1)
    spec = ModelSpec("solo", prefix, 1, {"data": (BATCH, IN_DIM)})
    bundle = mt.checkpoint.aot_bundle_path(prefix, 1)
    with mt.cpu():
        mgr = ModelManager(DevicePool(num_devices=1,
                                      bytes_per_device=1 << 20))
    try:
        mgr.register_model(spec)
        estimate = spec.exec_footprint()
        srv = mgr.fault_in("solo")
        assert {e.cache_state for e in srv.compiled_entries()} == {"miss"}
        assert os.path.exists(os.path.join(bundle, cc.MANIFEST_NAME))
        first = os.path.getmtime(os.path.join(bundle, cc.MANIFEST_NAME))
        ref = srv.predict(data=_x(1)[0])[0]
        assert spec.exec_footprint() == estimate
        mgr.page_out("solo")
        assert os.path.getmtime(os.path.join(bundle, cc.MANIFEST_NAME)) \
            >= first
        _reset()  # no in-memory entries: the bundle must serve
        srv2 = mgr.fault_in("solo")
        assert {e.cache_state for e in srv2.compiled_entries()} == {"hit"}
        assert cc.stats()["misses"] == 0
        np.testing.assert_array_equal(srv2.predict(data=_x(1)[0])[0], ref)
        assert srv2.cold_bucket_runs() == 0
    finally:
        mgr.close()


def test_observed_graph_bytes_replace_the_estimate(monkeypatch):
    """``_observe_exec_bytes`` sums the entries' measured pool and static
    bytes (the card's CUDA graphs report them) into the spec."""
    from mxnet_tpu_torch.platform import ModelManager, ModelSpec

    class Entry:
        def __init__(self, pool, static):
            self.cost_info = {"pool_bytes": pool, "static_bytes": static}

    class Server:
        def compiled_entries(self):
            return [Entry(1000, 24), Entry(500, 0), type("E", (), {
                "cost_info": None})()]

    spec = ModelSpec("m", "/nonexistent/m", 0, {"data": (2, 3)},
                     param_bytes=10 ** 6)
    assert spec.exec_footprint() == int(10 ** 6 * 0.25)
    ModelManager._observe_exec_bytes(None, spec, Server())
    assert spec.exec_footprint() == 1524
    assert spec.footprint()["total"] == 10 ** 6 + 1524


# ---------------------------------------------------------------------------
# admin surface
# ---------------------------------------------------------------------------

def test_admin_ls_verify_prune(cache_dir):
    _predict(np.zeros((2, IN_DIM), np.float32))
    _predict(np.zeros((4, IN_DIM), np.float32))
    entries = cc.ls_entries(cache_dir)
    assert len(entries) >= 2
    assert all(e["env_ok"] for e in entries)
    for e in entries:
        ok, detail = cc.verify_entry(e["path"])
        assert ok, detail
    removed = cc.prune(cache_dir, 0)
    assert sorted(removed) == sorted(e["path"] for e in entries)
    assert not cc.ls_entries(cache_dir)
    assert not [n for n in os.listdir(cache_dir) if n.endswith(".crc32")]


def test_admin_cli_verify_flags_corruption(cache_dir):
    _predict(np.zeros((2, IN_DIM), np.float32))
    entry = cc.ls_entries(cache_dir)[0]["path"]

    def verify():
        return subprocess.run(
            [sys.executable, "-m",
             "mxnet_tpu_torch.tools.compile_cache_admin", "verify",
             "--dir", cache_dir, "--json"], cwd=ROOT,
            capture_output=True, text=True, timeout=120)

    proc = verify()
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert json.loads(proc.stdout)["bad"] == 0
    with open(entry, "r+b") as f:  # flip one payload byte
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))
    proc = verify()
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["bad"] >= 1


# ---------------------------------------------------------------------------
# chaos: corruption and injected I/O faults degrade to a plain build
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_corrupt_entry_degrades_to_recompile(cache_dir, events):
    X = _x(seed=9)
    out_cold = _predict(X)
    _flip_tail(cc.ls_entries(cache_dir)[0]["path"])
    _reset()
    out = _predict(X)
    s = cc.stats()
    assert s["errors"] >= 1, "corruption went unnoticed"
    assert s["misses"] >= 1 and s["hits"] == 0
    np.testing.assert_array_equal(out, out_cold)
    assert "compile_cache_corrupt" in events()


@pytest.mark.chaos
def test_injected_load_ioerr_degrades(cache_dir):
    X = np.zeros((2, IN_DIM), np.float32)
    out_cold = _predict(X)
    _reset()
    with faults.inject("compile_cache.load:ioerr=1") as plan:
        out = _predict(X)
        assert ("compile_cache.load", "ioerr", 1) in plan.events
    s = cc.stats()
    assert s["errors"] >= 1 and s["misses"] >= 1 and s["hits"] == 0
    np.testing.assert_array_equal(out, out_cold)


@pytest.mark.chaos
def test_torn_store_never_leaves_partial_entry(cache_dir):
    """A torn write mid-store leaves NO entry (atomic_write tears the temp,
    not the target) and the build itself succeeds: a store failure is an
    error counter, not an exception."""
    with faults.inject("compile_cache.store:partial=1@0.5"):
        out = _predict(np.zeros((2, IN_DIM), np.float32))
    assert out.shape == (2, OUT)
    s = cc.stats()
    assert s["errors"] >= 1 and s["stores"] == 0
    assert not cc.ls_entries(cache_dir)
    # the NEXT store (fault cleared) repopulates the cache cleanly
    _predict(np.zeros((4, IN_DIM), np.float32))
    assert cc.stats()["stores"] >= 1


@pytest.mark.chaos
def test_strict_mode_raises_on_corrupt(cache_dir, monkeypatch):
    _predict(np.zeros((2, IN_DIM), np.float32))
    _flip_tail(cc.ls_entries(cache_dir)[0]["path"])
    _reset()
    monkeypatch.setenv("MXNET_COMPILE_CACHE_STRICT", "1")
    with pytest.raises(Exception):
        _predict(np.zeros((2, IN_DIM), np.float32))


# ---------------------------------------------------------------------------
# libraries, cubins and the graph wrapper (what the card runs, held here
# with stand-ins)
# ---------------------------------------------------------------------------

def test_library_blob_restores_without_nvcc_only_when_its_hash_holds(
        cache_dir, tmp_path, monkeypatch):
    lib = tmp_path / "build" / "libflash_fwd-0123456789abcdef.so"
    lib.parent.mkdir()
    lib.write_bytes(b"\x7fELF" + bytes(range(256)) * 4)
    assert cc.store_library(str(lib))
    got = tmp_path / "fresh" / lib.name
    assert cc.restore_library(str(got))
    assert got.read_bytes() == lib.read_bytes()
    # a blob whose bytes no longer match its sha256 is not written
    path = [e["path"] for e in cc.ls_entries(cache_dir)
            if e.get("kind") == "lib"][0]
    _flip_tail(path, 2)
    os.remove(path + ".crc32")  # past the CRC: the sha256 still holds
    other = tmp_path / "other" / lib.name
    _reset()
    assert not cc.restore_library(str(other))
    assert not other.exists()
    assert cc.stats()["errors"] == 1


def test_cubins_come_from_the_cache_by_source_hash(cache_dir, monkeypatch):
    key = mt.cuda_rtc.source_key("extern \"C\" __global__ void k() {}", "k")
    assert key == mt.cuda_rtc.source_key(
        "extern \"C\" __global__ void k() {}", "k")
    cc.store_cubin(key, b"cubin-bytes")
    monkeypatch.setattr(mt.cuda_rtc, "_CUBINS", {})
    cc._restore_blobs({"cubins": [key], "libs": {}})
    assert mt.cuda_rtc.cubin(key) == b"cubin-bytes"
    assert mt.cuda_rtc.COMPILES["n"] == 0


def test_graph_replay_copies_rebound_inputs_and_counts_its_launches():
    """The CUDA graph wrapper, with a stand-in graph: an argument whose
    tensor is not the captured buffer is copied into it before the
    replay; the launches the wrappers made during the capture are taken
    off at capture and added on every replay."""
    import torch

    kernels = mt.kernels
    buf = torch.zeros(4)
    out = torch.zeros(4)

    class FakeGraph:
        def replay(self):
            out.copy_(buf * 2)

    before = dict(kernels.LAUNCHES)
    with kernels.recording() as seen:
        kernels.count("flash_fwd", 6)
    kernels.uncount(seen["launches"])
    assert kernels.LAUNCHES == before
    g = cc._Graph(FakeGraph(), [buf], [out], dict(seen["launches"]))
    g.replay([torch.arange(4.0)])
    assert buf.tolist() == [0, 1, 2, 3] and out.tolist() == [0, 2, 4, 6]
    g.replay([buf])
    assert kernels.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 12


def test_only_kinds_written_in_place_are_graphed(monkeypatch):
    """A CUDA graph is captured for ``"fwd"`` and the engine's prefill
    kinds only: the lane kinds adopt their output planes and the training
    kinds run a backward, so they stay eager entries."""
    class CudaLeaf:  # what _graphable reads of a CUDA tensor
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(cc, "_leaves", lambda obj, out: [CudaLeaf()])

    class Plan:
        stochastic = False

    class Exec:
        _plan, _dp, _placement = Plan(), None, {}

    kinds = ("fwd", "gen-prefill", "gen-draft-prefill", "gen-step",
             "gen-draft-step", "gen-verify", "gen-catchup", "fwdbwd",
             "fused")
    graphed = {k for k in kinds
               if cc.CachedFunction(None, k, None, Exec())._graphable(())}
    assert graphed == set(cc.GRAPH_KINDS) == {"fwd", "gen-prefill",
                                              "gen-draft-prefill"}


# ---------------------------------------------------------------------------
# Predictor.export
# ---------------------------------------------------------------------------

def test_predictor_export_round_trips_like_the_jax_package(tmp_path):
    X = _x(BATCH, seed=7)
    tpred = mt.Predictor(_mlp(mt), {k: mt.nd.array(v, mt.cpu())
                                    for k, v in _params().items()},
                         {"data": X.shape}, ctx=mt.cpu())
    jpred = mx.Predictor(_mlp(mx), {k: mx.nd.array(v)
                                    for k, v in _params().items()},
                         {"data": X.shape})
    tpath, jpath = str(tmp_path / "t.mxtt"), str(tmp_path / "j.mxtpu")
    tpred.export(tpath)
    jpred.export(jpath)
    tserved = mt.load_exported(tpath, ctx=mt.cpu())
    jserved = mx.load_exported(jpath)
    assert tserved.input_names == jserved.input_names == ["data"]
    assert tserved.output_names == jserved.output_names
    got = tserved.forward(data=X)[0].asnumpy()
    want = np.asarray(jserved.forward(data=X)[0])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, tpred.forward(data=X)[0].asnumpy())
    with pytest.raises(MXNetError, match="not an exported"):
        mt.load_exported(jpath)
    with pytest.raises(mx.base.MXNetError, match="not an exported"):
        mx.load_exported(tpath)


if __name__ == "__main__" and sys.argv[1:] == ["--worker"]:
    _worker()
