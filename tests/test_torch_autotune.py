"""The port's autotuner (``mxnet_tpu_torch.autotune``) against the JAX
package's, on the CPU.

The counterparts of the 19 cases of ``tests/test_autotune.py``, held to
what those assert: the declared spaces, the deterministic winner, the DB
round trip, off mode, stale-env invalidation, the chaos cases, tuned and
untuned compile-cache entries never sharing a key, AOT bundles carrying
the tuning entries, the five sites (``flash_attention``, whose winner
sizes nothing on the card, ``fused_step``, which records its default,
``decode_engine``, ``draft_k``, ``serving_buckets``), the admin CLI, and
a fresh process inheriting a record-mode winner with zero re-tuning (this
file run as a script, ``--worker``).  Side by side with the JAX package:
the ``spaces`` lists are equal, and the analytic winners of
``serving_buckets``, ``decode_engine`` and ``draft_k`` are equal for the
same keys.  Plus: the roofline path (``build_fn``, the cost model of
``hlo_analysis`` on meta tensors) scores candidates as the JAX package's
XLA cost analysis does under the same peaks; a JAX ``.mxt`` entry in the
port's DB is a stale-env miss.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autotune, faults, telemetry
from mxnet_tpu_torch import compile_cache as cc
from mxnet_tpu_torch.autotune import spaces
from mxnet_tpu_torch.ops.attention import resolve_blocks

atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")

if __name__ != "__main__":
    from mxnet_tpu import autotune as jautotune
    from mxnet_tpu.autotune import spaces as jspaces

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
IN_DIM, HID = 6, 3


def _reset():
    autotune.reset_for_tests()
    cc.reset_stats()


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """Fresh tuning-DB dir in record mode, clean counters."""
    d = str(tmp_path / "at")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", d)
    monkeypatch.setenv("MXNET_AUTOTUNE", "record")
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    _reset()
    yield d
    _reset()


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(telemetry, "_ENABLED", True)
    return lambda: [e["kind"] for e in telemetry.events()]


def _put(site, key, config, d=None):
    db = autotune.db() if d is None else atdb.TuningDB(d)
    db.put(site, key, config, {"objective": "test"})
    return db


def _entry_path(d):
    return os.path.join(d, atdb.ls_entries(d)[0]["digest"]
                        + atdb.ENTRY_SUFFIX)


def _flip_tail(path):
    with open(path, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")


# ---------------------------------------------------------------------------
# search spaces (side by side)
# ---------------------------------------------------------------------------

SPACES = [("flash_blocks", (512, 512)), ("flash_blocks", (64, 64)),
          ("flash_blocks", (4096, 1024)), ("flash_blocks", (300, 300)),
          ("fused_step", (True,)), ("fused_step", (False,)),
          ("lane_bucket_sets", (8,)), ("lane_bucket_sets", (1,)),
          ("lane_bucket_sets", (20,)), ("decode_engine", (8, 256)),
          ("decode_engine", (4, 16)), ("draft_k", ()),
          ("serving_buckets", (8,)), ("serving_buckets", (1,)),
          ("serving_buckets", (48,))]


@pytest.mark.parametrize("fn,args", SPACES)
def test_spaces_are_the_jax_packages(fn, args):
    assert getattr(spaces, fn)(*args) == getattr(jspaces, fn)(*args)


def test_flash_space_dedup_and_clamp_stability():
    cands = spaces.flash_blocks(512, 512)
    pairs = [(c["block_q"], c["block_k"]) for c in cands]
    assert len(pairs) == len(set(pairs)), "duplicate effective configs"
    assert (512, 512) in pairs and (128, 512) in pairs
    from mxnet_tpu_torch.ops.attention import _pick_block
    for bq, bk in pairs:
        assert _pick_block(bq, 512) == bq and _pick_block(bk, 512) == bk
    short = [(c["block_q"], c["block_k"]) for c in spaces.flash_blocks(64, 64)]
    assert short == [(64, 64)]


def test_fused_and_engine_spaces():
    with_don = spaces.fused_step(donate_allowed=True)
    assert {"remat": 0, "donate": 1} in with_don and len(with_don) == 4
    no_don = spaces.fused_step(donate_allowed=False)
    assert all(c["donate"] == 0 for c in no_don) and len(no_don) == 2
    eng = spaces.decode_engine(8, 256)
    assert all(c["page_size"] <= 256 for c in eng)
    assert any(c["lane_buckets"] == [1, 2, 4, 8] for c in eng)
    srv = spaces.serving_buckets(8)
    assert any(c["buckets"] == [1, 2, 4, 8] for c in srv)
    assert all(c["buckets"][-1] == 8 for c in srv)


# ---------------------------------------------------------------------------
# tuner + DB
# ---------------------------------------------------------------------------

def test_deterministic_winner_ties_break_canonically(tune_dir):
    cands = [{"x": 3}, {"x": 1}, {"x": 2}]
    winners = []
    for i in range(2):
        winners.append(autotune.Tuner(autotune.db()).tune(
            "t_site", {"run": i}, cands, score_fn=lambda c: 1.0))
    assert winners == [{"x": 1}, {"x": 1}]
    w = autotune.Tuner(autotune.db()).tune(
        "t_site", {"run": 3}, cands, score_fn=lambda c: c["x"])
    assert w == {"x": 1}


def test_roofline_objective_scores_as_the_jax_package_does(tune_dir,
                                                          monkeypatch):
    """``build_fn`` gives (program, abstract arguments) per candidate; the
    Tuner scores each by the roofline over the cost model's count.  For a
    product of two n x n float32 matrices both packages count 2·n³
    operations and 3·n²·4 bytes, so under the same peaks the scores and
    the winner are the JAX package's, and the provenance names the
    roofline objective."""
    import jax
    import jax.numpy as jnp
    import torch
    from mxnet_tpu_torch.hlo_analysis import TensorSpec

    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MXNET_TELEMETRY_HBM_GBS", "100")
    cands = [{"n": 48}, {"n": 16}, {"n": 32}]

    def port_build(c):
        n = c["n"]
        return (lambda a, b: a @ b,
                (TensorSpec((n, n), torch.float32),) * 2)

    def jax_build(c):
        n = c["n"]
        return (jax.jit(lambda a, b: a @ b),
                (jax.ShapeDtypeStruct((n, n), jnp.float32),) * 2)

    got = autotune.Tuner(autotune.db(), measure=False).tune(
        "t_build", {"k": 1}, cands, build_fn=port_build, default={"n": 0})
    want = jautotune.Tuner(jautotune.db(), measure=False).tune(
        "t_build", {"k": 2}, cands, build_fn=jax_build, default={"n": 0})
    assert got == want == {"n": 16}
    prov = autotune.db().get("t_build", {"k": 1})["meta"]
    assert prov["objective"] == "roofline_proxy"
    jprov = jautotune.db().get("t_build", {"k": 2})["meta"]
    assert jprov["objective"] == "roofline_proxy"
    # 2·16³ operations over 1e12 against 3·16²·4 bytes over 100 GB/s
    assert prov["score"] == pytest.approx(jprov["score"], rel=1e-9)
    assert prov["score"] == pytest.approx(3 * 16 * 16 * 4 / 100e9 * 1e3)


def test_measurement_turns_on_where_cuda_is(tune_dir, monkeypatch):
    import torch

    assert autotune.Tuner(autotune.db())._measure == \
        torch.cuda.is_available()
    monkeypatch.setenv("MXNET_AUTOTUNE_MEASURE", "1")
    measured = []
    w = autotune.Tuner(autotune.db(), topk=2).tune(
        "t_measure", {"k": 1}, [{"a": 1}, {"a": 2}, {"a": 3}],
        score_fn=lambda c: c["a"],
        measure_fn=lambda c: measured.append(c["a"]) or 10.0 - c["a"])
    assert measured == [1, 2] and w == {"a": 2}
    ent = autotune.db().get("t_measure", {"k": 1})
    assert ent["meta"]["objective"] == "measured"


def test_db_roundtrip_fresh_instance(tune_dir):
    key = {"seq": 7, "flavor": "roundtrip"}
    _put("rt_site", key, {"block": 256})
    ent = atdb.TuningDB(tune_dir).get("rt_site", key)  # fresh: disk only
    assert ent is not None and ent["config"] == {"block": 256}
    assert atdb.TuningDB(tune_dir).get("rt_site", {"seq": 8}) is None


def test_off_mode_is_inert(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "off")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "never"))
    _reset()
    assert autotune.lookup("any", {"k": 1}) is None
    assert autotune.get_or_tune("any", {"k": 1}, candidates=[{"a": 1}],
                                score_fn=lambda c: 0.0,
                                default={"a": 9}) == {"a": 9}
    assert autotune.cache_fingerprint() is None
    assert not os.path.exists(str(tmp_path / "never"))


def test_stale_env_entry_invalidates(tune_dir, events):
    key = {"seq": 5}
    _put("env_site", key, {"block": 128})
    path = _entry_path(tune_dir)
    meta, payload = atdb._STORE.read_payload(path)
    meta["env"]["torch"] = "0.0.0-other"
    os.remove(path + ".crc32")
    os.remove(path)
    atdb._STORE.write_entry(tune_dir, meta["digest"], meta, payload)
    _reset()
    assert autotune.lookup("env_site", key) is None
    assert "autotune_invalidate" in events()


def test_a_jax_entry_in_the_ports_db_is_a_stale_env_miss(tune_dir,
                                                         events):
    """On the CPU the topology keys of both packages can match, so a
    JAX-written winner can land under the port's digest: its envelope
    (jax, no framework) makes it a miss, never a crash."""
    key = {"max_batch": 4}
    jdb = importlib.import_module("mxnet_tpu.autotune.db")
    jdb.TuningDB(tune_dir).put("serving_buckets", key, {"buckets": [4]},
                               {"objective": "test"})
    assert atdb.ls_entries(tune_dir)[0]["env_ok"] is False
    if atdb.TuningDB.digest("serving_buckets", key) in \
            autotune.db().all_digests():
        assert autotune.lookup("serving_buckets", key) is None
        assert "autotune_invalidate" in events()
    assert autotune.stats()["errors"] == 0


# ---------------------------------------------------------------------------
# chaos: corruption and injected faults degrade, never crash
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_corrupt_entry_degrades_to_default(tune_dir, events):
    key = {"seq": 11}
    _put("chaos_site", key, {"block": 256})
    _flip_tail(_entry_path(tune_dir))
    _reset()
    assert autotune.lookup("chaos_site", key) is None
    assert autotune.stats()["errors"] >= 1
    assert "autotune_corrupt" in events()
    w = autotune.get_or_tune("chaos_site", key, candidates=[{"block": 512}],
                             score_fn=lambda c: 0.0)
    assert w == {"block": 512}
    _reset()
    assert autotune.lookup("chaos_site", key) == {"block": 512}


@pytest.mark.chaos
def test_injected_load_ioerr_degrades(tune_dir):
    key = {"seq": 13}
    _put("chaos_site", key, {"block": 128})
    _reset()
    with faults.inject("autotune.load:ioerr=1") as plan:
        assert autotune.lookup("chaos_site", key) is None
        assert ("autotune.load", "ioerr", 1) in plan.events
    assert autotune.stats()["errors"] >= 1
    _reset()
    assert autotune.lookup("chaos_site", key) == {"block": 128}


@pytest.mark.chaos
def test_torn_store_leaves_no_entry(tune_dir):
    with faults.inject("autotune.store:partial=1@0.5"):
        _put("chaos_site", {"seq": 17}, {"block": 64})
    leftovers = [n for n in os.listdir(tune_dir)
                 if n.endswith(atdb.ENTRY_SUFFIX)] \
        if os.path.isdir(tune_dir) else []
    assert not leftovers, "torn store left a partial entry"
    assert autotune.stats()["errors"] >= 1
    _reset()
    assert autotune.lookup("chaos_site", {"seq": 17}) is None


@pytest.mark.chaos
def test_strict_mode_raises_on_corrupt(tune_dir, monkeypatch):
    key = {"seq": 19}
    _put("chaos_site", key, {"block": 256})
    _flip_tail(_entry_path(tune_dir))
    _reset()
    monkeypatch.setenv("MXNET_AUTOTUNE_STRICT", "1")
    with pytest.raises(Exception):
        autotune.lookup("chaos_site", key)


# ---------------------------------------------------------------------------
# compile-cache integration
# ---------------------------------------------------------------------------

def _tiny_forward(seed=0):
    rng = np.random.RandomState(seed)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=HID,
                                name="fc")
    params = {"fc_weight": mt.nd.array(
        rng.randn(HID, IN_DIM).astype(np.float32), mt.cpu()),
        "fc_bias": mt.nd.array(rng.randn(HID).astype(np.float32),
                               mt.cpu())}
    X = rng.randn(2, IN_DIM).astype(np.float32)
    pred = mt.Predictor(net, params, {"data": X.shape}, ctx=mt.cpu())
    return pred.forward(data=X)[0].asnumpy()


def test_tuned_and_untuned_never_share_a_cache_entry(tune_dir, tmp_path,
                                                     monkeypatch):
    """Turning the autotuner on re-keys every entry: the same program
    primes into a SECOND cache entry."""
    ccdir = str(tmp_path / "cc")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", ccdir)
    monkeypatch.setenv("MXNET_AUTOTUNE", "off")
    _reset()
    out_untuned = _tiny_forward()
    assert len(cc.ls_entries(ccdir)) == 1
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    _reset()
    out_tuned = _tiny_forward()
    assert len(cc.ls_entries(ccdir)) == 2, \
        "autotune mode change did not re-key the entry"
    np.testing.assert_array_equal(out_untuned, out_tuned)
    _reset()
    _tiny_forward()
    assert len(cc.ls_entries(ccdir)) == 2
    assert cc.stats()["hits"] >= 1


def test_aot_bundle_carries_tuning_entries(tune_dir, tmp_path, monkeypatch):
    key = {"seq_q": 512, "seq_k": 512, "head_dim": 128,
           "dtype": "float32", "causal": True}
    _put("flash_attention", key, {"block_q": 128, "block_k": 512})
    bundle = str(tmp_path / "bundle")
    cc.save_bundle(bundle, entries=[])
    assert cc.read_manifest(bundle).get("autotune_entries") == 1
    assert os.path.isdir(os.path.join(bundle, "autotune"))
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    _reset()
    assert autotune.lookup("flash_attention", key) is None
    _reset()
    cc.attach_bundle(bundle)
    assert autotune.lookup("flash_attention", key) == \
        {"block_q": 128, "block_k": 512}
    assert autotune.stats()["hits"] >= 1


# ---------------------------------------------------------------------------
# tunable sites
# ---------------------------------------------------------------------------

def test_flash_resolve_uses_db_winner(tune_dir, monkeypatch):
    key = {"seq_q": 512, "seq_k": 512, "head_dim": 128,
           "dtype": "float32", "causal": True}
    _put("flash_attention", key, {"block_q": 128, "block_k": 512})
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    _reset()
    assert resolve_blocks(None, None, 512, 512, head_dim=128,
                          dtype="float32", causal=True) == (128, 512)
    assert resolve_blocks(256, 256, 512, 512, head_dim=128,
                          dtype="float32", causal=True) == (256, 256)


def test_flash_site_records_its_key_from_the_op(tune_dir):
    """The op consults the site (record mode records the default: the
    winner sizes nothing here) and computes the same attention."""
    import torch

    q, k, v = (torch.randn(1, 40, 2, 16) for _ in range(3))
    ref = mt.ops.attention.flash_forward(q, k, v, True, 0.25)[0]
    from mxnet_tpu_torch.ops.attention import _fa_fn
    got = _fa_fn({"causal": True, "scale": 0.25}, q, k, v)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    ent = autotune.db().get("flash_attention", {
        "seq_q": 40, "seq_k": 40, "head_dim": 16, "dtype": "float32",
        "causal": True})
    assert ent is not None and ent["config"] == {"block_q": 40,
                                                 "block_k": 40}


def test_fused_step_site_records_winner(tune_dir):
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, name="fc1", num_hidden=8)
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, IN_DIM))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(initializer=mt.init.Xavier(), force_init=True)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1},
                       force_init=True)
    rng = np.random.RandomState(3)
    batch = mt.io.DataBatch(
        data=[mt.nd.array(rng.randn(4, IN_DIM).astype(np.float32),
                          mt.cpu())],
        label=[mt.nd.array(rng.randint(0, 8, (4,)).astype(np.float32),
                           mt.cpu())], pad=0)
    mod.forward_backward(batch)
    mod.update()
    mod.forward_backward(batch)
    mod.update()  # the same step key: the site is not consulted again
    s = autotune.stats()
    assert s["stores"] == 1 and s["tuning_ms"] > 0
    entries = atdb.ls_entries(tune_dir)
    assert [e["site"] for e in entries] == ["fused_step"]
    winner = atdb.show_winner(entries[0]["path"])
    assert winner["config"] == {"remat": 0, "donate": 0}


def _lm_params(V, LAYERS, HEADS, HIDDEN, S):
    net = mt.models.get_transformer_lm(vocab_size=V, num_layers=LAYERS,
                                       num_heads=HEADS, hidden=HIDDEN,
                                       seq_len=S)
    arg_shapes, _, _ = net.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.RandomState(0)
    return {name: mt.nd.array(rng.randn(*shp).astype(np.float32) * 0.05,
                              mt.cpu())
            for name, shp in zip(net.list_arguments(), arg_shapes)
            if name not in ("data", "softmax_label")}


def test_decode_engine_constructor_consults_db(tune_dir, monkeypatch):
    V, LAYERS, HEADS, HIDDEN, S = 64, 2, 2, 32, 32
    params = _lm_params(V, LAYERS, HEADS, HIDDEN, S)
    key = {"num_layers": LAYERS, "num_heads": HEADS,
           "head_dim": HIDDEN // HEADS, "max_seq_len": S,
           "max_lanes": 8, "dtype": "float32"}
    _put("decode_engine", key,
         {"page_size": 8, "lane_buckets": [1, 2, 4, 8]})
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    _reset()
    from mxnet_tpu_torch.generation import DecodeEngine
    eng = DecodeEngine(params, vocab_size=V, num_layers=LAYERS,
                       num_heads=HEADS, hidden=HIDDEN, max_seq_len=S,
                       num_pages=48, prefill_len_buckets=(8, 16, 32),
                       warmup=False, start=False, ctx=mt.cpu())
    try:
        assert eng.page_size == 8
        assert eng.lane_buckets == (1, 2, 4, 8)
        assert autotune.stats()["hits"] >= 1
    finally:
        eng.stop()


def test_serving_bucket_site_consults_db(tune_dir, monkeypatch):
    _put("serving_buckets", {"max_batch": 4}, {"buckets": [2, 4]})
    monkeypatch.setenv("MXNET_AUTOTUNE", "on")
    _reset()
    from mxnet_tpu_torch.serving.server import _autotune_buckets
    assert _autotune_buckets(4) == [2, 4]
    monkeypatch.setenv("MXNET_AUTOTUNE", "off")
    assert _autotune_buckets(4) is None


SITE_CASES = [
    ("serving_buckets", 8), ("serving_buckets", 48), ("serving_buckets", 3),
    ("decode_engine", (6, 16, 64, 1024, "float32", 8)),
    ("decode_engine", (2, 2, 16, 32, "float32", 4)),
    ("draft_k", (6, 2048, 3, 2048, 0.8)),
    ("draft_k", (2, 128, 2, 128, 0.55))]


@pytest.mark.parametrize("site,args", SITE_CASES)
def test_analytic_winners_are_the_jax_packages(site, args, tmp_path,
                                               monkeypatch):
    from mxnet_tpu.generation import engine as jengine
    from mxnet_tpu.serving import server as jserver
    from mxnet_tpu_torch.generation import engine as tengine
    from mxnet_tpu_torch.serving import server as tserver

    monkeypatch.setenv("MXNET_AUTOTUNE", "record")
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    got = {}
    for side, pkg_at, mods in (("port", autotune, (tserver, tengine)),
                               ("jax", jautotune, (jserver, jengine))):
        monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path / side))
        pkg_at.reset_for_tests()
        srv, eng = mods
        if site == "serving_buckets":
            got[side] = srv._autotune_buckets(args)
        elif site == "decode_engine":
            got[side] = eng._autotune_engine_config(
                *args[:4], np.dtype(args[4]), max_lanes=args[5])
        else:
            got[side] = eng._autotune_draft_k(*args)
        pkg_at.reset_for_tests()
    assert got["port"] == got["jax"] and got["port"] is not None


def test_default_blocks_at_benched_shape(monkeypatch):
    monkeypatch.delenv("MXNET_AUTOTUNE", raising=False)
    bq, bk = resolve_blocks(None, None, 8192, 8192, head_dim=128,
                            dtype="bfloat16", causal=True)
    assert (bq, bk) == (512, 512)
    assert bk >= bq


# ---------------------------------------------------------------------------
# admin CLI
# ---------------------------------------------------------------------------

def test_admin_ls_verify_prune_show(tune_dir):
    _put("flash_attention", {"seq_q": 512}, {"block_q": 128})

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.autotune_admin",
             *args, "--dir", tune_dir], cwd=ROOT,
            capture_output=True, text=True, timeout=120)

    ls = run("ls", "--json")
    assert ls.returncode == 0, ls.stderr[-800:]
    entries = json.loads(ls.stdout)
    assert len(entries) == 1 and entries[0]["site"] == "flash_attention"
    ver = run("verify", "--json")
    assert ver.returncode == 0 and json.loads(ver.stdout)["bad"] == 0
    show = run("show-winner", entries[0]["digest"])
    assert show.returncode == 0
    assert json.loads(show.stdout)["config"] == {"block_q": 128}
    assert run("prune", "--max-mb", "64").returncode == 0
    assert atdb.ls_entries(tune_dir)
    _flip_tail(entries[0]["path"])
    bad = run("verify", "--json")
    assert bad.returncode == 1 and json.loads(bad.stdout)["bad"] == 1


# ---------------------------------------------------------------------------
# the acceptance path: tune once, every later process starts tuned
# ---------------------------------------------------------------------------

def _run_worker(tune_dir, mode):
    env = dict(os.environ, MXNET_AUTOTUNE=mode, MXNET_AUTOTUNE_DIR=tune_dir,
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("MXNET_COMPILE_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, HERE, "--worker"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fresh_process_inherits_winner_zero_retuning(tune_dir):
    """Record mode pays the tuning cost and picks a NON-default winner
    (the serving ladder: the dense ladder beats pow2 at max batch 8 by
    the analytic objective); a fresh lookup-mode process resolves the
    same winners off the DB — hits, no misses, zero tuning ms."""
    first = _run_worker(tune_dir, "record")
    assert first["stats"]["stores"] >= 2
    assert first["stats"]["tuning_ms"] > 0
    assert first["buckets"] != [1, 2, 4, 8], \
        "tuning picked the default — the acceptance shape must move"
    second = _run_worker(tune_dir, "on")
    assert second["buckets"] == first["buckets"]
    assert second["blocks"] == first["blocks"]
    assert second["stats"]["hits"] >= 2
    assert second["stats"]["misses"] == 0
    assert second["stats"]["tuning_ms"] == 0, "lookup mode re-tuned"
    assert second["fingerprint"] == first["fingerprint"]


def _worker():
    from mxnet_tpu_torch.serving.server import _autotune_buckets

    buckets = _autotune_buckets(8)
    bq, bk = resolve_blocks(None, None, 512, 512, head_dim=128,
                            dtype="float32", causal=True)
    print(json.dumps({"buckets": buckets, "blocks": [bq, bk],
                      "stats": autotune.stats(),
                      "fingerprint": autotune.cache_fingerprint()}))


if __name__ == "__main__" and sys.argv[1:] == ["--worker"]:
    _worker()
