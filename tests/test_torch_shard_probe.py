"""``python -m mxnet_tpu_torch.tools.shard_probe`` against the JAX
package's ``tools/shard_probe.py``, on the CPU: the same mesh (data=4 x
model=2 over 8 contexts; the JAX tool over the conftest's 8 host devices),
the same resolved rule table, the same per-parameter sharding lines and
per-device bytes, exactly, on the MLP and the small transformer.  In place
of the JAX tool's post-SPMD collective mix the port prints the partitioned
walk's plan: the strategies, the gathered ops and the attention kernels'
launches a step, checked here against the plan's own nodes.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu_torch.tools import shard_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_shard_probe", os.path.join(ROOT, "tools", "shard_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sections(text):
    """{section title: its lines}, and the JSON of the last line."""
    lines = text.strip().splitlines()
    out, cur = {}, None
    for line in lines[:-1]:
        if line.startswith("== "):
            cur = line.strip("= ")
            out[cur] = []
        elif cur is not None and line.strip():
            out[cur].append(line)
    return out, json.loads(lines[-1])


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_probe_matches_the_jax_tool(model, capsys, monkeypatch):
    args = ["--model", model, "--mesh", "data=-1,model=2", "--steps", "0"]
    monkeypatch.setattr(sys, "argv", ["shard_probe.py"] + args)
    assert _jax_tool().main() == 0
    ref, ref_rec = _sections(capsys.readouterr().out)
    assert shard_probe.main(args + ["--ctx", "cpu", "--devices", "8"]) == 0
    got, rec = _sections(capsys.readouterr().out)
    for title in ("mesh", "rule table", "per-parameter sharding"):
        assert got[title] == ref[title], title
    for key in ("probe", "model", "mesh", "rules", "params_sharded_bytes",
                "params_replicated_bytes", "steps"):
        assert rec[key] == ref_rec[key], key
    walk = rec["walk"]
    assert got["partitioned walk plan"][0].startswith("gathered ops:")
    if model == "transformer":
        assert rec["params_sharded_bytes"] < rec["params_replicated_bytes"]
        assert {"col", "row"} <= set(walk["strategies"])
        # 2 layers x 4 batch shards: attention runs per shard
        assert walk["kernel_launches_per_step"] == {
            "flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    else:
        assert walk["kernel_launches_per_step"]["flash_fwd"] == 0


def test_probe_runs_as_a_module():
    """The entry point: ``python -m``, no steps, its JSON on the last
    line."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.shard_probe",
         "--ctx", "cpu", "--devices", "2", "--mesh", "data=1,model=2",
         "--steps", "0", "--batch-size", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert rec["mesh"] == {"data": 1, "model": 2} and rec["steps"] == 0
    assert rec["contexts"] == ["cpu(0)", "cpu(1)"]
    # data=1: attention runs once per layer on the whole batch
    assert rec["walk"]["kernel_launches_per_step"]["flash_fwd"] == 2
