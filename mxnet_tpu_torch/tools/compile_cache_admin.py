"""Admin CLI for the persistent compile cache (MXNET_COMPILE_CACHE_DIR);
the port's counterpart of the JAX package's ``tools/compile_cache_admin.py``,
with the same subcommands and flags.

Subcommands (all read the cache dir from --dir or the env var):

  ls      one line per entry: digest, kind, size, age, the cold build's
          ms it saves, and whether it is loadable in THIS environment.
          Kinds: "fwd" (scoring/bucket executors), "gen-prefill" /
          "gen-step" / "gen-draft-prefill" / "gen-draft-step" /
          "gen-verify" / "gen-catchup" (DecodeEngine executors), "fwdbwd"
          / "fused" (training steps), "lib" / "cubin" (the nvcc libraries
          and NVRTC cubins the entries load), "corrupt" (unreadable
          header)
  verify  CRC + header + payload check per entry; exit 1 if any fail
  prune   delete oldest entries until the directory fits the size budget
          (--max-mb or MXNET_COMPILE_CACHE_MAX_MB)

Usage:
  python -m mxnet_tpu_torch.tools.compile_cache_admin ls [--dir D] [--json]
  python -m mxnet_tpu_torch.tools.compile_cache_admin verify [--dir D] [--json]
  python -m mxnet_tpu_torch.tools.compile_cache_admin prune [--dir D]
      [--max-mb N] [--json]
"""
import argparse
import json
import os
import sys
import time


def _dir_from(cli):
    d = cli.dir or os.environ.get("MXNET_COMPILE_CACHE_DIR", "")
    if not d:
        sys.exit("no cache dir: pass --dir or set MXNET_COMPILE_CACHE_DIR")
    return d


def cmd_ls(cli):
    from mxnet_tpu_torch import compile_cache as cc

    entries = cc.ls_entries(_dir_from(cli))
    if cli.json:
        print(json.dumps(entries, default=str))
        return 0
    total = 0
    now = time.time()
    for e in entries:
        total += e["bytes"]
        age = now - e["mtime"]
        print("%s  %-7s %9.1fKB  %6.0fs old  build %sms  %s"
              % (e["digest"], e.get("kind") or "?", e["bytes"] / 1024.0,
                 age, e.get("compile_ms", "?"),
                 "ok" if e.get("env_ok") else
                 ("CORRUPT" if e.get("kind") == "corrupt" else "stale-env")))
    print("%d entries, %.1f MB" % (len(entries), total / (1 << 20)))
    return 0


def cmd_verify(cli):
    from mxnet_tpu_torch import compile_cache as cc

    d = _dir_from(cli)
    results = []
    bad = 0
    for e in cc.ls_entries(d):
        ok, detail = cc.verify_entry(e["path"])
        bad += 0 if ok else 1
        results.append({"digest": e["digest"], "ok": ok, "detail": detail})
    if cli.json:
        print(json.dumps({"entries": results, "bad": bad}))
    else:
        for r in results:
            print("%s  %s  %s" % (r["digest"],
                                  "ok " if r["ok"] else "BAD", r["detail"]))
        print("%d/%d entries verify clean"
              % (len(results) - bad, len(results)))
    return 1 if bad else 0


def cmd_prune(cli):
    from mxnet_tpu_torch import compile_cache as cc

    d = _dir_from(cli)
    budget = cli.max_mb if cli.max_mb is not None else int(
        os.environ.get("MXNET_COMPILE_CACHE_MAX_MB", "2048"))
    removed = cc.prune(d, budget)
    left = cc.ls_entries(d)
    out = {"removed": len(removed), "kept": len(left),
           "bytes": sum(e["bytes"] for e in left), "budget_mb": budget}
    if cli.json:
        print(json.dumps(out))
    else:
        print("pruned %(removed)d entries; %(kept)d kept "
              "(%(bytes)d bytes, budget %(budget_mb)d MB)" % out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=("ls", "verify", "prune"))
    ap.add_argument("--dir", default=None,
                    help="cache dir (default: $MXNET_COMPILE_CACHE_DIR)")
    ap.add_argument("--max-mb", type=int, default=None,
                    help="prune budget (default: $MXNET_COMPILE_CACHE_MAX_MB)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    cli = ap.parse_args(argv)
    return {"ls": cmd_ls, "verify": cmd_verify, "prune": cmd_prune}[cli.cmd](cli)


if __name__ == "__main__":
    sys.exit(main())
