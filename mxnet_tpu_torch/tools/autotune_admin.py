"""Admin CLI for the persistent tuning DB (MXNET_AUTOTUNE_DIR); the
port's counterpart of the JAX package's ``tools/autotune_admin.py``, with
the same subcommands and flags.

Subcommands (all read the DB dir from --dir, MXNET_AUTOTUNE_DIR, or
the <MXNET_COMPILE_CACHE_DIR>/autotune derivation):

  ls           one line per entry: digest, tunable site, objective,
               score, size, age, and whether the recording environment
               matches this one ("stale-env" entries invalidate on load)
  verify       CRC + header + payload check per entry; exit 1 if any fail
  prune        delete oldest entries until the dir fits the size budget
  show-winner  dump one entry's winner config + tuning provenance
               (candidate scores, objective ladder, tuning wall time)

Usage:
  python -m mxnet_tpu_torch.tools.autotune_admin ls [--dir D] [--json]
  python -m mxnet_tpu_torch.tools.autotune_admin verify [--dir D] [--json]
  python -m mxnet_tpu_torch.tools.autotune_admin prune [--dir D]
      [--max-mb N] [--json]
  python -m mxnet_tpu_torch.tools.autotune_admin show-winner DIGEST
      [--dir D]
"""
import argparse
import json
import os
import sys
import time


def _dir_from(cli):
    if cli.dir:
        return cli.dir
    from mxnet_tpu_torch import autotune

    d = autotune.db_dir()
    if not d:
        sys.exit("no tuning-DB dir: pass --dir or set MXNET_AUTOTUNE_DIR "
                 "(or MXNET_COMPILE_CACHE_DIR)")
    return d


def cmd_ls(cli):
    import importlib

    atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")

    entries = atdb.ls_entries(_dir_from(cli))
    if cli.json:
        print(json.dumps(entries, default=str))
        return 0
    total = 0
    now = time.time()
    for e in entries:
        total += e["bytes"]
        age = now - e["mtime"]
        print("%s  %-15s %-14s score %-10s %7.1fKB  %6.0fs old  %s"
              % (e["digest"], e.get("site") or "?",
                 e.get("objective") or "?", e.get("score", "?"),
                 e["bytes"] / 1024.0, age,
                 "ok" if e.get("env_ok") else
                 ("CORRUPT" if e.get("kind") == "corrupt" else "stale-env")))
    print("%d entries, %.1f MB" % (len(entries), total / (1 << 20)))
    return 0


def cmd_verify(cli):
    import importlib

    atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")

    d = _dir_from(cli)
    results = []
    bad = 0
    for e in atdb.ls_entries(d):
        ok, detail = atdb.verify_entry(e["path"])
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
    import importlib

    atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")

    d = _dir_from(cli)
    budget = cli.max_mb if cli.max_mb is not None else 64
    removed = atdb.prune(d, budget)
    left = atdb.ls_entries(d)
    out = {"removed": len(removed), "kept": len(left),
           "bytes": sum(e["bytes"] for e in left), "budget_mb": budget}
    if cli.json:
        print(json.dumps(out))
    else:
        print("pruned %(removed)d entries; %(kept)d kept "
              "(%(bytes)d bytes, budget %(budget_mb)d MB)" % out)
    return 0


def cmd_show_winner(cli):
    import importlib

    atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")

    if not cli.digest:
        sys.exit("show-winner needs a DIGEST argument (see ls)")
    d = _dir_from(cli)
    path = os.path.join(d, cli.digest + atdb.ENTRY_SUFFIX)
    if not os.path.exists(path):
        sys.exit("no entry %s in %s" % (cli.digest, d))
    print(json.dumps(atdb.show_winner(path), indent=2, default=str))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=("ls", "verify", "prune", "show-winner"))
    ap.add_argument("digest", nargs="?", default=None,
                    help="entry digest (show-winner only)")
    ap.add_argument("--dir", default=None,
                    help="tuning-DB dir (default: $MXNET_AUTOTUNE_DIR or "
                         "$MXNET_COMPILE_CACHE_DIR/autotune)")
    ap.add_argument("--max-mb", type=int, default=None,
                    help="prune budget in MB (default 64)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    cli = ap.parse_args(argv)
    return {"ls": cmd_ls, "verify": cmd_verify, "prune": cmd_prune,
            "show-winner": cmd_show_winner}[cli.cmd](cli)


if __name__ == "__main__":
    sys.exit(main())
