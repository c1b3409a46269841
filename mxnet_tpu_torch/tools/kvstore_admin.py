"""Admin CLI for the sparse parameter plane on a live kvstore fleet; the
port's counterpart of the JAX package's ``tools/kvstore_admin.py``, with
the same subcommands, flags, output and exit codes.

Subcommands:

  table-ls      connect to each server and print its sharded embedding
                tables: rows held, optimizer-state rows, bytes, and how
                many rows are misplaced (owner-by-hash != this server)
  table-verify  health check — exit nonzero if any server reports
                misplaced rows, if per-key row totals disagree with a
                --expect-rows floor, or if a server's durable snapshot
                file fails its CRC sidecar (--snapshot PREFIX, where
                server i>0 journals to PREFIX.i as in
                _init_kvstore_server_module)

Usage:
  python -m mxnet_tpu_torch.tools.kvstore_admin table-ls \
      --servers h1:p1,h2:p2 [--json]
  python -m mxnet_tpu_torch.tools.kvstore_admin table-verify \
      --servers h1:p1,h2:p2 [--snapshot /path/prefix] [--expect-rows N] \
      [--json]
"""
import argparse
import json
import sys


def _parse_servers(spec):
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, _, p = entry.rpartition(":")
        out.append((host or "127.0.0.1", int(p)))
    if not out:
        sys.exit("no servers: pass --servers host:port[,host:port...]")
    return out


def _collect(servers):
    """table_info from every server: list of (addr, info-dict | error str)."""
    from mxnet_tpu_torch.kvstore_server import ServerClient

    out = []
    for host, port in servers:
        addr = "%s:%d" % (host, port)
        try:
            c = ServerClient(host, port)
            try:
                out.append((addr, c.table_info()))
            finally:
                c.close()
        except Exception as e:
            out.append((addr, "unreachable: %s" % e))
    return out


def cmd_table_ls(cli):
    infos = _collect(_parse_servers(cli.servers))
    if cli.json:
        print(json.dumps([{"server": a,
                           "tables": i if isinstance(i, dict) else None,
                           "error": None if isinstance(i, dict) else i}
                          for a, i in infos]))
        return 0
    for addr, info in infos:
        if not isinstance(info, dict):
            print("%s  %s" % (addr, info))
            continue
        if not info:
            print("%s  (no tables)" % addr)
            continue
        for key, t in sorted(info.items(), key=lambda kv: str(kv[0])):
            print("%s  %-24s rows=%-8d state=%-8d %9.1fKB  misplaced=%d"
                  % (addr, key, t["rows"], t["state_rows"],
                     t["bytes"] / 1024.0, t["misplaced"]))
    return 0


def cmd_table_verify(cli):
    infos = _collect(_parse_servers(cli.servers))
    problems = []
    totals = {}
    for addr, info in infos:
        if not isinstance(info, dict):
            problems.append("%s: %s" % (addr, info))
            continue
        for key, t in info.items():
            if t["misplaced"]:
                problems.append("%s: key %r holds %d misplaced rows"
                                % (addr, key, t["misplaced"]))
            totals[key] = totals.get(key, 0) + t["rows"]
    if cli.expect_rows is not None:
        for key, n in sorted(totals.items(), key=str):
            if n < cli.expect_rows:
                problems.append("key %r: %d rows total < expected %d"
                                % (key, n, cli.expect_rows))
    snap_checks = []
    if cli.snapshot:
        from mxnet_tpu_torch.filesystem import verify_crc_sidecar

        for i in range(len(_parse_servers(cli.servers))):
            path = cli.snapshot if i == 0 else "%s.%d" % (cli.snapshot, i)
            ok = verify_crc_sidecar(path)
            snap_checks.append({"path": path, "crc_ok": ok})
            if ok is False:
                problems.append("snapshot %s fails its CRC sidecar" % path)

    report = {
        "servers": [{"server": a,
                     "tables": i if isinstance(i, dict) else None,
                     "error": None if isinstance(i, dict) else i}
                    for a, i in infos],
        "row_totals": {str(k): v for k, v in totals.items()},
        "snapshots": snap_checks,
        "problems": problems,
        "ok": not problems,
    }
    if cli.json:
        print(json.dumps(report))
    else:
        for key, n in sorted(totals.items(), key=str):
            print("key %-24s total rows %d" % (key, n))
        for s in snap_checks:
            state = {True: "crc ok", False: "CRC MISMATCH",
                     None: "no sidecar"}[s["crc_ok"]]
            print("snapshot %s  %s" % (s["path"], state))
        for p in problems:
            print("PROBLEM: %s" % p)
        print("verify: %s" % ("ok" if not problems else
                              "%d problem(s)" % len(problems)))
    return 1 if problems else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    ls = sub.add_parser("table-ls", help="list sharded tables per server")
    ls.add_argument("--servers", required=True,
                    help="comma-separated host:port list")
    ls.add_argument("--json", action="store_true")
    ls.set_defaults(fn=cmd_table_ls)

    ver = sub.add_parser("table-verify",
                         help="placement + snapshot CRC health check")
    ver.add_argument("--servers", required=True)
    ver.add_argument("--snapshot", default=None,
                     help="snapshot path prefix (server i>0 uses PREFIX.i)")
    ver.add_argument("--expect-rows", type=int, default=None,
                     help="fail if any key's fleet-wide row total is below")
    ver.add_argument("--json", action="store_true")
    ver.set_defaults(fn=cmd_table_verify)

    cli = ap.parse_args(argv)
    return cli.fn(cli)


if __name__ == "__main__":
    sys.exit(main())
