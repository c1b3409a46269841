"""Inspect telemetry artifacts from the command line; the port's
counterpart of the JAX package's ``tools/telemetry_dump.py``.

Two subcommands::

    python -m mxnet_tpu_torch.tools.telemetry_dump events run/events.jsonl \
        [--tail 20]
        Pretty-print a structured-event JSONL log (one event per line:
        timestamp, kind, then the event's own fields).

    python -m mxnet_tpu_torch.tools.telemetry_dump trace a.json b.json \
        -o merged.json
        Merge one or more Chrome-trace JSON files (dump_profile or
        telemetry.dump_trace output) into a single timeline, schema-check
        every event, and write the result — load it at chrome://tracing
        or https://ui.perfetto.dev.

Both read plain files: no framework import is needed for ``events``, so
the tool works on logs copied off a training host.
"""
import argparse
import json
import sys


def _load_events(path):
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                print("%s:%d: unparseable line skipped" % (path, lineno),
                      file=sys.stderr)
    return events


def cmd_events(cli):
    events = _load_events(cli.file)
    if cli.tail:
        events = events[-cli.tail:]
    if not events:
        print("(no events)")
        return 0
    t0 = events[0].get("ts", 0.0)
    for ev in events:
        ts = ev.get("ts", 0.0)
        kind = ev.get("kind", "?")
        rest = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
        fields = " ".join("%s=%s" % (k, rest[k]) for k in sorted(rest))
        print("+%9.3fs  %-16s %s" % (ts - t0, kind, fields))
    print("-- %d event(s), %d kind(s)"
          % (len(events), len({e.get("kind") for e in events})))
    return 0


def merge_traces(paths):
    """Merge per-process chrome-trace dumps into ONE fleet timeline.

    Each input file gets its own synthetic pid (its index), every event is
    rewritten onto that pid, and each file's ``process_name`` metadata —
    the role/rank label (``worker0``, ``server0``) the tracer stamped at
    dump time — names the process track.  Flow events keep their ids
    untouched, so a worker-side ``"s"`` and the server-side ``"f"`` with
    the same distributed trace id draw an arrow ACROSS process tracks.
    Returns the merged payload dict (raises on an unreadable input)."""
    out = []
    seen = set()
    for pid, path in enumerate(paths):
        with open(path) as f:
            payload = json.load(f)
        evs = payload.get("traceEvents", payload) \
            if isinstance(payload, dict) else payload
        if not isinstance(evs, list):
            raise ValueError("%s: not a chrome-trace file" % path)
        for ev in evs:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)  # never mutate the loaded payload
            ev["pid"] = pid
            if ev.get("ph") == "M":
                # per-process metadata dedup: one process_name per pid,
                # one thread_name per (pid, tid)
                key = (pid, ev.get("name"), ev.get("tid"),
                       json.dumps(ev.get("args", {}), sort_keys=True))
                if key in seen:
                    continue
                seen.add(key)
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def cmd_trace(cli):
    from mxnet_tpu_torch import telemetry

    try:
        payload = merge_traces(cli.files)
    except (ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 1
    telemetry.validate_trace(payload)
    with open(cli.output, "w") as f:
        json.dump(payload, f)
    out = payload["traceEvents"]
    spans = sum(1 for e in out if e.get("ph") == "X")
    tids = {(e.get("pid"), e.get("tid")) for e in out if e.get("ph") == "X"}
    procs = sorted(e["args"].get("name", "?") for e in out
                   if e.get("ph") == "M" and e.get("name") == "process_name")
    print("wrote %s: %d span(s) across %d thread track(s), processes: %s"
          % (cli.output, spans, len(tids), ", ".join(procs) or "(none)"))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ev = sub.add_parser("events", help="pretty-print an events.jsonl log")
    ev.add_argument("file")
    ev.add_argument("--tail", type=int, default=0,
                    help="only the last N events")
    tr = sub.add_parser("trace",
                        help="merge + validate chrome-trace JSON files")
    tr.add_argument("files", nargs="+")
    tr.add_argument("-o", "--output", required=True)
    cli = ap.parse_args(argv)
    return cmd_events(cli) if cli.cmd == "events" else cmd_trace(cli)


if __name__ == "__main__":
    sys.exit(main())
