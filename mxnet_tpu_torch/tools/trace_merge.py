"""Stitch per-process telemetry trace dumps into ONE fleet chrome trace;
the port's counterpart of the JAX package's ``tools/trace_merge.py``.

A cluster run with ``MXNET_TELEMETRY=1`` and ``MXNET_TELEMETRY_DIR`` set
leaves one ``trace-<role><rank>.json`` per process (workers, servers, the
launcher).  This tool merges them into a single timeline with one process
track per input file — named by the role/rank label each dump carries —
and validates the result against the chrome-trace schema::

    python -m mxnet_tpu_torch.tools.trace_merge -o fleet.json \
        run/trace-*.json

Open the output at chrome://tracing or https://ui.perfetto.dev: kvstore
RPC spans on a ``workerN`` track connect by flow arrows to their handler
spans on the ``serverM`` track (same distributed trace id).
"""
import argparse
import json
import sys

from .telemetry_dump import merge_traces


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+",
                    help="per-process chrome-trace JSON dumps")
    ap.add_argument("-o", "--output", required=True,
                    help="merged fleet trace path")
    cli = ap.parse_args(argv)

    from mxnet_tpu_torch import telemetry

    try:
        payload = merge_traces(cli.files)
    except (ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 1
    telemetry.validate_trace(payload)
    with open(cli.output, "w") as f:
        json.dump(payload, f)
    evs = payload["traceEvents"]
    procs = sorted(e["args"].get("name", "?") for e in evs
                   if e.get("ph") == "M" and e.get("name") == "process_name")
    flows = sum(1 for e in evs if e.get("ph") in ("s", "f"))
    print("wrote %s: %d event(s), %d flow arrow(s), process tracks: %s"
          % (cli.output, len(evs), flows, ", ".join(procs) or "(none)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
