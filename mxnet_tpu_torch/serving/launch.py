"""One registered serving replica as a process — the counterpart of the JAX
package's ``tools/launch.py --serving`` (``serving_main``), with the same
arguments::

    python -m mxnet_tpu_torch.serving.launch --registry HOST:PORT \\
        --name r0 --prefix PREFIX --epoch N \\
        --input-shapes '{"data": [32, 3, 224, 224]}'

It restores the checkpoint into an :class:`InferenceServer` (every bucket
run once before it serves), serves HTTP, registers and heartbeats into the
replica registry so every replicated router discovers it, and installs the
SIGTERM preemption handler: scale-in retirement and cluster preemption are
the same drain → deregister → exit 0 path.  The server runs on ``gpu(0)``
unless ``MXNET_SERVING_CTX`` names another context (``cpu`` on a machine
without a card).  ``ProcessProvider`` spawns this module.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

from ..base import register_env

register_env("MXNET_SERVING_CTX", "gpu(0)", str,
             "Context of a serving replica started by python -m "
             "mxnet_tpu_torch.serving.launch ('gpu(0)', 'cpu', ...).")


def _parse_ctx(text):
    """'gpu', 'gpu(1)', 'cpu' or 'cpu(0)' as a Context."""
    from ..context import Context

    name, _, rest = text.strip().partition("(")
    dev_id = int(rest.rstrip(")") or 0) if rest else 0
    return Context(name.strip(), dev_id)


def main(argv=None):
    from ..base import env
    from . import (InferenceServer, RegistryClient,
                   install_preemption_handler, start_heartbeater)

    parser = argparse.ArgumentParser(
        description="Launch one registered serving replica")
    parser.add_argument("--serving", action="store_true",
                        help="accepted for the JAX launcher's command line")
    parser.add_argument("--registry", required=True,
                        help="replica-registry address (host:port)")
    parser.add_argument("--name", required=True,
                        help="registry member name for this replica")
    parser.add_argument("--prefix", required=True,
                        help="checkpoint prefix (save_checkpoint files)")
    parser.add_argument("--epoch", type=int, required=True)
    parser.add_argument("--input-shapes", required=True,
                        help='JSON {input_name: [batch, ...]} shapes')
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=0)
    parser.add_argument("--no-aot", action="store_true",
                        help="serve without attaching an AOT bundle")
    args = parser.parse_args(argv)

    shapes = {k: tuple(v)
              for k, v in json.loads(args.input_shapes).items()}
    ctx = _parse_ctx(env("MXNET_SERVING_CTX", "gpu(0)", str))
    server = InferenceServer.from_checkpoint(
        args.prefix, args.epoch, shapes, attach_aot=not args.no_aot,
        ctx=ctx)
    host, port = server.serve_http(args.host, args.http_port)[:2]
    backend = "%s:%d" % (host, port)
    registry = RegistryClient(args.registry)
    stop_beat = start_heartbeater(registry, args.name, backend)
    install_preemption_handler(server, deregister=stop_beat)
    print("launch: serving replica %s at %s on %s (cold_bucket_runs=%d)"
          % (args.name, backend, ctx, server.cold_bucket_runs()),
          file=sys.stderr, flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        stop_beat()
        server.stop(drain=True)


if __name__ == "__main__":
    main()
