"""Serving — counterpart of ``mxnet_tpu/serving/``: a dynamic-batching
inference service over ``Predictor``.

A request queue and micro-batcher coalesce concurrent traffic into padded
power-of-two bucket batches (each bucket run once at startup, so the
steady state runs only warmed shapes); :class:`InferenceServer` gives
futures, bounded-queue backpressure, deadlines, graceful drain, hot swap
and a stdlib HTTP endpoint (``/predict``, NDJSON ``/generate``, ``/swap``,
``/metrics``, ``/healthz``, ``/readyz``) with Prometheus-style metrics;
over N such replicas :class:`Router` is the resilient front door
(health/load-aware dispatch, circuit breakers, retries, hedging, SLO
classes, rolling hot swap, resumable generate streams), the
:class:`ReplicaRegistry` its shared live set and :class:`Autoscaler` the
controller of the replica count.  ``python -m
mxnet_tpu_torch.serving.launch`` starts one registered replica process.
The HTTP APIs are the JAX package's, so servers, routers and registries of
the two packages work with each other.
"""
from .autoscaler import Autoscaler, LocalCheckpointProvider, ProcessProvider
from .batcher import (BucketedPredictor, DeadlineExceededError,
                      DrainTimeoutError, MicroBatcher, QueueFullError,
                      ServerClosedError, pow2_buckets)
from .metrics import ServingMetrics
from .registry import ReplicaRegistry, RegistryClient, start_heartbeater
from .router import (NoReplicaAvailableError, Router, RouterError,
                     RouterMetrics, RouterOverloadError, SLOClass)
from .server import InferenceServer, install_preemption_handler

__all__ = ["InferenceServer", "BucketedPredictor", "MicroBatcher",
           "ServingMetrics", "pow2_buckets", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError",
           "DrainTimeoutError",
           "Router", "SLOClass", "RouterMetrics", "RouterError",
           "NoReplicaAvailableError", "RouterOverloadError",
           "ReplicaRegistry", "RegistryClient", "start_heartbeater",
           "Autoscaler", "LocalCheckpointProvider", "ProcessProvider",
           "install_preemption_handler"]
