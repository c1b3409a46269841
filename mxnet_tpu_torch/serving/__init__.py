"""Serving — counterpart of ``mxnet_tpu/serving/``.  Ported so far: the
bucketed shared-weight predictor and the serving errors, which the
generation engine builds on.  The micro-batcher, the inference server, the
router and the rest of the serving tier are not ported yet (ROADMAP.md
A.5)."""
from .batcher import (BucketedPredictor, DeadlineExceededError,
                      DrainTimeoutError, QueueFullError, ServerClosedError,
                      pow2_buckets)

__all__ = ["BucketedPredictor", "pow2_buckets", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError", "DrainTimeoutError"]
