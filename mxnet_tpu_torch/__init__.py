"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``, the framework
with the API surface of Apache MXNet 0.9, for an NVIDIA Hopper card.

It keeps the JAX package's op names and attrs, its symbol JSON and its
``.params`` bytes, so a symbol or checkpoint written by one package loads
in the other.  Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a hand-written CUDA kernel (``csrc/``).  Entry points run
on the card (``gpu(0)``) unless the caller passes ``mx.cpu()``.

Ported so far: the serving path — ``Predictor`` over a transformer LM
(``models.transformer.get_transformer_lm``) with the flash-attention
forward kernel — and the training path — ``mod.Module`` with
``forward_backward``/``update`` (the fused step), every optimizer of the
JAX package on one list update, the initializers, the iterators
(``NDArrayIter``, ``MNISTIter``, ``CSVIter``, ``ResizeIter``,
``PrefetchingIter``), metrics, callbacks, checkpoints, ``model.FeedForward``
and ``test_utils``, with the flash-attention backward kernels — and the
user extension path: the
imperative ``nd.<op>`` surface, ``Symbol`` arithmetic and ``simple_bind``,
``rtc.MXRtc`` compiling a user's CUDA C at run time with NVRTC
(``cuda_rtc``), user kernels as trainable ops through
``register_kernel_op`` (``rtc_kernels`` registers ``rtc_gelu`` so), and
``operator.CustomOp`` — and the image data path: ``filesystem`` (URI
schemes), ``recordio``, ``native`` (the C++ reader and the JPEG codecs),
``image`` (augmenters, ``ImageIter``, ``ImageRecordIter``,
``ImageDetRecordIter``, the image-decode ops), with the spatial ops
(``ops/spatial.py``) — and generation: ``generation.DecodeEngine``
(continuous batching over a paged KV pool on the device, prefix caching,
speculative decoding) over the paged-attention ops (``ops/paged.py``) and
the prefill/decode/catch-up/verify builders, with ``faults`` and the metrics
half of ``telemetry`` — and the recurrent
family: the ``RNN``, ``Sequence*`` and ``WarpCTC`` ops, ``rnn`` (the cells
and ``BucketSentenceIter``), ``BucketingModule``, ``SequentialModule``,
``PythonModule`` and ``Monitor`` — and the GSPMD layer: ``sharding``
(named meshes, partition rules, placement), ``Module.bind(mesh=,
partition_rules=)`` over ``Executor.set_shardings`` (tensor parallelism
beside data parallelism, and every ``dist_sync`` worker's batch one shard
of the global batch) and ``checkpoint``'s sharded checkpoints — and the parameter server:
``kvstore_server`` (``KVStoreServer``, ``ServerClient``) behind
``kv.create("dist_async")`` with range split, fp16 wire compression, the
comm engine's bucketed wire, elastic membership, durable snapshots and the
preemption handler.  A process started with ``DMLC_ROLE=server`` serves
when it imports this package, then exits — and the serving tier:
``serving`` (``InferenceServer`` with its micro-batcher and HTTP API,
``Router``, ``ReplicaRegistry``, ``Autoscaler``, ``python -m
mxnet_tpu_torch.serving.launch``) and the checkpoint sidecars
(``model.find_latest_checkpoint``, ``load_checkpoint_state``) — and the
multi-model platform: ``platform`` (``ModelSpec``, ``PlacementPlanner``
over a ``DevicePool``, ``TenantQuotas``, ``HealthPlane``, ``ModelManager``
with its degradation ladder, ``FrontDoor``), a subpackage loaded by
``import mxnet_tpu_torch.platform`` as the JAX package's is, and
``models.get_dlrm`` — and observability and the training guardian:
``profiler`` (spans, and ``torch.profiler`` traces of the card),
``telemetry`` (the tracer, the flight recorder, fleet aggregation, the
step monitor over ``hlo_analysis``'s cost model of the eager plan) and
``guardian`` (the fused step's guard, skip → re-warm → rollback under
``Module.fit``) — and the sparse plane: ``sparse`` (``RowSparseArray``,
the server-placed updaters, ``SparseParamPlane`` on the comm engine,
``SparseEmbeddingModule``) over the servers' sharded row tables — and
the long tail: remat (``MXNET_BACKWARD_DO_MIRROR``) and the NaiveEngine
(``MXNET_ENGINE_TYPE``) in the executor, ``Symbol.infer_shape_partial``/
``eval``/``grad``, dims split over a tuple of mesh axes, ``caffe`` (the
Caffe converter), ``capi_shim`` behind the C ABI (``libmxtpu_torch_capi``,
built at first use; ``libinfo``), ``th`` (torch functions on NDArrays),
``visualization``, ``contrib``, ``notebook``, ``log``, ``misc``, the doc
and internal-op modules, and ``python -m mxnet_tpu_torch.tools.
shard_probe``.  ``platform`` stays out of the default import, as in the
JAX package.  This package imports neither ``jax`` nor ``mxnet_tpu``.
"""
from . import base
from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
from .attribute import AttrScope
from .name import NameManager, Prefix
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from .executor import Executor
from . import kernels
from . import cuda_rtc
from . import rtc
from . import operator
from . import models
from .predictor import Predictor, load_exported
from .ops import register_kernel_op, Param
from . import random
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import filesystem
from . import io
from . import recordio
from . import metric
from . import callback
from . import model
from . import kvstore
from . import kvstore as kv
from . import comm_engine
# row-sparse values and the sharded embedding-table plane (its eager surface
# numpy only: kvstore_server imports row_merge from it)
from . import sparse
from . import kvstore_dist
from . import module
from . import module as mod
from . import executor_manager
from . import convert
from . import test_utils
from . import image
from . import faults
from . import telemetry
from . import guardian
from . import profiler
from . import serving
from . import generation
from . import parallel
from . import sharding
from . import checkpoint
from . import compile_cache
from . import autotune
from . import rnn
from . import monitor
from . import monitor as mon
from . import visualization
from . import visualization as viz
from . import contrib
from . import torch as th
from . import caffe
from . import notebook
from . import log
from . import misc
from . import libinfo
from .libinfo import __version__
from . import kvstore_server

# server-role bootstrap, last so every module is loaded before requests
# are served: under DMLC_ROLE=server this serves and exits (reference
# python/mxnet/kvstore_server.py:58 _init_kvstore_server_module)
kvstore_server._init_kvstore_server_module()
