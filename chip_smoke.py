#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --parent-csrc DIR [--parent-csrc DIR ...]
                                           # also hold the bf16 K1 and
                                           # split-P of other versions'
                                           # csrc (flash_fwd.cu and its
                                           # headers) against these, bits
                                           # and time, at every bf16 case
                                           # of the main length, after the
                                           # kernel table is timed
    python3 chip_smoke.py --parent-rtc DIR [--parent-rtc DIR ...]
                                           # also hold the axpy user kernel
                                           # of other versions' checkouts
                                           # (their rtc_kernels.py) against
                                           # this one's, bits and time in
                                           # turns, at every axpy timing case
    python3 chip_smoke.py --profile DIR    # also trace one extra request
                                           # (its K1 the split-TF32 kernel),
                                           # one extra train step (its K1
                                           # must be the tensor-core
                                           # kernel), one extra float32
                                           # step (its K1/K2/K3 the
                                           # split-TF32 kernels), one extra
                                           # splash step
                                           # (its K1 the split-P variant),
                                           # one extra rtc_gelu step,
                                           # one extra ResNet-50 bf16 step,
                                           # one extra SSD train step,
                                           # one extra SSD request and one
                                           # extra .rec-fed ResNet-50 bf16
                                           # step, next() included (the
                                           # detection ops' kernels as a
                                           # group of their own; in every
                                           # step the optimizer's list
                                           # update's kernels too) and one
                                           # 8-lane generation engine
                                           # iteration (the paged ops'
                                           # kernels as a group; memcpy
                                           # ops and bytes printed) and
                                           # one bucket-60 step of the
                                           # PTB LSTM

Phases, each fatal on failure (non-zero exit, no result line):

1. build   — compile every CUDA kernel of the ported paths from
             ``mxnet_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per
             source, all started together (and beside them each
             ``--parent-csrc`` build of flash_fwd.cu); print ptxas's
             registers,
             shared memory and spills (a spill is fatal, and so are wgmmas
             that ptxas serialized), and the count of
             tensor-core instructions in each attention kernel from
             ``cuobjdump -sass``: ``HGMMA`` (wgmma) and ``HMMA``
             (mma.sync, which the float32 K2/K3 issue at the width 256);
             an instantiation without any is
             fatal: it would not run on the tensor cores (K1 plain and
             split-P in bf16, K1, K2 and K3 in both dtypes, at the widths
             64, 128 and 256);
             load NVRTC (a missing libnvrtc is fatal) and print its
             version;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at several shapes and both dtypes, the main paths' own shapes
             included: K1 (flash forward) on O and lse, K2/K3 (flash
             backward) on dQ, dK and dV, with bf16 cases for the tensor-core
             tiling (ragged, sq != sk, causal and full, packed and
             contiguous views, d=64 at the main length), and at the main
             length (b=4, s=4096) the main path's shape and the head dims
             32, 96 and 256 (64/16/8 heads) in float32 and bf16.  At each
             of those, repeated launches of K1, K2 and K3 give the same
             bits; at each float32 one the split-TF32 K1's mean error on
             O, and K2/K3's on dQ, dK, dV, against a float64 forward and
             backward (batch 0, two heads) is at most 8x the plain float32
             version's; at each bf16 one K1's split-P
             variant (splash's forward: P kept
             at float32 precision for P V), on a pre-scaled q at scale 1,
             must agree with the plain version and have at most half the
             mean error of plain K1 on the same inputs; a view that breaks
             the TMA rule must raise ``MXNetError`` in the forward and the
             backward.  Each of those shapes is timed beside its bound,
             the plain versions and the library calls
             (``scaled_dot_product_attention`` forward and backward, timed
             only as yardsticks).  Then the user kernels of
             ``mxnet_tpu_torch/rtc_kernels.py``, compiled by ``MXRtc`` with
             NVRTC: axpy (2-D launch), sgd_update, gelu_fwd and gelu_bwd
             (float32 and bf16) at ragged and full-width shapes and on an
             odd length and a misaligned view, timed in turns with the
             plain versions and the library calls (``F.gelu`` and its
             backward, ``torch.add``; ``--parent-rtc``'s axpy too), beside
             their bytes bound;
3. serve   — save a full-width transformer LM checkpoint (vocab 32000,
             6 x 2048, 16 heads, seq 4096, batch 4, float32; random weights
             from a seed), load it with ``Predictor.from_checkpoint`` on the
             default (GPU) context and answer requests, counting kernel
             launches;
4. train   — the same LM through ``mt.mod.Module`` on the default (GPU)
             context: bf16 compute, Xavier init, adam at lr 3e-4, one
             synthetic batch as ``examples/transformer/train_lm.py`` makes
             it; 2 warm-up and 5 timed steps; the loss must be finite and
             fall, and each step must launch each kernel once per layer;
             then the fused step and the two-phase path (forward_backward,
             then the updater over the gradients) are timed side by side;
             then the same LM, init and batch in float32 (``Module``'s
             default ``compute_dtype``), 2 warm-up and 3 timed steps: each
             launches K1, K2 and K3 (split TF32) once per layer, the loss
             falls, and neither of PyTorch's TF32 flags is on;
5. replay  — the train phase's first 3 steps again in a new Module from
             its initial parameters and batch: every loss and parameter
             the same bits; then once more under
             ``torch.use_deterministic_algorithms(True, warn_only=True)``,
             printing the ops it alerts on, with the same bits;
6. splash  — ``get_transformer_lm(attn_impl="splash")`` at the same
             geometry, trained 2 + 5 steps from the train phase's init and
             batch: each step launches K1 split-P, K2 and K3 once per
             layer, its step-0 loss within 1e-3 of the flash LM's; then one
             float32 request on the serve phase's weights within 1e-4 of
             the flash LM's answer;
7. extend  — the user extension path at full width: an axpy pushed
             through ``mt.rtc.MXRtc`` on NDArrays with explicit launch dims;
             ``sgd_update`` pushed over every parameter array of the LM
             (441,646,336 parameters) against the port's ``sgd_update`` on
             copies, its host time per push and a pass's device time beside
             ``torch._fused_sgd_``, and one pass under cProfile (host time
             per push by function); the train phase's LM with its six
             gelu nodes swapped for the user op ``rtc_gelu`` in the symbol
             JSON, trained 2 + 3
             steps: each step launches gelu_fwd, gelu_bwd and K1-K3 six
             times, and its loss matches the train phase's loss at that step;
8. agree   — a small LM served, and trained 3 adam steps in float32 and in
             bf16, on the card and on the CPU from one numpy init, must
             agree; so must the small splash LM (s=128), small LMs at head
             dims 32, 96 and 256, the small LM with ``rtc_gelu``, a net
             with the ``CustomOp`` sigmoid and softmax loss, and a few
             ``mt.nd`` ops; and a recorded reading (``spread_witness``) of
             how far one float32 ulp of the init moves the d=256 LM; then
             the float32 convolution (output and gradients at LeNet's and
             ResNet's layer shapes) against float64, and a small ResNet-50
             (cifar stem, 32x32, batch 8) and a ResNet-18 (imagenet stem,
             72x72, batch 4), both from the zero-γ init, and LeNet, trained
             3 SGD-momentum steps in float32 and bf16 on the card and on
             the CPU from one numpy init, aux states compared like
             parameters;
9. resnet  — ResNet-50 (224x224, 1000 classes) through ``mt.mod.Module`` on
             the default (GPU) context as examples/image_classification/
             common/fit.py's benchmark drives it: Xavier("in", 2.34), SGD
             lr 0.1, momentum 0.9, wd 1e-4, an Accuracy metric every step,
             SyntheticIter's batch; bf16 at batch 256 (2 warm-up and 5
             timed steps), then float32 at batch 32 (2 + 3; both TF32 flags
             off).  Each prints step ms, img/s, MFU and peak memory; the
             loss must be finite and fall, every moving statistic move and
             every parameter stay on the card.  The float32 run's first 2
             states go to the port's CPU route: its losses there within
             1e-4 of the card's, and, trained from the card's init, within
             4x the distance one ulp of the init moves the CPU's own run
             (lr 0.1 at batch 32 is chaotic).  The bf16 run's
             first 2 steps run again in a new Module from its init: the
             same bits (and, timed beside it, the replay under cuDNN's
             deterministic algorithms);
10. ssd    — the repo's SSD (BASELINE.md config #4: 20 classes, 300x300,
             batch 32, get_ssd_train's default widths; 29,272 anchors)
             through ``mt.mod.Module`` on the default (GPU) context as
             examples/ssd/train_ssd.py drives it (forward, outputs,
             backward, update; Xavier, SGD lr 0.2 momentum 0.9, float32,
             TF32 off) on 128 of its synthetic one-box images, labels
             padded to 8 rows: 2 warm-up steps, then six passes over the 4
             batches.  It prints step ms, img/s, peak memory and the
             example's cls+loc loss per pass (finite, the last pass below
             the first), keeps every parameter and aux state on the card,
             and holds its first 2 steps to the port's CPU route (losses
             within 1e-4; MultiBoxTarget's loc_mask and cls_target equal,
             a difference accepted only at a hard-negative score gap under
             1e-5).  Then the checkpoint is served by ``mt.Predictor`` with
             ``get_ssd_detect``: 3 requests of 32 images, ms per request
             and its NMS share (CUDA events around the NMS), detections
             (32, 29272, 6) with ids in [-1, 19], scores and boxes in [0,
             1], kept rows equal to the CPU route's but for a row whose
             score or overlap lies within 1e-5 of its threshold (printed);
             the agree phase adds the small SSD of tests/test_ssd.py
             trained 3 SGD-momentum steps on the card and on the CPU, and
             conv_precision_check a DCGAN-sized stride-2 Deconvolution and a
             bilinear UpSampling;
11. random — each sampler drawn 2**20 times on the card from the device
             generator (mean and variance within 6 standard errors), and
             ``random.get_state``/``set_state`` replaying the card's bits;
12. train_api — the training API on the default (GPU) context.  (a)
             LeNet/MNIST (BASELINE.md config #1, train_mnist.py's
             defaults) through ``model.FeedForward``: the example's
             synthetic digits written as idx-ubyte files (uint8: the round
             trip clips and quantises the images) and read by ``MNISTIter``
             in a ``PrefetchingIter``, the validation split as CSV read by
             ``CSVIter`` in a ``ResizeIter``; 5 epochs of SGD (lr 0.05,
             momentum 0.9, wd 1e-4, Xavier in 2.34, float32, TF32 off) with
             acc, top-3 accuracy and cross-entropy, ``Speedometer``,
             ``ProgressBar`` and ``do_checkpoint``; step ms, img/s, each
             epoch's metrics and peak memory printed; the first 2 steps'
             losses within 1e-4 of the port's CPU route, the final
             validation accuracy at least the JAX package's own reading
             (JAX_MNIST_VAL_ACC) less 0.02, the checkpoint reloaded by
             ``FeedForward.load`` scoring alike within 1e-6, ``predict``
             (1000, 10) probabilities.  (b) every optimizer of the JAX
             package over the train phase's LM (its init and batch, bf16
             compute): 1 + 3 fused steps each, finite losses, parameters and
             states on the card (adam's loss falls), step ms and the states'
             memory; then the update alone over the LM's arrays: the list
             update (median of 10 calls by CUDA events) beside the
             per-array loop over the registered update op (in turns; the
             new weights within 2 float32 ulps), the bytes bound and
             ``torch._fused_sgd_``/``torch._fused_adam_`` as yardsticks;
             a ``train_api`` JSON line with the table.  The agree phase
             adds ``test_utils.check_consistency`` of LeNet (cpu vs
             gpu(0)) and three NAG and three centered RMSProp steps of the
             small LM;
13. spatial — the spatial ops at the widths of the models that use them.
             (a) STN-LeNet (MXNet's lenet.py with add_stn) through
             ``FeedForward`` on the train_api phase's MNIST files,
             iterators and settings: stn_loc starts at weight 0 and the
             identity bias; the first 2 losses within 1e-4 of the CPU
             route, the final validation accuracy at least the JAX
             package's own (JAX_STN_VAL_ACC) less 0.02, 3 steps replayed
             bit for bit; step ms, img/s, peak memory.  (b) ROIPooling at
             Fast R-CNN's VGG16 head (roi_pool5, 7x7, 1/16 of conv5_3
             (1, 512, 38, 63), then fc6 4096) at 128 and 300 seeded ROIs
             (a quarter on corners that land on .5), forward and backward
             through an executor: the pooled output the CPU route's bits,
             the data gradient within 1e-6.  (c) Correlation at FlowNetC's
             corr layer (441 displacements of (8, 256, 48, 64)): batch 1's
             forward and both gradients within 1e-5 of the CPU route.  (d)
             GridGenerator(warp) + BilinearSampler over (8, 3, 384, 512):
             the CPU route within 1e-5, the gradients bit for bit on a
             second run, and GridGenerator(affine) + BilinearSampler equal
             to SpatialTransformer.  Each prints ms by CUDA events and
             peak memory, and a ``spatial`` JSON line;
14. image_io — ResNet-50 and SSD trained from .rec packs.  (a) The codec
             route (``image_backend.codec_routes``), ``native_status()``
             and ``os.cpu_count()``; fatal without the native reader or a
             batch JPEG decoder (libjpeg's ``src/imgdecode.cc`` where its
             headers are installed, else nvJPEG's
             ``mxnet_tpu_torch/csrc/nvjpeg_codec.cu``).  (b) A 2,560-image
             pack as ``im2rec --resize 256`` holds ImageNet (class-coloured
             images, short side 256, JPEG q95, labels i % 1000) written by
             ``MXIndexedRecordIO``; 16 of its images decoded by every codec
             of the card within stated bounds of the source and of each
             other; the batch decoder alone timed over 256 of them.  (c)
             fit.py's --test-io: ``ImageRecordIter`` as
             train_imagenet.get_rec_iter builds it (224², batch 256,
             shuffle, rand_crop, rand_mirror, means) at 4 threads and at
             ``os.cpu_count()``, img/s over 2 epochs.  (d) ResNet-50 bf16
             at batch 256 (the resnet phase's Module) fed by it: 2 + 8
             steps, step ms and img/s beside SyntheticIter's 145.13 ms
             before the image data path, the wait on the iterator, the
             batch's copy to the card.  (e) float32, batch 32, centre crop, no mirror: the
             first batch on the card the CPU route's read bit for bit, the
             first 3 losses the CPU route's at the card's states within
             1e-4.  (f) SSD trained 6 steps from a 128-image detection
             pack read by ``ImageDetRecordIter`` as train_ssd.py builds
             it, its first 2 steps held as the ssd phase holds them.  (g)
             ``nd.imdecode`` and the three ``_cv*`` ops on the card, the
             CPU route's bits.  An ``image_io`` JSON line ends it;
15. generate — the serve phase's LM (float32, max_seq_len 4096, weights
             N(0, 0.02) from SEED) saved as a checkpoint, loaded once onto
             the card and served by ``generation.DecodeEngine`` (lanes 1/2/
             4/8, pages of 16, 577 pages: 8 lanes of 1024 + 128 tokens and
             the scratch page; prefill lengths 64-1024, batches 1/2/4).
             (a) 32 seeded requests (prompts from {32, 128, 256, 512,
             1024}, budgets from {16, 32, 64, 128}, bench_generate's mix)
             submitted at once: generated tokens/s, TTFT and ITL p50/p99,
             decode steps, preemptions, peak pages; every stream ends
             without an exception, no cold run, the pool drains (free
             pages = capacity, refcounts 0), the first 8 transcripts equal
             those of one request at a time through another engine, every
             executor of both binds one ``tok_embed_weight``, each lane
             forward copies each pool plane exactly once (the paged op's
             copy, which the pool then holds) and every plane stays on the
             card.  (b) Two requests (prompts 128 and 512, 16 new): each
             decode step's logits within 1e-4 of the largest |value| of the
             full prefix recomputed through a dense prefill executor.  (c)
             ``get_transformer_lm_prefill`` with ``attn_impl="flash"`` and
             "dense" through ``Predictor`` at (4, 1024) on the same weights:
             logits and every K/V within 1e-4, ``flash_fwd`` (K1) launched 6
             times in one flash forward; both forwards timed (CUDA events,
             mean of 5).  (d) The prefix storm (16 requests of 1024 tokens
             sharing 928, 8 new) without the cache and with 577 cache pages
             after one warming request (the storm's first prompt): equal
             transcripts, fewer prefill tokens, the hits counted, at least
             one copy-on-write, refcounts 0; TTFT p50/p99 of both.  (e) The
             target as its own draft at k 4 on (a)'s first 8 requests:
             transcripts equal to (a)'s, k resolved to 4, 0 < accepted <=
             proposed; acceptance and tokens/s; then the same requests in
             turns under the JAX engine's draft-cursor rule and this
             engine's (ROADMAP C.9): the same transcripts, each rule's
             acceptance and tokens/s.  (f) One request (prompt
             128, 8 new) through a ``DecodeEngine(ctx=mt.cpu())`` of the
             checkpoint: the same transcript, the first decode step's
             logits within 1e-4.  (g) The 8- and 1-lane decode executors
             alone on a full table (median of 20 after 3, CUDA events)
             beside their bytes bounds.  Transcripts compare under the
             near-tie rule: a request that differs passes only if, at its
             first differing position, the reference's top-2 logits
             (recomputed by a dense prefill executor) lie within 1e-4 of
             the largest |logit|; the splits are printed.  A ``generate``
             JSON line ends it;
16. parallel — data and sequence parallelism on the card.  (a) The train
             phase's LM, init and batch (bf16, adam lr 3e-4) through
             ``Module(context=[gpu(0)] * 2)``: kvstore 'device' (the update
             through the async comm engine's store) 2 + 5 steps, then no
             kvstore (the fused step) 2 + 3; each step launches K1, K2 and
             K3 12 times (6 layers x 2 shards), the loss is finite and
             falls, the first 3 losses within 1e-3 (relative) of the train
             phase's one-context losses, after 3 steps the two routes'
             parameters within 1e-6 of the largest |parameter|, every
             parameter, stored value and optimizer state on the card; step
             ms, tokens/s and peak memory beside the one-context step.  (b)
             ``parallel.ring_flash_attention`` over ``make_mesh({"seq": 4},
             devices=[gpu(0)] * 4)`` at [1, 16384, 16, 128] bf16 causal and
             full and float32 causal at 4096, held to K1-K3 over the whole
             sequence (O, dQ, dK, dV within 2e-2 bf16 / 1e-4 float32 of
             max|ref|, lse within 1e-3); one forward launches 10 K1 causal
             (16 full), one backward 10 (16) K2 and K3; both timed (CUDA
             events, mean of 5).  (c) The long-context LM of
             examples/transformer/train_lm_longctx.py (this script's torch
             copy, ``longctx_params``/``longctx_step``) at vocab 32000, 6 x
             2048, 16 heads, seq 16384, batch 1, float32 (TF32 off), SGD lr
             0.05 on a ("data" 1, "seq" 4) mesh of the card: 1 + 3 steps,
             60 split-TF32 K1, K2 and K3 a step, the loss falls, step 0's
             loss within 1e-4 of the same model with ``flash_attention``
             over the whole sequence; step ms and peak memory.  (d) Two
             ``dist_sync`` workers (this script with ``--dist-worker``)
             under the DMLC environment on the card, so over gloo: the
             store's init is rank 0's, a push sums, and 3 SGD-momentum steps
             of a 2 x 1024 LM (seq 1024, batch 4 each, float32) match one
             process's Module at batch 8 within 1e-5; backend and ms per
             step.  (e) ``ulysses_attention`` (4 shards), ``pipeline_spmd``
             (4 stages, 8 microbatches) and ``moe_ffn`` (8 experts over 4
             shards, top-k 1 and 2) on meshes of the card against their
             single-device versions within 1e-5.  A ``parallel`` JSON line
             ends it.  The kernel table's d=128 K1-K3 rows add the
             phase's launches by path (``launches_by_path``): (a) and (b)'s
             bf16 cases on the bf16 rows, (b)'s float32 case and (c) on the
             float32 rows.
17. recurrent — the recurrent family, whose ops run no kernel of the
             port's own (plain torch and cuBLAS).  (a) BASELINE #3 at the
             widths of upstream example/rnn/lstm_bucketing.py: 2 LSTMCell
             layers of 200, embedding 200, vocab 10,000, batch 32, buckets
             10-60, SGD lr 0.01 wd 1e-5, Xavier(in, 2.34), 2 epochs of
             ``BucketingModule.fit`` with Perplexity(ignore_label=0) on
             lstm_bucketing.py's Markov corpus (1,200 sentences of 2-60
             words, table kept sparse); the perplexity falls from epoch 1
             to 2, the first 2 losses within 1e-4 (relative) of the port's
             CPU route from the same init and batches, the first 3 steps
             replay bit for bit; step ms at buckets 10 and 60 (CUDA events,
             mean of 5 after one), tokens/s, peak memory, and under
             ``--profile`` a traced bucket-60 step's idle share.  (b) The
             same model through ``FusedRNNCell`` (cudnn_lstm_bucketing.py)
             from (a)'s init packed by ``pack_weights``: step 0's loss
             within 1e-4 of (a)'s, step ms as (a)'s; the ``RNN`` op alone at
             (T 60, N 32, 2 x 200) and (T 35, N 20, 2 x 1500) forward and
             forward + backward by CUDA events beside ``torch.nn.LSTM``
             (cuDNN) on the same weights, outputs within 1e-4; GRU and a
             bidirectional LSTM against the CPU route within 1e-4.  (c)
             BASELINE #5, examples/model_parallel_lstm/lstm.py's net and
             loop at (a)'s widths, seq 35, each layer on its own context of
             gpu(0) by ``group2ctx``: 3 losses within 1e-6 of one context's
             ``Module``.  (d) examples/warpctc/lstm_ocr.py's net at upstream
             widths (LSTM 100, 80 frames of 30, 4 labels of 10 classes,
             batch 32), adam, 3 epochs of 10 batches: the CTC loss falls;
             ``WarpCTC``'s gradient at (2560, 11) within 1e-5 of the CPU
             route and 1e-4 of a float64 CTC written here.  (e)
             SequenceLast/Mask/Reverse with lengths: forward and gradient
             equal to the CPU route.  A ``recurrent`` JSON line ends it.
18. sharding — the GSPMD layer, through ``mt.sharding`` and
             ``Module.bind(mesh=, partition_rules="transformer_megatron")``
             on the train phase's LM, init and batch (bf16, adam lr 3e-4).
             (a) Tensor parallel: ``build_mesh("data=1,model=2",
             devices=[gpu(0)] * 2)``, 2 + 5 steps; (b) the 2-D mesh
             "data=2,model=2" on ``[gpu(0)] * 4``, 2 + 3 steps.  Each: the
             first 3 losses within 1e-3 (relative) of the train phase's
             one-context losses, ``layer0_qkv_weight`` stored as two
             pieces of (3072, 2048), the ``mxtpu_params_sharded_bytes``
             gauge below ``mxtpu_params_replicated_bytes`` (both printed),
             K1, K2 and K3 each launched as often a step as the
             partitioned walk's plan says (attention once per layer and
             batch shard, on the whole heads: 6 in (a), 12 in (b), held to
             both the plan and those numbers), the
             loss falls, every piece and optimizer state on the card; step
             ms, tokens/s and peak memory beside the train phase's.  (c)
             The LM at 2 layers in float32 (TF32 off, SGD lr 1e-3 momentum
             0.9) on (a)'s mesh against one unsharded Module on gpu(0):
             after 3 steps every parameter within 1e-4 of its largest
             |value|, and its move over the 3 steps within 1e-3 of the
             unsharded move's largest |value|; then the witness at lr 0.05,
             where the loss diverges: the same pair's gaps printed beside
             the unsharded Module's own gap from an init one float32 ulp
             away.  (d) (a)'s parameters after step 3 saved by
             ``save_sharded_checkpoint`` (with the optimizer states),
             restored by ``load_sharded_checkpoint(mesh=)`` onto a fresh
             mesh and a fresh Module: 2 steps give (a)'s steps 4-5, losses
             and parameters bit for bit; without its completion marker the
             directory raises.  (e) Two ``dist_sync`` workers (this script
             with ``--shard-worker``) over gloo on the card train a LeNet
             layout with two BatchNorms, batch 32 each, the second
             worker's rows shifted, under SoftmaxOutput per row and
             normalized by the (global) batch: parameters and moving
             statistics within 1e-5 (of the largest |value|) of one
             process on the concatenated batch; then each worker evaluates
             alone (1 and 3 inference forwards), its outputs within 1e-5
             of that process's rows.  Shards that share one card measure the
             partitioner's own cost, not a multi-card speed-up, and the
             output says so.  A ``sharding`` JSON line ends it; the kernel
             table's d=128 rows add (a), (b) and (d)'s launches on the
             bf16 rows and (c)'s on the float32 rows ("tensor parallel").
19. param_server — the parameter server, ``kv.create("dist_async")``,
             with its servers (``DMLC_ROLE=server python -c "import
             mxnet_tpu_torch"``, the updater on gpu(0)) and workers (this
             script with ``--ps-worker``) separate processes sharing the
             card: the times measure the server's own cost, not a
             multi-host speed-up, and the output says so.  The workers
             train the train phase's LM (bf16, Xavier from SEED, adam lr
             3e-4, rescale 1/(global batch)) through ``Module`` over
             ``dist_async``, 2 workers of batch 2 (the train phase's batch
             4 in halves) and 2 servers: every 2048x2048 weight and the
             embedding range-split, the LayerNorm vectors in buckets.  (a)
             Sync rounds (``MXNET_KVSTORE_SYNC=1``: Module waits at a
             barrier between pushes and pulls), 1 + 2 steps: step ms split
             into compute, push (to the round's barrier), pull wait and the
             server's update, bytes pushed and pulled per step, wire GB/s,
             each process's peak device memory, the updater's context;
             rank 0's init the train phase's bits, the mean of the two
             workers' first 3 losses within 1e-3 (relative) of the train
             phase's, K1-K3 each launched 6 times a step in each worker.
             (b) The LM at 2 layers in float32 (TF32 off, SGD lr 1e-3
             momentum 0.9), 2 sync workers against one process on the
             concatenated batch: after 3 steps every parameter within 1e-5
             of its largest |value|, and the 3-step move printed.  (c)
             Async (``MXNET_KVSTORE_SYNC=0``), 3 steps, run beside (b),
             (e1) and (e2) (its times printed as such): the servers' applied
             pushes equal the push items the workers sent (a range-split
             key once per server, a bucket's keys once each), the loss
             falls, every parameter finite (adam at a quarter of the lr:
             each worker's push is an update of its own).  (d) (a) with
             ``MXNET_KVSTORE_COMPRESS=fp16``: at most 0.51x (a)'s pushed
             bytes, the first 3 losses within 1e-3 of (a)'s.  (e1) Three
             elastic workers on one sync server (tests/
             elastic_churn_worker.py's loop): rank 2 waits after step 3 for
             SIGTERM and exits 0 through its preemption handler, a joiner
             (``MXNET_KVSTORE_ELASTIC_JOIN=1``) enters at step 6; the final
             weight is the churn invariant exactly and the rounds had 3 and
             2 members.  (e2) A float32 MLP through Module over a sync
             server with a snapshot path: after step 4 rank 0 snapshots, the
             server is SIGKILLed and restarted from it while the workers'
             pushes retry; parameters and losses bitwise equal to an
             uninterrupted run's (run beside it, and beside (e1); all
             three beside (b) and (c), which they start with).  (e3) A
             NaN push into an in-process server on the card raises
             ``NonFiniteGradientError`` and leaves the store and the
             momentum unchanged bit for bit.  A ``param_server`` JSON line
             ends it; the kernel table's d=128 rows add (a), (c) and (d)'s
             workers' launches on the bf16 rows and (b)'s on the float32
             rows ("parameter server").
20. serving — the serving tier (``mt.serving``) on the card, with its own
             checkpoints written by ``model.save_checkpoint`` in a
             temporary directory.  (a) The full-width LM (float32, TF32
             off, weights N(0, 0.02) drawn on the card from SEED) through
             ``InferenceServer.from_checkpoint`` with ``input_shapes``
             {"data", "softmax_label": (2, 4096)} (buckets 1 and 2) and a
             generator: 6 requests from 6 threads, each request's rows (its
             row of the batch, recorded at the batcher, times 4096) within
             1e-4 of their largest |value| of a direct batch-1
             ``Predictor``, rows summing to 1 within 1e-4, K1 launched 6
             times per executor call (the counts zeroed just before the
             requests), no cold bucket run; latency p50/p99, queue wait,
             the executor per bucket beside the serve phase's Predictor ms,
             the bucket-2 output's host copy (1.05 GB), occupancy and peak
             memory.  (c) ``POST /generate`` on that server (engine: lanes
             1/2/4, prefill lengths 128/512/1024, batches 1/2, pages for 4
             lanes of 1152 tokens): 4 prompts one at a time, their NDJSON
             records the JAX server's keys and their tokens a second LM
             server's engine's, one request at a time; 8 streams at once,
             all ending, under the near-tie rule; tokens/s and the client's
             TTFT/ITL beside the engine's.  (b) ResNet-50 (BASELINE.md's
             inference configuration: 224², 1000 classes, float32, batch
             32; a random init, SRV_RESNET_INIT) under ``InferenceServer``
             at pow2 buckets to 32: 256 single-image requests from 32
             threads on 2 replicas of the card (one queue), then on 1, each
             answer within 1e-4 of a direct batch-1 ``Predictor``'s; img/s,
             latency, occupancy; 4 ``POST /predict`` bit for bit the
             in-process answers, ``/healthz`` and ``/readyz`` 200,
             ``/metrics`` the JAX package's series, the handler's JSON
             decode and encode ms; ``/generate`` 404 without a generator.
             (d1) A ``Router`` over two ResNet servers under 32-thread
             load, one stopped mid-load (``stop(drain=False)``): no failed
             request, its breaker opens, a new server in its place serves.
             (d2) Epochs 1 and 2 saved with ``max_to_keep=2`` (epoch 0
             pruned) and a byte of epoch 2 flipped: ``find_latest_checkpoint``
             gives 1; ``router.swap`` to it under load: no failed request, a
             replica ready throughout, every answer epoch 0's or 1's and
             every one submitted after the swap epoch 1's, device memory
             within 64 MB.  (d3) A router over the two LM servers: one
             128-token stream, its replica stopped after 32 tokens; it ends
             on the other, equal to an uninterrupted run (near-tie rule),
             one resume counted.  (d4) A router over one server through
             HTTP: answers bit for bit the local ones, the overhead per
             request.  (e) A ``ReplicaRegistry`` over HTTP, an
             ``Autoscaler`` (1-3) with ``LocalCheckpointProvider``: a crowd
             of 64 clients for 5 s scales out and back to 1 with no failed
             request, every spawned replica without a cold bucket run;
             then one ``ProcessProvider`` replica process (``python -m
             mxnet_tpu_torch.serving.launch``, started before (d1) so that
             its start-up overlaps (d1)-(d2)) registers, answers one
             ``/predict`` bit for bit, exits 0 on SIGTERM and leaves the
             registry.  (f) Every server stopped: ``resident_bytes()`` 0
             and the card's live tensors within 64 MB of the phase's start
             (cuBLAS's per-thread workspaces cleared first).  A ``serving``
             JSON line ends it; the float32 d=128 K1 row adds (a)'s
             launches ("serving").  Replicas share one card: img/s of two
             is not a two-card number.
21. platform — the multi-model platform (``mt.platform``): one
             ``ModelManager`` and one ``FrontDoor`` (HTTP, port 0) over the
             card serve lm-a and lm-b (the full-width LM from SEED and
             SEED + 1, float32, slo "generate", tenant chat, phase 20's
             engine, buckets 1 and 2; lm-b asks for 2 replicas), ResNet-50
             (224², batch 32, float32, TF32 off, interactive, tenant
             vision) and the DLRM at the MLPerf widths (``get_dlrm``: 26
             slots of 128, bottom 13-512-256-128, top 1024-1024-512-256,
             batch 2048 of bags of 8 ids, tables of 16384 rows, ids drawn
             below; batch, tenant ads; phase 24 trains it over the full
             vocabularies), on a pool of one device sized from
             the specs' ``footprint()`` to hold the ResNet, the DLRM and one
             LM.  (a) A replan with demand on lm-a faults in lm-a, ResNet-50
             and the DLRM; the first ``/generate`` to lm-b faults it in on
             its handler thread and 2 arrivals inside its fault-in window
             get 503 with Retry-After; a replan with the demand on lm-b
             pages lm-a out.  Every replan raises the plan generation by
             one; every fault-in and page-out is metered: its seconds, no
             cold bucket run, the server on gpu(0), ``footprint()`` beside
             the card's measured delta, and a page-out hands back what its
             fault-in took within 64 MB with ``resident_bytes()`` 0.  (b)
             LM scoring through the front door (in process: an answer is
             4096 x 32000 floats), 2 requests one at a time: K1 6 times per
             executor call, each within 1e-4 of a direct ``Predictor``;
             ``/v1/resnet/predict`` and the DLRM's ``/predict`` with
             ``X-MXNet-Model`` within 1e-4 of direct ``Predictor``s; 3
             ``/generate`` streams equal to the served engine driven
             directly (near-tie rule); the front door's cost per DLRM
             request over the model's own ``InferenceServer``, by HTTP and
             in process.  (c) ads floods the DLRM from 16 threads past a
             quota of 20/s while vision sends 12 ResNet-50 requests: only
             ads gets 429 with Retry-After, every vision request is
             answered.  (d) A second manager with a ``HealthPlane`` on a pool
             of 2 one-device domains (bookkeeping: both are gpu(0)):
             ResNet-50 with a replica in each, the DLRM demand-paged onto
             domain 0; ``faults.inject("platform.health.domain.1:ioerr=1")``
             and a probe: the ladder reaps domain 1's replica, re-faults it
             onto domain 0, pages the DLRM out and browns the batch class
             out (the DLRM 503 with Retry-After, ResNet-50 served);
             ``mark_up`` clears it and the DLRM comes back on domain 1; a
             ResNet-50 loop meanwhile fails only in the retryable family.
             (e) lm-b's second replica faulted in by hand; a 64-token
             ``/generate`` whose replica is paged out gracefully after 16
             tokens finishes through the router's failover, bit for bit the
             uninterrupted stream, one resume counted, memory back within
             64 MB.  (f) Both front doors and managers closed: every
             page-out metered as in (a), the card's live tensors within
             64 MB of the phase's start.  A ``platform`` JSON line ends it;
             the float32 d=128 K1 row adds (b)'s launches ("platform").
22. compile_once — the compile-once tier (``mt.compile_cache``,
             ``mt.autotune``, AOT bundles) cold and then warm, in two
             processes (this script with ``--cc-worker``), over the
             full-width LM (float32, weights from SEED, the checkpoint
             written here) as a platform model: scoring buckets 1 and 2
             and a ``DecodeEngine`` with lanes 1/2/4/8 (GEN_ENGINE's pool;
             prefill lengths 128 and 1024), under ``MXNET_COMPILE_CACHE_DIR``
             and ``MXNET_AUTOTUNE=record``.  (a) Cold, in the repository
             tree with an empty cache: ``ModelManager.fault_in``
             (``InferenceServer.from_checkpoint``, warm-up: 8 entries, all
             misses, the 2 scoring and 2 prefill buckets each a CUDA graph,
             the 4 lane buckets eager; ``save_aot_bundle`` at the first
             build), ``page_out`` (the bundle refreshed before the server
             stops); an ``rtc`` axpy and the ``rtc_gelu`` op (forward and
             backward) through NVRTC (3 compiles).  (b) Warm, in a fresh
             copy of ``mxnet_tpu_torch/`` without ``_build/`` in a temporary
             directory, the same cache and the bundle: the same fault-in
             runs no nvcc (``kernels.BUILD_LOGS`` empty; the library
             restored from the cache), no NVRTC compile and no tuning
             (``tuning_ms`` 0, DB misses 0), 8 hits, no cold bucket run;
             K4/K5 from the cached cubins within 1 ulp of their plain
             versions.  (c) On that server, every graph's replay
             (scoring, prefill) bit for bit its eager walk on the same
             inputs; 2 scoring replies within 1e-4 of a direct batch-1
             forward (eager); K1 6 times per executor call counted through
             the replays, and one replay of each scoring bucket traced with
             torch.profiler: its ``flash_fwd_tf32_kernel`` device ops equal
             to the host count, 6, and the graph's own DOT dump (the warm
             worker keeps each graph's nodes) holds 6 such kernel nodes;
             the trace's kernel records and the graph's kernel nodes
             printed by family; a trace short of K1 passes only if it
             holds no record the graph lacks (the missing ones are records
             the profiler lost); the LM executor at buckets 1 and 2 eager
             against graph by CUDA events; 8 prompts (4 of 128 tokens, 4
             of 1024) through ``submit_generate``, token for token those of
             an eager engine (cache off, ``attach_aot=False``), and the
             8-lane step through ``_run_lanes`` (inputs, forward and the
             planes' adoption) timed by CUDA events in both.  (d) A bundle
             whose manifest names another ``device_kind``, and one with a
             JAX-shaped manifest, raise ``MXNetError``;
             ``attach_aot=False`` serves.  (e) The fault-ins of (a) and
             (b), cold against warm (each worker starts its CUDA context
             and the profiler first, timed apart), and once more in each
             worker after that (the in-memory entries dropped; a second
             checkpoint and cache directory): the seconds split into load,
             entries, first runs, captures and build, ``footprint()``
             against the card's delta in live tensors and in reserved
             bytes (a graph's pool is reserved whole), each page-out
             handing back its fault-in within 64 MB of both.  A
             ``compile_once`` JSON line ends it; the float32 d=128 K1 row
             adds (c)'s launches ("compile_once"), the user-kernel rows
             (b)'s.
23. observe — observability and the training guardian (``mt.telemetry``,
             ``mt.guardian``, ``mt.profiler``) on the train phase's LM
             (bf16, adam lr 3e-4, Xavier from SEED).  (a) Steps with
             telemetry (the tracer on) and the guardian (the fused step's
             guard and its ladder) off and on: 2 warm-up each way, then 5
             timed in turns off, on, on, off; step ms both ways and their
             ratio, then 1 + 5 steps with telemetry alone and with the
             guardian alone; every step 6 launches of K1, K2 and K3; the step
             monitor's ``flops_per_step`` (the eager plan's cost model)
             within 10% of the hand count (6 x the product parameters x
             16,384 tokens, plus the causal attention's products), MFU over
             989 TFLOP/s at the on steps' mean, ``device_peak_bytes`` equal
             to ``torch.cuda.max_memory_allocated()``, the merged trace
             valid.  (d) One step under ``profiler_set_state("run")``: the
             torch.profiler trace holds 6 device ops of each of K1-K3 inside
             the ``Executor.fused_step`` range, as the host counted; the
             profiler's start seconds.  (b) ``Module.fit`` over 11 batches
             under the guardian (snapshots every 4, the JAX defaults
             otherwise), SGD-momentum: an uninterrupted run (one snapshot,
             before batch 0), then one whose
             batch-end callback sets one weight to NaN after batch 4: the
             ladder answers skip, skip, rewarm, skip, skip, rollback; every
             parameter and momentum keeps its bits across each skipped
             step; the rollback to the snapshot taken before batch 4
             (seconds, the snapshot's bytes: the parameters and the pickled
             momentum) writes a flight-recorder postmortem; the replay's
             losses and final
             parameters are the uninterrupted run's bits; the merged trace
             holds the fit's spans.  Under adam (the small LM, float32,
             card and CPU from one numpy init) a rolled-back run is not an
             uninterrupted one (the update counts run on, ROADMAP.md C),
             and the card's equals the CPU route's within 1e-3 of the
             largest parameter.  (c) ``OBS_FAULT`` on a 2-layer LM at the
             full widths takes the eager loop: the guard answers skip,
             nothing changes, one anomaly counted.  An ``observe`` JSON line
             ends it; the bf16 d=128 K1-K3 rows add the phase's full-width
             launches ("observe").
24. sparse — the sparse plane (``mt.sparse``) training the MLPerf
             Training DLRM reference (facebookresearch/dlrm on Criteo
             Terabyte, --max-ind-range=40000000) at phase 21's widths with
             its 26 full vocabularies (187,767,399 rows, 96.1 GB of
             float32: more than the card holds) through
             ``SparseEmbeddingModule`` on gpu(0) over ``dist_async`` and 2
             server processes (the tables numpy on the servers, each slot
             bound at 16,384 rows on the card), SGD lr 1.0, batch 2048 of
             bags of 8 int32 ids drawn uniformly in each vocabulary (the
             lazy rows' worst case; Criteo's own ids are not in the
             repository).  (a) 3 steps: each step's route (ids
             uniquified, rows pulled, rows copied to the card),
             forward and backward on the card (CUDA events), update (rows
             to the host, push, the wait for the servers), the servers'
             seconds and the bytes moved; each server holds part of every
             table and no misplaced row, the worker's logical bytes at
             least 10x its resident ones; a probe batch's outputs finite.
             (b) The same 3 steps over 2 fresh servers, both shards
             snapshotted after step 2 and server 1 SIGKILLed and restarted
             from its snapshot: the touched rows and the probe's outputs
             bit for bit (a)'s.  (c) Beside (b): 2 steps at the same widths
             with every table at 65,536 rows and ids unique within a
             batch, ``SparseEmbeddingModule`` over 2 servers in this
             process against a ``Module`` holding the tables on the card
             from the same rows
             and weights: every touched row and dense weight within 2
             float32 ulps of its array's largest |value| (the reason at
             ``SPARSE_TOL_ULPS``).  (a)'s and (b)'s server processes start
             during phase 23's untimed half.  A ``sparse`` JSON line ends
             it; the phase launches no kernel of the port's own.
25. long_tail — the long tail of the port's modules on the train phase's
             LM (bf16, adam lr 3e-4, Xavier from SEED, its batch).  (a)
             Remat (``MXNET_BACKWARD_DO_MIRROR``) on and off in two
             ``Module``s from one init, 1 + 1 warm-up steps, then 3 + 3 in
             turns: step ms, tokens/s and each step's peak above its start;
             a remat step launches K1 12 times (forward and recompute) and
             K2, K3 6 times, an off step 6 of each; the losses and the
             parameters after the steps the same bits both ways; the step
             monitor's ``flops_per_step`` under remat within 10% of the
             hand count with the forward counted twice.  After (b): the
             two-phase ``forward_backward`` route one step each way (the
             same bits, 12/6/6 launches with remat), then the
             ``fused_step`` autotune site once in record mode on the off
             Module: both candidates' roofline scores and the winner, and
             the step runs the winner's remat.  (b) The NaiveEngine
             (``MXNET_ENGINE_TYPE``) in a fresh Module with
             ``MXNET_COMPILE_CACHE_DIR`` set, 1 + 3 steps and an inference
             forward: the parameters the default engine's bits, no cache
             entry, lookup or CUDA graph.  (c) Caffe: BVLC AlexNet's
             deploy.prototxt (227², grouped convolutions, LRN) and seeded
             blobs through ``mt.caffe.encode_caffemodel`` and ``convert``,
             scored in float32 at batch 32 through ``Predictor``: ms a
             batch and img/s, the output within 1e-4 of the port's CPU
             route.  (d) The C ABI: ``libmxtpu_torch_capi`` built with g++
             (beside (a)), driven through ctypes in this process:
             ``MXTPUPredCreate`` (dev_type 2) over the LM's checkpoint, 1 x
             4096 through ``SetInput``/``Forward``/``GetOutput``: ms a
             forward, 6 K1 launches each, the host copy's ms, the output
             within 1e-4 of ``Predictor``'s; ``examples/c_predict/demo.c``
             compiled against the library and run as a process of its own
             (dev_type 1, beside (c)) prints what the in-process route
             gives.  (e) ``python -m mxnet_tpu_torch.tools.shard_probe`` at
             the LM's widths under ``transformer_megatron`` on data=1 x
             model=2 over ``[gpu(0)] * 2`` (a process beside (c) and (d)):
             its per-device bytes phase 18's
             ``mxtpu_params_sharded_bytes``; the embedding under
             ``P(("data", "model"), None)`` on data=2 x model=2 over
             ``[gpu(0)] * 4``: each piece the rule's row block, gathered bit
             for bit; 3 SGD steps of the 2-layer float32 LM with that split
             beside the Megatron rules, losses within 1e-3 of one
             context's.  A ``long_tail`` JSON line ends it; the bf16 d=128
             K1-K3 rows add (a)'s and (b)'s launches ("long_tail"), the
             float32 d=128 rows (d)'s and (e)'s.

Side by side, to keep the whole run well inside its time limit (each
clock: line gives a phase's seconds and the script's so far):

- The serve phase's checkpoint is drawn and written on a thread while
  the build's nvcc processes run, and joined before any kernel is timed;
  the splash phase reuses its weights.
- Lane A: phases 9, 10, 11, 13, 14, 15 and 17 run, in that order, in a
  process of their own (this script with ``--lane``), started after the
  extend phase, whose readings close the kernel table's timings, and
  joined before phase 19's (b), (c), (e1) and (e2) start.  They read
  none of the main sequence's state and add nothing to the table.  Their
  output is printed when the lane is joined; a lane that failed fails
  the script at the next phase's end.  Their times, and those of phases
  8, 12, 16, 18 and 19 (a) and (d), are read with both processes on the
  card.
- Phase 16 (d)'s and phase 18 (e)'s gloo worker processes start at
  their phase's start and run beside its (a)-(c) and (a)-(d).
- Phase 22's checkpoint is written before phase 20, and its two worker
  processes run, one after the other, beside phases 20 and 21; its
  output is printed where it is joined, after phase 21.
- Phase 25 runs in the main sequence after phase 24 (its launches join
  the kernel table); its C library builds beside its (a) and (b), and
  the shard probe's process and the demo's run beside its (c) and (d),
  which gate on results.
The second-to-last lines are the kernel table as JSON and the card's name
and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
``examples/``.
"""
import argparse
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

FULL = dict(vocab_size=32000, num_layers=6, num_heads=16, hidden=2048,
            seq_len=4096)
BATCH = 4
REQUESTS = 3
SEED = 0
SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=128, seq_len=40)
# the agree phase's other small LMs: head dims 32, 96, 256 (flash; trained
# at the init spread of the CPU tests' 64-wide LM, std 0.3 * sqrt(64 /
# hidden): at SMALL's spread three float32 steps of the 256-wide LM took
# the loss from 8.09 to 3.14 and amplified summation order to 1.06e-4 of
# the largest parameter, with K1-K3 at d=256 within 8e-7 of their plain
# versions) and the splash LM (its sequence a multiple of 128)
SMALL_HEAD_DIMS = {32: dict(SMALL, num_heads=4), 96: dict(SMALL, hidden=192),
                   256: dict(SMALL, num_heads=1, hidden=256)}
SMALL_SPLASH = dict(SMALL, seq_len=128, attn_impl="splash")
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_LR = 2, 5, 3e-4
F32_WARMUP, F32_STEPS = 2, 3  # the float32 train phase
REPLAY_STEPS = 3
SOURCE_DIR = "mxnet_tpu_torch/csrc/"
# the TPU kernel each CUDA kernel replaces (the split-P K1 serves splash,
# upstream JAX's Pallas kernel, reached from the repo at attention.py:604)
REPLACES = {"flash_fwd": "mxnet_tpu/ops/attention.py:97",
            "flash_fwd_splitp": "mxnet_tpu/ops/attention.py:604",
            "flash_bwd_dq": "mxnet_tpu/ops/attention.py:216",
            "flash_bwd_dkv": "mxnet_tpu/ops/attention.py:262"}
RTC_SOURCE = "mxnet_tpu_torch/rtc_kernels.py"
AXPY_PY_SRC = """
def kernel(x_ref, out_ref):
    out_ref[...] = 2.0 * x_ref[...]
"""
EXTEND_WARMUP, EXTEND_STEPS = 2, 3
# the user kernels' full-width shape: the gelu input of the train phase's
# LM, (batch x seq, 4 x hidden)
WIDE = (BATCH * FULL["seq_len"], 4 * FULL["hidden"])
# sgd_update's hyperparameters in the extend phase, and the passes over
# the LM's arrays whose enqueue is timed for the host time per push
SGD = dict(lr=0.01, rescale_grad=1.0 / BATCH, wd=1e-4)
HOST_PASSES = 3
# the step times and the train step's peak memory of the version before
# the optimizers' list update (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside this run's
BEFORE_MS = {"train": 139.06, "resnet bf16": 149.04, "ssd": 59.06}
BEFORE_TRAIN_PEAK_GB = 29.87

# Data-sheet peaks per H100 variant (dense): float32 on the CUDA cores, bf16
# and TF32 (half of bf16) on the tensor cores (TFLOP/s), device memory
# (TB/s).  nvidia-smi names the SXM part "NVIDIA H100 80GB HBM3", so SXM is
# the fallback.
PEAKS = {
    "H100 PCIe": {"float32": 51.0, "bfloat16": 756.0, "tf32": 378.0,
                  "tbs": 2.0},
    "H100 NVL": {"float32": 60.0, "bfloat16": 835.0, "tf32": 417.5,
                 "tbs": 3.9},
    "H100 SXM": {"float32": 67.0, "bfloat16": 989.0, "tf32": 495.0,
                 "tbs": 3.35},
}


class PhaseClock:
    """Prints each phase's seconds and the script's seconds so far, so the
    budget of the whole run can be read phase by phase.  Each mark first
    collects the phase's garbage and returns the card's cached blocks (a
    phase's Module can sit in a reference cycle, its tensors on the card,
    until the collector runs); and a lane (``LaneJob``) that has already
    failed fails the script."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.lanes = []

    def mark(self, name):
        import gc

        import torch

        gc.collect()
        torch.cuda.empty_cache()
        now = time.perf_counter()
        print("clock: %s %.1f s (script at %.1f s; %.2f GB on the card "
              "held by this process after it)"
              % (name, now - self.last, now - self.t0,
                 torch.cuda.memory_allocated() / 1e9), flush=True)
        self.last = now
        for lane in self.lanes:
            lane.fail_early()


class Background:
    """``fn(*args)`` on a thread of its own; ``result()`` joins it and
    returns what it returned, or raises what it raised."""

    def __init__(self, fn, *args):
        self._out = {}

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as exc:  # check() raises SystemExit
                self._out["error"] = exc
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def check(ok, msg):
    if not ok:
        raise SystemExit("chip_smoke FAILED: " + msg)


def peaks_for(name):
    for key, val in PEAKS.items():
        if all(part in name for part in key.split()):
            return key, val
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_work(kind, b, sq, sk, h, d, causal, itemsize):
    """(operations, bytes) that attention function ``kind`` must do for
    these shapes: 2·d operations per visible (query, key) pair for each
    distinct product, each input read once and each output written once.

    fwd     QKᵀ, PV                         reads q, k, v; writes o, lse
    bwd_dq  QKᵀ, dO·Vᵀ, dS·K                reads q, k, v, dO, lse, Δ; writes dq
    bwd_dkv QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q        reads q, k, v, dO, lse, Δ; writes dk, dv
    bwd     the five products of the whole backward (no product counted
            twice); reads q, k, v, o, dO, lse; writes dq, dk, dv
    """
    if causal:
        pairs = int(np.minimum(np.arange(sq) + 1, sk).sum())
    else:
        pairs = sq * sk
    qs = b * sq * h * d * itemsize  # one [b, sq, h, d] tensor
    ks = b * sk * h * d * itemsize  # one [b, sk, h, d] tensor
    rows = b * h * sq * 4           # one float32 [b*h, sq] row vector
    products, nbytes = {
        "fwd": (2, 2 * qs + 2 * ks + rows),
        "bwd_dq": (3, 3 * qs + 2 * ks + 2 * rows),
        "bwd_dkv": (4, 2 * qs + 4 * ks + 2 * rows),
        "bwd": (5, 4 * qs + 4 * ks + rows),
    }[kind]
    return 2.0 * products * d * pairs * b * h, nbytes


def bound_ms(torch, work, dtype, products=False, cuda_cores=False):
    """(bound ms, what bounds it): the larger of the work's operations
    over the card's peak for ``dtype`` and its bytes over memory rate.
    float32 matrix ``products`` are bounded on the tensor cores by the
    split-TF32 product, three TF32 operations per operation ("operations
    (3xTF32)" in the printed lines; "operations" in the kernel table);
    ``cuda_cores`` bounds them at the float32 CUDA-core peak instead, the
    bound of the tables before that route."""
    _, peak = peaks_for(torch.cuda.get_device_name(0))
    flops, nbytes = work
    if dtype == torch.bfloat16:
        t_ops = flops / (peak["bfloat16"] * 1e12) * 1e3
    elif products and not cuda_cores:
        t_ops = 3 * flops / (peak["tf32"] * 1e12) * 1e3
    else:
        t_ops = flops / (peak["float32"] * 1e12) * 1e3
    t_bytes = nbytes / (peak["tbs"] * 1e12) * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def qkv_views(torch, gen, b, sq, sk, h, d, dtype, device, packed=True):
    """q, k, v as the LM hands them to the kernels: strided views of one
    packed [b, s, 3, h, d] projection when sq == sk (and ``packed``), else
    three contiguous tensors."""
    if packed and sq == sk:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device=device)
        return tuple(t.squeeze(2) for t in qkv.to(dtype).split(1, dim=2))
    mk = lambda s: torch.randn((b, s, h, d), generator=gen,  # noqa: E731
                               device=device).to(dtype)
    return mk(sq), mk(sk), mk(sk)


def rel_err(torch, got, ref):
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


# the head dims the kernels take besides the main path's, at the main
# length: (heads, d), b = BATCH, s = 4096
HEAD_DIM_CASES = ((64, 32), (16, 96), (8, 256))


def kernel_phase(torch, att, device, parents=()):
    """K1 against the plain forward (O, lse) and K2/K3 against the plain
    backward (dQ, dK, dV) at every case.  The cases "timed" are those at
    the main length: the main path's shape and the head dims of
    ``HEAD_DIM_CASES``, each in float32 and bf16, and d=64 in bf16; at each
    one, two launches of each kernel give the same bits
    (``repeat_check``); at each bf16 one K1's split-P variant is held to
    what it adds (``splitp_check``), at each float32 one the split-TF32
    K2/K3 to a float64 truth (``precision_check``).  Then every timed case beside its bound, its
    plain version and SDPA (``time_case``), and after all of them, at each
    bf16 case, the comparison with the ``--parent-csrc`` builds
    (``parent_lines``), so that their longer load does not set the clock
    the table is timed at.
    Returns (the rows of the main
    path's shape in bf16 keyed by kernel, the other rows keyed (kernel, d,
    dtype): the main shape in float32 (the float32 train phase's) and the
    head dims)."""
    f32, bf16 = torch.float32, torch.bfloat16
    h_main, s = FULL["num_heads"], FULL["seq_len"]
    d_main = FULL["hidden"] // h_main
    cases = [  # name, b, sq, sk, h, d, causal, dtype[, packed]
        ("f32 causal d64", 2, 256, 256, 4, 64, True, f32),
        ("f32 full d64", 2, 256, 256, 4, 64, False, f32),
        ("f32 causal sq<sk d128 ragged", 2, 200, 333, 4, 128, True, f32),
        ("f32 full sq>sk d128 ragged", 2, 333, 200, 4, 128, False, f32),
        ("f32 causal sq>sk d64", 1, 300, 100, 2, 64, True, f32),
        ("bf16 causal d128", 2, 512, 512, 4, 128, True, bf16),
        ("bf16 full sq<sk d64", 2, 192, 320, 4, 64, False, bf16),
        ("bf16 causal sq>sk d128 ragged", 2, 333, 200, 4, 128, True, bf16),
        # the tensor-core kernels' tiling: 128 resident rows per block (two
        # warpgroups of 64), streamed tiles of 128 keys (K1) or 64 rows
        # (K2/K3)
        ("bf16 causal d64 tiny ragged", 1, 17, 17, 2, 64, True, bf16),
        ("bf16 full d64 tiny ragged", 1, 17, 17, 2, 64, False, bf16),
        ("bf16 causal d128 ragged", 2, 333, 333, 4, 128, True, bf16),
        ("bf16 full d128 ragged", 2, 333, 333, 4, 128, False, bf16),
        ("bf16 causal sq<sk d64 ragged", 2, 200, 333, 4, 64, True, bf16),
        ("bf16 full sq>sk d64 ragged", 2, 333, 200, 4, 64, False, bf16),
        ("bf16 causal d128 contiguous", 2, 320, 320, 4, 128, True, bf16,
         False),
        ("bf16 causal d64 main length", BATCH, s, s, 16, 64, True, bf16),
    ]
    for h, d in ((h_main, d_main),) + HEAD_DIM_CASES:
        what = "main-path shape" if d == d_main else "head dim %d" % d
        cases += [("%s causal %s" % (tag, what), BATCH, s, s, h, d, True,
                   dtype) for dtype, tag in ((f32, "f32"), (bf16, "bf16"))]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    timed = {}
    for name, b, sq, sk, h, d, causal, dtype, *packed in cases:
        fwd_tol = 1e-4 if dtype == f32 else 2e-2  # abs, O and lse
        bwd_tol = 1e-4 if dtype == f32 else 2e-2  # relative to max |ref|
        q, k, v = qkv_views(torch, gen, b, sq, sk, h, d, dtype, device,
                            *packed)
        scale = 1.0 / np.sqrt(d)
        o, lse = att.flash_forward(q, k, v, causal, scale)
        o_ref, lse_ref = plain_forward(att, q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        print("kernel flash_fwd [%s] b=%d sq=%d sk=%d h=%d d=%d: "
              "max|dO|=%.3g max|dlse|=%.3g (tolerance %g)"
              % (name, b, sq, sk, h, d, err_o, err_l, fwd_tol), flush=True)
        check(torch.isfinite(o.float()).all().item()
              and torch.isfinite(lse).all().item(),
              "non-finite flash_fwd output in case %s" % name)
        check(err_o <= fwd_tol and err_l <= fwd_tol,
              "flash_fwd disagrees with its plain version in case %s" % name)
        del o_ref, lse_ref

        do = torch.randn((b, sq, h, d), generator=gen, device=device).to(dtype)
        grads = att.flash_backward(q, k, v, o, lse, do, causal, scale)
        refs = plain_backward(att, q, k, v, o, lse, do, causal, scale)
        torch.cuda.synchronize()
        errs = {}
        for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            check(got.dtype == dtype and got.shape == ref.shape
                  and torch.isfinite(got.float()).all().item(),
                  "flash_backward %s: bad dtype, shape or non-finite values "
                  "in case %s" % (gname, name))
            errs[gname] = rel_err(torch, got, ref)
        print("kernel flash_bwd [%s]: max|err|/max|ref| dq %.3g dk %.3g dv "
              "%.3g (tolerance %g)" % (name, errs["dq"][1], errs["dk"][1],
                                       errs["dv"][1], bwd_tol), flush=True)
        check(all(e[1] <= bwd_tol for e in errs.values()),
              "flash_backward disagrees with its plain version in case %s"
              % name)
        del grads, refs
        if b == BATCH and sq == s:
            m = dict(name=name, q=q, k=k, v=v, o=o, lse=lse, do=do,
                     scale=scale, err_o=err_o, errs=errs)
            repeat_check(torch, att, m)
            if dtype == bf16:
                m.update(splitp_check(torch, att, m))
            else:
                forward_precision_check(torch, att, m)
                precision_check(torch, att, m)
            timed[(d, dtype)] = m
    torch.cuda.empty_cache()
    tma_rule_check(torch, att, timed[(d_main, bf16)])
    variant, peak = peaks_for(torch.cuda.get_device_name(0))
    print("kernel bounds against the %s data sheet: %.0f TFLOP/s float32, "
          "%.0f TFLOP/s bf16 dense, %.1f TFLOP/s TF32 dense (float32 "
          "products: 3 TF32 operations each), %.2f TB/s" % (
              variant, peak["float32"], peak["bfloat16"], peak["tf32"],
              peak["tbs"]), flush=True)
    main_rows, dim_rows = {}, {}
    for (d, dtype), m in timed.items():
        rows = time_case(torch, att, m)
        del m["o"], m["do"]
        if dtype == f32 or not parents:
            for key in ("q", "qs", "k", "v"):
                m.pop(key, None)
        torch.cuda.empty_cache()
        if d == d_main and dtype == bf16:
            main_rows = rows  # the bf16 train, replay and splash paths
            continue
        if d not in {dim for _, dim in HEAD_DIM_CASES} | {d_main}:
            continue  # d=64 at the main length: printed only
        tag = "f32" if dtype == f32 else "bf16"
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            row = dict(rows[kernel])
            row["name"] = "%s[d=%d,%s%s]" % (
                kernel, d, tag, ",dV+dK" if kernel == "flash_bwd_dkv" and
                att.kernel_width(d) > 128 else "")
            dim_rows[(kernel, d, tag)] = row
    for (d, dtype), m in timed.items():
        if dtype == bf16 and parents:
            parent_lines(torch, att, parents, m)
            del m["q"], m["qs"], m["k"], m["v"]
    return main_rows, dim_rows


def repeat_check(torch, att, m):
    """Two launches of K1, K2 and K3 on one bf16 case give the same bits as
    the case's own (no atomics)."""
    q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o", "lse",
                                                  "do", "scale"))
    runs = [att.flash_forward(q, k, v, True, scale) for _ in range(2)]
    same = [torch.equal(a, b) for a, b in zip(*runs)] + \
        [torch.equal(runs[0][0], o), torch.equal(runs[0][1], lse)]
    del runs
    delta = att._row_delta(o, do).contiguous()
    runs = [(att.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),)
            + att.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    same += [torch.equal(a, b) for a, b in zip(*runs)]
    print("kernel [%s], two launches of K1 (and the case's own), K2, K3: o, "
          "lse (, o, lse), dq, dk, dv bitwise equal %s" % (m["name"], same),
          flush=True)
    check(all(same), "repeated launches differ in case %s" % m["name"])


def backward_f64(torch, q, k, v, o, lse, do, scale):
    """The causal attention backward in float64 from float32 inputs and the
    forward's lse (natural log): the truth ``precision_check`` measures
    against (``attention_backward_reference`` computes in float32)."""
    b, s, h, _ = q.shape
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
                  - lse.double().reshape(b, h, s, 1))
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2).reshape(b, h, s, 1)
    ds = p * (dp - delta) * scale
    del p, dp
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q), dv)


# the split-TF32 K2/K3's mean |error| against float64 may be at most this
# many times the plain float32 version's (one TF32 product reads ~1000x)
SPLIT_MEAN_LIMIT = 8.0


def precision_check(torch, att, m):
    """The split-TF32 K2/K3 of one float32 case against a float64 backward
    on batch 0, heads 0 and 1: the mean |error| of dQ, dK and dV at most
    ``SPLIT_MEAN_LIMIT`` times that of the plain float32 version on the same
    inputs.  The 1e-4 limit on max |err| / max |ref| does not tell a split
    product from a float32 one; this does."""
    cut = (slice(0, 1), slice(None), slice(0, 2))
    q, k, v, o, do = (m[x][cut] for x in ("q", "k", "v", "o", "do"))
    b, s, h, _ = m["q"].shape
    lse = m["lse"].view(b, h, s)[0:1, 0:2].reshape(2, s).contiguous()
    got = att.flash_backward(q, k, v, o, lse, do, True, m["scale"])
    plain = att.attention_backward_reference(q, k, v, o, lse, do, True,
                                             m["scale"])
    truth = backward_f64(torch, q, k, v, o, lse, do, m["scale"])
    ratios = {}
    for name, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        ka = (a.double() - t).abs().mean().item()
        pa = (p.double() - t).abs().mean().item()
        ratios[name] = (ka, pa, ka / max(pa, 1e-300))
    print("kernel flash_bwd [%s] batch 0, heads 0-1 against a float64 "
          "backward: mean|err| kernel / plain float32 %s (limit %g)"
          % (m["name"], ", ".join("%s %.4g / %.4g = %.3g" % (n, *r)
                                  for n, r in ratios.items()),
             SPLIT_MEAN_LIMIT), flush=True)
    check(all(r[2] <= SPLIT_MEAN_LIMIT for r in ratios.values()),
          "the split-TF32 backward is not of float32 precision in case %s"
          % m["name"])


def forward_f64(torch, q, k, v, scale):
    """The causal attention forward in float64 from float32 inputs: (o,
    lse in natural log), the truth ``forward_precision_check`` measures
    against (``attention_reference`` computes in float32)."""
    b, s, h, _ = q.shape
    q, k, v = (t.double() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    mx = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - mx)
    del sc
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / den, v)
    return o, (mx + torch.log(den)).reshape(b * h, s)


def forward_precision_check(torch, att, m):
    """The split-TF32 K1 of one float32 case against a float64 forward on
    batch 0, heads 0 and 1: max |error| on O and lse at most 1e-4, and the
    mean |error| of O at most ``SPLIT_MEAN_LIMIT`` times that of the plain
    float32 version on the same inputs (which one TF32 product breaks)."""
    cut = (slice(0, 1), slice(None), slice(0, 2))
    q, k, v = (m[x][cut] for x in ("q", "k", "v"))
    got = att.flash_forward(q, k, v, True, m["scale"])
    plain = att.attention_reference(q, k, v, True, m["scale"])
    truth = forward_f64(torch, q, k, v, m["scale"])
    errs = {}
    for name, a, p, t in zip(("o", "lse"), got, plain, truth):
        errs[name] = ((a.double() - t).abs().max().item(),
                      (a.double() - t).abs().mean().item(),
                      (p.double() - t).abs().mean().item())
    ratio = errs["o"][1] / max(errs["o"][2], 1e-300)
    print("kernel flash_fwd [%s] batch 0, heads 0-1 against a float64 "
          "forward: max|err| o %.3g lse %.3g (tolerance 1e-4); mean|err| "
          "kernel / plain float32 o %.4g / %.4g = %.3g (limit %g), lse "
          "%.4g / %.4g" % (m["name"], errs["o"][0], errs["lse"][0],
                           errs["o"][1], errs["o"][2], ratio,
                           SPLIT_MEAN_LIMIT, errs["lse"][1], errs["lse"][2]),
          flush=True)
    check(errs["o"][0] <= 1e-4 and errs["lse"][0] <= 1e-4,
          "the split-TF32 forward is off a float64 forward in case %s"
          % m["name"])
    check(ratio <= SPLIT_MEAN_LIMIT, "the split-TF32 forward is not of "
          "float32 precision in case %s" % m["name"])


def splitp_check(torch, att, m):
    """K1's split-P variant as splash runs it (q pre-scaled in bf16, scale
    1) against the plain version (P in float32), and what it adds: it
    exists to keep P at float32 precision in P·V, which the limit on O
    (2e-2 abs, one bf16 rounding of O at its largest) cannot show, since
    plain K1, which rounds P to bf16, passes it too.  So its mean |error|
    over O must be at most half that of plain K1 on the same inputs; lse
    within 1e-4; two launches give the same bits.  Returns the pre-scaled q
    and its max|error| on O."""
    from mxnet_tpu_torch.kernels import LAUNCHES

    q, k, v, scale = m["q"], m["k"], m["v"], m["scale"]
    qs = q * torch.tensor(scale, dtype=q.dtype)
    before = LAUNCHES["flash_fwd_splitp"]
    o, lse = att.flash_forward(qs, k, v, True, 1.0, split_p=True)
    check(LAUNCHES["flash_fwd_splitp"] == before + 1,
          "split_p=True did not launch flash_fwd_splitp")
    o_k1, _ = att.flash_forward(qs, k, v, True, 1.0)
    again = att.flash_forward(qs, k, v, True, 1.0, split_p=True)
    o_ref, lse_ref = plain_forward(att, qs, k, v, True, 1.0)
    torch.cuda.synchronize()
    err = {}
    for what, got in (("split-P", o), ("K1", o_k1)):
        diff = (got.float() - o_ref.float()).abs()
        err[what] = (diff.max().item(), diff.mean().item())
        del diff
    err_l = (lse - lse_ref).abs().max().item()
    same = [torch.equal(again[0], o), torch.equal(again[1], lse)]
    ratio = err["split-P"][1] / max(err["K1"][1], 1e-30)
    print("kernel flash_fwd_splitp [%s] (q pre-scaled, scale 1): max|dO| "
          "%.3g, mean|dO| %.4g; K1 with P rounded on the same inputs: max|dO| "
          "%.3g, mean|dO| %.4g; mean ratio %.3g (limit 0.5); max|dlse| %.3g "
          "(tolerance 2e-2 on O, 1e-4 on lse); two launches bitwise equal %s"
          % (m["name"], err["split-P"][0], err["split-P"][1], err["K1"][0],
             err["K1"][1], ratio, err_l, same), flush=True)
    check(err["split-P"][0] <= 2e-2 and err_l <= 1e-4,
          "flash_fwd_splitp disagrees with its plain version in case %s"
          % m["name"])
    check(ratio <= 0.5, "flash_fwd_splitp is not closer than K1 to P in "
          "float32 in case %s: its mean error is %.3g of K1's"
          % (m["name"], ratio))
    check(all(same), "repeated flash_fwd_splitp launches differ in case %s"
          % m["name"])
    return {"qs": qs, "err_sp": err["split-P"][0]}


def time_case(torch, att, m):
    """K1, K2, K3 (and for bf16 the split-P K1 on the pre-scaled q) of one
    timed case beside their bounds (counted at the real d: columns padded
    to the kernels' width are waste), the plain versions and SDPA.  Returns
    the rows keyed by kernel name."""
    from mxnet_tpu_torch.kernels import SOURCES

    q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o", "lse",
                                                  "do", "scale"))
    b, s, h, d = q.shape
    dtype = q.dtype
    sdpa = torch.nn.functional.scaled_dot_product_attention
    delta = att._row_delta(o, do).contiguous()
    t = {"fwd": cuda_ms(lambda: att.flash_forward(q, k, v, True, scale), 20),
         "bwd_dq": cuda_ms(lambda: att.flash_bwd_dq(
             q, k, v, do, lse, delta, True, scale), 3),
         "bwd_dkv": cuda_ms(lambda: att.flash_bwd_dkv(
             q, k, v, do, lse, delta, True, scale), 3),
         "bwd": cuda_ms(lambda: att.flash_backward(
             q, k, v, o, lse, do, True, scale), 3),
         "fwd_plain": cuda_ms(lambda: plain_forward(att, q, k, v, True,
                                                    scale), 1),
         "bwd_plain": cuda_ms(lambda: plain_backward(
             att, q, k, v, o, lse, do, True, scale), 1)}
    torch.cuda.empty_cache()
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    t["fwd_lib"] = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        scale=scale), 20)
    out = sdpa(qt, kt, vt, is_causal=True, scale=scale)
    t["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 3)
    del out, qt, kt, vt
    size = torch.tensor([], dtype=dtype).element_size()
    work = {kind: attention_work(kind, b, s, s, h, d, True, size)
            for kind in ("fwd", "bwd_dq", "bwd_dkv", "bwd")}
    bound = {kind: bound_ms(torch, w, dtype, products=True)
             for kind, w in work.items()}
    tflops = {kind: work[kind][0] / (t[kind] * 1e-3) / 1e12 for kind in work}
    pair = t["bwd_dq"] + t["bwd_dkv"]
    ops14 = work["bwd_dq"][0] + work["bwd_dkv"][0]
    two = att.kernel_width(d) > 128
    print("kernel timing [%s] b=%d s=%d h=%d d=%d (runs at width %d) causal: "
          "K1 %.4f ms (plain %.4f, sdpa fwd %.4f, %.2fx it, bound %.4f by %s, "
          "%.2f TFLOP/s on the 4·d count at the real d); K2 %.4f ms (bound "
          "%.4f by %s); K3 %.4f ms%s (bound %.4f by %s); K2+K3 %.4f ms "
          "(%.2f TFLOP/s on the 14·d count, split kernels' bound %.4f ms; "
          "%.2f TFLOP/s on the 10·d count), %.2fx sdpa bwd %.4f ms; "
          "flash_backward with Δ %.4f ms (bound %.4f by %s), plain %.4f ms"
          % (m["name"], b, s, h, d, att.kernel_width(d), t["fwd"],
             t["fwd_plain"], t["fwd_lib"], t["fwd"] / t["fwd_lib"],
             bound["fwd"][0], bound["fwd"][1], tflops["fwd"], t["bwd_dq"],
             bound["bwd_dq"][0], bound["bwd_dq"][1], t["bwd_dkv"],
             " (two launches: dV, then dK)" if two else "",
             bound["bwd_dkv"][0], bound["bwd_dkv"][1], pair,
             ops14 / (pair * 1e-3) / 1e12,
             bound_ms(torch, (ops14, 0.0), dtype, products=True)[0],
             work["bwd"][0] / (pair * 1e-3) / 1e12, pair / t["bwd_lib"],
             t["bwd_lib"], t["bwd"], bound["bwd"][0], bound["bwd"][1],
             t["bwd_plain"]), flush=True)
    if dtype == torch.float32:
        # the share of the 3xTF32 bound beside that of the CUDA-core bound
        # the tables used before the float32 backward took the tensor cores
        old = {kind: bound_ms(torch, w, dtype, products=True,
                              cuda_cores=True)[0] for kind, w in work.items()}
        print("kernel timing [%s] share of the bound by operations (3xTF32) "
              "/ by the float32 CUDA-core peak: K1 %.1f%% / %.1f%%, K2 %.1f%% "
              "/ %.1f%%, K3 %.1f%% / %.1f%%, K2+K3 %.1f%% / %.1f%%" % (
                  m["name"], *(100 * x for kind in ("fwd", "bwd_dq",
                                                    "bwd_dkv")
                               for x in (bound[kind][0] / t[kind],
                                         old[kind] / t[kind])),
                  100 * (bound["bwd_dq"][0] + bound["bwd_dkv"][0]) / pair,
                  100 * (old["bwd_dq"] + old["bwd_dkv"]) / pair), flush=True)

    def row(name, kind, err, plain, lib, ms=None):
        return {"name": name, "route": "cuda",
                "source": SOURCE_DIR + SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": err, "ms": t[kind] if ms is None else ms,
                "plain_ms": plain, "bound_ms": bound[kind][0],
                "bound_by": bound[kind][1], "library_ms": lib}

    errs = m["errs"]
    rows = {
        "flash_fwd": row("flash_fwd", "fwd", m["err_o"], t["fwd_plain"],
                         t["fwd_lib"]),
        # one library call computes dQ, dK and dV together: SDPA's backward
        # is the yardstick of both rows, against K2 + K3
        "flash_bwd_dq": row("flash_bwd_dq", "bwd_dq", errs["dq"][0],
                            t["bwd_plain"], t["bwd_lib"]),
        "flash_bwd_dkv": row("flash_bwd_dkv", "bwd_dkv",
                             max(errs["dk"][0], errs["dv"][0]),
                             t["bwd_plain"], t["bwd_lib"]),
    }
    if dtype == torch.bfloat16:
        qs = m["qs"]
        ms = cuda_ms(lambda: att.flash_forward(qs, k, v, True, 1.0,
                                               split_p=True), 20)
        k1_ms = cuda_ms(lambda: att.flash_forward(qs, k, v, True, 1.0), 20)
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, k, v))
        lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=1.0), 20)
        plain = cuda_ms(lambda: plain_forward(att, qs, k, v, True, 1.0), 1)
        # split-P issues 6·d operations per visible pair (P_hi V and P_lo
        # V), where the function needs 4·d
        print("kernel timing [%s] flash_fwd_splitp on the pre-scaled q: %.4f "
              "ms (%.2f TFLOP/s on the 4·d count, %.2f on the 6·d count it "
              "issues: bounds %.4f / %.4f ms), K1 on the same inputs %.4f ms "
              "(%+.1f%%), sdpa fwd at scale 1 %.4f ms (%.2fx it), plain %.4f "
              "ms" % (m["name"], ms, work["fwd"][0] / (ms * 1e-3) / 1e12,
                      1.5 * work["fwd"][0] / (ms * 1e-3) / 1e12,
                      bound["fwd"][0],
                      bound_ms(torch, (1.5 * work["fwd"][0], work["fwd"][1]),
                               dtype)[0], k1_ms, 100 * (ms / k1_ms - 1), lib,
                      ms / lib, plain), flush=True)
        rows["flash_fwd_splitp"] = row("flash_fwd_splitp", "fwd",
                                       m["err_sp"], plain, lib, ms)
        del qt, kt, vt
    return rows


def tma_rule_check(torch, att, m):
    """A bf16 view that breaks the TMA rule raises ``MXNetError`` without a
    launch (no copy, no fallback), in the forward and in the backward."""
    from mxnet_tpu_torch import MXNetError, kernels

    q, k, v, o, lse, do, scale = (m[x] for x in ("q", "k", "v", "o", "lse",
                                                  "do", "scale"))
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    shifted = flat[1:].view(q.shape)  # base 2 bytes past a 16-byte boundary
    for what, call in (
            ("flash_fwd", lambda: att.flash_forward(shifted, k, v, True,
                                                    scale)),
            ("flash_bwd", lambda: att.flash_backward(shifted, k, v, o, lse,
                                                     do, True, scale))):
        before = dict(kernels.LAUNCHES)
        try:
            call()
            raised = ""
        except MXNetError as e:
            raised = str(e)
        print("kernel %s bf16 with a misaligned q view raises: %s"
              % (what, raised[:160]), flush=True)
        check("TMA" in raised and kernels.LAUNCHES == before,
              "a misaligned bf16 view did not raise before any %s launch"
              % what)


def plain_forward(att, q, k, v, causal, scale):
    """``attention_reference`` one batch element and at most 16 heads at a
    time, so that its float32 score tensors stay near 1 GB at s = 4096."""
    import torch

    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(b):
        for j in range(0, h, 16):
            cut = (slice(i, i + 1), slice(None), slice(j, j + 16))
            o[cut], part = att.attention_reference(q[cut], k[cut], v[cut],
                                                   causal, scale)
            lse[i, j:j + 16] = part
    return o, lse.view(b * h, sq)


def plain_backward(att, q, k, v, o, lse, do, causal, scale):
    """``attention_backward_reference`` in the pieces of ``plain_forward``."""
    import torch

    b, sq, h, _ = q.shape
    lse3 = lse.view(b, h, sq)
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    for i in range(b):
        for j in range(0, h, 16):
            cut = (slice(i, i + 1), slice(None), slice(j, j + 16))
            parts = att.attention_backward_reference(
                q[cut], k[cut], v[cut], o[cut],
                lse3[i, j:j + 16].contiguous(), do[cut], causal, scale)
            for g, part in zip(grads, parts):
                g[cut] = part
    return grads


def ptxas_report(tag, log):
    """Print ptxas's registers, shared memory, spills and wgmma notes from
    a build log; returns its faults: a spill, and wgmmas that ptxas
    serialized (each product then waits for the one before it)."""
    faults = []
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or \
                "Compiling entry" in line or "setmaxnreg" in line or \
                "wgmma" in line:
            print("  ptxas %s: %s" % (tag, line.strip()), flush=True)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills and spills.groups() != ("0", "0"):
            faults.append("a kernel of %s spills registers: %s"
                          % (tag, line.strip()))
        if "instructions are serialized" in line:
            faults.append("ptxas serialized the wgmmas of a kernel of %s: %s"
                          % (tag, line.strip()))
    return faults


def fwd_entry(lib):
    """``mxtt_flash_fwd`` of another build of flash_fwd.cu, with its
    argument types."""
    import ctypes

    fn = lib.mxtt_flash_fwd
    fn.argtypes = ([ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def extra_forward(torch, att, fn, q, k, v, scale, split_p):
    """The causal bf16 forward through another build's ``mxtt_flash_fwd``
    (``fwd_entry``).  Not counted in ``LAUNCHES``: these launches only
    compare."""
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    strides = att._strides(q, k, v)
    err = fn(1, d, att.kernel_width(d), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq,
             k.shape[1], strides.data_ptr(),
             float(scale) * att._LOG2E, 1, int(split_p),
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, "flash_fwd build entry failed (cudaError %d)" % err)
    return o, lse


def in_turns(torch, calls, rounds=8, reps=10):
    """Device ms of each named call, timed in turns: ``rounds`` passes over
    the calls, in order and in reverse by turns, ``reps`` launches each per
    pass (the card's clock moves with its power draw over a pass).  Returns
    {name: (median ms, [the readings])}."""
    got = {name: [] for name, _ in calls}
    for r in range(rounds):
        for name, fn in (calls if r % 2 == 0 else calls[::-1]):
            got[name].append(cuda_ms(fn, reps))
    return {name: (float(np.median(v)), v) for name, v in got.items()}


def parent_lines(torch, att, parents, m):
    """K1 and split-P on one bf16 case against other builds of
    flash_fwd.cu (``--parent-csrc``, {label: entry}): the same bits (fatal
    for K1; printed for split-P) and the times in turns (each build and
    this one, in order and in reverse by turns)."""
    q, qs, k, v, scale = m["q"], m["qs"], m["k"], m["v"], m["scale"]
    b, s, h, d = q.shape
    flops = attention_work("fwd", b, s, s, h, d, True, 2)[0]
    for split, qq, sc in ((False, q, scale), (True, qs, 1.0)):
        what = "split-P" if split else "K1"
        mine = att.flash_forward(qq, k, v, True, sc, split_p=split)
        calls = [("this", lambda: att.flash_forward(qq, k, v, True, sc,
                                                    split_p=split))]
        same = {}
        for label, fn in parents.items():
            theirs = extra_forward(torch, att, fn, qq, k, v, sc, split)
            torch.cuda.synchronize()
            same[label] = torch.equal(mine[0], theirs[0]) and \
                torch.equal(mine[1], theirs[1])
            del theirs
            calls.append((label, lambda fn=fn: extra_forward(
                torch, att, fn, qq, k, v, sc, split)))
        del mine
        times = in_turns(torch, calls)
        this = times["this"][0]
        for label, (ms, runs) in times.items():
            print("kernel parent [%s] %s %s: %.4f ms (median of %s), %+.1f%% "
                  "against this, %.2f TFLOP/s on the 4·d count%s%s" % (
                      m["name"], what, label, ms,
                      " / ".join("%.4f" % x for x in runs),
                      100 * (ms / this - 1), flops / (ms * 1e-3) / 1e12,
                      ", %.2f on the 6·d count" % (
                          1.5 * flops / (ms * 1e-3) / 1e12) if split else "",
                      "" if label == "this" else
                      "; o, lse this build's bits %s" % same[label]),
                  flush=True)
        if not split:
            check(all(same.values()), "K1 does not give the bits of the "
                  "builds %s in case %s" % (
                      sorted(k for k, v in same.items() if not v), m["name"]))


def sass_mma(paths):
    """Tensor-core instructions per attention kernel in the libraries at
    ``paths``, from ``cuobjdump -sass``: {(kernel, template args): count},
    the args as a tuple of ints (width D, then for K1 in bf16 split-P,
    for K3 its outputs).  A
    count is of HGMMA (wgmma) or HMMA (mma.sync), whichever the kernel
    issues."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts, key = {}, None
    for path in paths:
        sass = subprocess.run([tool, "-sass", path],
                              capture_output=True, text=True,
                              check=True).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                found = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)"
                                  r"(?:_tc|_tf32)?_kernel)I((?:L[a-z]\d+E)+)E",
                                  line)
                key = (found.group(1), tuple(
                    int(a) for a in re.findall(r"L[a-z](\d+)E",
                                               found.group(2)))) \
                    if found else None
                if key:
                    counts[key] = 0
            elif key and ("HGMMA" in line or "HMMA" in line):
                counts[key] += 1
    return counts


def ulps(torch, got, ref):
    """Largest distance in units in the last place between two float32 or
    bf16 tensors of one dtype (0 = the same bits; +0 and -0 are equal)."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[ref.dtype]
    top = -(2 ** (8 * ref.element_size() - 1))

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i >= 0, i, top - i)

    return int((ordered(got) - ordered(ref)).abs().max().item())


def elementwise_bound(torch, n, nbytes_per, flops_per, dtype):
    """bound_ms of an elementwise pass over ``n`` elements."""
    return bound_ms(torch, (float(flops_per) * n, float(nbytes_per) * n),
                    dtype)


def axpy_cases(torch, randn, wide_only=False):
    """(what, shape, x, y) of the axpy checks: a ragged shape and WIDE,
    contiguous (the 16-byte vector loop), then at the width WIDE an odd
    column count and x a view one float past a 16-byte boundary (every
    row by the scalar loop)."""
    shapes = (WIDE,) if wide_only else ((1000, 777), WIDE)
    for shape in shapes:
        yield "contiguous", shape, randn(shape), randn(shape)
    odd = (WIDE[0], WIDE[1] - 1)
    yield "odd columns", odd, randn(odd), randn(odd)
    flat = randn((WIDE[0] * WIDE[1] + 1,))
    yield "misaligned view", WIDE, flat[1:].view(WIDE), randn(WIDE)


def rtc_kernel_phase(torch, mt, device, parents=None):
    """The user kernels (``rtc_kernels``, compiled by MXRtc with NVRTC)
    against their plain versions: axpy exactly (its FMA rounds as 2·x + y
    does; an odd column count and a misaligned view included), sgd_update
    exactly or within 1 float32 ulp, gelu within 1 bf16 ulp and, in
    float32, within 1e-6 of max |ref|; then timed at WIDE (axpy also on
    its odd and misaligned cases), each in turns with its plain version
    and its library call (medians of 8 interleaved rounds), and axpy with
    the axpy of each ``parents`` entry ({label: (CUDA body, dims
    function)}, ``--parent-rtc``), which must give the same bits.
    Returns the rows of axpy, gelu_fwd and gelu_bwd."""
    from mxnet_tpu_torch import rtc_kernels as rk

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)

    def randn(shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    err = {}
    for what, shape, x, y in axpy_cases(torch, randn):
        out = torch.empty(shape, device=device)
        rk.axpy(x, y, out)
        ref = rk.axpy_plain(x, y)
        d = ulps(torch, out, ref)
        print("kernel rtc:axpy %s f32 %s (x base %% 16 = %d), grid/block %s: "
              "%d ulps from plain (tolerance 0)"
              % (shape, what, x.data_ptr() % 16, rk.axpy_dims(shape), d),
              flush=True)
        check(d == 0, "rtc:axpy disagrees with its plain version at %s %s"
              % (shape, what))
        if what == "contiguous" and shape == WIDE:
            err["axpy"] = (d, (out - ref).abs().max().item())
        del x, y, out, ref
    for wd in (0.0, SGD["wd"]):
        w, g = randn((100003,), 0.02), randn((100003,))
        ref = w.clone()
        hp = rk.sgd_hyper(SGD["lr"], SGD["rescale_grad"], wd, device)
        for _ in range(2):
            rk.sgd_update(w, g, hp)
            mt.nd.sgd_update(ref, g, out=ref, lr=SGD["lr"],
                             rescale_grad=SGD["rescale_grad"], wd=wd)
        d = ulps(torch, w, ref)
        print("kernel rtc:sgd_update (100003,) f32 wd=%g, 2 in-place pushes: "
              "%d ulps from the port's sgd_update" % (wd, d), flush=True)
        check(d <= 1, "rtc:sgd_update disagrees with sgd_update")
    for shape, dtype in (((3001, 517), f32), ((3001, 517), bf16),
                         (WIDE, f32), (WIDE, bf16)):
        x, dy = randn(shape, 3.0, dtype), randn(shape, 1.0, dtype)
        got = (rk.gelu_forward(x), rk.gelu_backward(x, dy))
        ref = (rk.gelu_plain(x), rk.gelu_grad_plain(x, dy))
        for name, a, b in zip(("gelu_fwd", "gelu_bwd"), got, ref):
            d = ulps(torch, a, b)
            rel = ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            print("kernel rtc:%s %s %s: %d ulps, max|err|/max|ref| %.3g "
                  "(tolerance %s)" % (name, shape, str(dtype)[6:], d, rel,
                                      "1 ulp" if dtype == bf16 else "1e-6"),
                  flush=True)
            check(d <= 1 if dtype == bf16 else rel <= 1e-6,
                  "rtc:%s disagrees with its plain version at %s %s"
                  % (name, shape, dtype))
            if shape == WIDE and dtype == bf16:
                err[name] = (d, (a.float() - b.float()).abs().max().item())
        del x, dy, got, ref
    # gelu_fwd and gelu_bwd where their 16-byte vector loops do not reach:
    # an odd length (the scalar tail) and contiguous views one element (2
    # bytes in bf16, 4 in float32) past a 16-byte boundary (every element
    # by the scalar loop)
    for dtype in (bf16, f32):
        flat = randn((WIDE[0] * WIDE[1] + 1,), 3.0, dtype)
        flat_dy = randn((WIDE[0] * WIDE[1] + 1,), 1.0, dtype)
        for what, x, dy in (("odd length", flat, flat_dy),
                            ("misaligned view", flat[1:], flat_dy[1:])):
            for name, got, ref in (
                    ("gelu_fwd", rk.gelu_forward(x), rk.gelu_plain(x)),
                    ("gelu_bwd", rk.gelu_backward(x, dy),
                     rk.gelu_grad_plain(x, dy))):
                d = ulps(torch, got, ref)
                rel = ((got.float() - ref.float()).abs().max()
                       / ref.float().abs().max()).item()
                print("kernel rtc:%s %s %s (%d elements, base %% 16 = %d): "
                      "%d ulps, max|err|/max|ref| %.3g (tolerance %s)"
                      % (name, str(dtype)[6:], what, x.numel(),
                         x.data_ptr() % 16, d, rel,
                         "1 ulp" if dtype == bf16 else "1e-6"), flush=True)
                check(d <= 1 if dtype == bf16 else rel <= 1e-6,
                      "rtc:%s disagrees with its plain version on the %s %s"
                      % (name, str(dtype)[6:], what))
                del got, ref
        del flat, flat_dy, x, dy
    torch.cuda.empty_cache()

    # each route refuses the other device, and NVRTC's log reaches the user
    arr = mt.nd.zeros((4,))
    for what, src, want in (
            ("a CUDA body that does not compile", "out[0] = no_such_name;",
             "no_such_name"),
            ("a Python source on CUDA arrays", AXPY_PY_SRC, "CPU arrays only")):
        try:
            mt.rtc.MXRtc("probe", [("x", arr)], [("out", arr)], src).push(
                [arr], [arr])
            raised = ""
        except mt.MXNetError as e:
            raised = str(e)
        print("kernel rtc: %s raises: %s" % (what, raised.splitlines()[:3]),
              flush=True)
        check(want in raised, "%s did not raise as it should" % what)

    # every user kernel is timed in turns with its plain version and its
    # library call (medians of 8 interleaved rounds): read alone, one
    # after another, axpy's time moved from call to call while
    # torch.add's did not
    n = WIDE[0] * WIDE[1]
    t = {}
    for what, shape, x, y in axpy_cases(torch, randn, wide_only=True):
        out = torch.empty(shape, device=device)
        calls = [("kernel", lambda: rk.axpy(x, y, out)),
                 ("plain", lambda: rk.axpy_plain(x, y)),
                 ("library", lambda: torch.add(y, x, alpha=2.0))]
        for label, (body, dims) in (parents or {}).items():
            theirs = torch.empty(shape, device=device)
            krnl = mt.rtc.MXRtc("axpy_parent", [("x", x), ("y", y)],
                                [("out", theirs)], body)
            grid, block = dims(shape)
            krnl.push([x, y], [theirs], grid, block)
            d = ulps(torch, theirs, rk.axpy_plain(x, y))
            print("kernel parent [%s] rtc:axpy %s f32 %s: %d ulps from "
                  "plain" % (label, shape, what, d), flush=True)
            check(d == 0, "the axpy of %s disagrees with plain" % label)
            calls.append((label, lambda k=krnl, o=theirs, g=grid, b=block:
                          k.push([x, y], [o], g, b)))
        med = in_turns(torch, calls)
        times = (med["kernel"][0], med["plain"][0], med["library"][0],
                 elementwise_bound(torch, x.numel(), 12, 2, f32))
        for label in parents or ():
            print("kernel parent [%s] rtc:axpy %s f32 %s: %.4f ms (median "
                  "of %s), this %.4f ms (%s), %+.1f%% against this; "
                  "torch.add %.4f" % (
                      label, shape, what, med[label][0],
                      " / ".join("%.4f" % v for v in med[label][1]),
                      times[0], " / ".join("%.4f" % v
                                            for v in med["kernel"][1]),
                      100 * (med[label][0] / times[0] - 1), times[2]),
                  flush=True)
        if what == "contiguous":
            t["axpy"] = times
        else:
            print("kernel timing rtc:axpy %s f32 %s: %.4f ms (plain %.4f, "
                  "library %.4f, bound %.4f by %s)"
                  % ((shape, what) + times[:3] + times[3]), flush=True)
        del x, y, out, calls
    x, dy = randn(WIDE, 3.0, bf16), randn(WIDE, 1.0, bf16)
    gelu_bwd_lib = torch.ops.aten.gelu_backward
    med = in_turns(torch, [
        ("fwd", lambda: rk.gelu_forward(x)),
        ("fwd plain", lambda: rk.gelu_plain(x)),
        ("fwd library", lambda: torch.nn.functional.gelu(x)),
        ("bwd", lambda: rk.gelu_backward(x, dy)),
        ("bwd plain", lambda: rk.gelu_grad_plain(x, dy)),
        ("bwd library", lambda: gelu_bwd_lib(dy, x))])
    for name, nbytes, ops in (("fwd", 4, 5), ("bwd", 6, 12)):
        t["gelu_" + name] = tuple(med[name + part][0] for part in
                                  ("", " plain", " library")) + (
            elementwise_bound(torch, n, nbytes, ops, f32),)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print("kernel rtc:gelu_fwd and gelu_bwd %s bf16 launch dims (grid, "
          "block) %s on %d SMs" % (WIDE, rk.gelu_dims(n, 2, sms), sms),
          flush=True)
    del x, dy
    x, dy = randn(WIDE, 3.0), randn(WIDE)
    med = in_turns(torch, [
        ("fwd", lambda: rk.gelu_forward(x)),
        ("bwd", lambda: rk.gelu_backward(x, dy)),
        ("library", lambda: torch.nn.functional.gelu(x))])
    print("kernel timing rtc:gelu_fwd/bwd %s f32: %.4f / %.4f ms (bounds "
          "%.4f / %.4f by bytes; F.gelu %.4f ms)" % (
              WIDE, med["fwd"][0], med["bwd"][0],
              elementwise_bound(torch, n, 8, 5, f32)[0],
              elementwise_bound(torch, n, 12, 12, f32)[0],
              med["library"][0]), flush=True)
    del x, dy
    torch.cuda.empty_cache()
    rows = []
    for name, replaces in (("axpy", "mxnet_tpu/rtc.py:81"),
                           ("gelu_fwd", "mxnet_tpu/ops/pallas_op.py:33"),
                           ("gelu_bwd", "mxnet_tpu/ops/pallas_op.py:33")):
        ms, plain, lib, (bound, by) = t[name]
        print("kernel timing rtc:%s %s %s: %.4f ms (plain %.4f, library "
              "%.4f, bound %.4f by %s: %.1f%% of it)"
              % (name, WIDE, "f32" if name == "axpy" else "bf16", ms, plain,
                 lib, bound, by, 100 * bound / ms), flush=True)
        rows.append({"name": "rtc:" + name, "route": "cuda",
                     "source": RTC_SOURCE, "replaces": replaces,
                     "launches": None, "max_abs_err": err[name][1],
                     "ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib})
    return rows


def lm_params(mt, sym, shapes, rng, std):
    """Random LM weights from numpy: N(0, std) matrices and embeddings,
    unit LayerNorm gains, zero biases and shifts.  CPU NDArrays keyed as a
    checkpoint stores them."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            arr = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32)
            arr *= std
        params["arg:" + name] = mt.nd.array(arr, mt.cpu())
    return params


#: the serve phase's steady ms per request, printed beside phase 20's
SERVE_READINGS = {}

# the label is bound too (as zeros): its shape cannot be inferred back
# through the symbol's Reshape, in this package or the JAX one
SERVE_SHAPES = {"data": (BATCH, FULL["seq_len"]),
                "softmax_label": (BATCH, FULL["seq_len"])}


#: serve_inputs' draws by the net's argument names: the serve and splash
#: phases share one draw of the 441M weights (main clears it after them)
SERVE_INPUTS = {}
SERVE_INPUTS_LOCK = threading.Lock()


def serve_inputs(mt, net):
    """The served LM's weights (N(0, 0.02) from SEED, as a checkpoint
    stores them) and its requests, the same for every LM of the full
    geometry whatever its attention op.  Drawn once a process for each
    list of argument names; the callers only read them."""
    key = tuple(net.list_arguments())
    with SERVE_INPUTS_LOCK:
        if key not in SERVE_INPUTS:
            rng = np.random.default_rng(SEED)
            params = lm_params(mt, net, SERVE_SHAPES, rng, 0.02)
            requests = [rng.integers(0, FULL["vocab_size"],
                                     SERVE_SHAPES["data"])
                        .astype(np.float32) for _ in range(REQUESTS)]
            SERVE_INPUTS[key] = params, requests
        return SERVE_INPUTS[key]


def serve_checkpoint(mt, net, folder):
    """The serve phase's checkpoint of ``net`` (serve_inputs' weights)
    written in ``folder``; main runs it on a thread beside the build.
    Returns its prefix, the requests, the parameter count and the seconds
    it took."""
    t0 = time.perf_counter()
    prefix = os.path.join(folder, "lm")
    params, requests = serve_inputs(mt, net)
    n_params = sum(p.size for p in params.values())
    net.save(prefix + "-symbol.json")
    mt.nd.save(prefix + "-0000.params", params)
    return prefix, requests, n_params, time.perf_counter() - t0


def serve_phase(torch, mt, ckpt):
    """Loads ``ckpt`` (``serve_checkpoint``'s result) into a Predictor and
    serves its requests; removes the checkpoint's folder.  Returns the
    Predictor, the first request and its output (on the host)."""
    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    shapes = SERVE_SHAPES
    prefix, requests, n_params, written_s = ckpt
    try:
        t1 = time.perf_counter()
        pred = mt.Predictor.from_checkpoint(prefix, 0, shapes)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(os.path.dirname(prefix), ignore_errors=True)
    print("serve: %d parameters; checkpoint written in %.2f s (beside the "
          "build), Predictor built in %.2f s" % (n_params, written_s,
                                                 t2 - t1), flush=True)

    per_request = FULL["num_layers"]  # one attention per layer
    torch.cuda.reset_peak_memory_stats()
    times = []
    mt.kernels.reset_launches()
    for i, tokens in enumerate(requests):
        before = mt.kernels.LAUNCHES["flash_fwd"]
        t0 = time.perf_counter()
        out = pred.forward(data=tokens)[0]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = mt.kernels.LAUNCHES["flash_fwd"] - before
        probs = out._data
        check(out.context == mt.gpu(0) and probs.is_cuda,
              "request %d answered on %s, not the card" % (i, out.context))
        check(out.shape == (b * s, vocab), "request %d output shape %s"
              % (i, out.shape))
        check(torch.isfinite(probs).all().item(),
              "request %d output has non-finite values" % i)
        row_err = (probs.sum(dim=-1) - 1).abs().max().item()
        check(row_err <= 1e-4, "request %d rows sum to 1 only within %.3g"
              % (i, row_err))
        check(delta == per_request, "request %d launched flash_fwd %d "
              "times, expected %d" % (i, delta, per_request))
        print("serve: request %d: %.2f ms, flash_fwd launches %d, rows sum "
              "to 1 within %.2g" % (i, times[-1] * 1e3, delta, row_err),
              flush=True)
        if i == 0:
            first = probs.cpu()
    launches = dict(mt.kernels.LAUNCHES)
    check(launches["flash_fwd"] > 0, "the serving path never launched "
          "flash_fwd")
    steady = float(np.mean(times[1:]))
    SERVE_READINGS["steady_ms"] = steady * 1e3
    print("serve: %d requests of %d tokens; first %.2f ms, then %.2f ms per "
          "request = %.1f tokens/s; peak device memory %.2f GB; launches %s"
          % (REQUESTS, b * s, times[0] * 1e3, steady * 1e3, b * s / steady,
             torch.cuda.max_memory_allocated() / 1e9, launches), flush=True)
    return pred, requests[0], first


def step_paths(torch, mod, batch):
    """Step ms and peak device memory of the two ways ``Module`` trains at
    the train phase's shapes: the fused step (``forward_backward`` defers
    the batch, ``update`` runs ``Executor.fused_step``) and the two-phase
    path (the executor group's ``forward_backward`` writes ``grad_dict``,
    then ``update`` runs the updater over it).  Blocks of one warm-up and
    two timed steps, in the order fused, two-phase, two-phase, fused."""
    def fused():
        mod.forward_backward(batch)
        mod.update()

    def two_phase():
        mod._exec_group.forward_backward(batch)
        mod.update()

    got = {"fused": [], "two-phase": []}
    for name, step in (("fused", fused), ("two-phase", two_phase),
                       ("two-phase", two_phase), ("fused", fused)):
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        got[name].append(((time.perf_counter() - t0) / 2 * 1e3,
                          torch.cuda.max_memory_allocated() / 1e9))
    for name, blocks in got.items():
        print("train: %s path: step ms %s, peak device memory GB %s"
              % (name, ["%.2f" % ms for ms, _ in blocks],
                 ["%.3f" % gb for _, gb in blocks]), flush=True)


def lm_loss(torch, probs, labels):
    """Mean cross-entropy of the SoftmaxOutput probabilities (an NDArray
    [n, classes]) against the labels (next tokens, or an image's class), in
    float32."""
    p = probs._data.float()
    lab = torch.as_tensor(labels.reshape(-1), device=p.device).long()
    picked = p.gather(1, lab[:, None]).squeeze(1)
    return -picked.clamp_min(1e-30).log().mean().item()


def train_module(mt, net, ctx, data_shape, init=None, arg_params=None,
                 compute_dtype=None, optimizer_params=None, optimizer="adam",
                 kvstore="local"):
    """A bound, initialized ``Module`` with adam (or ``optimizer``), as
    ``train_lm.benchmark`` sets it up."""
    mod = mt.mod.Module(net, label_names=("softmax_label",), context=ctx,
                        compute_dtype=compute_dtype)
    mod.bind(data_shapes=[mt.io.DataDesc("data", data_shape)],
             label_shapes=[mt.io.DataDesc("softmax_label", data_shape)],
             for_training=True)
    mod.init_params(initializer=init, arg_params=arg_params)
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                       optimizer_params=optimizer_params or
                       {"learning_rate": TRAIN_LR})
    return mod


def train_phase(torch, mt):
    """The slice's main path: a full-width train loop through Module."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    # examples/transformer/train_lm.py::_synth_iter, one batch
    rng = np.random.RandomState(SEED)
    X = rng.randint(0, vocab, size=(b, s)).astype(np.float32)
    Y = (X + 1) % vocab
    it = mt.io.NDArrayIter(X, Y, batch_size=b, label_name="softmax_label")
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    mt.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod = train_module(mt, net, None, (b, s),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34),
                       compute_dtype="bfloat16")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ex = mod._exec_group.execs[0]
    n_params = sum(ex.arg_dict[n].size for n in mod._exec_group.param_names)
    check(all(ex.arg_dict[n]._data.is_cuda and
              ex.arg_dict[n].context == mt.gpu(0)
              for n in mod._exec_group.param_names),
          "the parameters do not live on the card")
    print("train: %d parameters on %s, bound and initialized in %.2f s"
          % (n_params, ex.arg_dict[mod._exec_group.param_names[0]].context,
             t1 - t0), flush=True)
    batch = it.next()

    per_step = FULL["num_layers"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    losses, times = [], []
    # the replay check's reference: the parameters before the first step
    # and after step REPLAY_STEPS
    init = state_snapshot(mod)[0]
    mt.kernels.reset_launches()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES[n] - before[n] for n in names}
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        print("train: step %d: %.2f ms, loss %.6f, launches %s"
              % (step, times[-1] * 1e3, losses[-1], delta), flush=True)
        check(np.isfinite(losses[-1]), "step %d loss is not finite" % step)
        check(all(v == per_step for v in delta.values()),
              "step %d launched %s, expected %d of each" % (step, delta,
                                                            per_step))
        if step + 1 == REPLAY_STEPS:
            replayed = state_snapshot(mod)[0]
    launches = dict(mt.kernels.LAUNCHES)
    check(launches["flash_fwd_splitp"] == 0, "the flash LM launched the "
          "split-P forward")
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)
    check(all(ex.arg_dict[n]._data.is_cuda
              for n in mod._exec_group.param_names),
          "the parameters left the card")
    steady = float(np.mean(times[TRAIN_WARMUP:]))
    print("train: step ms %.2f (mean of %d timed steps after %d warm-up; "
          "before the list update: %.2f)"
          % (steady * 1e3, TRAIN_STEPS, TRAIN_WARMUP, BEFORE_MS["train"]),
          flush=True)
    print("train: tokens/s %.1f" % (b * s / steady), flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("train: peak device memory %.2f GB (before the list update: %.2f)"
          % (peak_gb, BEFORE_TRAIN_PEAK_GB), flush=True)
    print("train: loss %.6f -> %.6f over %d steps on one batch; launches %s"
          % (losses[0], losses[-1], len(losses), launches), flush=True)
    replay = {"net": net, "init": init, "after": replayed,
              "losses": losses[:REPLAY_STEPS], "Y": Y,
              "step_ms": steady * 1e3, "peak_gb": peak_gb}
    return mod, batch, launches, losses, steady * 1e3, replay


def train_f32_phase(torch, mt, batch, Y, bf16_losses, profile_dir=None):
    """The train phase's LM, init and batch with ``compute_dtype`` left at
    its float32 default, as a user who does not ask for bf16 trains: adam
    at lr 3e-4, F32_WARMUP + F32_STEPS steps; each step launches K1, K2
    and K3 (the split-TF32 backward) once per layer, and the loss falls.
    Neither TF32 flag of PyTorch may be on: the GEMMs run in float32.
    Returns the launch counts."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s = BATCH, FULL["seq_len"]
    flags = {"torch.backends.cuda.matmul.allow_tf32":
             torch.backends.cuda.matmul.allow_tf32,
             "torch.backends.cudnn.allow_tf32":
             torch.backends.cudnn.allow_tf32}
    print("train f32: %s" % flags, flush=True)
    check(not any(flags.values()), "a TF32 flag is on: the float32 step's "
          "GEMMs would not run in float32")
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    mt.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    mod = train_module(mt, net, None, (b, s),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34))
    ex = mod._exec_group.execs[0]
    check(all(ex.arg_dict[n]._data.dtype == torch.float32
              for n in mod._exec_group.param_names),
          "the float32 Module holds parameters of another dtype")
    per_step = FULL["num_layers"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    losses, times = [], []
    mt.kernels.reset_launches()
    for step in range(F32_WARMUP + F32_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES[n] - before[n] for n in names}
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        print("train f32: step %d: %.2f ms, loss %.6f (bf16 step %.6f), "
              "launches %s" % (step, times[-1] * 1e3, losses[-1],
                               bf16_losses[step], delta), flush=True)
        check(np.isfinite(losses[-1]), "float32 step %d loss is not finite"
              % step)
        check(all(v == per_step for v in delta.values()),
              "float32 step %d launched %s, expected %d of each"
              % (step, delta, per_step))
    launches = dict(mt.kernels.LAUNCHES)
    check(losses[-1] < losses[0], "the float32 loss did not fall: %s"
          % losses)
    steady = float(np.mean(times[F32_WARMUP:]))
    print("train f32: step ms %.2f (mean of %d timed steps after %d "
          "warm-up)" % (steady * 1e3, F32_STEPS, F32_WARMUP), flush=True)
    print("train f32: tokens/s %.1f" % (b * s / steady), flush=True)
    print("train f32: peak device memory %.2f GB"
          % (torch.cuda.max_memory_allocated() / 1e9), flush=True)
    print("train f32: loss %.6f -> %.6f over %d steps; launches %s"
          % (losses[0], losses[-1], len(losses), launches), flush=True)
    if profile_dir:
        def step():
            mod.forward_backward(batch)
            mod.update()
        got = profile(torch, step, profile_dir, "train_step_f32")
        names = [n for group in ("K1 flash_fwd", "K2 flash_bwd_dq",
                                 "K3 flash_bwd_dkv")
                 for n in sorted(got.get(group, ()))]
        print("profile train_step_f32: K1/K2/K3 kernels %s" % names,
              flush=True)
        check(len(names) == 3 and all("_tf32_kernel<128" in n
                                      for n in names),
              "the float32 step's K1/K2/K3 are not the split-TF32 kernels")
    del mod, ex
    torch.cuda.empty_cache()
    return launches


def replay_phase(torch, mt, batch, replay):
    """The train phase's first REPLAY_STEPS steps again, from its initial
    parameters and its batch, in a new Module: every loss and every
    parameter must be the same bits.  Then once more under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the ops
    it warns about are the step's ops that have no deterministic CUDA
    implementation, and that run must give the same bits too."""
    import warnings

    b, s = BATCH, FULL["seq_len"]
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    for mode in ("default", "deterministic"):
        mod = train_module(mt, replay["net"], None, (b, s), arg_params=init,
                           compute_dtype="bfloat16")
        losses = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if mode == "deterministic":
                torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for _ in range(REPLAY_STEPS):
                    mod.forward_backward(batch)
                    mod.update()
                    torch.cuda.synchronize()
                    losses.append(lm_loss(torch, mod.get_outputs()[0],
                                          replay["Y"]))
            finally:
                torch.use_deterministic_algorithms(False)
        after = state_snapshot(mod)[0]
        differ = sorted(n for n, t in after.items()
                        if not torch.equal(t, replay["after"][n]))
        alerts = sorted({str(w.message).split("\n")[0][:160]
                         for w in caught
                         if "deterministic" in str(w.message)})
        print("replay (%s): %d steps from the train phase's init and batch: "
              "losses %s vs %s, bitwise equal %s; %d of %d parameters differ "
              "%s; nondeterministic-op alerts: %s"
              % (mode, REPLAY_STEPS, ["%.9g" % x for x in losses],
                 ["%.9g" % x for x in replay["losses"]],
                 losses == replay["losses"], len(differ), len(after),
                 differ[:5], alerts or "none"), flush=True)
        check(losses == replay["losses"] and not differ,
              "the bf16 train step is not reproducible (%s mode)" % mode)
        del mod, after
        torch.cuda.empty_cache()


def splash_phase(torch, mt, batch, replay, flash_losses, flash_step_ms,
                 tokens, flash_out, profile_dir=None):
    """The splash LM (``attn_impl="splash"``) at the full geometry: trained
    through Module in bf16 from the train phase's init and batch, 2 + 5
    steps, each launching K1's split-P variant, K2 and K3 once per layer
    (and the plain K1 never); its step-0 loss within 1e-3 of the flash
    LM's.  Then one float32 request on the serve phase's weights, within
    1e-4 of the flash LM's answer.  Returns the launch counts."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s = BATCH, FULL["seq_len"]
    with mt.NameManager():
        net = get_transformer_lm(attn_impl="splash", **FULL)
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    torch.cuda.reset_peak_memory_stats()
    mod = train_module(mt, net, None, (b, s), arg_params=init,
                       compute_dtype="bfloat16")
    per_step = FULL["num_layers"]
    want = {"flash_fwd_splitp": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step, "flash_fwd": 0}
    losses, times = [], []
    mt.kernels.reset_launches()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES[n] - before[n] for n in want}
        losses.append(lm_loss(torch, mod.get_outputs()[0], replay["Y"]))
        print("splash: step %d: %.2f ms, loss %.6f (flash LM %.6f), launches "
              "%s" % (step, times[-1] * 1e3, losses[-1], flash_losses[step],
                      delta), flush=True)
        check(np.isfinite(losses[-1]), "splash step %d loss is not finite"
              % step)
        check(delta == want, "splash step %d launched %s, expected %s"
              % (step, delta, want))
    launches = dict(mt.kernels.LAUNCHES)
    rel0 = abs(losses[0] - flash_losses[0]) / abs(flash_losses[0])
    steady = float(np.mean(times[TRAIN_WARMUP:]))
    print("splash: step ms %.2f (mean of %d timed steps after %d warm-up; "
          "flash LM %.2f)" % (steady * 1e3, TRAIN_STEPS, TRAIN_WARMUP,
                              flash_step_ms), flush=True)
    print("splash: tokens/s %.1f" % (b * s / steady), flush=True)
    print("splash: peak device memory %.2f GB"
          % (torch.cuda.max_memory_allocated() / 1e9), flush=True)
    print("splash: loss %.6f -> %.6f; step-0 loss relative to the flash LM's "
          "%.3g (tolerance 1e-3)" % (losses[0], losses[-1], rel0),
          flush=True)
    check(rel0 <= 1e-3, "the splash LM's step-0 loss differs from the flash "
          "LM's")
    check(losses[-1] < losses[0], "the splash LM's loss did not fall")
    if profile_dir:
        def step():
            mod.forward_backward(batch)
            mod.update()
        k1 = sorted(profile(torch, step, profile_dir, "splash_step")
                    .get("K1 flash_fwd split-P", ()))
        print("profile splash_step: K1 kernels %s" % k1, flush=True)
        check(k1 and all("flash_fwd_tc_kernel<128, true>" in n for n in k1),
              "the splash step's K1 is not flash_fwd_tc_kernel<128, true>")
    del mod, init
    torch.cuda.empty_cache()

    params, _ = serve_inputs(mt, net)
    pred = mt.Predictor(net, params, SERVE_SHAPES)
    del params
    before = mt.kernels.LAUNCHES["flash_fwd"]
    t0 = time.perf_counter()
    out = pred.forward(data=tokens)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n_fwd = mt.kernels.LAUNCHES["flash_fwd"] - before
    err = (out._data.cpu() - flash_out).abs().max().item()
    print("splash: one float32 request on the serve phase's weights: %.2f ms "
          "(first request), K1 (float32) launches %d, max|d| from the flash "
          "LM's answer %.3g (tolerance 1e-4)" % (ms, n_fwd, err), flush=True)
    check(out.context == mt.gpu(0) and n_fwd == per_step and err <= 1e-4,
          "the splash LM's served answer differs from the flash LM's")
    del pred, out
    torch.cuda.empty_cache()
    return launches


def lm_update_arrays(torch, mt, gen, device):
    """(weights, gradients) of every parameter array of the full-width LM,
    as an update loop meets them: gammas 1, betas and biases 0, the rest
    N(0, 0.02); gradients N(0, 1)."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    shape = (BATCH, FULL["seq_len"])
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    weights, grads = [], []
    for name, ashape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            w = torch.ones(ashape, device=device)
        elif name.endswith(("_beta", "_bias")):
            w = torch.zeros(ashape, device=device)
        else:
            w = torch.randn(ashape, generator=gen, device=device) * 0.02
        weights.append(w)
        grads.append(torch.randn(ashape, generator=gen, device=device))
    return weights, grads


def sgd_pass(rk, weights, grads, hp):
    """One ``rtc_kernels.sgd_update`` push per array."""
    for w, g in zip(weights, grads):
        rk.sgd_update(w, g, hp)


def sgd_host_us(torch, rk, weights, grads, hp):
    """Host µs per push: the enqueue of HOST_PASSES passes back to back,
    timed on the host clock without a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_PASSES):
        sgd_pass(rk, weights, grads, hp)
    host_us = (time.perf_counter() - t0) / (HOST_PASSES * len(weights)) * 1e6
    torch.cuda.synchronize()
    return host_us


def fused_sgd(torch, weights, grads):
    """A call of ``torch._fused_sgd_`` (the library's multi-tensor SGD) on
    copies of the arrays with the extend phase's hyperparameters."""
    lib_w = [w.clone() for w in weights]
    lib_g = [g.clone() for g in grads]
    scale = torch.tensor(1.0 / SGD["rescale_grad"], device=weights[0].device)
    return lambda: torch._fused_sgd_(
        lib_w, lib_g, [], weight_decay=SGD["wd"], momentum=0.0,
        lr=SGD["lr"], dampening=0.0, nesterov=False, maximize=False,
        is_first_step=False, grad_scale=scale)


def push_profile(torch, fn, n_pushes, what):
    """One call of ``fn`` (``n_pushes`` pushes) under cProfile: the host
    time per push by function (cProfile's own cost included, so the shares
    matter more than the sum), largest first."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])
    total = sum(v[2] for _, v in rows)
    print("extend: %s push profile (cProfile, %d pushes): %.1f us per push "
          "in all; by function, own time per push: %s" % (
              what, n_pushes, total / n_pushes * 1e6, "; ".join(
                  "%s:%d %s %.2f us (%.2g calls)" % (
                      os.path.basename(f), line, name, v[2] / n_pushes * 1e6,
                      v[1] / n_pushes)
                  for (f, line, name), v in rows[:14])), flush=True)


def extend_phase(torch, mt, train_losses, train_step_ms, profile_dir=None):
    """The user extension path at full width, with every launch count set
    to 0 before it and read after.  Returns the counts and the
    sgd_update row."""
    from mxnet_tpu_torch import rtc_kernels as rk
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    mt.kernels.reset_launches()

    # (a0) a user's imperative push: MXRtc on NDArrays, explicit 2-D dims
    x = mt.nd.NDArray(torch.randn(WIDE, generator=gen, device=device),
                      mt.gpu(0))
    y = mt.nd.ones(WIDE)
    out = mt.nd.zeros(WIDE)
    krnl = mt.rtc.MXRtc("axpy", [("x", x), ("y", y)], [("out", out)],
                        rk.AXPY_CUDA)
    grid, block = rk.axpy_dims(WIDE)
    krnl.push([x, y], [out], grid_dims=grid, block_dims=block)
    d = ulps(torch, out._data, 2.0 * x._data + 1.0)
    print("extend: axpy pushed on %s NDArrays with grid %s block %s: %d ulps "
          "from 2x + 1" % (WIDE, grid, block, d), flush=True)
    check(d == 0, "the axpy push disagrees with 2x + 1")
    del x, y, out

    # (a) sgd_update pushed over every parameter array of the LM
    weights, grads = lm_update_arrays(torch, mt, gen, device)
    n_params = sum(w.numel() for w in weights)
    refs = [w.clone() for w in weights]
    hp = rk.sgd_hyper(SGD["lr"], SGD["rescale_grad"], SGD["wd"], device)

    def plain():
        for w, g in zip(refs, grads):
            mt.nd.sgd_update(w, g, out=w, **SGD)

    t0 = time.perf_counter()
    sgd_pass(rk, weights, grads, hp)  # compiles one kernel per shape
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    plain()
    host_us = sgd_host_us(torch, rk, weights, grads, hp)
    for _ in range(HOST_PASSES):
        plain()
    passes = 1 + HOST_PASSES
    d = max(ulps(torch, w, r) for w, r in zip(weights, refs))
    check(d <= 1, "the sgd_update pushes disagree with sgd_update (%d ulps)"
          % d)
    max_abs_err = max((w - r).abs().max().item()
                      for w, r in zip(weights, refs))
    n_pushes = mt.kernels.LAUNCHES["rtc:sgd_update"]
    print("extend: sgd_update pushed over %d parameter arrays (%d parameters,"
          " %d distinct shapes compiled in %.2f s with the first pass), %d "
          "pushes counted over the passes; %d ulps from sgd_update after %d "
          "passes" % (len(weights), n_params,
                      len({tuple(w.shape) for w in weights}), first, n_pushes,
                      d, passes), flush=True)
    print("extend: sgd_update host time %.1f us per push (enqueue of %d "
          "passes back to back, not synchronized)" % (host_us, HOST_PASSES),
          flush=True)
    bound, by = elementwise_bound(torch, n_params, 12, 5, torch.float32)
    sgd_row = {"name": "rtc:sgd_update", "route": "cuda",
               "source": RTC_SOURCE, "replaces": "mxnet_tpu/rtc.py:81",
               "launches": None, "max_abs_err": max_abs_err,
               "bound_ms": bound, "bound_by": by}
    push_profile(torch, lambda: sgd_pass(rk, weights, grads, hp),
                 len(weights), "sgd_update")
    del weights, grads, refs
    torch.cuda.empty_cache()

    # (b) the train phase's LM with rtc_gelu in place of gelu
    b, s, vocab = BATCH, FULL["seq_len"], FULL["vocab_size"]
    rng = np.random.RandomState(SEED)
    X = rng.randint(0, vocab, size=(b, s)).astype(np.float32)
    Y = (X + 1) % vocab
    batch = mt.io.NDArrayIter(X, Y, batch_size=b,
                              label_name="softmax_label").next()
    with mt.NameManager():
        net = rk.with_rtc_gelu(get_transformer_lm(**FULL))
    mt.random.seed(SEED)
    mod = train_module(mt, net, None, (b, s),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34),
                       compute_dtype="bfloat16")
    per_step = FULL["num_layers"]
    names = ("rtc:gelu_fwd", "rtc:gelu_bwd", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv")
    times = []
    for step in range(EXTEND_WARMUP + EXTEND_STEPS):
        before = {n: mt.kernels.LAUNCHES.get(n, 0) for n in names}
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {n: mt.kernels.LAUNCHES.get(n, 0) - before[n] for n in names}
        loss = lm_loss(torch, mod.get_outputs()[0], Y)
        rel = abs(loss - train_losses[step]) / abs(train_losses[step])
        print("extend: rtc_gelu step %d: %.2f ms, loss %.6f (train phase "
              "%.6f, relative difference %.3g, tolerance 1e-3), launches %s"
              % (step, times[-1] * 1e3, loss, train_losses[step], rel, delta),
              flush=True)
        check(rel <= 1e-3, "step %d loss with rtc_gelu differs from the "
              "train phase's" % step)
        check(all(v == per_step for v in delta.values()),
              "step %d launched %s, expected %d of each" % (step, delta,
                                                            per_step))
    launches = dict(mt.kernels.LAUNCHES)
    if profile_dir:
        def step():
            mod.forward_backward(batch)
            mod.update()
        profile(torch, step, profile_dir, "train_step_rtc_gelu")
    steady = float(np.mean(times[EXTEND_WARMUP:])) * 1e3
    print("extend: rtc_gelu step ms %.2f (mean of %d timed steps after %d "
          "warm-up), train phase step ms %.2f (gelu)" % (
              steady, EXTEND_STEPS, EXTEND_WARMUP, train_step_ms), flush=True)
    print("extend: launches %s" % launches, flush=True)
    del mod
    torch.cuda.empty_cache()
    sgd_row.update(sgd_turns(torch, mt, rk, gen, device))
    return launches, sgd_row


def sgd_turns(torch, mt, rk, gen, device):
    """A pass of sgd_update pushes over the LM's parameter arrays, timed in
    turns with the port's sgd_update over them and ``torch._fused_sgd_``
    (as the kernel phase times the other user kernels), after the extend
    phase's launch counts are read.  Returns the row's times."""
    weights, grads = lm_update_arrays(torch, mt, gen, device)
    refs = [w.clone() for w in weights]
    hp = rk.sgd_hyper(SGD["lr"], SGD["rescale_grad"], SGD["wd"], device)

    def plain():
        for w, g in zip(refs, grads):
            mt.nd.sgd_update(w, g, out=w, **SGD)

    med = in_turns(torch, [
        ("kernel", lambda: sgd_pass(rk, weights, grads, hp)),
        ("plain", plain), ("library", fused_sgd(torch, weights, grads))])
    times = {"ms": med["kernel"][0], "plain_ms": med["plain"][0],
             "library_ms": med["library"][0]}
    print("extend: sgd_update timing in turns: %.4f ms per pass of %d "
          "pushes (%s), plain sgd_update %.4f ms, torch._fused_sgd_ %.4f ms "
          "over the same arrays" % (
              times["ms"], len(weights),
              " / ".join("%.4f" % v for v in med["kernel"][1]),
              times["plain_ms"], times["library_ms"]), flush=True)
    del weights, grads, refs
    torch.cuda.empty_cache()
    return times


def small_agreement(mt):
    """The same small checkpoint served on the card (kernel) and on the CPU
    (plain versions) must agree."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    with mt.NameManager():
        net = get_transformer_lm(**SMALL)
    rng = np.random.default_rng(SEED + 1)
    params = lm_params(mt, net, shapes, rng, 0.3)
    tokens = rng.integers(0, SMALL["vocab_size"],
                          shapes["data"]).astype(np.float32)
    out_gpu = mt.Predictor(net, params, shapes).forward(data=tokens)[0]
    out_cpu = mt.Predictor(net, params, shapes, ctx=mt.cpu()).forward(
        data=tokens)[0]
    err = float(np.abs(out_gpu.asnumpy() - out_cpu.asnumpy()).max())
    print("check: small LM %s served on the card vs the CPU: max|d| = %.3g "
          "(tolerance 1e-4)" % (SMALL, err), flush=True)
    check(err <= 1e-4, "small LM served on the card disagrees with the CPU")


# card vs CPU training of the small LM: (init std, loss limit, limit on the
# parameters).  float32: every parameter within 1e-4 of the largest
# parameter.  bf16: the change of the parameters (after - before) within
# 3e-2 of its norm, the loss within 1e-3.  A sound run on an H100 read
# 6.4e-3 and 1.5e-4; on the CPU the port's bf16 run differs from its
# float32 run by 1.5% of the change.  A lost update moves the change error
# to 1, an lr off by 10% to about 0.1.
AGREE = {None: (0.3, 1e-4, 1e-4), "bfloat16": (0.02, 1e-3, 3e-2)}


#: the agree phase's optimizer: adam at lr 1e-3, epsilon 1e-4
AGREE_ADAM = ("adam", {"learning_rate": 1e-3, "epsilon": 1e-4})
#: and two more rules of the optimizers' list update.  Centered RMSProp
#: at epsilon 1e-4 and lr 3e-4: at 1e-8 and 1e-3 its steps saturate near
#: ±lr for gradients that are roundoff (as adam's do), and one float32 ulp
#: of the init alone moved the CPU's own run by 8.2e-4 of the largest
#: parameter; here it moves it by 1.5e-5 (NAG's: 8.8e-6)
AGREE_MORE = (("nag", {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-3}),
              ("rmsprop", {"learning_rate": 3e-4, "centered": True,
                           "epsilon": 1e-4, "wd": 1e-3}))


def train3(torch, mt, net, ctx, shape, arg_params, dtype, batch, Y,
           optimizer=AGREE_ADAM):
    """3 steps of ``optimizer`` ((name, kwargs); adam by default) of
    ``net`` on ``ctx`` from ``arg_params`` on one batch: (losses,
    parameters as numpy)."""
    mod = train_module(mt, net, ctx, shape, arg_params=arg_params,
                       compute_dtype=dtype, optimizer=optimizer[0],
                       optimizer_params=dict(optimizer[1]))
    losses = []
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
    args, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in args.items()}


def small_train_agreement(torch, mt, dtype, rtc_gelu=False, cfg=None,
                          std_width=None, optimizer=AGREE_ADAM):
    """A small LM (``SMALL``, or ``cfg``) trained 3 adam steps (or 3 of
    ``optimizer``) on the card
    (kernels) and on the CPU (plain versions) from one numpy init, in
    float32 or with bf16 compute, must agree (limits in ``AGREE``; with
    ``std_width`` the init std is scaled by sqrt(std_width / hidden), so
    that every width has the pre-activation spread of a std_width-wide
    LM); with ``rtc_gelu`` its gelu
    nodes are the user op (NVRTC kernels on the card, Python source on the
    CPU).  Returns the kernel launches of the card's run.  Adam's epsilon is
    1e-4:
    with the usual 1e-8 its first steps are ±lr for any gradient, so
    roundoff in a gradient that is 0 in exact arithmetic (the key bias:
    softmax ignores a per-row shift) would become a full step of either
    sign."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    from mxnet_tpu_torch.rtc_kernels import with_rtc_gelu

    cfg = cfg or SMALL
    std, loss_tol, param_tol = AGREE[dtype]
    std *= np.sqrt((std_width or cfg["hidden"]) / cfg["hidden"])
    shape = (2, cfg["seq_len"])
    with mt.NameManager():
        net = get_transformer_lm(**cfg)
    if rtc_gelu:
        net = with_rtc_gelu(net)
    rng = np.random.default_rng(SEED + 2)
    params = lm_params(mt, net, {"data": shape, "softmax_label": shape}, rng,
                       std)
    arg_params = {k[4:]: v for k, v in params.items()}
    init = {k: v.asnumpy() for k, v in arg_params.items()}
    X = rng.integers(0, cfg["vocab_size"], shape).astype(np.float32)
    Y = (X + 1) % cfg["vocab_size"]
    batch = mt.io.DataBatch(data=[mt.nd.array(X, mt.cpu())],
                            label=[mt.nd.array(Y, mt.cpu())])
    mt.kernels.reset_launches()
    lg, pg = train3(torch, mt, net, mt.gpu(0), shape, arg_params, dtype,
                    batch, Y, optimizer)
    launches = dict(mt.kernels.LAUNCHES)
    lc, pc = train3(torch, mt, net, mt.cpu(), shape, arg_params, dtype,
                    batch, Y, optimizer)
    loss_err = float((np.abs(np.array(lg) - np.array(lc)) / np.abs(lc)).max())
    change = {k: pc[k].astype(np.float64) - init[k] for k in pc}
    scale = max(float(np.abs(pc[k]).max()) for k in pc)
    moved = max(float(np.abs(c).max()) for c in change.values()) / scale
    if dtype is None:
        param_err = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc) / \
            scale
        what = "parameter error %.3g of the largest parameter" % param_err
    else:
        num = sum(float(((pg[k].astype(np.float64) - pc[k]) ** 2).sum())
                  for k in pc)
        den = sum(float((c ** 2).sum()) for c in change.values())
        param_err = (num / den) ** 0.5
        what = "parameter change error %.3g of its norm" % param_err
    what_lm = "%s%s" % ("" if cfg is SMALL else " %s" % {
        k: v for k, v in cfg.items() if SMALL.get(k) != v},
        " with rtc_gelu" if rtc_gelu else "")
    opt_name = optimizer[0] + (" centered" if optimizer[1].get("centered")
                               else "")
    print("check: small LM%s trained 3 %s steps (%s, init std %.3g) on the "
          "card "
          "vs the CPU: losses %s vs %s, relative loss error %.3g (tolerance "
          "%g), %s (tolerance %g; the steps moved parameters by up to %.3g "
          "of the largest)"
          % (what_lm, opt_name, dtype or "float32", std,
             ["%.6f" % x for x in lg],
             ["%.6f" % x for x in lc], loss_err, loss_tol, what, param_tol,
             moved), flush=True)
    check(loss_err <= loss_tol and param_err <= param_tol,
          "small LM%s trained on the card (%s) disagrees with the CPU"
          % (what_lm, dtype or "float32"))
    return launches


# one-ulp draws of the init per device and spread in ``spread_witness``
WITNESS_DRAWS = 4


def spread_witness(torch, mt):
    """A recorded reading, not a check: the d=256 LM of the agree phase in
    float32, at the spread the agree phase holds (a 64-wide LM's, std 0.3 *
    sqrt(64 / 256)) and at a 128-wide LM's (std 0.3 * sqrt(128 / 256)),
    where three steps amplify roundoff more: the card-vs-CPU gap beside
    the gaps that moving the init one float32 ulp per entry (at random,
    ``WITNESS_DRAWS`` draws) makes on the card alone and on the CPU alone.
    A card-vs-CPU gap inside that range is amplified summation order, not
    a fault of the kernels."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    cfg = SMALL_HEAD_DIMS[256]
    shape = (2, cfg["seq_len"])
    with mt.NameManager():
        net = get_transformer_lm(**cfg)
    for width in (64, 128):
        std = AGREE[None][0] * np.sqrt(width / cfg["hidden"])
        rng = np.random.default_rng(SEED + 2)  # small_train_agreement's
        params = lm_params(mt, net, {"data": shape, "softmax_label": shape},
                           rng, std)
        arg_params = {k[4:]: v for k, v in params.items()}
        X = rng.integers(0, cfg["vocab_size"], shape).astype(np.float32)
        Y = (X + 1) % cfg["vocab_size"]
        batch = mt.io.DataBatch(data=[mt.nd.array(X, mt.cpu())],
                                label=[mt.nd.array(Y, mt.cpu())])
        base = {ctx: train3(torch, mt, net, ctx, shape, arg_params, None,
                            batch, Y)[1] for ctx in (mt.gpu(0), mt.cpu())}
        scale = max(float(np.abs(v).max()) for v in base[mt.cpu()].values())

        def gap(a, b):
            return max(float(np.abs(a[k] - b[k]).max()) for k in a) / scale
        off_gaps = {ctx: [] for ctx in base}
        for draw in range(WITNESS_DRAWS):
            flip = np.random.default_rng(SEED + 100 + draw)
            off = {}
            for k, v in arg_params.items():
                a = v.asnumpy()
                if not k.endswith(("_gamma", "_beta", "_bias")):
                    a = np.nextafter(a, np.where(
                        flip.random(a.shape) < 0.5, -np.inf,
                        np.inf).astype(np.float32))
                off[k] = mt.nd.array(a, mt.cpu())
            for ctx in base:
                got = train3(torch, mt, net, ctx, shape, off, None, batch,
                             Y)[1]
                off_gaps[ctx].append(gap(got, base[ctx]))
        print("witness: d=256 LM at init std %.3g (a %d-wide LM's spread), "
              "3 float32 adam steps, gaps of the largest parameter: card vs "
              "CPU %.3g; from the init one ulp off, %d draws: card vs card "
              "%s, CPU vs CPU %s (recorded, not checked)" % (
                  std, width, gap(base[mt.gpu(0)], base[mt.cpu()]),
                  WITNESS_DRAWS,
                  ["%.3g" % g for g in off_gaps[mt.gpu(0)]],
                  ["%.3g" % g for g in off_gaps[mt.cpu()]]), flush=True)


def register_custom_props(mt):
    """The sigmoid and softmax-loss CustomOps of tests/test_custom_op.py."""

    @mt.operator.register("_smoke_sigmoid")
    class SigmoidProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Sigmoid(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0],
                                (1.0 / (1.0 + np.exp(-x))).astype(x.dtype))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    y = out_data[0].asnumpy()
                    g = out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                (g * y * (1.0 - y)).astype(y.dtype))

            return Sigmoid()

    @mt.operator.register("_smoke_softmax_loss")
    class SoftmaxLossProp(mt.operator.CustomOpProp):
        def __init__(self):
            super(SoftmaxLossProp, self).__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class SoftmaxLoss(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    e = np.exp(x - x.max(axis=1, keepdims=True))
                    self.assign(out_data[0], req[0],
                                (e / e.sum(axis=1, keepdims=True))
                                .astype(x.dtype))

                def backward(self, req, out_grad, in_data, out_data, in_grad,
                             aux):
                    lab = in_data[1].asnumpy().astype(np.int64)
                    y = out_data[0].asnumpy().copy()
                    y[np.arange(lab.shape[0]), lab] -= 1.0
                    self.assign(in_grad[0], req[0], y)
                    self.assign(in_grad[1], req[1],
                                np.zeros_like(in_data[1].asnumpy()))

            return SoftmaxLoss()


def custom_op_agreement(mt):
    """A net with the CustomOp sigmoid and softmax loss, trained 3 SGD
    steps through Module on the card and on the CPU from one numpy init:
    parameters within 1e-4 of the largest, outputs within 1e-4."""
    register_custom_props(mt)
    rng = np.random.default_rng(SEED + 5)
    X = rng.standard_normal((32, 10), dtype=np.float32)
    L = rng.integers(0, 3, 32).astype(np.float32)
    init = {"fc1_weight": rng.standard_normal((16, 10), dtype=np.float32) * .3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.standard_normal((3, 16), dtype=np.float32) * .3,
            "fc2_bias": np.zeros(3, np.float32)}
    runs = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=16,
                                    name="fc1")
        net = mt.sym.Custom(net, op_type="_smoke_sigmoid", name="sig")
        net = mt.sym.FullyConnected(net, num_hidden=3, name="fc2")
        net = mt.sym.Custom(net, mt.sym.Variable("label"),
                            op_type="_smoke_softmax_loss", name="loss")
        mod = mt.mod.Module(net, label_names=("label",), context=ctx)
        mod.bind(data_shapes=[("data", X.shape)],
                 label_shapes=[("label", L.shape)])
        mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                    for k, v in init.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        batch = mt.io.DataBatch([mt.nd.array(X, mt.cpu())],
                                [mt.nd.array(L, mt.cpu())])
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        runs[ctx.device_type] = (mod.get_outputs()[0].asnumpy(), {
            k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    (og, pg), (oc, pc) = runs["gpu"], runs["cpu"]
    scale = max(float(np.abs(v).max()) for v in pc.values())
    param_err = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc) / scale
    moved = max(float(np.abs(pc[k] - init[k]).max()) for k in pc)
    out_err = float(np.abs(og - oc).max())
    print("check: CustomOp sigmoid + softmax-loss net trained 3 SGD steps on "
          "the card vs the CPU: parameter error %.3g of the largest, output "
          "error %.3g (tolerance 1e-4; the steps moved parameters by up to "
          "%.3g)" % (param_err, out_err, moved), flush=True)
    check(param_err <= 1e-4 and out_err <= 1e-4 and moved > 1e-2,
          "the CustomOp net trained on the card disagrees with the CPU")


def nd_agreement(mt):
    """A few ``mt.nd`` ops and operators on the card against the CPU,
    within 1e-5 of the largest value."""
    rng = np.random.default_rng(SEED + 6)
    a_np = rng.standard_normal((64, 33), dtype=np.float32)
    b_np = rng.standard_normal((1, 33), dtype=np.float32)
    got = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        a, b = mt.nd.array(a_np, ctx), mt.nd.array(b_np, ctx)
        onehot = mt.nd.zeros((64, 40), ctx)
        mt.nd.onehot_encode(mt.nd.arange(64, ctx=ctx) % 37, onehot)
        got[ctx.device_type] = {
            "exp": mt.nd.exp(a), "broadcast_add": mt.nd.broadcast_add(a, b),
            "sum": mt.nd.sum(a, axis=1), "softmax": mt.nd.softmax(a),
            "arith": (a * 2.0 - b) / (abs(a) + 1.0), "compare": a > b,
            "add_n": mt.nd.add_n(a, a, a), "norm": mt.nd.norm(a),
            "argmax": mt.nd.argmax(a, axis=0), "onehot": onehot,
            "gelu": mt.nd.gelu(a), "T": a.T.copy()}
    errs = {}
    for name, ref in got["cpu"].items():
        on_card = got["gpu"][name]
        check(on_card.context == mt.gpu(0), "nd.%s ran on %s"
              % (name, on_card.context))
        r = ref.asnumpy()
        errs[name] = float(np.abs(on_card.asnumpy() - r).max()) / max(
            float(np.abs(r).max()), 1e-30)
    print("check: mt.nd ops on the card vs the CPU, max|err|/max|ref|: %s "
          "(tolerance 1e-5)" % {k: float("%.3g" % v) for k, v in
                                errs.items()}, flush=True)
    check(all(e <= 1e-5 for e in errs.values()),
          "mt.nd ops on the card disagree with the CPU")


# -- image classification: ResNet-50 through Module (phase 9) and the small
# image nets of the agree phase ----------------------------------------------

#: bench.py:116-156 resnet_bench: ResNet-50 at 224², 1000 classes
def lenet_consistency(mt):
    """``test_utils.check_consistency`` of LeNet's forward (batch 8, random
    weights from a seed) between ``mt.cpu()`` and ``mt.gpu(0)`` in float32,
    within the agree limit 1e-4."""
    from mxnet_tpu_torch.models.lenet import get_lenet

    with mt.NameManager():
        net = get_lenet(10)
    shape = (8, 1, 28, 28)
    arg_shapes, _, _ = net.infer_shape(data=shape)
    rng = np.random.RandomState(SEED + 5)
    location = {n: (rng.randint(0, 10, s) if n == "softmax_label" else
                    rng.standard_normal(s) * (1.0 if n == "data" else 0.1))
                .astype(np.float32) for n, s in zip(net.list_arguments(),
                                                    arg_shapes)}
    outs = mt.test_utils.check_consistency(
        net, location, dtypes=(np.float32,), ctx_list=[mt.cpu(), mt.gpu(0)],
        rtol=1e-4, atol=1e-6)
    err = float(np.abs(outs[0][0] - outs[1][0]).max())
    print("check: test_utils.check_consistency of LeNet %s, cpu vs gpu(0), "
          "float32: max|d| = %.3g (rtol 1e-4, atol 1e-6)" % (shape, err),
          flush=True)


RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
#: (compute dtype, batch, warm-up steps, timed steps): the JAX package's
#: bench batch and dtype (bench.py:61, :124), then Module's float32 default
#: at the reference's published P100 batch
RESNET_RUNS = (("bfloat16", 256, 2, 5), (None, 32, 2, 3))
#: SGD as fit.benchmark sets it up (bench.py:60, fit.py:27-28); Module
#: makes rescale_grad 1/batch
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
#: forward GFLOP per 224² image; a training step is 3x (bench.py:144-145)
RESNET_GFLOP = 4.089
RESNET_REPLAY = 2
# the float32 run's states held to the CPU route (resnet_cpu_witness): its
# init and the state after step 0; each more state is CPU ResNet-50 work at
# batch 32 inside the script's time limit
RESNET_WITNESS = 2
#: the BASELINE.md yardstick: the reference on a P100, float32, batch 32
P100_IMG_S = 181.53


def resnet_batch(mt, batch):
    """``SyntheticIter``'s batch (examples/image_classification/common/
    fit.py:46-70): U(-1, 1) images and random labels from
    RandomState(0), as arrays on the default context."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (batch,) + RESNET["image_shape"]).astype(
        np.float32)
    Y = rng.randint(0, RESNET["num_classes"], (batch,)).astype(np.float32)
    return Y, mt.io.DataBatch(data=[mt.nd.array(X)], label=[mt.nd.array(Y)],
                              pad=0)


def image_module(mt, net, ctx, data_shape, dtype, sgd, arg_params=None,
                 aux_params=None):
    """A bound Module with SGD-momentum, initialized by Xavier("in", 2.34)
    as fit.benchmark does, or from the given parameters."""
    mod = mt.mod.Module(net, context=ctx, compute_dtype=dtype)
    mod.bind(data_shapes=[mt.io.DataDesc("data", data_shape)],
             label_shapes=[mt.io.DataDesc("softmax_label", data_shape[:1])],
             for_training=True)
    if arg_params is None:
        mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                                   magnitude=2.34))
    else:
        mod.init_params(arg_params=arg_params, aux_params=aux_params)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(sgd))
    return mod


def state_snapshot(mod):
    """Host copies of a bound Module's parameters and aux states, by name
    (kept off the card, so that they do not count in its peak memory)."""
    ex = mod._exec_group.execs[0]
    return ({n: ex.arg_dict[n]._data.to("cpu", copy=True)
             for n in mod._exec_group.param_names},
            {n: t._data.to("cpu", copy=True) for n, t in ex.aux_dict.items()})


def resnet_steps(torch, mt, mod, batch, Y, n, metric=None, label=None,
                 first=0):
    """``n`` steps of fit.benchmark's loop (forward_backward, update,
    update_metric): (losses, step seconds), each step synchronized."""
    losses, times = [], []
    for step in range(first, first + n):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        if metric is not None:
            mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        if label:
            print("resnet %s: step %d: %.2f ms, loss %.6f"
                  % (label, step, times[-1] * 1e3, losses[-1]), flush=True)
    return losses, times


def resnet_cpu_witness(torch, mt, net, states, batch, Y, losses, label):
    """The float32 run against the port's CPU route (held to the JAX
    package by the CPU tests) on the same batch.  Re-anchored: at each of
    the card's first states (``states``: parameters and aux before steps
    0, 1, ...), the CPU's training forward gives the card's loss within
    the agree phase's float32 limit.  Free-running: the CPU trains from
    the card's init, and again from that init moved one float32 ulp up;
    lr 0.1 at batch 32 is chaotic at this init (one ulp moves the CPU's
    own losses by ~4e-3 and its first gradient by ~2%), so the card's
    losses must lie within WITNESS_FACTOR times that spread of the CPU's."""
    b, cpu = len(Y), mt.cpu()

    def nds(tensors):
        return {k: mt.nd.NDArray(v.clone(), cpu) for k, v in tensors.items()}

    def module(args):
        return image_module(mt, net, cpu, (b,) + RESNET["image_shape"], None,
                            dict(RESNET_SGD, rescale_grad=1.0 / b),
                            nds(args), nds(states[0][1]))

    cpu_batch = mt.io.DataBatch(
        data=[mt.nd.NDArray(batch.data[0]._data.cpu(), cpu)],
        label=[mt.nd.NDArray(batch.label[0]._data.cpu(), cpu)], pad=0)
    def first_gradient(mod, data, args):
        mod.set_params(nds(args), nds(states[0][1]))
        mod.forward_backward(data)
        mod.get_outputs()  # runs the step Module defers to update()
        ex = mod._exec_group.execs[0]
        return {n: ex.grad_dict[n]._data.to("cpu", torch.float64)
                for n in mod._exec_group.param_names}

    def gap(a, ref):
        return (sum(float((a[n] - ref[n]).square().sum()) for n in ref) /
                sum(float(ref[n].square().sum()) for n in ref)) ** 0.5

    nudged = {k: torch.nextafter(v, torch.full_like(v, np.inf))
              if k.endswith("weight") else v for k, v in states[0][0].items()}
    t0 = time.perf_counter()
    mod = module(states[0][0])
    grads = {"cpu": first_gradient(mod, cpu_batch, states[0][0]),
             "one ulp": first_gradient(mod, cpu_batch, nudged)}
    anchored = []
    for args, aux in states:
        mod.set_params(nds(args), nds(aux))
        mod.forward(cpu_batch, is_train=True)
        anchored.append(lm_loss(torch, mod.get_outputs()[0], Y))
    del mod
    mod = image_module(mt, net, None, (b,) + RESNET["image_shape"], None,
                       dict(RESNET_SGD, rescale_grad=1.0 / b),
                       nds(states[0][0]), nds(states[0][1]))
    grads["card"] = first_gradient(mod, batch, states[0][0])
    del mod
    torch.cuda.empty_cache()
    free, _ = resnet_steps(torch, mt, module(states[0][0]), cpu_batch, Y,
                           len(states))
    spread, _ = resnet_steps(torch, mt, module(nudged), cpu_batch, Y,
                             len(states))
    secs = time.perf_counter() - t0

    def rel(a, ref):
        return max(abs(x - r) / abs(r) for x, r in zip(a, ref))

    card = losses[:len(states)]
    limit = AGREE[None][1]
    print("resnet %s: the card's first %d losses %s; the port's CPU route "
          "(%.1f s on %d threads) at the card's states %s, relative error "
          "%.3g (tolerance %g); trained from the card's init %s, relative "
          "error %.3g, against the init one ulp up %s, %.3g apart (the card "
          "within %dx: %s)"
          % (label, len(states), ["%.7f" % x for x in card], secs,
             torch.get_num_threads(), ["%.7f" % x for x in anchored],
             rel(card, anchored), limit, ["%.7f" % x for x in free],
             rel(card, free), ["%.7f" % x for x in spread],
             rel(spread, free), WITNESS_FACTOR,
             rel(card, free) <= WITNESS_FACTOR * rel(spread, free)),
          flush=True)
    print("resnet %s: the first gradient, norm of the difference over the "
          "CPU's: the card %.3g, the CPU from the init one ulp up %.3g "
          "(recorded, not checked)" % (label, gap(grads["card"], grads["cpu"]),
                                       gap(grads["one ulp"], grads["cpu"])),
          flush=True)
    check(rel(card, anchored) <= limit, "the float32 ResNet's losses on the "
          "card disagree with the port's CPU route at the card's states: "
          "%s vs %s" % (card, anchored))
    check(rel(card, free) <= WITNESS_FACTOR * rel(spread, free),
          "the float32 ResNet trained on the card strays from the CPU's "
          "run further than %dx one ulp of the init moves it: %s vs %s "
          "(one ulp: %s)" % (WITNESS_FACTOR, card, free, spread))


def resnet_replay(torch, mt, net, init, batch, Y, ref, deterministic):
    """The bf16 run's first RESNET_REPLAY steps again in a new Module from
    its init and batch; with ``deterministic`` under cuDNN's deterministic
    algorithms and ``torch.use_deterministic_algorithms(True,
    warn_only=True)``.  Returns (the run's bits, the last step's ms)."""
    import warnings

    dtype, b, _, _ = RESNET_RUNS[0]
    args = {k: mt.nd.NDArray(v, mt.cpu()) for k, v in init[0].items()}
    aux = {k: mt.nd.NDArray(v, mt.cpu()) for k, v in init[1].items()}
    mod = image_module(mt, net, None, (b,) + RESNET["image_shape"], dtype,
                       dict(RESNET_SGD, rescale_grad=1.0 / b), args, aux)
    old = torch.backends.cudnn.deterministic
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if deterministic:
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            losses, times = resnet_steps(torch, mt, mod, batch, Y,
                                         RESNET_REPLAY)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = old
    got = state_snapshot(mod)
    del mod
    torch.cuda.empty_cache()
    differ = sorted(n for part, want in zip(got, ref[1])
                    for n, t in part.items() if not torch.equal(t, want[n]))
    same = losses == ref[0] and not differ
    alerts = sorted({str(w.message).split("\n")[0][:160] for w in caught
                     if "deterministic" in str(w.message)})
    print("resnet replay (%s): %d bf16 steps from the run's init and batch: "
          "losses %s vs the run's %s; %d of %d parameters and aux states "
          "differ %s; the run's bits %s; step ms %s; nondeterministic-op "
          "alerts: %s"
          % ("cudnn.deterministic" if deterministic else "default",
             RESNET_REPLAY, ["%.9g" % x for x in losses],
             ["%.9g" % x for x in ref[0]], len(differ),
             sum(len(p) for p in got), differ[:4], same,
             ["%.2f" % (t * 1e3) for t in times], alerts or "none"),
          flush=True)
    return same, times[-1] * 1e3


def resnet_phase(torch, mt, profile_dir=None):
    """Phase 9: ResNet-50 trained through ``mt.mod.Module`` on the default
    context as fit.benchmark drives it, bf16 at batch 256 and float32 at
    batch 32, each from Xavier("in", 2.34) on SyntheticIter's batch.  Each
    run prints step ms, img/s, MFU and peak memory and must keep its
    parameters on the card, give finite losses that fall, and move every
    moving statistic; the float32 run's first losses must be the port's
    CPU route's, and the bf16 run's first steps replay bit for bit.
    Returns the launch counts of the runs (no kernel of the port's own is
    on this path: cuDNN convolutions and plain torch)."""
    from mxnet_tpu_torch.models import get_resnet

    name = torch.cuda.get_device_name(0)
    peaks_key, peaks = peaks_for(name)
    with mt.NameManager():
        net = get_resnet(**RESNET)
    mt.kernels.reset_launches()
    for dtype, b, warmup, timed in RESNET_RUNS:
        label = "%s b%d" % (dtype or "float32", b)
        if dtype is None:
            check(not torch.backends.cuda.matmul.allow_tf32 and
                  not torch.backends.cudnn.allow_tf32,
                  "a TF32 flag is on for the float32 ResNet run")
        Y, batch = resnet_batch(mt, b)
        mt.random.seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mod = image_module(mt, net, None, (b,) + RESNET["image_shape"],
                           dtype, dict(RESNET_SGD, rescale_grad=1.0 / b))
        torch.cuda.synchronize()
        ex = mod._exec_group.execs[0]
        names = mod._exec_group.param_names
        n_params = sum(ex.arg_dict[n].size for n in names)
        check(all(ex.arg_dict[n]._data.is_cuda for n in names) and
              all(t._data.is_cuda for t in ex.aux_dict.values()),
              "the ResNet parameters do not live on the card")
        print("resnet %s: %d parameters and %d aux states on %s, bound and "
              "initialized in %.2f s" % (label, n_params, len(ex.aux_dict),
                                         ex.arg_dict[names[0]].context,
                                         time.perf_counter() - t0),
              flush=True)
        init = state_snapshot(mod)
        metric = mt.metric.Accuracy()
        # the state before each of the first steps, for the CPU witness
        states, losses, times = [init], [], []
        for step in range(RESNET_REPLAY):
            one, one_t = resnet_steps(torch, mt, mod, batch, Y, 1, metric,
                                      label, step)
            losses += one
            times += one_t
            states.append(state_snapshot(mod))
        replay_ref = (list(losses), states[-1])
        more, more_t = resnet_steps(torch, mt, mod, batch, Y,
                                    warmup + timed - RESNET_REPLAY, metric,
                                    label, RESNET_REPLAY)
        losses += more
        times += more_t
        step_ms = float(np.mean(times[warmup:])) * 1e3
        img_s = b / step_ms * 1e3
        flops = img_s * 3 * RESNET_GFLOP * 1e9
        peak_key = "bfloat16" if dtype else "float32"
        mfu = flops / (peaks[peak_key] * 1e12)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print("resnet %s: step ms %.2f (mean of %d timed steps after %d "
              "warm-up%s); img/s %.1f; model TFLOP/s %.1f; MFU %.4f of the "
              "%s %s dense peak %.0f TFLOP/s%s; peak device memory %.2f GB; "
              "accuracy %s"
              % (label, step_ms, timed, warmup,
                 "; before the list update: %.2f" % BEFORE_MS["resnet bf16"]
                 if dtype else "",
                 img_s, flops / 1e12, mfu,
                 peaks_key, peak_key, peaks[peak_key],
                 " (CUDA cores: TF32 off)" if dtype is None else "",
                 peak_gb, metric.get()), flush=True)
        if dtype is None:
            print("resnet %s: %.2fx the reference's P100 %.2f img/s "
                  "(BASELINE.md; a yardstick only)"
                  % (label, img_s / P100_IMG_S, P100_IMG_S), flush=True)
        check(all(np.isfinite(losses)), "ResNet %s losses are not finite: "
              "%s" % (label, losses))
        # bf16 at batch 256 falls step after step; float32 at batch 32 with
        # the same lr 0.1 falls at its second step and then climbs: it must
        # reach below its first step's loss, and its first states must give
        # the port's CPU route's losses (resnet_cpu_witness)
        fell = losses[-1] < losses[0] if dtype else \
            min(losses[1:]) < losses[0]
        check(fell, "the ResNet %s loss did not fall: %s" % (label, losses))
        if dtype is None:
            resnet_cpu_witness(torch, mt, net, states[:RESNET_WITNESS],
                               batch, Y, losses, label)
        del states
        check(all(ex.arg_dict[n]._data.is_cuda for n in names),
              "the ResNet parameters left the card")
        end = state_snapshot(mod)
        still = sorted(n for n, t in end[1].items()
                       if torch.equal(t, init[1][n]))
        print("resnet %s: loss %.6f -> %.6f; %d of %d moving statistics "
              "moved from their init" % (label, losses[0], losses[-1],
                                         len(end[1]) - len(still),
                                         len(end[1])), flush=True)
        check(not still, "ResNet %s moving statistics did not move: %s"
              % (label, still[:4]))
        if dtype and profile_dir:
            def step():
                mod.forward_backward(batch)
                mod.update()
            groups = profile(torch, step, profile_dir, "resnet_step_bf16")
            for group in ("conv (cuDNN)", "GEMM (cuBLAS)"):
                names = sorted(groups.get(group, ()))
                print("profile resnet_step_bf16: %d %s kernels, e.g. %s"
                      % (len(names), group, [n[:90] for n in names[:4]]),
                      flush=True)
        del mod, ex, end
        torch.cuda.empty_cache()
        if dtype:
            same, replay_ms = resnet_replay(torch, mt, net, init, batch, Y,
                                            replay_ref, False)
            _, det_ms = resnet_replay(torch, mt, net, init, batch, Y,
                                      replay_ref, True)
            print("resnet replay: second step %.2f ms by default, %.2f ms "
                  "with cudnn.deterministic" % (replay_ms, det_ms),
                  flush=True)
            check(same, "the bf16 ResNet step is not reproducible")
        del batch, init, replay_ref
        torch.cuda.empty_cache()
    return dict(mt.kernels.LAUNCHES)


#: the agree phase's image nets: (builder, kwargs, data shape, SGD lr,
#: the residual branches' last BatchNorm, whose γ starts at 0, or None).
#: From unit γ small ResNets train chaotically at small batches (BatchNorm's
#: gradients explode with depth): one float32 ulp of the init moves them
#: further than the agree limits (tests/test_torch_models.py::
#: test_small_resnet_training_is_chaotic_where_parity_is_not_held), and
#: ResNet-18 at unit γ read 3.4e-4 (lr 0.01) and 1.9e-4 (lr 0.001) from
#: the CPU.  The zero-γ init keeps the same graphs well-conditioned.
SMALL_IMAGE = {
    "ResNet-50 (cifar stem, 32x32)": (
        "get_resnet", dict(num_layers=50, image_shape=(3, 32, 32),
                           num_classes=10), (8, 3, 32, 32), 0.01, "c"),
    "ResNet-18 (imagenet stem, 72x72)": (
        "get_resnet", dict(num_layers=18, image_shape=(3, 72, 72),
                           num_classes=10), (4, 3, 72, 72), 0.01, "b"),
    "LeNet": ("get_lenet", dict(num_classes=10), (8, 1, 28, 28), 0.1, None),
}


#: bf16 image nets, and the float32 ResNet-50 run trained free: how far
#: the card may lie from the CPU, in units of the CPU's own distance under
#: a one-ulp nudge of the init, where the agree limits do not hold.  The card rounds every convolution differently, a
#: larger perturbation than the nudge (ResNet-50 read 1.06e-3 in loss
#: against a witness of 5.2e-4, and 0.033 in the parameter change against
#: 0.022); a lost or wrong gradient moves the change error to about 1.
WITNESS_FACTOR = 4


def image_train3(torch, mt, net, ctx, shape, lr, args, aux, dtype, X, Y):
    """3 SGD-momentum steps of ``net`` on ``ctx`` from numpy ``args`` and
    ``aux``: (losses, parameters, aux states) as numpy."""
    mod = image_module(mt, net, ctx, shape, dtype,
                       dict(learning_rate=lr, momentum=0.9, wd=1e-4),
                       {k: mt.nd.array(v, ctx) for k, v in args.items()},
                       {k: mt.nd.array(v, ctx) for k, v in aux.items()})
    batch = mt.io.DataBatch(data=[mt.nd.array(X, ctx)],
                            label=[mt.nd.array(Y, ctx)])
    losses = []
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
    a, x = mod.get_params()
    return (losses, {k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def train_distance(a, b, args, aux):
    """(loss error, parameter error of the largest, aux error of the
    largest, parameter change error of its norm, aux change error) of run
    ``a`` against run ``b`` from ``args``/``aux``."""
    def largest(got, ref):
        if not ref:
            return 0.0
        scale = max(float(np.abs(v).max()) for v in ref.values())
        return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale

    def change(got, ref, init):
        if not ref:
            return 0.0
        num = sum(float(((got[k].astype(np.float64) - ref[k]) ** 2).sum())
                  for k in ref)
        den = sum(float(((ref[k].astype(np.float64) - init[k]) ** 2).sum())
                  for k in ref)
        return (num / den) ** 0.5

    loss = float((np.abs(np.array(a[0]) - np.array(b[0]))
                  / np.abs(b[0])).max())
    return (loss, largest(a[1], b[1]), largest(a[2], b[2]),
            change(a[1], b[1], args), change(a[2], b[2], aux))


#: conv_precision_check's shapes: (data, weight, stride, pad), LeNet's two
#: layers and ResNet's stem, 3x3 and strided 1x1 layers at a small batch
CONV_CASES = (((8, 1, 28, 28), (20, 1, 5, 5), (1, 1), (0, 0)),
              ((8, 20, 12, 12), (50, 20, 5, 5), (1, 1), (0, 0)),
              ((8, 3, 64, 64), (64, 3, 7, 7), (2, 2), (3, 3)),
              ((8, 64, 16, 16), (64, 64, 3, 3), (1, 1), (1, 1)),
              ((8, 256, 16, 16), (512, 256, 1, 1), (2, 2), (0, 0)))


#: and the transposed convolutions: (op, data, weight, stride,
#: pad), a DCGAN generator's stride-2 Deconvolution layers and a bilinear
#: UpSampling by 2 (the small SSD has none)
DECONV_CASES = (("Deconvolution", (8, 512, 4, 4), (512, 256, 4, 4), (2, 2),
                 (1, 1)),
                ("Deconvolution", (8, 128, 16, 16), (128, 64, 4, 4), (2, 2),
                 (1, 1)),
                ("UpSampling", (8, 64, 16, 16), (64, 1, 4, 4), (2, 2),
                 (1, 1)))


def conv_precision_check(torch, mt):
    """The port's float32 ``Convolution``, ``Deconvolution`` and bilinear
    ``UpSampling`` on the card, output and both gradients, against float64
    on the CPU: within 1e-5 of the largest value.  cuDNN's default float32
    algorithm (``F.conv2d``/``F.conv_transpose2d``, TF32 off) is measured
    beside it, recorded, not checked."""
    from mxnet_tpu_torch.ops import OpContext, get_op

    gen = torch.Generator().manual_seed(SEED + 8)
    cases = [("Convolution",) + c for c in CONV_CASES] + list(DECONV_CASES)
    for name, xs, ws, stride, pad in cases:
        op = get_op(name)
        x = torch.randn(xs, generator=gen, dtype=torch.float64)
        fan = {"Convolution": np.prod(ws[1:]), "UpSampling": np.prod(ws[2:]),
               "Deconvolution": ws[0] * np.prod(ws[2:])}[name]
        w = torch.randn(ws, generator=gen, dtype=torch.float64) / np.sqrt(fan)
        if name == "UpSampling":
            attrs = op.parse_attrs({"scale": stride[0], "num_filter": xs[1],
                                    "sample_type": "bilinear"})
        else:
            nf = ws[0] if name == "Convolution" else ws[1]
            attrs = op.parse_attrs({"kernel": ws[2:], "num_filter": nf,
                                    "stride": stride, "pad": pad,
                                    "no_bias": True})
        out_shape = op.infer_shape(attrs, [xs, None])[1][0]
        ct = torch.randn(out_shape, generator=gen, dtype=torch.float64)

        def run(device, dtype, fn):
            a = x.to(device, dtype).requires_grad_(True)
            b = w.to(device, dtype).requires_grad_(True)
            o = fn(a, b)
            gx, gw = torch.autograd.grad(o, (a, b), ct.to(device, dtype))
            return [t.detach().double().cpu() for t in (o, gx, gw)]

        def port(a, b):
            return op.apply(OpContext(), attrs, [a, b])[0][0]

        def cudnn(a, b):
            if name == "Convolution":
                return torch.nn.functional.conv2d(a, b, None, stride, pad)
            return torch.nn.functional.conv_transpose2d(
                a, b, None, stride, pad, groups=1 if name ==
                "Deconvolution" else xs[1])

        ref = run("cpu", torch.float64, port)
        errs = {}
        for route, fn in (("port", port), ("cuDNN", cudnn)):
            got = run("cuda", torch.float32, fn)
            errs[route] = [((g - r).abs().max() / r.abs().max()).item()
                          for g, r in zip(got, ref)]
        print("check: float32 %s %s * %s stride %s pad %s on the "
              "card vs float64 on the CPU, max|err|/max|ref| of the output, "
              "data and weight gradients: port %s (tolerance 1e-5); cuDNN's "
              "default %s (recorded)"
              % (name, xs, ws, stride, pad,
                 ["%.3g" % e for e in errs["port"]],
                 ["%.3g" % e for e in errs["cuDNN"]]), flush=True)
        check(max(errs["port"]) <= 1e-5, "the float32 %s %s * %s on the "
              "card is not float32-accurate" % (name, xs, ws))


def image_agreement(torch, mt, what, dtype):
    """A small image net trained 3 SGD-momentum steps on the card and on
    the CPU from one numpy init, aux states compared like parameters, under
    the agree limits (``AGREE``): float32 loss, parameters and aux states
    within 1e-4; bf16 loss within 1e-3 and the change of the parameters and
    of the aux states within 3e-2 of its norm.  Where bf16 misses those,
    the CPU's own run from the init moved one float32 ulp is the witness
    of how far bf16 rounding alone carries this net, and the card must lie
    within WITNESS_FACTOR times its distance."""
    from mxnet_tpu_torch import models

    fn, kw, shape, lr, zero_gamma = SMALL_IMAGE[what]
    with mt.NameManager():
        net = getattr(models, fn)(**kw)
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape)
    rng = np.random.RandomState(SEED + 7)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            scale = np.sqrt(2.34 / np.prod(s[1:]))
            args[n] = rng.uniform(-scale, scale, s).astype(np.float32)
        elif n.endswith("gamma"):
            zero = zero_gamma and n.startswith("stage") and \
                n.endswith("_%s_bn_gamma" % zero_gamma)
            args[n] = np.full(s, 0.0 if zero else 1.0, np.float32)
        else:
            args[n] = np.zeros(s, np.float32)
    aux = {n: (np.zeros if n.endswith("mean") else np.ones)(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    Y = rng.randint(0, 10, shape[:1]).astype(np.float32)
    card = image_train3(torch, mt, net, mt.gpu(0), shape, lr, args, aux,
                        dtype, X, Y)
    cpu = image_train3(torch, mt, net, mt.cpu(), shape, lr, args, aux,
                       dtype, X, Y)
    d = train_distance(card, cpu, args, aux)
    _, loss_tol, param_tol = AGREE[dtype]
    if dtype is None:
        ok = d[0] <= loss_tol and d[1] <= param_tol and d[2] <= param_tol
        what_err = ("parameter error %.3g and aux error %.3g of the largest"
                    % (d[1], d[2]))
    else:
        ok = d[0] <= loss_tol and d[3] <= param_tol and d[4] <= param_tol
        what_err = ("parameter change error %.3g and aux change error %.3g "
                    "of its norm" % (d[3], d[4]))
    print("check: %s trained 3 SGD-momentum steps (%s, lr %g%s) on the card "
          "vs the CPU: losses %s vs %s, relative loss error %.3g (tolerance "
          "%g), %s (tolerance %g)"
          % (what, dtype or "float32", lr, ", zero-γ init" if zero_gamma
             else "", ["%.6f" % x for x in card[0]],
             ["%.6f" % x for x in cpu[0]], d[0], loss_tol, what_err,
             param_tol), flush=True)
    if not ok and dtype is not None:
        nudged = {k: np.nextafter(v, np.float32(np.inf)).astype(np.float32)
                  if k.endswith("weight") else v for k, v in args.items()}
        w = train_distance(image_train3(torch, mt, net, mt.cpu(), shape, lr,
                                        nudged, aux, dtype, X, Y),
                           cpu, args, aux)
        ok = all(d[i] <= WITNESS_FACTOR * w[i] for i in (0, 3, 4))
        print("check: %s bf16 witness, the CPU from the init moved one "
              "float32 ulp vs the CPU: relative loss error %.3g, parameter "
              "change error %.3g, aux change error %.3g; the card within "
              "%dx: %s" % (what, w[0], w[3], w[4], WITNESS_FACTOR, ok),
              flush=True)
    check(ok, "%s trained on the card (%s) disagrees with the CPU"
          % (what, dtype or "float32"))


# -- detection: SSD through Module and Predictor (phase 10), the small SSD
# of the agree phase, and the samplers (phase 11) ----------------------------

#: BASELINE.md config #4 at its VOC 300² setting: 20 classes,
#: get_ssd_train's default widths, batch 32; 128 synthetic images, labels
#: padded to 8 rows
#: (the example's --label-pad-width)
SSD = dict(num_classes=20)
SSD_IMAGE = (3, 300, 300)
SSD_BATCH = 32
SSD_IMAGES = 128
SSD_LABEL_ROWS = 8
#: 4 anchors at each cell of the 75², 37² and 18² maps
SSD_ANCHORS = 4 * (75 * 75 + 37 * 37 + 18 * 18)
SSD_SGD = dict(learning_rate=0.2, momentum=0.9)  # the example's defaults
SSD_WARMUP, SSD_PASSES = 2, 6
SSD_WITNESS = 2
SSD_REQUESTS = 3
#: a MultiBoxTarget difference between the card and the CPU is accepted
#: only at a near-tie of the hard-negative ranking, and a detection only
#: where its score or an overlap lies this close to its threshold
NEAR_TIE = 1e-5
#: the agree phase's small SSD (tests/test_ssd.py)
SMALL_SSD = dict(num_classes=2, num_filters=(8, 16, 16, 16))
SMALL_SSD_SHAPE = (8, 3, 64, 64)


def synthetic_detection(n, size=64, num_classes=2, seed=0,
                        rows=SSD_LABEL_ROWS):
    """examples/ssd/train_ssd.py's ``synthetic_detection``: one square of
    ones per image, in the channel of its class mod 3, on zeros; its label
    row [class, xmin, ymin, xmax, ymax] (in [0, 1]), then rows of -1 up to
    ``rows`` (the example pads to 4; its --label-pad-width is 8)."""
    rng = np.random.RandomState(seed)
    data = np.zeros((n, 3, size, size), np.float32)
    label = np.full((n, rows, 5), -1.0, np.float32)
    for i in range(n):
        s = rng.randint(size // 4, size // 2)
        x0 = rng.randint(0, size - s)
        y0 = rng.randint(0, size - s)
        cls = rng.randint(0, num_classes)
        data[i, cls % 3, y0:y0 + s, x0:x0 + s] = 1.0
        label[i, 0] = [cls, x0 / size, y0 / size, (x0 + s) / size,
                       (y0 + s) / size]
    return data, label


def ssd_loss(torch, outs):
    """The example's cls + loc loss of one step from the train graph's
    outputs (cls_prob, loc_loss, cls_target), computed where they lie."""
    cls_prob, loc_loss, cls_target = (o._data.float() for o in outs)
    valid = cls_target >= 0
    idx = cls_target.clamp_min(0).long().unsqueeze(1)
    picked = cls_prob.gather(1, idx).squeeze(1)
    ce = -picked.clamp_min(1e-8).log()[valid].mean()
    return (ce + loc_loss.sum() / valid.sum().clamp_min(1)).item()


def ssd_module(mt, net, ctx, data_shape, label_shape, args=None, aux=None):
    """The example's Module: data and label by name, Xavier() (or the
    given parameters), SGD lr 0.2 momentum 0.9."""
    mod = mt.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=ctx)
    mod.bind(data_shapes=[mt.io.DataDesc("data", data_shape)],
             label_shapes=[mt.io.DataDesc("label", label_shape)])
    if args is None:
        mod.init_params(mt.init.Xavier())
    else:
        mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SSD_SGD)
    return mod


def ssd_target_probe(mt, ctx, args, aux, batch):
    """The train graph's matching on ``ctx`` at the given state: the
    heads' class predictions and MultiBoxTarget's (loc_mask, cls_target),
    from a graph of the same layers and parameter names (the train graph
    shows cls_target but not loc_mask).  Returns numpy arrays."""
    import inspect

    from mxnet_tpu_torch.models import ssd

    widths = inspect.signature(ssd.get_ssd_train).parameters[
        "num_filters"].default
    with mt.NameManager():
        _, (loc, cls, anchors) = ssd._ssd_graph(SSD["num_classes"], widths)
        tmp = mt.sym._contrib_MultiBoxTarget(
            anchors, mt.sym.Variable("label"), cls, overlap_threshold=0.5,
            ignore_label=-1, negative_mining_ratio=3.0,
            minimum_negative_samples=0, negative_mining_thresh=0.5,
            variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
        net = mt.sym.Group([cls, tmp[1], tmp[2]])
    feed = {k: mt.nd.NDArray(v.to(ctx.torch_device()), ctx)
            for k, v in args.items()}
    feed["data"] = batch.data[0].as_in_context(ctx)
    feed["label"] = batch.label[0].as_in_context(ctx)
    ex = net.bind(ctx, feed, aux_states={
        k: mt.nd.NDArray(v.to(ctx.torch_device()), ctx)
        for k, v in aux.items()})
    return [o.asnumpy() for o in ex.forward(is_train=True)]


def mining_gaps(cls_pred, loc_mask, k_ratio=3.0):
    """Per sample, the relative score gap between the last mined hard
    negative (rank k - 1 of the negatives by their best non-background
    prediction) and the next one."""
    pos = loc_mask.reshape(loc_mask.shape[0], -1, 4)[..., 0] > 0
    scores = cls_pred[:, 1:, :].max(axis=1).astype(np.float64)
    gaps = []
    for s, p in zip(scores, pos):
        k = int(np.float32(p.sum()) * np.float32(k_ratio))
        neg = np.sort(s[~p])[::-1]
        if 0 < k < len(neg):
            gaps.append(abs(neg[k - 1] - neg[k]) / max(abs(neg[k - 1]),
                                                       1e-30))
        else:
            gaps.append(np.inf)
    return np.array(gaps)


def ssd_cpu_witness(torch, mt, net, states, batches, losses):
    """The card's first steps against the port's CPU route (held to the
    JAX package by tests/test_torch_models.py) from the same states and
    batches: the example's loss within the float32 agree limit, and
    MultiBoxTarget's loc_mask and cls_target equal.  Where the targets
    differ, the count of anchors and, per sample, the score gap at the
    last hard negative are printed, and a difference is accepted only in
    samples whose gap is under NEAR_TIE."""
    cpu = mt.cpu()
    t0 = time.perf_counter()
    anchored, diffs = [], []
    for (args, aux), batch in zip(states, batches):
        host = mt.io.DataBatch(
            data=[batch.data[0].as_in_context(cpu)],
            label=[batch.label[0].as_in_context(cpu)], pad=0)
        mod = ssd_module(mt, net, cpu, host.data[0].shape,
                         host.label[0].shape,
                         {k: mt.nd.NDArray(v.clone(), cpu)
                          for k, v in args.items()},
                         {k: mt.nd.NDArray(v.clone(), cpu)
                          for k, v in aux.items()})
        mod.forward(host, is_train=True)
        anchored.append(ssd_loss(torch, mod.get_outputs()))
        del mod
        card = ssd_target_probe(mt, mt.gpu(0), args, aux, batch)
        host_t = ssd_target_probe(mt, cpu, args, aux, batch)
        mask_diff = card[1] != host_t[1]
        cls_diff = card[2] != host_t[2]
        samples = sorted(set(np.nonzero(mask_diff)[0]) |
                         set(np.nonzero(cls_diff)[0]))
        gaps = mining_gaps(host_t[0], host_t[1])
        diffs.append((int(mask_diff.sum()) // 4, int(cls_diff.sum()),
                      samples, gaps))
    secs = time.perf_counter() - t0
    card = losses[:len(states)]
    err = max(abs(c - a) / abs(a) for c, a in zip(card, anchored))
    limit = AGREE[None][1]
    print("ssd: the card's first %d losses %s; the port's CPU route at the "
          "card's states %s (%.1f s), relative error %.3g (tolerance %g)"
          % (len(states), ["%.7f" % x for x in card],
             ["%.7f" % x for x in anchored], secs, err, limit), flush=True)
    check(err <= limit, "the SSD losses on the card disagree with the "
          "port's CPU route: %s vs %s" % (card, anchored))
    for step, (masks, classes, samples, gaps) in enumerate(diffs):
        near = all(gaps[s] < NEAR_TIE for s in samples)
        print("ssd: step %d MultiBoxTarget card vs CPU: %d anchors' loc_mask "
              "and %d anchors' cls_target differ, in samples %s; the score "
              "gap at the last hard negative there %s (accepted below %g: %s)"
              % (step, masks, classes, samples,
                 ["%.3g" % gaps[s] for s in samples], NEAR_TIE, near),
              flush=True)
        check(near, "MultiBoxTarget's targets differ between the card and "
              "the CPU away from a near-tie (step %d, samples %s)"
              % (step, samples))


def nms_timer(torch):
    """Wrap ``contrib_ops._nms_keep`` so that each call records CUDA events
    around it; returns (the list of (start, end) event pairs, a function
    that restores the original)."""
    from mxnet_tpu_torch.ops import contrib_ops

    original, spans = contrib_ops._nms_keep, []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    contrib_ops._nms_keep = timed

    def restore():
        contrib_ops._nms_keep = original

    return spans, restore


def detections_agree(card, host, thresh, nms_thresh):
    """Rows kept (id >= 0) on the card and on the CPU: (number of rows that
    differ, the rows not excused).  A differing row is excused where its
    score lies within NEAR_TIE of ``thresh``, or where it overlaps a box
    of its class (of the CPU's decoding) by an IoU within NEAR_TIE of
    ``nms_thresh``, or, in turn, by more than ``nms_thresh`` a box that
    is itself excused (a suppressor whose own keep flipped)."""
    n_rows, bad = 0, []
    for b in range(card.shape[0]):
        ck, hk = card[b, :, 0] >= 0, host[b, :, 0] >= 0
        differ = np.nonzero((ck != hk) | (ck & hk & (card[b, :, 0] !=
                                                     host[b, :, 0])))[0]
        n_rows += len(differ)
        if not len(differ):
            continue
        boxes, scores = host[b, :, 2:], host[b, :, 1]
        excused = {int(r) for r in differ
                   if abs(scores[r] - thresh) <= NEAR_TIE}
        ids = np.maximum(card[b, :, 0], host[b, :, 0])

        def iou(r, others):
            x0 = np.maximum(boxes[r, 0], boxes[others, 0])
            y0 = np.maximum(boxes[r, 1], boxes[others, 1])
            x1 = np.minimum(boxes[r, 2], boxes[others, 2])
            y1 = np.minimum(boxes[r, 3], boxes[others, 3])
            inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            return inter / np.maximum(area[r] + area[others] - inter, 1e-12)

        same = {int(r): np.nonzero((ids == ids[r]) & (scores >= scores[r]) &
                                   (np.arange(len(ids)) != r))[0]
                for r in differ}
        for r in differ:
            if abs(iou(r, same[int(r)]) - nms_thresh).min(initial=1.0) \
                    <= NEAR_TIE:
                excused.add(int(r))
        grew = True
        while grew:
            grew = False
            for r in differ:
                r = int(r)
                if r in excused:
                    continue
                others = np.array(sorted(excused & set(same[r].tolist())),
                                  int)
                if len(others) and (iou(r, others) > nms_thresh).any():
                    excused.add(r)
                    grew = True
        for r in differ:
            print("ssd serve: sample %d row %d: card %s, CPU %s, %s"
                  % (b, r, card[b, r, :2].tolist(), host[b, r, :2].tolist(),
                     "near a threshold" if int(r) in excused else
                     "NOT near a threshold"), flush=True)
            if int(r) not in excused:
                bad.append((b, int(r)))
    return n_rows, bad


def ssd_phase(torch, mt, profile_dir=None):
    """Phase 10: the repo's SSD (BASELINE.md config #4, 20 classes, 300²,
    batch 32) trained through ``mt.mod.Module`` on the default context as
    examples/ssd/train_ssd.py drives it (forward, outputs, backward,
    update) on its synthetic boxes, then served from the checkpoint by
    ``mt.Predictor`` with ``get_ssd_detect``.  Training must keep every
    parameter and aux state on the card, give finite losses whose last
    pass is below the first, and match the port's CPU route at its first
    steps (losses and MultiBoxTarget's targets); serving must give
    well-formed detections whose kept rows are the CPU route's.  Returns
    the launch counts (no kernel of the port's own is on this path) and
    the training step's ms."""
    from mxnet_tpu_torch.models import get_ssd_detect, get_ssd_train

    with mt.NameManager():
        net = get_ssd_train(**SSD)
    with mt.NameManager():
        det = get_ssd_detect(**SSD)
    check(not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.allow_tf32,
          "a TF32 flag is on for the float32 SSD run")
    X, L = synthetic_detection(SSD_IMAGES, size=SSD_IMAGE[1],
                               num_classes=SSD["num_classes"])
    it = mt.io.NDArrayIter(data=X, label=L, batch_size=SSD_BATCH,
                           label_name="label")
    mt.random.seed(SEED)
    mt.kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod = mt.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mt.current_context())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=SSD_SGD)
    torch.cuda.synchronize()
    ex = mod._exec_group.execs[0]
    names = mod._exec_group.param_names
    n_params = sum(ex.arg_dict[n].size for n in names)
    on_card = all(ex.arg_dict[n]._data.is_cuda for n in names) and \
        all(t._data.is_cuda for t in ex.aux_dict.values())
    print("ssd: %d parameters and %d aux states on %s, bound and initialized "
          "in %.2f s; %d images %s, labels %s, batch %d"
          % (n_params, len(ex.aux_dict), ex.arg_dict[names[0]].context,
             time.perf_counter() - t0, SSD_IMAGES, X.shape[1:], L.shape[1:],
             SSD_BATCH), flush=True)
    check(on_card, "the SSD parameters do not live on the card")

    def step(batch):
        t = time.perf_counter()
        mod.forward(batch, is_train=True)
        outs = mod.get_outputs()
        loss = ssd_loss(torch, outs)
        mod.backward()
        mod.update()
        torch.cuda.synchronize()
        return loss, time.perf_counter() - t, outs

    states, batches, losses, times, passes = [], [], [], [], []
    it.reset()
    for i, batch in zip(range(SSD_WARMUP), it):  # warm-up, first 2 batches
        states.append(state_snapshot(mod))
        batches.append(batch)
        loss, secs, outs = step(batch)
        losses.append(loss)
        if i == 0:
            shapes = [tuple(o.shape) for o in outs]
        print("ssd: warm-up step %d: %.2f ms, loss %.6f"
              % (i, secs * 1e3, loss), flush=True)
    check(shapes[0] == (SSD_BATCH, SSD["num_classes"] + 1, SSD_ANCHORS),
          "cls_prob has shape %s" % (shapes[0],))
    for p in range(SSD_PASSES):
        it.reset()
        got = []
        for batch in it:
            loss, secs, _ = step(batch)
            got.append(loss)
            times.append(secs)
        passes.append(float(np.mean(got)))
        losses += got
        print("ssd: pass %d: cls+loc loss %.6f (steps %s)"
              % (p, passes[-1], ["%.4f" % x for x in got]), flush=True)
    step_ms = float(np.mean(times[-5:])) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("ssd: step ms %.2f (mean of the last 5 of %d steps after %d "
          "warm-up; forward, backward, update as the example runs them; "
          "before the list update: %.2f); img/s %.1f; peak device memory "
          "%.2f GB; outputs %s"
          % (step_ms, len(times), SSD_WARMUP, BEFORE_MS["ssd"],
             SSD_BATCH / step_ms * 1e3,
             peak_gb, shapes), flush=True)
    check(all(np.isfinite(losses)), "SSD losses are not finite: %s" % losses)
    check(passes[-1] < passes[0], "the SSD loss did not fall: passes %s"
          % passes)
    check(all(ex.arg_dict[n]._data.is_cuda for n in names) and
          all(t._data.is_cuda for t in ex.aux_dict.values()),
          "the SSD parameters left the card")
    print("ssd: cls+loc loss per pass %s; every parameter and aux state on "
          "%s" % (["%.6f" % x for x in passes],
                  ex.arg_dict[names[0]]._data.device), flush=True)
    ssd_cpu_witness(torch, mt, net, states, batches, losses)
    if profile_dir:
        profile(torch, lambda: step(batches[0]), profile_dir,
                "ssd_train_step")
    launches = dict(mt.kernels.LAUNCHES)

    # serving: the checkpoint through Predictor with the detect graph
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ssd")
        mod.save_checkpoint(prefix, SSD_PASSES)
        del mod, ex
        torch.cuda.empty_cache()
        params = "%s-%04d.params" % (prefix, SSD_PASSES)
        shapes = {"data": (SSD_BATCH,) + SSD_IMAGE}
        pred = mt.Predictor(det, params, shapes)
        host = mt.Predictor(det, params, shapes, ctx=mt.cpu())
    spans, restore = nms_timer(torch)
    attrs = det._outputs[0][0].attrs
    req_ms, nms_ms = [], []
    try:
        for r in range(SSD_REQUESTS):
            images = X[r * SSD_BATCH:(r + 1) * SSD_BATCH]
            spans.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            pred.forward(data=images)
            out = pred.get_output(0)
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t) * 1e3)
            nms_ms.append(sum(s.elapsed_time(e) for s, e in spans))
            card = out.asnumpy()
            host.forward(data=images)
            ref = host.get_output(0).asnumpy()
            ids = card[..., 0]
            well = (card.shape == (SSD_BATCH, SSD_ANCHORS, 6) and
                    np.isfinite(card).all() and ids.min() >= -1 and
                    ids.max() <= SSD["num_classes"] - 1 and
                    np.array_equal(ids, np.round(ids)) and
                    card[..., 1].min() >= 0 and card[..., 1].max() <= 1 and
                    card[..., 2:].min() >= 0 and card[..., 2:].max() <= 1)
            n_diff, bad = detections_agree(card, ref, attrs["threshold"],
                                           attrs["nms_threshold"])
            kept = int((ids >= 0).sum())
            print("ssd serve: request %d: %.2f ms (NMS %.2f ms, %.1f%%), "
                  "output %s, %d rows kept (CPU %d), %d rows differ from "
                  "the CPU route, %d not near a threshold"
                  % (r, req_ms[-1], nms_ms[-1], 100 * nms_ms[-1] / req_ms[-1],
                     card.shape, kept, int((ref[..., 0] >= 0).sum()), n_diff,
                     len(bad)), flush=True)
            check(well, "the SSD detections are not well formed (request %d)"
                  % r)
            check(kept > 0, "the SSD request kept no detection")
            check(not bad, "the card's detections differ from the CPU "
                  "route's away from any threshold: %s" % bad[:8])
        if profile_dir:
            images = X[:SSD_BATCH]
            profile(torch, lambda: pred.forward(data=images), profile_dir,
                    "ssd_request")
    finally:
        restore()
    print("ssd serve: %d requests of %d images: first %.2f ms, then %.2f ms "
          "per request; NMS %.2f ms of them (%.1f%%, %d rounds of "
          "nms_topk %d)" % (SSD_REQUESTS, SSD_BATCH, req_ms[0],
                            float(np.mean(req_ms[1:])),
                            float(np.mean(nms_ms[1:])),
                            100 * float(np.mean(nms_ms[1:])) /
                            float(np.mean(req_ms[1:])),
                            min(attrs["nms_topk"], SSD_ANCHORS),
                            attrs["nms_topk"]), flush=True)
    del pred, host
    torch.cuda.empty_cache()
    return launches, step_ms


def small_ssd_agreement(torch, mt):
    """The small SSD of tests/test_ssd.py (2 classes, 64², batch 8, the
    example's images) trained 3 SGD-momentum steps on the card and on the
    CPU from one numpy init: the example's loss, parameters and aux states
    within the float32 agree limit, and every step's class targets
    equal."""
    from mxnet_tpu_torch.models import get_ssd_train

    with mt.NameManager():
        net = get_ssd_train(**SMALL_SSD)
    X, L = synthetic_detection(SMALL_SSD_SHAPE[0], size=SMALL_SSD_SHAPE[2],
                               num_classes=2, seed=SEED, rows=4)
    arg_shapes, _, aux_shapes = net.infer_shape(data=X.shape, label=L.shape)
    rng = np.random.RandomState(SEED + 9)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "label"):
            continue
        if n.endswith("weight"):
            rf = int(np.prod(s[2:]))
            scale = np.sqrt(6.0 / (s[1] * rf + s[0] * rf))
            args[n] = rng.uniform(-scale, scale, s).astype(np.float32)
        else:
            args[n] = (np.ones if n.endswith("gamma") else np.zeros)(
                s, np.float32)
    aux = {n: (np.zeros if n.endswith("mean") else np.ones)(s, np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}

    def run(ctx):
        mod = ssd_module(mt, net, ctx, X.shape, L.shape,
                         {k: mt.nd.array(v, ctx) for k, v in args.items()},
                         {k: mt.nd.array(v, ctx) for k, v in aux.items()})
        batch = mt.io.DataBatch(data=[mt.nd.array(X, ctx)],
                                label=[mt.nd.array(L, ctx)])
        losses, targets = [], []
        for _ in range(3):
            mod.forward(batch, is_train=True)
            outs = mod.get_outputs()
            losses.append(ssd_loss(torch, outs))
            targets.append(outs[2].asnumpy())
            mod.backward()
            mod.update()
        a, x = mod.get_params()
        return (losses, {k: v.asnumpy() for k, v in a.items()},
                {k: v.asnumpy() for k, v in x.items()}, targets)

    card, cpu = run(mt.gpu(0)), run(mt.cpu())
    d = train_distance(card[:3], cpu[:3], args, aux)
    same = all(np.array_equal(a, b) for a, b in zip(card[3], cpu[3]))
    _, loss_tol, param_tol = AGREE[None]
    print("check: small SSD trained 3 SGD-momentum steps (float32, lr 0.2) "
          "on the card vs the CPU: losses %s vs %s, relative loss error %.3g "
          "(tolerance %g), parameter error %.3g and aux error %.3g of the "
          "largest (tolerance %g); class targets equal at every step: %s"
          % (["%.6f" % x for x in card[0]], ["%.6f" % x for x in cpu[0]],
             d[0], loss_tol, d[1], d[2], param_tol, same), flush=True)
    check(d[0] <= loss_tol and d[1] <= param_tol and d[2] <= param_tol and
          same, "the small SSD trained on the card disagrees with the CPU")


#: the samplers' phase: (op, attrs, mean, variance, fourth central moment)
SAMPLERS = (
    ("_sample_uniform", dict(low=-2.0, high=5.0), 1.5, 49 / 12, 7 ** 4 / 80),
    ("_sample_normal", dict(loc=3.0, scale=0.5), 3.0, 0.25, 3 * 0.5 ** 4),
    ("_sample_gamma", dict(alpha=2.5, beta=1.5), 3.75, 5.625,
     5.625 ** 2 * (3 + 6 / 2.5)),
    ("_sample_exponential", dict(lam=4.0), 0.25, 1 / 16, 9 / 4 ** 4),
    ("_sample_poisson", dict(lam=3.0), 3.0, 3.0, 3.0 * 10.0),
)


def random_phase(torch, mt):
    """Phase 11: each sampler drawn on the card from the device generator
    (``mt.nd`` on the default context): 2**20 draws whose mean and
    variance lie within 6 standard errors of the distribution's; then
    ``random.get_state``/``set_state`` replays the card's bits."""
    n = 1 << 20
    mt.random.seed(SEED)
    for name, attrs, mean, var, mu4 in SAMPLERS:
        x = getattr(mt.nd, name)(shape=(n,), **attrs)
        check(x._data.is_cuda, "%s did not draw on the card" % name)
        v = x._data.double()
        m, s2 = v.mean().item(), v.var(unbiased=False).item()
        ok = abs(m - mean) <= 6 * np.sqrt(var / n) and \
            abs(s2 - var) <= 6 * np.sqrt((mu4 - var * var) / n)
        print("random: %s %s on %s: mean %.6f (%.6f), variance %.6f (%.6f) "
              "of %d draws; within 6 standard errors: %s"
              % (name, attrs, x._data.device, m, mean, s2, var, n, ok),
              flush=True)
        check(ok, "%s's draws on the card are off their distribution" % name)
    state = mt.random.get_state()
    first = [mt.random.uniform(shape=(1000,)).asnumpy(),
             mt.random.normal(shape=(1000,)).asnumpy(),
             mt.random.randint(0, 1000, shape=(1000,)).asnumpy()]
    mt.random.set_state(state)
    again = [mt.random.uniform(shape=(1000,)).asnumpy(),
             mt.random.normal(shape=(1000,)).asnumpy(),
             mt.random.randint(0, 1000, shape=(1000,)).asnumpy()]
    same = all(np.array_equal(a, b) for a, b in zip(first, again))
    print("random: get_state/set_state on %s replays the bits of uniform, "
          "normal and randint: %s" % (sorted(state["generators"]), same),
          flush=True)
    check(same, "set_state did not replay the card's draws")


# phase 11 ``train_api``: LeNet/MNIST through FeedForward (BASELINE.md config
# #1, examples/image_classification/train_mnist.py's defaults) and every
# optimizer over the full-width LM
MNIST_N, MNIST_VAL, MNIST_BATCH, MNIST_EPOCHS = 6000, 1000, 64, 5
MNIST_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)
# the JAX package's own final validation accuracy on the CPU
# (``python examples/image_classification/train_mnist.py --num-epochs 5``,
# synthetic digits, batch 64); the card's run may fall short of it by at
# most MNIST_GATE
JAX_MNIST_VAL_ACC = 0.997070
MNIST_GATE = 0.02
MNIST_WITNESS = 2
# every optimizer of the JAX package in its registry order, over the
# train phase's LM: (label, name, kwargs, f32 accesses of one update per
# parameter: each input read once, each output written once)
# (Test's update is weight += rescale_grad · grad, an ascent: at
# Module's 1/batch the LM's loss reached nan in 2 steps)
LM_OPTIMIZERS = (
    ("sgd", "sgd", dict(learning_rate=1e-3, momentum=0.9, wd=1e-4), 5),
    ("dcasgd", "dcasgd", dict(learning_rate=1e-3, momentum=0.9, wd=1e-4), 7),
    ("nag", "nag", dict(learning_rate=1e-3, momentum=0.9, wd=1e-4), 5),
    ("sgld", "sgld", dict(learning_rate=1e-6), 3),
    ("ccsgd", "ccsgd", dict(learning_rate=1e-3, momentum=0.9, wd=1e-4), 5),
    ("adam", "adam", dict(learning_rate=TRAIN_LR), 7),
    ("adagrad", "adagrad", dict(learning_rate=1e-3), 5),
    ("rmsprop", "rmsprop", dict(learning_rate=TRAIN_LR), 5),
    ("rmsprop centered", "rmsprop", dict(learning_rate=TRAIN_LR,
                                         centered=True), 9),
    ("adadelta", "adadelta", {}, 7),
    ("test", "test", dict(rescale_grad=1e-4), 4),
)
LM_OPT_WARMUP, LM_OPT_STEPS = 1, 3
UPDATE_ROUNDS = 10
# the per-array loop over the registered update op of an optimizer
PER_ARRAY_OPS = {"sgd": "sgd_mom_update", "adam": "adam_update",
                 "rmsprop": "rmsprop_update",
                 "rmsprop centered": "rmspropalex_update"}


def synthetic_mnist(n=6000, seed=0):
    """10 random 28x28 class templates + per-sample noise and shifts (a
    copy of examples/image_classification/train_mnist.py's)."""
    rng = np.random.RandomState(seed)
    templates = rng.uniform(0, 1, (10, 28, 28)).astype(np.float32)
    labels = rng.randint(0, 10, n)
    imgs = templates[labels]
    shifts = rng.randint(-2, 3, (n, 2))
    out = np.empty_like(imgs)
    for i in range(n):
        out[i] = np.roll(imgs[i], tuple(shifts[i]), axis=(0, 1))
    out += rng.normal(0, 0.3, out.shape).astype(np.float32)
    return out[:, None], labels.astype(np.float32)


def mnist_files(folder, n=MNIST_N):
    """The synthetic digits as MNIST files: the images after the first
    MNIST_VAL as idx-ubyte (magic 2051/2049, uint8 at x255: the round trip
    clips the noise to [0, 1] and quantises it to 1/255), the first
    MNIST_VAL, the example's validation split, quantised alike, as CSV.
    Returns the paths."""
    x, y = synthetic_mnist(n)
    u8 = np.clip(np.round(x[:, 0] * 255), 0, 255).astype(np.uint8)
    paths = {k: os.path.join(folder, k) for k in
             ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "val-data.csv", "val-label.csv")}
    train, val = u8[MNIST_VAL:], u8[:MNIST_VAL]
    with open(paths["train-images-idx3-ubyte"], "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(train), 28, 28))
        f.write(train.tobytes())
    with open(paths["train-labels-idx1-ubyte"], "wb") as f:
        f.write(struct.pack(">II", 2049, len(train)))
        f.write(y[MNIST_VAL:].astype(np.uint8).tobytes())
    np.savetxt(paths["val-data.csv"], val.reshape(len(val), -1) / 255.0,
               delimiter=",", fmt="%.8g")
    np.savetxt(paths["val-label.csv"], y[:MNIST_VAL], delimiter=",",
               fmt="%d")
    return paths


def mnist_iters(mt, paths):
    """(train, validation): MNISTIter in a PrefetchingIter, and CSVIter
    resized to its batch count (its last batch padded from the start)."""
    train = mt.io.PrefetchingIter(mt.io.MNISTIter(
        image=paths["train-images-idx3-ubyte"],
        label=paths["train-labels-idx1-ubyte"], batch_size=MNIST_BATCH,
        shuffle=True))
    csv = mt.io.CSVIter(data_csv=paths["val-data.csv"],
                        data_shape=(1, 28, 28),
                        label_csv=paths["val-label.csv"], label_shape=(),
                        batch_size=MNIST_BATCH)
    val = mt.io.ResizeIter(csv, -(-MNIST_VAL // MNIST_BATCH))
    return train, val


def lenet_witness(torch, mt, net, init, batches, losses,
                  label="train_api lenet"):
    """The card's first MNIST_WITNESS steps again on the port's CPU route
    from the same init and batches: each loss within 1e-4 relative."""
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (MNIST_BATCH, 1, 28, 28))],
             label_shapes=[("softmax_label", (MNIST_BATCH,))])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in init.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(MNIST_SGD))
    cpu = []
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        cpu.append(lm_loss(torch, mod.get_outputs()[0],
                           b.label[0].asnumpy()))
    err = max(abs(a - c) / abs(c) for a, c in zip(losses, cpu))
    print("%s: first %d steps' losses on the card %s vs the "
          "CPU route %s: relative error %.3g (tolerance 1e-4)"
          % (label, len(cpu), ["%.7f" % x for x in losses],
             ["%.7f" % x for x in cpu], err), flush=True)
    check(err <= 1e-4, "%s: the first steps on the card disagree with "
          "the CPU route" % label)


def lenet_feedforward(torch, mt, folder):
    """(a) LeNet trained MNIST_EPOCHS epochs through ``FeedForward`` on the
    default context from MNISTIter + PrefetchingIter, evaluated on CSVIter
    + ResizeIter every epoch; checks and prints as the module docstring
    says."""
    from mxnet_tpu_torch.models.lenet import get_lenet

    paths = mnist_files(folder)
    train, val = mnist_iters(mt, paths)
    with mt.NameManager():
        net = get_lenet(10)
    # the Xavier init on the card, from the seed, kept as numpy for the CPU
    # witness; FeedForward starts from it
    mt.random.seed(SEED)
    probe = mt.mod.Module(net)
    probe.bind(data_shapes=train.provide_data,
               label_shapes=train.provide_label)
    probe.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
    init = {k: v.asnumpy() for k, v in probe.get_params()[0].items()}
    del probe
    n_batches = (MNIST_N - MNIST_VAL) // MNIST_BATCH
    prefix = os.path.join(folder, "lenet")
    ff = mt.model.FeedForward(
        net, ctx=None, num_epoch=MNIST_EPOCHS, optimizer="sgd",
        initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
        arg_params={k: mt.nd.array(v, mt.gpu(0)) for k, v in init.items()},
        aux_params={}, **MNIST_SGD)
    ends, witness, val_metrics, train_metrics = [], [], [], []

    def on_batch(param):
        ends.append((param.epoch, param.nbatch, time.perf_counter()))
        if param.epoch == 0 and param.nbatch < MNIST_WITNESS:
            mod = param.locals["self"]
            b = param.locals["data_batch"]
            witness.append((b, lm_loss(torch, mod.get_outputs()[0],
                                       b.label[0].asnumpy())))
        if param.nbatch == n_batches - 1:
            train_metrics.append(param.eval_metric.get_name_value())

    def on_eval(param):
        val_metrics.append(param.eval_metric.get_name_value())

    metric = mt.metric.create(["acc", mt.metric.TopKAccuracy(top_k=3),
                               "ce"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    with train:
        ff.fit(train, eval_data=val, eval_metric=metric,
               batch_end_callback=[on_batch,
                                   mt.callback.Speedometer(MNIST_BATCH, 20,
                                                           auto_reset=False),
                                   mt.callback.ProgressBar(n_batches)],
               epoch_end_callback=mt.callback.do_checkpoint(prefix),
               eval_end_callback=on_eval)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not torch.backends.cuda.matmul.allow_tf32 and
          not torch.backends.cudnn.allow_tf32, "a TF32 flag is on")
    # step ms: between consecutive batch ends (each waits for its step in
    # the metric's host read) within an epoch, after the first epoch
    gaps = [t1 - t0 for (e0, _, t0), (e1, _, t1) in zip(ends, ends[1:])
            if e0 == e1 and e0 > 0]
    step_ms = float(np.mean(gaps)) * 1e3
    for epoch, (tr, va) in enumerate(zip(train_metrics, val_metrics)):
        print("train_api lenet: epoch %d train %s validation %s"
              % (epoch, ["%s=%.6f" % kv for kv in tr],
                 ["%s=%.6f" % kv for kv in va]), flush=True)
    print("train_api lenet: %d epochs of %d batches of %d through "
          "FeedForward: step ms %.3f (mean over epochs 1-%d), img/s %.1f, "
          "peak device memory %.3f GB"
          % (MNIST_EPOCHS, n_batches, MNIST_BATCH, step_ms,
             MNIST_EPOCHS - 1, MNIST_BATCH / step_ms * 1e3, peak_gb),
          flush=True)
    ex = ff._module._exec_group.execs[0]
    on_card = all(a._data.is_cuda for a in ex.arg_dict.values())
    print("train_api lenet: every parameter on cuda: %s" % on_card,
          flush=True)
    check(on_card, "LeNet's parameters left the card")
    lenet_witness(torch, mt, net, init, [b for b, _ in witness],
                  [x for _, x in witness])
    final = dict(val_metrics[-1])["accuracy"]
    print("train_api lenet: final validation accuracy %.6f; the JAX "
          "package's own %.6f (CPU, train_mnist.py --num-epochs 5); gate "
          ">= %.6f" % (final, JAX_MNIST_VAL_ACC,
                       JAX_MNIST_VAL_ACC - MNIST_GATE), flush=True)
    check(final >= JAX_MNIST_VAL_ACC - MNIST_GATE,
          "LeNet's validation accuracy %.6f is under the gate" % final)
    # the checkpoint of the last epoch, loaded and scored alike
    loaded = mt.model.FeedForward.load(prefix, MNIST_EPOCHS)
    renamed = mt.io.PrefetchingIter(val, rename_label=[{"label":
                                                        "softmax_label"}])
    with renamed:
        again = loaded.score(renamed)
    print("train_api lenet: FeedForward.load(prefix, %d).score: %.6f vs "
          "%.6f" % (MNIST_EPOCHS, again, final), flush=True)
    check(abs(again - final) <= 1e-6, "the reloaded LeNet scores otherwise")
    probs = ff.predict(val)
    rows = np.abs(probs.astype(np.float64).sum(1) - 1).max()
    print("train_api lenet: predict: %s probabilities, rows sum to 1 within "
          "%.3g" % (probs.shape, rows), flush=True)
    check(probs.shape == (MNIST_VAL, 10) and rows <= 1e-5,
          "LeNet's predictions are not (%d, 10) probabilities" % MNIST_VAL)
    return {"step_ms": step_ms, "val_acc": final, "peak_gb": peak_gb}


def optimizer_states_gb(states):
    """Bytes of an updater's states, in GB."""
    total = 0
    for st in states.values():
        for s in (st if isinstance(st, tuple) else (st,)):
            if s is not None:
                total += s._data.numel() * s._data.element_size()
    return total / 1e9


def lm_optimizer_sweep(torch, mt, batch, replay):
    """(b) Every optimizer over the train phase's LM (bf16 compute, float32
    masters, its init and batch): LM_OPT_WARMUP + LM_OPT_STEPS fused steps
    each, after ``init_optimizer(force_init=True)`` from the init.  Returns
    {label: (step ms, states GB, losses)}."""
    b, s = BATCH, FULL["seq_len"]
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    mod = train_module(mt, replay["net"], None, (b, s), arg_params=init,
                       compute_dtype="bfloat16")
    ex = mod._exec_group.execs[0]
    out = {}
    for label, name, kwargs, _ in LM_OPTIMIZERS:
        mod.set_params(init, {})
        mod.init_optimizer(kvstore="local", optimizer=name,
                           optimizer_params=dict(kwargs), force_init=True)
        losses, times = [], []
        for _ in range(LM_OPT_WARMUP + LM_OPT_STEPS):
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(lm_loss(torch, mod.get_outputs()[0], replay["Y"]))
        states = mod._updater.states
        on_card = all(a._data.is_cuda for a in ex.arg_dict.values()) and \
            all(x._data.is_cuda for st in states.values()
                for x in (st if isinstance(st, tuple) else (st,))
                if x is not None)
        step_ms = float(np.mean(times[LM_OPT_WARMUP:])) * 1e3
        gb = optimizer_states_gb(states)
        print("train_api lm %s: step ms %.2f (mean of %d after %d warm-up), "
              "optimizer states %.3f GB, losses %s, parameters and states "
              "on cuda: %s" % (label, step_ms, LM_OPT_STEPS, LM_OPT_WARMUP,
                               gb, ["%.6f" % x for x in losses], on_card),
              flush=True)
        check(np.all(np.isfinite(losses)), "%s: the LM's loss is not finite"
              % label)
        check(on_card, "%s: parameters or states left the card" % label)
        if label == "adam":
            check(losses[-1] < losses[0], "adam: the LM's loss did not fall")
        out[label] = (step_ms, gb, losses)
    del mod, ex, init
    torch.cuda.empty_cache()
    return out


def per_array_loop(mt, label, opt, weights, grads, states, t):
    """The update as a user's loop over the registered update op: one
    ``nd.<op>`` call per array (torch tensors in place)."""
    op = getattr(mt.nd, PER_ARRAY_OPS[label])
    for i, (w, g) in enumerate(zip(weights, grads)):
        common = dict(lr=opt._get_lr(i), wd=opt._get_wd(i),
                      rescale_grad=opt.rescale_grad)
        st = states[i]
        if label == "sgd":
            op(w, g, st, out=w, momentum=opt.momentum, **common)
        elif label == "adam":
            common["lr"] *= (math.sqrt(1.0 - opt.beta2 ** t) /
                             (1.0 - opt.beta1 ** t))
            op(w, g, *st, out=w, beta1=opt.beta1, beta2=opt.beta2,
               epsilon=opt.epsilon, **common)
        elif label == "rmsprop":
            op(w, g, *st, out=w, gamma1=opt.gamma1, epsilon=opt.epsilon,
               **common)
        else:
            op(w, g, *st, out=w, gamma1=opt.gamma1, gamma2=opt.gamma2,
               epsilon=opt.epsilon, **common)


def fused_adam(torch, weights, grads):
    """A call of ``torch._fused_adam_`` (the library's multi-tensor adam:
    a yardstick only, eps inside its bias correction) on copies."""
    w = [x.clone() for x in weights]
    g = [x.clone() for x in grads]
    m = [torch.zeros_like(x) for x in weights]
    v = [torch.zeros_like(x) for x in weights]
    steps = [torch.ones((), device=x.device) for x in weights]
    return lambda: torch._fused_adam_(
        w, g, m, v, [], steps, amsgrad=False, lr=TRAIN_LR, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-8, maximize=False,
        grad_scale=None, found_inf=None)


def update_table(torch, mt, gen, device):
    """The update alone over every parameter array of the full-width LM
    (``lm_update_arrays``): per optimizer, the list update (median of
    UPDATE_ROUNDS calls by CUDA events; the gradients are read, as on the
    two-phase path: the fused step's own update skips the rescaled copy),
    beside it the per-array loop over the registered update op where there
    is one (timed in turns with it, after both started from the same
    arrays: the new weights within 2 float32 ulps), the bytes bound, and
    ``torch._fused_sgd_``/``torch._fused_adam_`` as yardsticks.  Returns
    the table's rows."""
    weights, grads = lm_update_arrays(torch, mt, gen, device)
    n = sum(w.numel() for w in weights)
    with mt.NameManager():
        from mxnet_tpu_torch.models.transformer import get_transformer_lm

        names = [k for k in get_transformer_lm(**FULL).list_arguments()
                 if k not in ("data", "softmax_label")]
    _, peak = peaks_for(torch.cuda.get_device_name(0))
    yard = in_turns(torch, [("sgd", fused_sgd(torch, weights, grads)),
                            ("adam", fused_adam(torch, weights, grads))],
                    rounds=UPDATE_ROUNDS, reps=1)
    torch.cuda.empty_cache()
    rows = []
    for label, name, kwargs, accesses in LM_OPTIMIZERS:
        kw = dict(kwargs)
        kw.setdefault("rescale_grad", 1.0 / BATCH)
        opt = mt.optimizer.create(name, param_idx2name=dict(enumerate(names)),
                                  **kw)
        nds = [mt.nd.NDArray(w.clone(), mt.gpu(0)) for w in weights]
        states = [mt.optimizer._tensors(opt.create_state(i, w))
                  for i, w in enumerate(nds)]
        ws = [w._data for w in nds]
        idx = list(range(len(ws)))
        t = [1]

        def listed():
            opt.update_tensors_list(idx, ws, grads, states, [t[0]] * len(ws))

        row = {"optimizer": label, "arrays": len(ws), "parameters": n,
               "accesses": accesses,
               "bound_ms": accesses * n * 4 / (peak["tbs"] * 1e12) * 1e3}
        if label in PER_ARRAY_OPS:
            ws2 = [w.clone() for w in ws]
            st2 = [tuple(x.clone() for x in s) if isinstance(s, tuple)
                   else s.clone() for s in states]
            listed()
            per_array_loop(mt, label, opt, ws2, grads, st2, 1)
            torch.cuda.synchronize()
            d = max(ulps(torch, a, b) for a, b in zip(ws, ws2))
            row["ulps"] = d
            print("train_api update %s: the list update's new weights vs "
                  "the per-array %s loop's: %d float32 ulps at most%s"
                  % (label, PER_ARRAY_OPS[label], d,
                     " (bitwise equal)" if d == 0 else ""), flush=True)
            check(d <= 2, "%s: the list update disagrees with the per-array "
                  "update ops (%d ulps)" % (label, d))
            med = in_turns(torch, [
                ("list", listed),
                ("per-array", lambda: per_array_loop(mt, label, opt, ws2,
                                                     grads, st2, 1))],
                rounds=UPDATE_ROUNDS, reps=1)
            row["ms"] = med["list"][0]
            row["per_array_ms"] = med["per-array"][0]
            del ws2, st2
        else:
            med = in_turns(torch, [("list", listed)], rounds=UPDATE_ROUNDS,
                           reps=1)
            row["ms"] = med["list"][0]
            row["per_array_ms"] = None
            row["ulps"] = None
        check(all(torch.isfinite(w).all().item() for w in ws),
              "%s: the list update wrote non-finite weights" % label)
        row["fused_sgd_ms"] = yard["sgd"][0]
        row["fused_adam_ms"] = yard["adam"][0]
        print("train_api update %s: list update %.4f ms over %d arrays (%d "
              "parameters), per-array ops %s, bound %.4f ms (%d f32 "
              "accesses a parameter at %.2f TB/s): %.2fx; yardsticks "
              "torch._fused_sgd_ %.4f ms, torch._fused_adam_ %.4f ms"
              % (label, row["ms"], len(ws), n,
                 "%.4f ms" % row["per_array_ms"]
                 if row["per_array_ms"] is not None else "none",
                 row["bound_ms"], accesses, peak["tbs"],
                 row["ms"] / row["bound_ms"], row["fused_sgd_ms"],
                 row["fused_adam_ms"]), flush=True)
        rows.append(row)
        del nds, states, ws
        torch.cuda.empty_cache()
    del weights, grads
    torch.cuda.empty_cache()
    return rows


def train_api_phase(torch, mt, batch, replay):
    """Phase 11: the training API on the card (module docstring)."""
    with tempfile.TemporaryDirectory() as folder:
        lenet = lenet_feedforward(torch, mt, folder)
    sweep = lm_optimizer_sweep(torch, mt, batch, replay)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = update_table(torch, mt, gen, torch.device("cuda", 0))
    for row in rows:
        step_ms, gb, losses = sweep[row["optimizer"]]
        row.update(lm_step_ms=step_ms, states_gb=gb,
                   lm_losses=[float(x) for x in losses])
    print(json.dumps({"train_api": {"lenet": lenet, "update": rows}}),
          flush=True)


# ---------------------------------------------------------------------------
# spatial: STN-LeNet, Fast R-CNN's ROI pooling, FlowNet's correlation and
# warp, at the widths of the models that use them
# ---------------------------------------------------------------------------

#: the JAX package's own final validation accuracy of the STN-LeNet on the
#: CPU with this phase's net, files, iterators and settings
#: (``JAX_PLATFORMS=cpu python tests/test_torch_spatial.py``); the card's
#: may fall short of it by at most MNIST_GATE
JAX_STN_VAL_ACC = 0.091797
STN_REPLAY = 3
#: Fast R-CNN's VGG16 head (MXNet example/rcnn, roi_pool5 then fc6): the
#: conv5_3 features of a 600x1000 image, 128 ROIs in training, 300 in test
FRCNN_POOL = dict(pooled_size=(7, 7), spatial_scale=0.0625)
FRCNN_FEATURES = (1, 512, 38, 63)
FRCNN_IMAGE = (600, 1000)
FRCNN_ROIS = (128, 300)
FRCNN_FC = 4096
#: FlowNetC's corr layer over its conv3 features (441 displacements)
FLOWNET_CORR = dict(pad_size=20, kernel_size=1, max_displacement=20,
                    stride1=1, stride2=2)
FLOWNET_FEATURES = (8, 256, 48, 64)
#: FlowNet's warping of a batch of 384x512 images by a flow field
WARP_IMAGES = (8, 3, 384, 512)
SPATIAL_REPS = 5


def stn_lenet(mt, num_classes=10):
    """MXNet's example/image-classification/symbols/lenet.py with
    ``add_stn=True``: the localisation net (its FullyConnected named
    ``stn_loc`` with attr lr_mult 0.01), SpatialTransformer to 28x28
    (affine, bilinear), then get_lenet's layers (a copy of
    tests/test_torch_spatial.py's builder)."""
    s = mt.sym
    data = s.Variable("data")
    loc = s.Convolution(data=data, num_filter=30, kernel=(5, 5),
                        stride=(2, 2))
    loc = s.Activation(data=loc, act_type="relu")
    loc = s.Pooling(data=loc, kernel=(2, 2), stride=(2, 2), pool_type="max")
    loc = s.Convolution(data=loc, num_filter=60, kernel=(3, 3), pad=(1, 1))
    loc = s.Activation(data=loc, act_type="relu")
    loc = s.Pooling(data=loc, global_pool=True, kernel=(2, 2),
                    pool_type="avg")
    loc = s.Flatten(data=loc)
    loc = s.FullyConnected(data=loc, num_hidden=6, name="stn_loc",
                           attr={"lr_mult": "0.01"})
    data = s.SpatialTransformer(data=data, loc=loc, target_shape=(28, 28),
                                transform_type="affine",
                                sampler_type="bilinear")
    net = s.Convolution(data=data, kernel=(5, 5), num_filter=20)
    net = s.Activation(data=net, act_type="tanh")
    net = s.Pooling(data=net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = s.Convolution(data=net, kernel=(5, 5), num_filter=50)
    net = s.Activation(data=net, act_type="tanh")
    net = s.Pooling(data=net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = s.Flatten(data=net)
    net = s.FullyConnected(data=net, num_hidden=500)
    net = s.Activation(data=net, act_type="tanh")
    net = s.FullyConnected(data=net, num_hidden=num_classes)
    return s.SoftmaxOutput(data=net, name="softmax")


def stn_replay(torch, mt, net, init, batches, shapes):
    """STN_REPLAY steps of a new Module on the card from ``init`` over
    ``batches``: (losses, parameters)."""
    mod = mt.mod.Module(net)
    mod.bind(data_shapes=shapes[0], label_shapes=shapes[1])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.gpu(0))
                                for k, v in init.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(MNIST_SGD))
    losses = []
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        losses.append(lm_loss(torch, mod.get_outputs()[0],
                              b.label[0].asnumpy()))
    return losses, state_snapshot(mod)[0]


def stn_lenet_run(torch, mt, folder):
    """(a) The STN-LeNet trained MNIST_EPOCHS epochs through
    ``FeedForward`` on the train_api phase's MNIST files and iterators and
    settings: stn_loc starts at weight 0 and the identity bias (the
    initializer's name rules); the first MNIST_WITNESS losses are the CPU
    route's within 1e-4, the final validation accuracy at least
    JAX_STN_VAL_ACC less MNIST_GATE, and STN_REPLAY steps replay bit for
    bit from the init and the run's first batches."""
    paths = mnist_files(folder)
    train, val = mnist_iters(mt, paths)
    with mt.NameManager():
        net = stn_lenet(mt)
    mt.random.seed(SEED)
    probe = mt.mod.Module(net)
    probe.bind(data_shapes=train.provide_data,
               label_shapes=train.provide_label)
    probe.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
    init = {k: v.asnumpy() for k, v in probe.get_params()[0].items()}
    del probe
    rules = (not init["stn_loc_weight"].any() and
             np.array_equal(init["stn_loc_bias"], [1, 0, 0, 0, 1, 0]))
    print("spatial stn: stn_loc weight all 0 and bias the identity "
          "[1, 0, 0, 0, 1, 0] after Xavier: %s" % rules, flush=True)
    check(rules, "the initializer's stn_loc rules did not apply")
    n_batches = (MNIST_N - MNIST_VAL) // MNIST_BATCH
    ff = mt.model.FeedForward(
        net, ctx=None, num_epoch=MNIST_EPOCHS, optimizer="sgd",
        initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
        arg_params={k: mt.nd.array(v, mt.gpu(0)) for k, v in init.items()},
        aux_params={}, **MNIST_SGD)
    ends, first, val_metrics = [], [], []

    def on_batch(param):
        ends.append((param.epoch, param.nbatch, time.perf_counter()))
        if param.epoch == 0 and param.nbatch < STN_REPLAY:
            mod = param.locals["self"]
            b = param.locals["data_batch"]
            first.append((b, lm_loss(torch, mod.get_outputs()[0],
                                     b.label[0].asnumpy())))

    def on_eval(param):
        val_metrics.append(param.eval_metric.get_name_value())

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with train:
        ff.fit(train, eval_data=val, eval_metric="acc",
               batch_end_callback=on_batch, eval_end_callback=on_eval)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gaps = [t1 - t0_ for (e0, _, t0_), (e1, _, t1) in zip(ends, ends[1:])
            if e0 == e1 and e0 > 0]
    step_ms = float(np.mean(gaps)) * 1e3
    final = dict(val_metrics[-1])["accuracy"]
    print("spatial stn: %d epochs of %d batches of %d through FeedForward "
          "in %.1f s: step ms %.3f (mean over epochs 1-%d), img/s %.1f, "
          "peak device memory %.3f GB; validation accuracy per epoch %s"
          % (MNIST_EPOCHS, n_batches, MNIST_BATCH, secs, step_ms,
             MNIST_EPOCHS - 1, MNIST_BATCH / step_ms * 1e3, peak_gb,
             ["%.6f" % dict(m)["accuracy"] for m in val_metrics]),
          flush=True)
    ex = ff._module._exec_group.execs[0]
    check(all(a._data.is_cuda for a in ex.arg_dict.values()),
          "the STN-LeNet's parameters left the card")
    batches = [b for b, _ in first]
    lenet_witness(torch, mt, net, init, batches[:MNIST_WITNESS],
                  [x for _, x in first[:MNIST_WITNESS]], "spatial stn")
    print("spatial stn: final validation accuracy %.6f; the JAX package's "
          "own %.6f (CPU, tests/test_torch_spatial.py); gate >= %.6f"
          % (final, JAX_STN_VAL_ACC, JAX_STN_VAL_ACC - MNIST_GATE),
          flush=True)
    check(final >= JAX_STN_VAL_ACC - MNIST_GATE,
          "the STN-LeNet's validation accuracy %.6f is under the gate"
          % final)
    shapes = (train.provide_data, train.provide_label)
    a = stn_replay(torch, mt, net, init, batches, shapes)
    b = stn_replay(torch, mt, net, init, batches, shapes)
    differ = sorted(k for k in a[1] if not torch.equal(a[1][k], b[1][k]))
    same = a[0] == b[0] and not differ
    print("spatial stn replay: %d steps twice from the init and the run's "
          "first batches: losses %s and %s; %d of %d parameters differ %s"
          % (STN_REPLAY, ["%.9g" % x for x in a[0]],
             ["%.9g" % x for x in b[0]], len(differ), len(a[1]),
             differ[:4]), flush=True)
    check(same, "the STN-LeNet steps do not replay bit for bit")
    return {"step_ms": step_ms, "val_acc": final, "peak_gb": peak_gb}


def rel_max(torch, got, ref):
    """max |got - ref| over max |ref|, in float64 on the CPU."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def spatial_exec(torch, mt, net, ctx, inputs, grad_names):
    """``net`` bound on ``ctx`` with ``inputs`` (name -> CPU tensor), a
    gradient written for each of ``grad_names``."""
    ex = net.simple_bind(ctx, grad_req={n: "write" for n in grad_names},
                         **{k: tuple(v.shape) for k, v in inputs.items()})
    for k, v in inputs.items():
        ex.arg_dict[k]._data.copy_(v)
    return ex


def timed_step(torch, ex, out_grads):
    """(ms of forward alone, ms of forward + backward, peak device GB of
    one forward + backward); the times are CUDA events' means over
    SPATIAL_REPS calls after one warm-up."""
    fwd = cuda_ms(lambda: ex.forward(is_train=True), SPATIAL_REPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ex.forward_backward(out_grads=out_grads)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    both = cuda_ms(lambda: ex.forward_backward(out_grads=out_grads),
                   SPATIAL_REPS)
    return fwd, both, peak


def frcnn_rois(rng, n):
    """``n`` boxes (batch 0, x0, y0, x1, y1) inside the 600x1000 image; a
    quarter with corners at 16k + 8, which land on .5 at scale 1/16."""
    h, w = FRCNN_IMAGE
    x0 = rng.uniform(0, w - 32, n)
    y0 = rng.uniform(0, h - 32, n)
    x1 = np.minimum(x0 + rng.uniform(16, 600, n), w - 1)
    y1 = np.minimum(y0 + rng.uniform(16, 400, n), h - 1)
    boxes = np.stack([np.zeros(n), x0, y0, x1, y1], 1)
    half = n // 4
    boxes[:half, 1:] = np.floor(boxes[:half, 1:] / 16) * 16 + 8
    return boxes.astype(np.float32)


def roi_pool_run(torch, mt):
    """(b) ROIPooling at Fast R-CNN's VGG16 head, through an executor of
    ROIPooling -> Flatten -> FullyConnected(4096), at 128 and 300 ROIs:
    the pooled output bit for bit the CPU route's, the data gradient within
    1e-6; ms by CUDA events and peak memory."""
    rng = np.random.RandomState(SEED)
    feats = torch.from_numpy(np.maximum(
        rng.randn(*FRCNN_FEATURES), 0).astype(np.float32))
    with mt.NameManager():
        pool = mt.sym.ROIPooling(mt.sym.Variable("data"),
                                 mt.sym.Variable("rois"), name="roi_pool5",
                                 **FRCNN_POOL)
        fc = mt.sym.FullyConnected(mt.sym.Flatten(pool),
                                   num_hidden=FRCNN_FC, name="fc6")
        net = mt.sym.Group([pool, fc])
    w = torch.from_numpy((rng.randn(FRCNN_FC, 512 * 49) * 0.01)
                         .astype(np.float32))
    out = {}
    for n in FRCNN_ROIS:
        rois = torch.from_numpy(frcnn_rois(rng, n))
        g = torch.from_numpy(rng.randn(n, FRCNN_FC).astype(np.float32))
        inputs = {"data": feats, "rois": rois, "fc6_weight": w,
                  "fc6_bias": torch.zeros(FRCNN_FC)}
        grads = ("data", "fc6_weight", "fc6_bias")
        heads = [torch.zeros((n, 512, 7, 7)), g]
        results = {}
        for ctx in (mt.gpu(0), mt.cpu()):
            ex = spatial_exec(torch, mt, net, ctx, inputs, grads)
            if ctx.device_type == "gpu":
                fwd, both, peak = timed_step(
                    torch, ex, [h.cuda() for h in heads])
            else:
                ex.forward_backward(out_grads=heads)
            results[ctx.device_type] = (ex.outputs[0]._data.cpu(),
                                        ex.grad_dict["data"]._data.cpu())
            del ex
        card, cpu = results["gpu"], results["cpu"]
        same = torch.equal(card[0], cpu[0])
        gerr = rel_max(torch, card[1], cpu[1])
        print("spatial roi_pool5 %d ROIs: pooled %s; forward %.3f ms, "
              "forward + backward %.3f ms (ROIPooling -> Flatten -> fc6 "
              "%d), peak device memory %.3f GB; pooled output equal to the "
              "CPU route's: %s; data gradient %.3g from it (tolerance 1e-6)"
              % (n, tuple(card[0].shape), fwd, both, FRCNN_FC, peak, same,
                 gerr), flush=True)
        check(same, "ROIPooling's output on the card differs from the CPU "
              "route's (%d ROIs)" % n)
        check(gerr <= 1e-6, "ROIPooling's data gradient on the card is "
              "%.3g from the CPU route's (%d ROIs)" % (gerr, n))
        out[n] = {"fwd_ms": fwd, "fwd_bwd_ms": both, "peak_gb": peak}
    return out


def correlation_run(torch, mt):
    """(c) Correlation at FlowNetC's corr layer (441 displacements over
    conv3 features (8, 256, 48, 64)): ms and peak memory on the card; on
    batch 1 the forward and both gradients within 1e-5 of the CPU route."""
    rng = np.random.RandomState(SEED)
    x1 = torch.from_numpy(rng.randn(*FLOWNET_FEATURES).astype(np.float32))
    x2 = torch.from_numpy(rng.randn(*FLOWNET_FEATURES).astype(np.float32))
    with mt.NameManager():
        net = mt.sym.Correlation(mt.sym.Variable("data1"),
                                 mt.sym.Variable("data2"), name="corr",
                                 **FLOWNET_CORR)
    oshape = net.infer_shape(data1=FLOWNET_FEATURES,
                             data2=FLOWNET_FEATURES)[1][0]
    g = torch.from_numpy(rng.randn(*oshape).astype(np.float32))
    ex = spatial_exec(torch, mt, net, mt.gpu(0), {"data1": x1, "data2": x2},
                      ("data1", "data2"))
    fwd, both, peak = timed_step(torch, ex, [g.cuda()])
    card = [ex.outputs[0]._data[:1].cpu()] + \
        [ex.grad_dict[k]._data[:1].cpu() for k in ("data1", "data2")]
    del ex
    host = spatial_exec(torch, mt, net, mt.cpu(),
                        {"data1": x1[:1], "data2": x2[:1]},
                        ("data1", "data2"))
    t0 = time.perf_counter()
    host.forward_backward(out_grads=[g[:1]])
    secs = time.perf_counter() - t0
    ref = [host.outputs[0]._data] + \
        [host.grad_dict[k]._data for k in ("data1", "data2")]
    errs = [rel_max(torch, c, r) for c, r in zip(card, ref)]
    print("spatial corr: output %s; forward %.3f ms, forward + backward "
          "%.3f ms, peak device memory %.3f GB; batch 1 against the CPU "
          "route (%.1f s): forward %.3g, gradients %.3g and %.3g (tolerance "
          "1e-5)" % (tuple(oshape), fwd, both, peak, secs, *errs),
          flush=True)
    check(max(errs) <= 1e-5, "Correlation on the card disagrees with the "
          "CPU route: %s" % errs)
    return {"fwd_ms": fwd, "fwd_bwd_ms": both, "peak_gb": peak}


def warp_run(torch, mt):
    """(d) GridGenerator(warp) then BilinearSampler over images (8, 3,
    384, 512) and a seeded flow: ms and peak memory; the CPU route within
    1e-5; both gradients bit for bit on a second run; and on a small case
    GridGenerator(affine) + BilinearSampler equal to SpatialTransformer."""
    rng = np.random.RandomState(SEED)
    n, c, h, w = WARP_IMAGES
    img = torch.from_numpy(rng.rand(*WARP_IMAGES).astype(np.float32))
    flow = torch.from_numpy((rng.randn(n, 2, h, w) * 4).astype(np.float32))
    g = torch.from_numpy(rng.randn(*WARP_IMAGES).astype(np.float32))
    with mt.NameManager():
        grid = mt.sym.GridGenerator(mt.sym.Variable("flow"),
                                    transform_type="warp")
        net = mt.sym.BilinearSampler(mt.sym.Variable("data"), grid)
    inputs = {"data": img, "flow": flow}
    ex = spatial_exec(torch, mt, net, mt.gpu(0), inputs, ("data", "flow"))
    fwd, both, peak = timed_step(torch, ex, [g.cuda()])

    def run(e, head):
        e.forward_backward(out_grads=[head])
        return [e.outputs[0]._data.cpu()] + \
            [e.grad_dict[k]._data.cpu() for k in ("data", "flow")]

    first, second = run(ex, g.cuda()), run(ex, g.cuda())
    replay = all(torch.equal(a, b) for a, b in zip(first, second))
    del ex
    host = spatial_exec(torch, mt, net, mt.cpu(), inputs, ("data", "flow"))
    t0 = time.perf_counter()
    ref = run(host, g)
    secs = time.perf_counter() - t0
    errs = [rel_max(torch, a, b) for a, b in zip(first, ref)]
    small = rng.rand(2, 3, 9, 11).astype(np.float32)
    loc = (np.tile([1, 0, 0, 0, 1, 0], (2, 1)) +
           rng.randn(2, 6) * 0.1).astype(np.float32)
    with mt.gpu(0):
        two = mt.nd.BilinearSampler(
            mt.nd.array(small), mt.nd.GridGenerator(
                mt.nd.array(loc), transform_type="affine",
                target_shape=(7, 8)))
        one = mt.nd.SpatialTransformer(mt.nd.array(small), mt.nd.array(loc),
                                       target_shape=(7, 8))
    st_same = two.context == one.context == mt.gpu(0) and \
        np.array_equal(two.asnumpy(), one.asnumpy())
    print("spatial warp: images %s, flow %s; forward %.3f ms, forward + "
          "backward %.3f ms, peak device memory %.3f GB; against the CPU "
          "route (%.1f s): output %.3g, gradients %.3g (data) and %.3g "
          "(flow) (tolerance 1e-5); a second run's output and gradients "
          "the same bits: %s; GridGenerator(affine) + BilinearSampler equal "
          "to SpatialTransformer on the card: %s"
          % (WARP_IMAGES, (n, 2, h, w), fwd, both, peak, secs, *errs, replay,
             st_same), flush=True)
    check(max(errs) <= 1e-5, "the warp disagrees with the CPU route: %s"
          % errs)
    check(replay, "the warp's gradients do not replay bit for bit")
    check(st_same, "GridGenerator + BilinearSampler differs from "
          "SpatialTransformer")
    return {"fwd_ms": fwd, "fwd_bwd_ms": both, "peak_gb": peak}


def spatial_phase(torch, mt):
    """The spatial ops at the widths of the models that use them (module
    docstring).  Returns the launch counts of the port's kernels in the
    phase (none is on this path: plain torch and cuDNN)."""
    mt.kernels.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        stn = stn_lenet_run(torch, mt, folder)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {"stn_lenet": stn, "roi_pool5": roi_pool_run(torch, mt),
               "corr": correlation_run(torch, mt), "warp": warp_run(torch, mt)}
    torch.cuda.empty_cache()
    print("spatial: phase wall time %.1f s" % (time.perf_counter() - t0),
          flush=True)
    print(json.dumps({"spatial": summary}), flush=True)
    return dict(mt.kernels.LAUNCHES)


# ---------------------------------------------------------------------------
# image_io: ResNet-50 and SSD trained from .rec packs
# ---------------------------------------------------------------------------

#: an ImageNet pack as ``tools/im2rec.py --resize 256`` holds it: 2,560
#: class-coloured images (short side 256, long side 256-341), labels
#: i % 1000, JPEG at im2rec's default quality
PACK_N, PACK_SHORT, PACK_LONG, PACK_QUALITY = 2560, 256, 342, 95
#: decoding PACK_CHECK of the pack's images: each codec's mean |decoded -
#: source| per image at most DECODE_MEAN (libjpeg through PIL on the CPU
#: reads at most 7.64 on these images, rounded up) and its largest error
#: at most DECODE_MAX; two codecs on one JPEG within CODEC_MEAN (mean) and
#: CODEC_MAX (largest) of each other (their IDCT and upsampling differ)
PACK_CHECK, DECODE_MEAN, DECODE_MAX, CODEC_MEAN, CODEC_MAX = 16, 8.0, 64, \
    3.0, 24
#: train_imagenet.get_rec_iter's iterator and its default thread count
REC_MEANS = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939)
REC_THREADS = 4
REC_WARMUP, REC_TIMED, REC_AGREE_BATCH, REC_AGREE_STEPS = 2, 8, 32, 3
#: the batch decoder alone is timed over this many of the pack's JPEGs
DECODE_BATCH = 256
#: the ResNet-50 bf16 step on SyntheticIter of the version before the image
#: data path (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W), printed beside
#: the .rec-fed step
SYNTHETIC_RESNET_MS = 145.13
DET_STEPS = 6


def cls_image(rng, i):
    """Image ``i`` of the pack: noise of amplitude 40 with the channel of
    class (i % 1000) % 3 lifted by 180 (tests/test_real_data_e2e.py's
    class-coloured images), short side PACK_SHORT."""
    long = rng.randint(PACK_SHORT, PACK_LONG)
    h, w = (PACK_SHORT, long) if i % 2 else (long, PACK_SHORT)
    img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
    c = (i % 1000) % 3
    img[:, :, c] = np.minimum(img[:, :, c] + 180, 255)
    return img


def write_pack(mt, folder):
    """The .rec and .idx as im2rec writes them; returns (path, bytes,
    seconds, the first PACK_CHECK sources and their JPEGs, the first
    batch's JPEGs)."""
    rng = np.random.RandomState(SEED)
    prefix = os.path.join(folder, "imagenet")
    t0 = time.perf_counter()
    rec = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    sources, jpegs = [], []
    for i in range(PACK_N):
        img = cls_image(rng, i)
        s = mt.recordio.pack_img(mt.recordio.IRHeader(0, float(i % 1000), i,
                                                      0), img,
                                 quality=PACK_QUALITY)
        rec.write_idx(i, s)
        if i < DECODE_BATCH:
            jpegs.append(mt.recordio.unpack(s)[1])
        if i < PACK_CHECK:
            sources.append((img, jpegs[-1]))
    rec.close()
    return (prefix + ".rec", os.path.getsize(prefix + ".rec"),
            time.perf_counter() - t0, sources, jpegs)


def decode_rate(jpegs, threads, rounds=3):
    """img/s of ``native.decode_jpeg_batch`` alone over one batch of the
    pack's JPEGs, after a warm-up call."""
    from mxnet_tpu_torch import native

    native.decode_jpeg_batch(jpegs, threads)
    t0 = time.perf_counter()
    for _ in range(rounds):
        native.decode_jpeg_batch(jpegs, threads)
    return rounds * len(jpegs) / (time.perf_counter() - t0)


def decode_check(mt, sources):
    """Each codec of the card against the encoded sources, and the codecs
    against each other; nvJPEG's encoder too where it is the card's."""
    from mxnet_tpu_torch import image_backend, native

    def err(a, b):
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        return float(d.mean()), int(d.max())

    rows = {}
    batch = native.decode_jpeg_batch([b for _, b in sources], REC_THREADS)
    check(all(x is not None for x in batch), "the batch decoder (%s) "
          "failed on the pack's JPEGs" % native.decoder_route())
    rows["batch %s vs source" % native.decoder_route()] = \
        [err(d, src) for d, (src, _) in zip(batch, sources)]
    if image_backend.HAVE_PIL:
        pil = [image_backend.decode_image(b) for _, b in sources]
        rows["PIL vs source"] = [err(d, src)
                                 for d, (src, _) in zip(pil, sources)]
        if native.decoder_route() != "libjpeg":
            rows["codecs: %s vs PIL" % native.decoder_route()] = \
                [err(a, b) for a, b in zip(batch, pil)]
    if native.nvjpeg_lib() is not None:
        enc = [native.encode_jpeg(src, PACK_QUALITY) for src, _ in sources]
        dec = native.decode_jpeg_batch(enc, REC_THREADS)
        rows["nvjpeg-encoded, nvjpeg vs source"] = \
            [err(d, src) for d, (src, _) in zip(dec, sources)]
        if image_backend.HAVE_PIL:
            rows["nvjpeg-encoded, PIL vs source"] = \
                [err(image_backend.decode_image(e), src)
                 for e, (src, _) in zip(enc, sources)]
    ok = True
    for what, errs in rows.items():
        mean = max(e[0] for e in errs)
        worst = max(e[1] for e in errs)
        if what.startswith("codecs"):
            fine = mean <= CODEC_MEAN and worst <= CODEC_MAX
            bound = (CODEC_MEAN, CODEC_MAX)
        else:
            fine = mean <= DECODE_MEAN and worst <= DECODE_MAX
            bound = (DECODE_MEAN, DECODE_MAX)
        ok = ok and fine
        print("image_io decode: %s over %d images: mean |error| per image "
              "at most %.3f, largest %d (bounds %.1f, %d): %s"
              % (what, len(errs), mean, worst, bound[0], bound[1], fine),
              flush=True)
    check(ok, "a codec's decode is outside its bound")
    return {k: [max(e[0] for e in v), max(e[1] for e in v)]
            for k, v in rows.items()}


def rec_iter(mt, rec, batch, threads, train=True):
    """``mt.io.ImageRecordIter`` exactly as train_imagenet.get_rec_iter
    builds it (training: shuffle, rand_crop, rand_mirror; else neither),
    224x224, the three means."""
    return mt.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, 224, 224), batch_size=batch,
        shuffle=train, rand_crop=train, rand_mirror=train,
        preprocess_threads=threads, **REC_MEANS)


def close_iter(it):
    it.close()
    for src in getattr(it, "iters", ()):
        src.close()


def io_rate(mt, rec, threads):
    """fit.py's --test-io: img/s of the iterator alone over 2 epochs."""
    it = rec_iter(mt, rec, 256, threads)
    try:
        n = 0
        t0 = time.perf_counter()
        for epoch in range(2):
            if epoch:
                it.reset()
            for b in it:
                n += b.data[0].shape[0] - b.pad
        return n / (time.perf_counter() - t0)
    finally:
        close_iter(it)


def card_and_limit():
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def rec_resnet_bf16(torch, mt, rec, profile_dir):
    """(d) ResNet-50 bf16 at batch 256 (the resnet phase's Module) fed by
    the iterator at REC_THREADS threads: REC_WARMUP then REC_TIMED steps,
    each from ``next`` to the update's end, synchronized."""
    from mxnet_tpu_torch.models import get_resnet

    b = 256
    with mt.NameManager():
        net = get_resnet(**RESNET)
    mt.random.seed(SEED)
    mod = image_module(mt, net, None, (b,) + RESNET["image_shape"],
                       "bfloat16", dict(RESNET_SGD, rescale_grad=1.0 / b))
    it = rec_iter(mt, rec, b, REC_THREADS)
    times, waits, losses = [], [], []
    try:
        for step in range(REC_WARMUP + REC_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = it.next()
            t1 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            waits.append(t1 - t0)
            losses.append(lm_loss(torch, mod.get_outputs()[0],
                                  batch.label[0].asnumpy()))
        copy_ms = cuda_ms(lambda: batch.data[0]._data.to("cuda"), 3)
        if profile_dir:
            it.reset()

            def step():
                one = it.next()
                mod.forward_backward(one)
                mod.update()
            profile(torch, step, profile_dir, "resnet_step_bf16_rec")
    finally:
        close_iter(it)
    step_ms = float(np.mean(times[REC_WARMUP:])) * 1e3
    wait_ms = float(np.mean(waits[REC_WARMUP:])) * 1e3
    print("image_io resnet bf16 b%d from the .rec: step ms %.2f (mean of %d "
          "after %d warm-up, next() included), img/s %.1f; waiting on the "
          "iterator %.2f ms a step; the batch's host-to-card copy %.2f ms "
          "(%.1f MB); SyntheticIter's step before the image data path "
          "%.2f ms (%.1f img/s, NVIDIA H100 80GB HBM3, 700.00 W); this "
          "card: %s; losses %s"
          % (b, step_ms, REC_TIMED, REC_WARMUP, b / step_ms * 1e3, wait_ms,
             copy_ms, batch.data[0]._data.numel() * 4 / 1e6,
             SYNTHETIC_RESNET_MS, b / SYNTHETIC_RESNET_MS * 1e3,
             card_and_limit(), ["%.4f" % x for x in losses]), flush=True)
    check(all(np.isfinite(losses)), "ResNet-50's losses from the .rec are "
          "not finite: %s" % losses)
    del mod
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "img_s": b / step_ms * 1e3,
            "wait_ms": wait_ms, "copy_ms": copy_ms}


def rec_resnet_agreement(torch, mt, rec):
    """(e) float32, batch REC_AGREE_BATCH, centre crop, no mirror: the
    first batch on the card equals the CPU route's read of the pack bit
    for bit, and the card's first REC_AGREE_STEPS losses are the CPU
    route's at the card's states within the float32 agree limit."""
    from mxnet_tpu_torch.models import get_resnet

    b = REC_AGREE_BATCH
    with mt.NameManager():
        net = get_resnet(**RESNET)
    mt.random.seed(SEED)
    sgd = dict(RESNET_SGD, rescale_grad=1.0 / b)
    mod = image_module(mt, net, None, (b,) + RESNET["image_shape"], None,
                       sgd)
    it = rec_iter(mt, rec, b, REC_THREADS, train=False)
    states, batches, losses = [], [], []
    try:
        for step in range(REC_AGREE_STEPS):
            batch = it.next()
            states.append(state_snapshot(mod))
            batches.append(batch)
            mod.forward_backward(batch)
            mod.update()
            if step == 0:
                on_card = mod._exec_group.execs[0].arg_dict["data"]._data
                first = on_card.cpu()
                where = on_card.device
            losses.append(lm_loss(torch, mod.get_outputs()[0],
                                  batch.label[0].asnumpy()))
    finally:
        close_iter(it)
    del mod
    torch.cuda.empty_cache()
    again = rec_iter(mt, rec, b, REC_THREADS, train=False)
    try:
        host_first = again.next().data[0]._data
    finally:
        close_iter(again)
    same = torch.equal(first, host_first)
    cpu = mt.cpu()
    anchored = []
    t0 = time.perf_counter()
    host = image_module(mt, net, cpu, (b,) + RESNET["image_shape"], None,
                        sgd, {k: mt.nd.NDArray(v, cpu)
                              for k, v in states[0][0].items()},
                        {k: mt.nd.NDArray(v, cpu)
                         for k, v in states[0][1].items()})
    for (args, aux), batch in zip(states, batches):
        host.set_params({k: mt.nd.NDArray(v, cpu) for k, v in args.items()},
                        {k: mt.nd.NDArray(v, cpu) for k, v in aux.items()})
        host.forward(batch, is_train=True)
        anchored.append(lm_loss(torch, host.get_outputs()[0],
                                batch.label[0].asnumpy()))
    del host
    err = max(abs(a - c) / abs(c) for a, c in zip(losses, anchored))
    limit = AGREE[None][1]
    print("image_io resnet float32 b%d (centre crop, no mirror): the first "
          "batch on %s equal to the CPU route's read of the pack: %s; the "
          "card's first %d losses %s, the CPU route's at the card's states "
          "%s (%.1f s), relative error %.3g (tolerance %g)"
          % (b, where, same, REC_AGREE_STEPS, ["%.7f" % x for x in losses],
             ["%.7f" % x for x in anchored], time.perf_counter() - t0, err,
             limit), flush=True)
    check(same, "the batch on the card differs from the CPU route's read")
    check(err <= limit, "ResNet-50 from the .rec disagrees with the CPU "
          "route: %s vs %s" % (losses, anchored))
    return {"first_batch_equal": same, "loss_rel_err": err}


def write_det_pack(mt, folder):
    """SSD_IMAGES of synthetic_detection's one-box images at 300x300 as
    JPEG, each label [2, 5, cls, xmin, ymin, xmax, ymax]."""
    X, L = synthetic_detection(SSD_IMAGES, size=SSD_IMAGE[1],
                               num_classes=SSD["num_classes"])
    prefix = os.path.join(folder, "det")
    rec = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    for i in range(SSD_IMAGES):
        img = np.transpose(X[i] * 255, (1, 2, 0)).astype(np.uint8)
        label = [2.0, 5.0] + [float(v) for v in L[i, 0]]
        rec.write_idx(i, mt.recordio.pack_img(
            mt.recordio.IRHeader(0, label, i, 0), img, quality=PACK_QUALITY))
    rec.close()
    return prefix + ".rec"


def rec_ssd(torch, mt, folder, ssd_step_ms):
    """(f) SSD (the ssd phase's net and Module) trained DET_STEPS steps from
    a detection pack read by ``mt.image.ImageDetRecordIter`` as
    examples/ssd/train_ssd.py builds it; its first 2 steps against the CPU
    route (ssd_cpu_witness)."""
    from mxnet_tpu_torch.models import get_ssd_train

    rec = write_det_pack(mt, folder)
    with mt.NameManager():
        net = get_ssd_train(**SSD)
    it = mt.image.ImageDetRecordIter(
        path_imgrec=rec, data_shape=SSD_IMAGE, batch_size=SSD_BATCH,
        label_pad_width=SSD_LABEL_ROWS, std_r=255.0, std_g=255.0,
        std_b=255.0, label_name="label")
    mt.random.seed(SEED)
    mod = ssd_module(mt, net, None, (SSD_BATCH,) + SSD_IMAGE,
                     (SSD_BATCH, SSD_LABEL_ROWS, 5))
    states, batches, losses, times = [], [], [], []
    try:
        for step in range(DET_STEPS):
            t0 = time.perf_counter()
            try:
                batch = it.next()
            except StopIteration:
                it.reset()
                batch = it.next()
            if step < SSD_WITNESS:
                states.append(state_snapshot(mod))
                batches.append(batch)
            mod.forward(batch, is_train=True)
            losses.append(ssd_loss(torch, mod.get_outputs()))
            mod.backward()
            mod.update()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        close_iter(it)
    step_ms = float(np.mean(times[SSD_WARMUP:])) * 1e3
    print("image_io ssd from the detection pack (%d images, batch %d, "
          "labels padded to %d): step ms %.2f (mean of steps %d-%d, next() "
          "included) beside the ssd phase's %.2f on NDArrayIter; losses %s"
          % (SSD_IMAGES, SSD_BATCH, SSD_LABEL_ROWS, step_ms, SSD_WARMUP,
             DET_STEPS - 1, ssd_step_ms, ["%.5f" % x for x in losses]),
          flush=True)
    check(all(np.isfinite(losses)), "SSD's losses from the pack are not "
          "finite: %s" % losses)
    del mod
    torch.cuda.empty_cache()
    ssd_cpu_witness(torch, mt, net, states, batches, losses)
    return {"step_ms": step_ms, "losses": losses}


def image_ops_on_card(torch, mt, jpg):
    """(g) nd.imdecode and the image-decode ops on the default context:
    results on the card, the CPU route's bits."""
    def run():
        buf = mt.nd.array(np.frombuffer(jpg, np.uint8), dtype=np.uint8)
        dec = mt.nd._cvimdecode(buf)
        return {"nd.imdecode": mt.nd.imdecode(jpg), "_cvimdecode": dec,
                "_cvimresize": mt.nd._cvimresize(dec, w=224, h=200),
                "_cvcopyMakeBorder": mt.nd._cvcopyMakeBorder(
                    dec, top=2, bot=3, left=4, right=5, values=(7.0,))}

    card = run()
    with mt.cpu():
        host = run()
    same = {k: card[k]._data.is_cuda and
            np.array_equal(card[k].asnumpy(), host[k].asnumpy())
            for k in card}
    print("image_io ops: on the card and equal to the CPU route's: %s"
          % same, flush=True)
    check(all(same.values()), "an image-decode op left the card or differs "
          "from the CPU route: %s" % same)
    return same


def image_io_phase(torch, mt, ssd_step_ms, profile_dir=None):
    """ResNet-50 and SSD trained from .rec packs (module docstring).
    Returns the launch counts of the port's kernels in the phase (none is
    on this path)."""
    from mxnet_tpu_torch import image_backend, native

    mt.kernels.reset_launches()
    t0 = time.perf_counter()
    status = native.native_status()
    routes = image_backend.codec_routes()
    print("image_io codec: %s; native_status %s; the iterators decode "
          "batches with %s; os.cpu_count() %d"
          % (routes, status, native.decoder_route(), os.cpu_count()),
          flush=True)
    check(status["reader"] == "loaded", "the native reader did not load: "
          "%s" % status)
    check(native.decoder_route() is not None, "no JPEG codec loaded for "
          "the iterators: %s" % status)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as folder:
        rec, size, secs, sources, jpegs = write_pack(mt, folder)
        print("image_io pack: %d images (JPEG q%d by %s) in %s: %.1f MB in "
              "%.1f s" % (PACK_N, PACK_QUALITY, routes["encode"], rec,
                          size / 1e6, secs), flush=True)
        decode = decode_check(mt, sources)
        rates, decode_rates = {}, {}
        for threads in sorted({REC_THREADS, os.cpu_count()}):
            decode_rates[threads] = decode_rate(jpegs, threads)
            print("image_io decode alone: %s over a batch of %d of the "
                  "pack's JPEGs at %d threads: %.1f img/s"
                  % (native.decoder_route(), len(jpegs), threads,
                     decode_rates[threads]), flush=True)
            rates[threads] = io_rate(mt, rec, threads)
            print("image_io test-io: ImageRecordIter (224x224, batch 256, "
                  "shuffle, rand_crop, rand_mirror, means) at %d threads: "
                  "%.1f img/s over 2 epochs" % (threads, rates[threads]),
                  flush=True)
        bf16 = rec_resnet_bf16(torch, mt, rec, profile_dir)
        agree = rec_resnet_agreement(torch, mt, rec)
        ssd = rec_ssd(torch, mt, folder, ssd_step_ms)
        ops = image_ops_on_card(torch, mt, sources[0][1])
    wall = time.perf_counter() - t0
    print("image_io: phase wall time %.1f s" % wall, flush=True)
    print(json.dumps({"image_io": {
        "codec": {"encode": routes["encode"],
                  "batch_decode": native.decoder_route(),
                  "decode": routes["decode"]},
        "native": status, "cpu_count": os.cpu_count(),
        "pack_mb": size / 1e6, "decode": decode,
        "decode_img_s": {str(k): v for k, v in decode_rates.items()},
        "io_img_s": {str(k): v for k, v in rates.items()},
        "resnet_bf16_rec": bf16, "resnet_f32_agree": agree,
        "ssd_rec": ssd, "ops_on_card": all(ops.values()),
        "wall_s": wall}}), flush=True)
    return dict(mt.kernels.LAUNCHES)


# -- phase 14: generation ----------------------------------------------------

GEN_MODEL = dict(vocab_size=FULL["vocab_size"], num_layers=FULL["num_layers"],
                 num_heads=FULL["num_heads"], hidden=FULL["hidden"],
                 max_seq_len=FULL["seq_len"])
# 8 lanes x 72 pages (1024 prompt + 128 new tokens) + the scratch page
GEN_ENGINE = dict(lane_buckets=(1, 2, 4, 8), page_size=16, num_pages=577,
                  prefill_len_buckets=(64, 128, 256, 512, 1024),
                  prefill_batch_buckets=(1, 2, 4))
# tools/bench_generate.py::make_workload's mix at this model's scale
GEN_PROMPTS = (32, 128, 256, 512, 1024)
GEN_BUDGETS = (16, 32, 64, 128)
GEN_REQUESTS = 32
GEN_REFERENCE = 8          # (a)'s requests replayed one at a time
GEN_DENSE = ((128, 16), (512, 16))  # (b): prompt length, new tokens
GEN_FLASH = (4, 1024)      # (c): prefill batch and length
GEN_STORM = (16, 1024, 928, 8)  # (d): requests, prompt, shared, new
GEN_DRAFT_K = 4            # (e)
GEN_CPU = (128, 8)         # (f): prompt length, new tokens
GEN_STEP_REPS = (3, 20)    # (g): warm-up, timed
GEN_NEAR_TIE = 1e-4
GEN_LIMIT_TBS = 3.35


def gen_workload(rng, n):
    return [([int(t) for t in rng.integers(0, GEN_MODEL["vocab_size"],
                                           int(rng.choice(GEN_PROMPTS)))],
             int(rng.choice(GEN_BUDGETS))) for _ in range(n)]


def pct(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else float("nan")


class GenLogits:
    """The LM's logits at the last position of a token list, recomputed
    through dense prefill executors on the card (a length bucket of the
    given engine, or one at half the position table for longer lists):
    the yardstick of (b) and of the near-tie rule."""

    def __init__(self, mt, engine, params):
        self.mt, self.engine, self.params = mt, engine, params
        self.long = None

    def __call__(self, tokens):
        from mxnet_tpu_torch.models.transformer import \
            get_transformer_lm_prefill

        n = len(tokens)
        fits = [L for L in self.engine.prefill_len_buckets if L >= n]
        if fits:
            L = fits[0]
            buf = np.zeros((L,), np.float32)
            buf[:n] = tokens
            _, outs = self.engine._prefill[L].forward_padded([{"data": buf}])
            return outs[0]._data[0, n - 1].double().cpu().numpy()
        L = GEN_MODEL["max_seq_len"] // 2
        if self.long is None:
            with self.mt.NameManager():
                sym = get_transformer_lm_prefill(
                    GEN_MODEL["vocab_size"], GEN_MODEL["num_layers"],
                    GEN_MODEL["num_heads"], GEN_MODEL["hidden"], seq_len=L,
                    max_seq_len=GEN_MODEL["max_seq_len"])
            self.long = self.mt.Predictor(sym, self.params, {"data": (1, L)})
        buf = np.zeros((1, L), np.float32)
        buf[0, :n] = tokens
        out = self.long.forward(data=buf)[0]._data
        return out[0, n - 1].double().cpu().numpy()


def near_tie_compare(got, ref, workload, logits_at, what):
    """Transcripts ``got`` against ``ref`` under the near-tie rule: a
    request that differs passes only if, at its first differing position,
    the reference's top-2 logits lie within GEN_NEAR_TIE of the largest
    |logit| (the comparison of that request stops there).  Fatal on any
    other difference; returns how many requests split at a near tie."""
    ties = []
    for i, (g, r, (prompt, _)) in enumerate(zip(got, ref, workload)):
        if g == r:
            continue
        split = [j for j, (a, b) in enumerate(zip(g, r)) if a != b]
        check(split, "%s: request %d has %d tokens, the reference %d"
              % (what, i, len(g), len(r)))
        j = split[0]
        logits = logits_at(list(prompt) + list(r[:j]))
        top = np.sort(logits)[-2:]
        gap = float(top[1] - top[0]) / float(np.abs(logits).max())
        check(gap <= GEN_NEAR_TIE, "%s: request %d splits from the reference "
              "at token %d (%d vs %d), where its top-2 logits differ by %.3g "
              "of the largest |logit| (> %g)" % (what, i, j, g[j], r[j], gap,
                                                 GEN_NEAR_TIE))
        ties.append((i, j, gap))
    print("generate %s: %d of %d transcripts equal, %d split at a near tie "
          "%s" % (what, len(got) - len(ties), len(got), len(ties), ties),
          flush=True)
    return len(ties)


def gen_streams(engine, workload):
    """Submit every request at once; (streams, wall seconds to the last
    token).  Fatal if a stream ends in an exception."""
    t0 = time.perf_counter()
    streams = [engine.submit(p, n) for p, n in workload]
    for s in streams:
        s._done.wait(600)
    wall = time.perf_counter() - t0
    for i, s in enumerate(streams):
        check(s.done and s.exception() is None, "stream %d ended with %r"
              % (i, s.exception()))
    return streams, wall


def gen_stats(streams, wall):
    tokens = sum(len(s.tokens) for s in streams)
    ttft = [s.ttft_ms for s in streams]
    itl = [g for s in streams for g in s.itl_ms]
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
            "itl_ms_p50": pct(itl, 50), "itl_ms_p99": pct(itl, 99)}


def capture_steps(engine):
    """Record row 0 of every lane executor's logits (host copies) while
    ``engine`` runs; returns the list it fills."""
    rows = []
    real = engine._run_lanes

    def run_lanes(*args):
        logits = real(*args)
        rows.append(logits[0].double().cpu().numpy())
        return logits
    engine._run_lanes = run_lanes
    return rows


def plane_watch(engine, paged):
    """Hold the device-resident pool to its contract while ``engine``
    runs: each lane forward copies each plane exactly once (the paged op's
    own copy, ``paged._write``) and the pool then holds exactly those
    copies, on the card.  Returns (counts, violations, restore)."""
    written, bad, counts = [], [], {"forwards": 0, "copies": 0}
    real_write, real_run = paged._write, engine._run_lanes

    def write(*args):
        out = real_write(*args)
        written.append((out[0].data_ptr(), out[1].data_ptr()))
        return out

    def run_lanes(pred, pool, *rest):
        del written[:]
        logits = real_run(pred, pool, *rest)
        counts["forwards"] += 1
        counts["copies"] += len(written)
        planes = [(k.data_ptr(), v.data_ptr())
                  for k, v in zip(pool.k_pools, pool.v_pools)]
        if planes != written:
            bad.append("%d copies in a forward over %d layers, the pool "
                       "not on them" % (len(written), pool.num_layers))
        if not all(t.is_cuda for t in pool.k_pools + pool.v_pools):
            bad.append("a plane off the card")
        return logits
    paged._write = write
    engine._run_lanes = run_lanes

    def restore():
        paged._write = real_write
        engine._run_lanes = real_run
    return counts, bad, restore


def gen_executors(engine):
    preds = [p for bp in list(engine._prefill.values()) +
             list(engine._draft_prefill.values()) for p in bp._preds.values()]
    return preds + (list(engine._decode.values()) +
                    list(engine._catchup.values()) +
                    list(engine._verify.values()) +
                    list(engine._draft_decode.values()))


def draft_cursor_turns(engine, workload, transcripts):
    """(e)'s requests again through ``engine`` in turns with the JAX
    engine's draft-cursor rule (``draft_pos = next_pos`` after a verify
    pass, which leaves the last accepted token's draft slot stale; ROADMAP
    C.9) and this engine's own: the same transcripts, and each run's
    acceptance and tokens/s."""
    real = engine._spec_step

    def reference_rule(active):
        real(active)
        for seq in active:
            seq.draft_pos = seq.next_pos
    out = []
    for rule in ("jax", "port", "jax"):
        if rule == "jax":
            engine._spec_step = reference_rule
        streams, wall = gen_streams(engine, workload)
        if rule == "jax":
            del engine._spec_step
        check([list(s.tokens) for s in streams] == transcripts, "(e) the "
              "%s cursor rule changed a transcript" % rule)
        acc = sum(s.draft_accepted for s in streams)
        prop = sum(s.draft_proposed for s in streams)
        tokens = sum(len(s.tokens) for s in streams)
        out.append({"rule": rule, "accepted": acc, "proposed": prop,
                    "tokens_per_s": tokens / wall})
        print("generate (e) draft cursor, %s rule: acceptance %d of %d = "
              "%.4f, %.1f tokens/s, the same transcripts" % (
                  rule, acc, prop, acc / prop, tokens / wall), flush=True)
    return out


def decode_alone(torch, engine, lanes):
    """The ``lanes``-lane decode executor alone on a synthetic full table
    (every lane at position 4095 over 256 seeded pages): median device ms
    of GEN_STEP_REPS by CUDA events, and the bytes its work moves."""
    rng = np.random.default_rng(SEED + lanes)
    feed = (rng.integers(0, GEN_MODEL["vocab_size"], lanes)
            .astype(np.float32),
            np.full((lanes,), engine.max_seq_len - 1, np.float32),
            rng.integers(1, engine.num_pages, (lanes, engine.max_pages))
            .astype(np.float32))
    warm, reps = GEN_STEP_REPS
    times = []
    for i in range(warm + reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        # not adopted: the pool is unchanged
        engine._forward_lanes(engine._decode[lanes], *feed)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    # bytes: the weights read once; each lane's history (4096 tokens of K
    # and V in each layer) gathered, i.e. written once and read once by
    # the scores and by P V; each plane read and written by the op's copy
    weights = sum(a._data.numel() * 4 for a in engine._params.values())
    hist = lanes * engine.max_seq_len * engine.hidden * 4 * 2 \
        * engine.num_layers
    planes = sum(t.numel() * 4 for t in engine.pool.k_pools +
                 engine.pool.v_pools)
    least = weights + hist          # the history read once, no copy
    gathered = weights + 2 * hist   # gathered K/V read and written
    code = gathered + 2 * planes    # and the functional copy of each plane
    rate = GEN_LIMIT_TBS * 1e12
    return {"lanes": lanes, "ms": ms, "least_gb": least / 1e9,
            "least_ms": least / rate * 1e3, "gathered_gb": gathered / 1e9,
            "gathered_ms": gathered / rate * 1e3, "code_gb": code / 1e9,
            "code_ms": code / rate * 1e3}


def generate_phase(torch, mt, profile_dir=None):
    """Phase 14: the full-width LM served through ``DecodeEngine`` on the
    card (module docstring).  Returns the kernel launches of its K1
    check."""
    from mxnet_tpu_torch.generation import DecodeEngine
    from mxnet_tpu_torch.models.transformer import (
        get_transformer_lm, get_transformer_lm_prefill)
    from mxnet_tpu_torch.ops import paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    walls = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prefix = os.path.join(tmp, "lm")
        ckpt, _ = serve_inputs(mt, net)
        net.save(prefix + "-symbol.json")
        mt.nd.save(prefix + "-0000.params", ckpt)
        del ckpt
        # one copy of the weights on the card for every engine of the
        # phase (and each engine's executors share it)
        params = {k: v.as_in_context(mt.gpu(0)) for k, v in
                  mt.nd.load(prefix + "-0000.params").items()}
        # one lane and one prefill shape: the CPU runs only this request
        ps = GEN_ENGINE["page_size"]
        cpu_engine = DecodeEngine.from_checkpoint(
            prefix, 0, ctx=mt.cpu(), **GEN_MODEL, page_size=ps,
            num_pages=-(-sum(GEN_CPU) // ps) + 1, lane_buckets=(1,),
            prefill_len_buckets=(GEN_CPU[0],), prefill_batch_buckets=(1,))
    walls["checkpoint"] = time.perf_counter() - t0
    spec = dict(GEN_MODEL, **GEN_ENGINE)
    rng = np.random.default_rng(SEED)
    workload = gen_workload(rng, GEN_REQUESTS)

    # -- the reference: (a)'s first requests one at a time ------------------
    t0 = time.perf_counter()
    ref_engine = DecodeEngine(params, **spec)
    logits_at = GenLogits(mt, ref_engine, params)
    walls["reference build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reference = [ref_engine.generate(p, n, timeout=600)
                 for p, n in workload[:GEN_REFERENCE]]
    walls["reference"] = time.perf_counter() - t0

    # -- (b) paged against dense ------------------------------------------
    t0 = time.perf_counter()
    dense_err = 0.0
    for plen, new in GEN_DENSE:
        prompt = [int(t) for t in rng.integers(0, GEN_MODEL["vocab_size"],
                                               plen)]
        rows = capture_steps(ref_engine)
        out = ref_engine.generate(prompt, new, timeout=600)
        del ref_engine._run_lanes
        check(len(rows) == new - 1, "(b) %d decode steps for %d tokens"
              % (len(rows), new))
        toks = prompt + out
        for j, row in enumerate(rows):
            want = logits_at(toks[:plen + j + 1])
            err = float(np.abs(row - want).max() / np.abs(want).max())
            dense_err = max(dense_err, err)
            check(err <= 1e-4, "(b) prompt %d, decode step %d: logits %.3g "
                  "of the largest |value| off the dense recompute"
                  % (plen, j, err))
    print("generate (b) paged vs dense: %d decode steps of prompts %s, "
          "largest difference %.3g of the largest |logit| (limit 1e-4)"
          % (sum(n - 1 for _, n in GEN_DENSE),
             [p for p, _ in GEN_DENSE], dense_err), flush=True)
    walls["(b)"] = time.perf_counter() - t0

    # -- (f) the card against the CPU route -------------------------------
    t0 = time.perf_counter()
    prompt = [int(t) for t in rng.integers(0, GEN_MODEL["vocab_size"],
                                           GEN_CPU[0])]
    card_rows = capture_steps(ref_engine)
    card = ref_engine.generate(prompt, GEN_CPU[1], timeout=600)
    del ref_engine._run_lanes
    host_rows = capture_steps(cpu_engine)
    host = cpu_engine.generate(prompt, GEN_CPU[1], timeout=900)
    cpu_engine.stop()
    cpu_err = float(np.abs(card_rows[0] - host_rows[0]).max()
                    / np.abs(host_rows[0]).max())
    check(cpu_err <= 1e-4, "(f) first decode step's logits %.3g of the "
          "largest |value| off the CPU route's" % cpu_err)
    cpu_ties = near_tie_compare([card], [host], [(prompt, GEN_CPU[1])],
                                logits_at, "(f) card vs CPU")
    print("generate (f) card vs CPU route: prompt %d, %d new tokens, first "
          "decode step's logits within %.3g" % (GEN_CPU[0], GEN_CPU[1],
                                                cpu_err), flush=True)
    del cpu_engine
    walls["(f)"] = time.perf_counter() - t0

    # -- (a) continuous batching ------------------------------------------
    t0 = time.perf_counter()
    engine = DecodeEngine(params, **spec)
    walls["(a) build"] = time.perf_counter() - t0
    counts, bad, restore = plane_watch(engine, paged)
    streams, wall = gen_streams(engine, workload)
    restore()
    del restore  # it holds the engine
    stats = gen_stats(streams, wall)
    got = [list(s.tokens) for s in streams]
    snap = engine.snapshot()
    check(engine.cold_decode_runs() == 0, "(a) %d cold decode runs"
          % engine.cold_decode_runs())
    check(engine.pool.free_pages() == engine.pool.capacity and
          engine.pool.total_refcount() == 0, "(a) the pool did not drain: "
          "%s" % engine.pool.snapshot())
    check(not bad and counts["copies"] == counts["forwards"] *
          engine.num_layers, "(a) a lane forward copied a plane more than "
          "once or left the pool off the op's copies: %s, %d copies in %d "
          "forwards" % (bad[:4], counts["copies"], counts["forwards"]))
    ptrs = {p._exec.arg_dict["tok_embed_weight"]._data.data_ptr()
            for p in gen_executors(engine) + gen_executors(ref_engine)}
    check(len(ptrs) == 1, "(a) the executors bind %d copies of "
          "tok_embed_weight" % len(ptrs))
    check(all(t.is_cuda for t in engine.pool.k_pools + engine.pool.v_pools),
          "(a) a pool plane left the card")
    a_ties = near_tie_compare(got[:GEN_REFERENCE], reference,
                              workload[:GEN_REFERENCE], logits_at,
                              "(a) continuous vs one at a time")
    print("generate (a) continuous batching: %d requests (prompts %s, "
          "budgets %s), %d tokens in %.3f s = %.1f tokens/s; TTFT p50 %.2f "
          "p99 %.2f ms; ITL p50 %.2f p99 %.2f ms; %d decode steps, %d "
          "preemptions, peak %d of %d pages; %d lane forwards, each plane "
          "copied once per forward on the card" % (
              GEN_REQUESTS, list(GEN_PROMPTS), list(GEN_BUDGETS),
              stats["tokens"], wall, stats["tokens_per_s"],
              stats["ttft_ms_p50"], stats["ttft_ms_p99"],
              stats["itl_ms_p50"], stats["itl_ms_p99"],
              engine.metrics.steps.value, engine.metrics.preempted.value,
              engine.pool.peak_pages, engine.pool.capacity,
              counts["forwards"]), flush=True)
    a_out = dict(stats, steps=engine.metrics.steps.value,
                 preemptions=engine.metrics.preempted.value,
                 peak_pages=engine.pool.peak_pages, near_ties=a_ties,
                 lane_forwards=counts["forwards"], kv=snap["kv"])
    walls["(a)"] = time.perf_counter() - t0

    # -- (g) the decode step against its bound ----------------------------
    t0 = time.perf_counter()
    steps = [decode_alone(torch, engine, lanes) for lanes in (8, 1)]
    for st in steps:
        print("generate (g) decode step, %d lane(s), full table: %.3f ms "
              "(median of %d); bytes bound %.3f ms (%.3f GB: the weights "
              "and each lane's 4096-token history read once); the "
              "reference's algorithm moves %.3f GB = %.3f ms with the "
              "gathered K/V read and written, %.3f GB = %.3f ms with the "
              "functional copy of each plane" % (
                  st["lanes"], st["ms"], GEN_STEP_REPS[1], st["least_ms"],
                  st["least_gb"], st["gathered_gb"], st["gathered_ms"],
                  st["code_gb"], st["code_ms"]), flush=True)
    if profile_dir:
        prof_engine = DecodeEngine(params, start=False, **spec)
        for p, _ in workload[:8]:
            prof_engine.submit(p[:32], 16)
        prof_engine._admit()
        check(prof_engine.active_lanes() == 8, "profile: %d lanes active"
              % prof_engine.active_lanes())
        profile(torch, prof_engine._decode_step, profile_dir,
                "generate_step")
        prof_engine.stop()
        del prof_engine
    walls["(g)"] = time.perf_counter() - t0

    # -- (c) K1 on the generation path ------------------------------------
    t0 = time.perf_counter()
    b, L = GEN_FLASH
    tokens = rng.integers(0, GEN_MODEL["vocab_size"], (b, L)).astype(
        np.float32)
    preds = {}
    for impl in ("dense", "flash"):
        with mt.NameManager():
            sym = get_transformer_lm_prefill(
                GEN_MODEL["vocab_size"], GEN_MODEL["num_layers"],
                GEN_MODEL["num_heads"], GEN_MODEL["hidden"], seq_len=L,
                max_seq_len=GEN_MODEL["max_seq_len"], attn_impl=impl)
        preds[impl] = mt.Predictor(sym, params, {"data": (b, L)})
    mt.kernels.reset_launches()
    flash = [o._data for o in preds["flash"].forward(data=tokens)]
    torch.cuda.synchronize()
    k1_launches = dict(mt.kernels.LAUNCHES)
    check(k1_launches["flash_fwd"] == GEN_MODEL["num_layers"], "(c) the "
          "flash prefill launched flash_fwd %d times, expected %d"
          % (k1_launches["flash_fwd"], GEN_MODEL["num_layers"]))
    dense = [o._data for o in preds["dense"].forward(data=tokens)]
    errs = [float((f - d).abs().max() / d.abs().max())
            for f, d in zip(flash, dense)]
    check(max(errs) <= 1e-4, "(c) flash prefill vs dense: %s of the "
          "largest |value|" % ["%.3g" % e for e in errs])
    del flash, dense
    fwd_ms = {impl: cuda_ms(lambda p=p: p.forward(data=tokens), 5)
              for impl, p in preds.items()}
    print("generate (c) K1 on the generation path: prefill (%d, %d) "
          "flash vs dense, logits within %.3g and K/V within %.3g of the "
          "largest |value|; flash_fwd launched %d times in one flash "
          "forward; forward %.3f ms flash, %.3f ms dense (mean of 5)"
          % (b, L, errs[0], max(errs[1:]), k1_launches["flash_fwd"],
             fwd_ms["flash"], fwd_ms["dense"]), flush=True)
    del preds
    walls["(c)"] = time.perf_counter() - t0

    # -- (d) prefix cache -------------------------------------------------
    t0 = time.perf_counter()
    n_req, plen, shared_len, new = GEN_STORM
    shared = [int(t) for t in rng.integers(0, GEN_MODEL["vocab_size"],
                                           shared_len)]
    storm = [(shared + [int(t) for t in rng.integers(
        0, GEN_MODEL["vocab_size"], plen - shared_len)], new)
        for _ in range(n_req)]
    off_streams, off_wall = gen_streams(engine, storm)
    off = gen_stats(off_streams, off_wall)
    engine.stop()
    del engine
    cache_engine = DecodeEngine(
        params, prefix_cache_pages=GEN_ENGINE["num_pages"], **spec)
    # the warming request is the storm's first prompt: its repeat in the
    # storm is a full hit whose last page copy-on-writes
    cache_engine.generate(storm[0][0], 2, timeout=600)
    on_streams, on_wall = gen_streams(cache_engine, storm)
    on = gen_stats(on_streams, on_wall)
    kv = cache_engine.pool.snapshot()
    off_pf = sum(s.prefill_tokens for s in off_streams)
    on_pf = sum(s.prefill_tokens for s in on_streams)
    d_ties = near_tie_compare([list(s.tokens) for s in on_streams],
                              [list(s.tokens) for s in off_streams], storm,
                              logits_at, "(d) cache on vs off")
    check(on_pf < off_pf, "(d) prefill tokens %d with the cache, %d "
          "without" % (on_pf, off_pf))
    check(kv["prefix_hits"] >= n_req, "(d) %d prefix hits" % kv["prefix_hits"])
    check(kv["total_refcount"] == 0, "(d) refcounts left: %s" % kv)
    check(kv["cow_copies"] >= 1, "(d) no copy-on-write: %s" % kv)
    check(cache_engine.cold_decode_runs() == 0, "(d) cold runs")
    print("generate (d) prefix cache: %d requests of %d tokens sharing %d; "
          "TTFT p50 %.2f p99 %.2f ms without the cache, %.2f / %.2f ms "
          "with it; prefill tokens %d -> %d; %d hits, %d copy-on-write, "
          "refcounts drained" % (n_req, plen, shared_len, off["ttft_ms_p50"],
                                 off["ttft_ms_p99"], on["ttft_ms_p50"],
                                 on["ttft_ms_p99"], off_pf, on_pf,
                                 kv["prefix_hits"], kv["cow_copies"]),
          flush=True)
    cache_engine.stop()
    del cache_engine
    walls["(d)"] = time.perf_counter() - t0

    # -- (e) speculative decoding -----------------------------------------
    t0 = time.perf_counter()
    draft = {"params": params, "num_layers": GEN_MODEL["num_layers"],
             "num_heads": GEN_MODEL["num_heads"],
             "hidden": GEN_MODEL["hidden"], "k": GEN_DRAFT_K}
    spec_engine = DecodeEngine(params, draft=draft, **spec)
    check(spec_engine.spec()["draft"]["k"] == GEN_DRAFT_K, "(e) resolved "
          "k %s" % spec_engine.spec()["draft"]["k"])
    s_streams, s_wall = gen_streams(spec_engine, workload[:GEN_REFERENCE])
    s_stats = gen_stats(s_streams, s_wall)
    proposed = sum(s.draft_proposed for s in s_streams)
    accepted = sum(s.draft_accepted for s in s_streams)
    check(0 < accepted <= proposed, "(e) accepted %d of %d proposed"
          % (accepted, proposed))
    e_ties = near_tie_compare([list(s.tokens) for s in s_streams],
                              got[:GEN_REFERENCE], workload[:GEN_REFERENCE],
                              logits_at, "(e) speculative vs plain")
    print("generate (e) speculative decoding, the target as its own draft, "
          "k %d: %d tokens in %.3f s = %.1f tokens/s (plain engine, all %d "
          "requests: %.1f); acceptance %d of %d = %.4f" % (
              GEN_DRAFT_K, s_stats["tokens"], s_wall, s_stats["tokens_per_s"],
              GEN_REQUESTS, stats["tokens_per_s"], accepted, proposed,
              accepted / proposed), flush=True)
    cursors = draft_cursor_turns(spec_engine, workload[:GEN_REFERENCE],
                                 [list(s.tokens) for s in s_streams])
    spec_engine.stop()
    del spec_engine
    ref_engine.stop()
    del ref_engine, logits_at
    walls["(e)"] = time.perf_counter() - t0

    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    wall = time.perf_counter() - t_phase
    smi = card_and_limit()
    print("generate: peak device memory %.2f GB above the phase's start; "
          "walls %s; phase %.1f s" % (
              peak, {k: round(v, 2) for k, v in walls.items()}, wall),
          flush=True)
    print(json.dumps({"generate": {
        "card": smi, "continuous": a_out,
        "paged_vs_dense_err": dense_err,
        "flash_prefill": {"launches": k1_launches["flash_fwd"],
                          "errs": errs, "flash_ms": fwd_ms["flash"],
                          "dense_ms": fwd_ms["dense"]},
        "prefix": {"off": off, "on": on, "prefill_tokens": [off_pf, on_pf],
                   "kv": kv, "near_ties": d_ties},
        "speculative": dict(s_stats, k=GEN_DRAFT_K, proposed=proposed,
                            accepted=accepted, near_ties=e_ties,
                            cursor_turns=cursors),
        "cpu_route": {"first_step_err": cpu_err, "near_ties": cpu_ties},
        "decode_step": steps, "peak_gb": peak, "walls_s": walls,
        "wall_s": wall}}), flush=True)
    return k1_launches


# ---------------------------------------------------------------------------
# phase 16: data and sequence parallelism
# ---------------------------------------------------------------------------
PAR_DP_CONTEXTS = 2
PAR_DP_RUNS = (("device", 2, 5), (None, 2, 3))  # kvstore, warm-up, timed
PAR_DP_AGREE = 3           # the first steps held to the train phase's
RING = (1, 16384, 16, 128)  # b, s, h, d: the LM's attention at 16384
RING_F32_S = 4096
RING_SHARDS = 4
RING_REPS = 5
RING_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LONGCTX = dict(vocab=32000, layers=6, hidden=2048, heads=16, seq_len=16384,
               batch=1, lr=0.05)
LONGCTX_STEPS = 1 + 3
DIST = dict(vocab_size=32000, num_layers=2, num_heads=16, hidden=1024,
            seq_len=1024)
DIST_WORKERS, DIST_BATCH, DIST_STEPS = 2, 4, 3
DIST_SGD = {"learning_rate": 0.01, "momentum": 0.9}
DIST_TIMEOUT = 300


def longctx_params(torch, rng, vocab, hidden, heads, layers, seq_len,
                   device):
    """``examples/transformer/train_lm_longctx.py::build_params`` in torch:
    the same numpy draws in the same order, float32 on ``device``."""
    def glorot(*shape):
        # numpy scales in float64; jnp.asarray keeps float32 of it
        scale = np.sqrt(2.0 / (shape[0] + shape[-1]))
        return torch.tensor((rng.randn(*shape).astype(np.float32) * scale)
                            .astype(np.float32), device=device)

    def norm():
        return {"g": torch.ones(hidden, device=device),
                "b": torch.zeros(hidden, device=device)}

    params = {"embed": glorot(vocab, hidden),
              "pos": glorot(seq_len, hidden) * 0.1,
              "ln_f": norm(), "head": glorot(hidden, vocab), "layers": []}
    for _ in range(layers):
        params["layers"].append({
            "ln1": norm(), "qkv": glorot(hidden, 3 * hidden),
            "proj": glorot(hidden, hidden), "ln2": norm(),
            "fc1": glorot(hidden, 4 * hidden),
            "fc2": glorot(4 * hidden, hidden)})
    return params


def longctx_leaves(params):
    """The parameter tensors in a fixed order."""
    out = [params["embed"], params["pos"], params["ln_f"]["g"],
           params["ln_f"]["b"], params["head"]]
    for lp in params["layers"]:
        out += [lp["ln1"]["g"], lp["ln1"]["b"], lp["qkv"], lp["proj"],
                lp["ln2"]["g"], lp["ln2"]["b"], lp["fc1"], lp["fc2"]]
    return out


def longctx_loss(torch, mt, params, tokens, labels, heads, mesh=None):
    """``train_lm_longctx.py::make_step``'s loss in torch: attention is
    ``parallel.ring_flash_attention`` over the ("data", "seq") mesh (causal),
    or, with ``mesh`` None, ``flash_attention`` over the whole sequence."""
    F = torch.nn.functional

    def ln(x, p):
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        return (x - m) * torch.rsqrt(v + 1e-5) * p["g"] + p["b"]

    b, s = tokens.shape
    h = params["embed"][tokens] + params["pos"][None, :s]
    for lp in params["layers"]:
        a = ln(h, lp["ln1"])
        q, k, v = (a @ lp["qkv"]).chunk(3, dim=-1)
        d = q.shape[-1] // heads
        q, k, v = (t.reshape(b, s, heads, d) for t in (q, k, v))
        if mesh is None:
            from mxnet_tpu_torch.ops.attention import flash_attention

            att = flash_attention(q, k, v, causal=True)
        else:
            att = mt.parallel.ring_flash_attention(
                q, k, v, mesh, axis="seq", batch_axis="data", causal=True)
        h = h + att.reshape(b, s, -1) @ lp["proj"]
        a = ln(h, lp["ln2"])
        h = h + F.gelu(a @ lp["fc1"], approximate="tanh") @ lp["fc2"]
    logits = ln(h, params["ln_f"]) @ params["head"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def longctx_step(torch, mt, params, tokens, labels, heads, lr, mesh):
    """One SGD step of ``make_step`` (p - lr * g over every parameter), in
    place; returns the loss before the step."""
    leaves = longctx_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = longctx_loss(torch, mt, params, tokens, labels, heads, mesh)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.requires_grad_(False)
            p.sub_(lr * g.to(p.dtype))
    return loss.detach()


def kernel_delta(mt, before):
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    return {n: mt.kernels.LAUNCHES[n] - before.get(n, 0) for n in names}


def dp_phase(torch, mt, batch, replay):
    """(a): the train phase's LM through Module over PAR_DP_CONTEXTS
    contexts of the card, first with kvstore 'device' (the update through
    the async store), then with no kvstore (the fused step)."""
    b, s = BATCH, FULL["seq_len"]
    ctxs = [mt.gpu(0)] * PAR_DP_CONTEXTS
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    Y = replay["Y"]
    per_step = FULL["num_layers"] * PAR_DP_CONTEXTS
    out, after = {}, {}
    for kvstore, warm, timed in PAR_DP_RUNS:
        tag = kvstore or "none"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mod = train_module(mt, replay["net"], ctxs, (b, s), arg_params=init,
                           compute_dtype="bfloat16", kvstore=kvstore)
        kv = mod._kvstore
        check(mod._update_on_kvstore == (kvstore is not None) and
              (kvstore is None or isinstance(kv, mt.comm_engine.AsyncKVStore)),
              "dp %s: the update did not take the expected route" % tag)
        losses, times = [], []
        mt.kernels.reset_launches()
        for step in range(warm + timed):
            before = dict(mt.kernels.LAUNCHES)
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            if kv is not None:
                kv.wait_all()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            delta = kernel_delta(mt, before)
            losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
            print("parallel dp (%s): step %d: %.2f ms, loss %.6f, launches %s"
                  % (tag, step, times[-1] * 1e3, losses[-1], delta),
                  flush=True)
            check(np.isfinite(losses[-1]), "dp %s: step %d loss is not "
                  "finite" % (tag, step))
            check(all(v == per_step for v in delta.values()),
                  "dp %s: step %d launched %s, expected %d of each"
                  % (tag, step, delta, per_step))
            if step + 1 == PAR_DP_AGREE:
                after[tag] = state_snapshot(mod)[0]
        launches = kernel_delta(mt, {})
        check(losses[-1] < losses[0], "dp %s: the loss did not fall: %s"
              % (tag, losses))
        rel = [abs(a - r) / abs(r) for a, r in
               zip(losses[:PAR_DP_AGREE], replay["losses"][:PAR_DP_AGREE])]
        print("parallel dp (%s): first %d losses %s vs one context %s, "
              "relative difference %s (tolerance 1e-3)"
              % (tag, PAR_DP_AGREE, ["%.6f" % x for x in losses[:3]],
                 ["%.6f" % x for x in replay["losses"][:3]],
                 ["%.3g" % x for x in rel]), flush=True)
        check(max(rel) <= 1e-3, "dp %s: the losses left the one-context "
              "run's" % tag)
        ex = mod._exec_group.execs[0]
        states = (kv.inner._updater.states if kv is not None
                  else mod._updater.states)
        tensors = [ex.arg_dict[n]._data for n in mod._exec_group.param_names]
        for st in states.values():
            tensors += [x._data for x in (st if isinstance(st, (tuple, list))
                                          else [st]) if x is not None]
        if kv is not None:
            tensors += [a._data for a in kv.inner._store.values()]
        check(all(t.is_cuda for t in tensors), "dp %s: a parameter or "
              "optimizer state left the card" % tag)
        steady = float(np.mean(times[warm:]))
        out[tag] = {"step_ms": steady * 1e3, "tokens_s": b * s / steady,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "losses": losses, "launches": launches,
                    "gathered_ops": ex._dp.gathered_ops()}
        print("parallel dp (%s): step ms %.2f, tokens/s %.1f, peak device "
              "memory %.2f GB; one context (train phase): step ms %.2f, "
              "tokens/s %.1f, peak %.2f GB; ops run on the whole batch: %s"
              % (tag, steady * 1e3, b * s / steady, out[tag]["peak_gb"],
                 replay["step_ms"], b * s / replay["step_ms"] * 1e3,
                 replay["peak_gb"], out[tag]["gathered_ops"] or "none"),
              flush=True)
        if kv is not None:
            print("parallel dp (%s): comm %s" % (tag, {
                k: v for k, v in kv.comm_stats().items()
                if k in ("pushes", "pulls", "wait_calls", "wait_ms_total",
                         "queue_peak")}), flush=True)
            kv.close()
        del mod, ex, states, tensors, kv
    scale = max(t.abs().max().item() for t in after["none"].values())
    diff = max((after["device"][n] - after["none"][n]).abs().max().item()
               for n in after["none"])
    print("parallel dp: after %d steps the two routes' parameters differ by "
          "%.3g, %.3g of the largest |parameter| (tolerance 1e-6)"
          % (PAR_DP_AGREE, diff, diff / scale), flush=True)
    check(diff <= 1e-6 * scale, "dp: the store's update and the fused "
          "step disagree")
    out["route_diff"] = diff / scale
    torch.cuda.empty_cache()
    return out


def ring_lse(torch, mt, q, k, v, mesh, causal, scale):
    """The ring's global lse, [b*h, s]."""
    from mxnet_tpu_torch.parallel import ring

    layout = ring._RingLayout(mesh, "seq", None)
    with torch.no_grad():
        _, lses = ring._ring_flash_fwd(layout, q, k, v, causal, scale)
    return torch.cat(lses[0], dim=1)


def ring_case(torch, mt, att, mesh, s, dtype, causal):
    """(b): the ring on [1, s, 16, 128] against K1-K3 over the whole
    sequence: errors, launches and times."""
    b, _, h, d = RING
    n = RING_SHARDS
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = qkv_views(torch, gen, b, s, s, h, d, dtype, device)
    do = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
    scale = 1.0 / math.sqrt(d)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    mt.kernels.reset_launches()
    o = mt.parallel.ring_flash_attention(*leaves, mesh, causal=causal)
    fwd = kernel_delta(mt, {})
    o.backward(do)
    launches = kernel_delta(mt, {})
    launches["flash_fwd"] = fwd["flash_fwd"]
    bwd_counted = {n: launches[n] for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    want = n * (n + 1) // 2 if causal else n * n
    o_ref, lse_ref = att.flash_forward(q, k, v, causal, scale)
    dq, dk, dv = att.flash_backward(q, k, v, o_ref, lse_ref, do, causal,
                                    scale)
    lse = ring_lse(torch, mt, q, k, v, mesh, causal, scale)
    errs = {"o": rel_err(torch, o, o_ref)[1],
            "lse": (lse - lse_ref).abs().max().item(),
            "dq": rel_err(torch, leaves[0].grad, dq)[1],
            "dk": rel_err(torch, leaves[1].grad, dk)[1],
            "dv": rel_err(torch, leaves[2].grad, dv)[1]}
    tol = RING_TOL[str(dtype)[6:]]
    tag = "%s %s s=%d" % (str(dtype)[6:], "causal" if causal else "full", s)
    print("parallel ring (%s): launches %s (want %d of each); errors %s "
          "(tolerance %g on O, dQ, dK, dV as max|err|/max|ref|, 1e-3 on lse)"
          % (tag, launches, want, {k_: "%.3g" % e for k_, e in errs.items()},
             tol), flush=True)
    check(fwd["flash_fwd"] == want and fwd["flash_bwd_dq"] == 0 and
          all(c == want for c in bwd_counted.values()),
          "ring %s launched %s, expected %d of each" % (tag, launches, want))
    check(all(errs[x] <= tol for x in ("o", "dq", "dk", "dv")) and
          errs["lse"] <= 1e-3, "ring %s disagrees with the whole-sequence "
          "kernels: %s" % (tag, errs))

    def ring_fwd():
        with torch.no_grad():
            mt.parallel.ring_flash_attention(q, k, v, mesh, causal=causal)

    def ring_step():
        x = [t.detach().requires_grad_(True) for t in (q, k, v)]
        mt.parallel.ring_flash_attention(*x, mesh, causal=causal) \
            .backward(do)

    def whole_step():
        o_, lse_ = att.flash_forward(q, k, v, causal, scale)
        att.flash_backward(q, k, v, o_, lse_, do, causal, scale)

    times = {"ring_fwd": cuda_ms(ring_fwd, RING_REPS),
             "whole_fwd": cuda_ms(lambda: att.flash_forward(
                 q, k, v, causal, scale), RING_REPS),
             "ring_fwd_bwd": cuda_ms(ring_step, RING_REPS),
             "whole_fwd_bwd": cuda_ms(whole_step, RING_REPS)}
    print("parallel ring (%s): ms (CUDA events, mean of %d): %s"
          % (tag, RING_REPS, {k_: "%.3f" % t for k_, t in times.items()}),
          flush=True)
    del q, k, v, do, leaves, o, o_ref, dq, dk, dv
    torch.cuda.empty_cache()
    return {"case": tag, "launches": launches, "errors": errs,
            "ms": times}


def ring_phase(torch, mt, att):
    mesh = mt.parallel.make_mesh({"seq": RING_SHARDS},
                                 devices=[mt.gpu(0)] * RING_SHARDS)
    _, s, _, _ = RING
    rows = [ring_case(torch, mt, att, mesh, s, torch.bfloat16, True),
            ring_case(torch, mt, att, mesh, s, torch.bfloat16, False),
            ring_case(torch, mt, att, mesh, RING_F32_S, torch.float32, True)]
    return rows


def longctx_phase(torch, mt):
    """(c): the long-context LM (train_lm_longctx.py's model at the LM's
    full width) trained LONGCTX_STEPS SGD steps in float32 over a
    ("data" 1, "seq" 4) mesh of the card."""
    c = LONGCTX
    device = torch.device("cuda", 0)
    mesh = mt.parallel.make_mesh({"data": 1, "seq": RING_SHARDS},
                                 devices=[mt.gpu(0)] * RING_SHARDS)
    rng = np.random.RandomState(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = longctx_params(torch, rng, c["vocab"], c["hidden"], c["heads"],
                            c["layers"], c["seq_len"], device)
    X = rng.randint(0, c["vocab"], size=(c["batch"], c["seq_len"]))
    tokens = torch.tensor(X, device=device)
    labels = torch.tensor((X + 1) % c["vocab"], device=device)
    with torch.no_grad():
        whole = longctx_loss(torch, mt, params, tokens, labels, c["heads"],
                             None).item()
    per_step = c["layers"] * RING_SHARDS * (RING_SHARDS + 1) // 2
    losses, times, counts = [], [], []
    mt.kernels.reset_launches()
    for step in range(LONGCTX_STEPS):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        loss = longctx_step(torch, mt, params, tokens, labels, c["heads"],
                            c["lr"], mesh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        counts.append(kernel_delta(mt, before))
        print("parallel longctx: step %d: %.2f ms, loss %.6f, launches %s"
              % (step, times[-1] * 1e3, losses[-1], counts[-1]), flush=True)
        check(all(v == per_step for v in counts[-1].values()),
              "longctx: step %d launched %s, expected %d of each"
              % (step, counts[-1], per_step))
    launches = kernel_delta(mt, {})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "longctx: the loss did not fall: %s" % losses)
    print("parallel longctx: step 0 loss %.7f vs %.7f with flash_attention "
          "over the whole sequence, difference %.3g (tolerance 1e-4)"
          % (losses[0], whole, abs(losses[0] - whole)), flush=True)
    check(abs(losses[0] - whole) <= 1e-4, "longctx: the ring's loss is not "
          "the whole sequence's")
    steady = float(np.mean(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print("parallel longctx: step ms %.2f (mean of %d after 1), tokens/s "
          "%.1f, peak device memory %.2f GB"
          % (steady * 1e3, LONGCTX_STEPS - 1,
             c["batch"] * c["seq_len"] / steady, peak), flush=True)
    del params, tokens, labels
    torch.cuda.empty_cache()
    return {"step_ms": steady * 1e3,
            "tokens_s": c["batch"] * c["seq_len"] / steady,
            "peak_gb": peak, "losses": losses, "whole_loss": whole,
            "launches": launches}


def dist_init(rng):
    """The dist LM's parameters as numpy, from the shapes its symbol
    infers: N(0, 0.02) weights, zero biases, unit LayerNorm gammas."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    with mt.NameManager():
        net = get_transformer_lm(**DIST)
    shapes = {"data": (DIST_BATCH, DIST["seq_len"]),
              "softmax_label": (DIST_BATCH, DIST["seq_len"])}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    out = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("bias", "beta")):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (rng.randn(*shape) * 0.02).astype(np.float32)
    return net, out


def dist_batch():
    rng = np.random.RandomState(SEED + 1)
    X = rng.randint(0, DIST["vocab_size"],
                    size=(DIST_WORKERS * DIST_BATCH, DIST["seq_len"]))
    return X.astype(np.float32), ((X + 1) % DIST["vocab_size"]).astype(
        np.float32)


def dist_module(mt, net, init, batch, kvstore):
    mod = mt.mod.Module(net, label_names=("softmax_label",),
                        context=mt.gpu(0))
    shape = (batch, DIST["seq_len"])
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", shape)])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in init.items()}, aux_params={})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=DIST_SGD)
    return mod


def dist_worker(outdir):
    """One dist_sync worker (run by ``--dist-worker``): the DMLC variables
    name its rank; it checks the store's init and push, trains DIST_STEPS
    steps on its rows of the batch and writes its losses, parameters and
    checks to ``outdir``."""
    import torch

    import mxnet_tpu_torch as mt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kv = mt.kv.create("dist_sync")
    rank, n = kv.rank, kv.num_workers
    # init: each rank offers its own value, rank 0's must win
    kv.init("probe", mt.nd.array(np.full(4, rank + 1.0, np.float32),
                                 mt.gpu(0)))
    probe = mt.nd.zeros((4,), mt.gpu(0))
    kv.pull("probe", out=probe)
    kv.push("probe", mt.nd.array(np.full(4, rank + 1.0, np.float32),
                                 mt.gpu(0)))
    summed = mt.nd.zeros((4,), mt.gpu(0))
    kv.pull("probe", out=summed)
    net, init = dist_init(np.random.RandomState(SEED))
    # every rank but 0 starts elsewhere: the store's init must replace it
    init = {k: v + rank for k, v in init.items()}
    X, Y = dist_batch()
    rows = slice(rank * DIST_BATCH, (rank + 1) * DIST_BATCH)
    it = mt.io.NDArrayIter(X[rows], Y[rows], batch_size=DIST_BATCH,
                           label_name="softmax_label")
    batch = it.next()
    mod = dist_module(mt, net, init, DIST_BATCH, kv)
    losses, times = [], []
    for _ in range(DIST_STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y[rows]))
    arg, _ = mod.get_params()
    np.savez(os.path.join(outdir, "rank%d.npz" % rank),
             losses=np.array(losses), times=np.array(times),
             probe=probe.asnumpy(), summed=summed.asnumpy(),
             multiprocess=np.array(mod._exec_group._multiprocess),
             backend=np.array(mt.kvstore_dist.BACKEND or ""),
             **{"p:" + k: v.asnumpy() for k, v in arg.items()})
    kv._barrier()


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_workers(flag, n, prefix):
    """``n`` processes of this script in the worker mode ``flag``, ranks
    0..n-1 of one gloo group on a free port, each logging to
    ``worker<rank>.log`` in a new folder.  Returns (folder, processes)."""
    port = free_port()
    outdir = tempfile.mkdtemp(prefix=prefix)
    env = dict(os.environ, DMLC_NUM_WORKER=str(n),
               DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port))
    procs = []
    for r in range(n):
        with open(os.path.join(outdir, "worker%d.log" % r), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, outdir],
                env=dict(env, DMLC_WORKER_ID=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
    return outdir, procs


def stop_workers(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def join_workers(job, timeout):
    """Wait up to ``timeout`` s for ``start_workers``' processes, then stop
    any still running; their logs, by rank."""
    outdir, procs = job
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        stop_workers(procs)
    logs = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, "worker%d.log" % r)) as f:
            logs.append(f.read())
    return logs


def dist_phase(torch, mt, job):
    """(d): DIST_WORKERS dist_sync workers on the card (``job``, started
    by ``parallel_phase`` beside (a)-(c)), against one process's Module at
    the combined batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    outdir, procs = job
    logs = join_workers(job, DIST_TIMEOUT)
    for r, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.strip().splitlines()[-12:])
        print("parallel dist: worker %d exit %s; log tail:\n%s"
              % (r, p.returncode, tail), flush=True)
        check(p.returncode == 0, "dist worker %d failed (exit %s):\n%s"
              % (r, p.returncode, tail))
    got = [dict(np.load(os.path.join(outdir, "rank%d.npz" % r)))
           for r in range(DIST_WORKERS)]
    backends = {str(g["backend"]) for g in got}
    print("parallel dist: backend %s on %d worker(s) of %s"
          % (backends, DIST_WORKERS, torch.cuda.get_device_name(0)),
          flush=True)
    check(backends == {"gloo"}, "dist: two workers on one card must take "
          "gloo, took %s" % backends)
    for r, g in enumerate(got):
        check(bool(g["multiprocess"]), "dist: worker %d did not sum its "
              "gradients over the group" % r)
        check(np.array_equal(g["probe"], np.full(4, 1.0)),
              "dist: worker %d's init is not rank 0's: %s" % (r, g["probe"]))
        check(np.array_equal(g["summed"], np.full(4, 3.0)),
              "dist: worker %d's push did not sum: %s" % (r, g["summed"]))
    # the one-process reference at the combined batch, same init
    net, init = dist_init(np.random.RandomState(SEED))
    X, Y = dist_batch()
    it = mt.io.NDArrayIter(X, Y, batch_size=DIST_WORKERS * DIST_BATCH,
                           label_name="softmax_label")
    batch = it.next()
    mod = dist_module(mt, net, init, DIST_WORKERS * DIST_BATCH, None)
    ref_losses, ref_times = [], []
    for _ in range(DIST_STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        ref_times.append(time.perf_counter() - t0)
        probs = mod.get_outputs()[0]
        rows = probs.shape[0] // DIST_WORKERS
        ref_losses.append([lm_loss(torch, mt.nd.NDArray(
            probs._data[r * rows:(r + 1) * rows], probs.context),
            Y[r * DIST_BATCH:(r + 1) * DIST_BATCH])
            for r in range(DIST_WORKERS)])
    arg, _ = mod.get_params()
    ref = {k: v.asnumpy() for k, v in arg.items()}
    scale = max(np.abs(v).max() for v in ref.values())
    loss_err = max(abs(g["losses"][s] - ref_losses[s][r])
                   for r, g in enumerate(got) for s in range(DIST_STEPS))
    param_err = max(np.abs(g["p:" + k] - v).max()
                    for g in got for k, v in ref.items()) / scale
    worker_ms = float(np.mean([g["times"][1:].mean() for g in got])) * 1e3
    single_ms = float(np.mean(ref_times[1:])) * 1e3
    print("parallel dist: losses %s vs one process %s; max loss difference "
          "%.3g, parameters %.3g of the largest |parameter| (tolerance 1e-5)"
          % ([["%.6f" % x for x in g["losses"]] for g in got],
             [["%.6f" % x for x in row] for row in ref_losses], loss_err,
             param_err), flush=True)
    print("parallel dist: ms per step %.2f per worker (mean of %d after 1), "
          "one process at batch %d %.2f" % (
              worker_ms, DIST_STEPS - 1, DIST_WORKERS * DIST_BATCH,
              single_ms), flush=True)
    check(loss_err <= 1e-5 and param_err <= 1e-5, "dist: the workers "
          "disagree with one process at the combined batch")
    del mod
    torch.cuda.empty_cache()
    return {"backend": sorted(backends)[0], "worker_ms": worker_ms,
            "single_ms": single_ms, "loss_err": float(loss_err),
            "param_err": float(param_err)}


def rest_phase(torch, mt):
    """(e): ulysses, the pipeline and MoE on meshes of the card against
    their single-device versions, float32, TF32 off."""
    P = mt.parallel
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    mesh = P.make_mesh({"seq": 4}, devices=[mt.gpu(0)] * 4)
    q, k, v = rand(2, 1024, 16, 64), rand(2, 1024, 16, 64), \
        rand(2, 1024, 16, 64)
    for causal in (False, True):
        err = rel_err(torch, P.ulysses_attention(q, k, v, mesh,
                                                 causal=causal),
                      P.local_attention(q, k, v, causal=causal))[0]
        out["ulysses %s" % ("causal" if causal else "full")] = err
    pmesh = P.make_mesh({"pipe": 4}, devices=[mt.gpu(0)] * 4)
    ws = rand(4, 256, 256, scale=0.06)
    x = rand(64, 256)
    got = P.pipeline_spmd(lambda w, a: torch.tanh(a @ w), ws, x, pmesh,
                          axis="pipe", n_microbatches=8)
    ref = x
    for i in range(4):
        ref = torch.tanh(ref @ ws[i])
    out["pipeline"] = rel_err(torch, got, ref)[0]
    emesh = P.make_mesh({"expert": 4}, devices=[mt.gpu(0)] * 4)
    x, gw = rand(2, 128, 256), rand(256, 8, scale=0.5)
    w1, w2 = rand(8, 256, 512, scale=0.05), rand(8, 512, 256, scale=0.05)
    for top_k in (1, 2):
        out["moe top-%d" % top_k] = rel_err(
            torch, P.moe_ffn(x, gw, w1, w2, emesh, top_k=top_k),
            P.moe_ffn_reference(x, gw, w1, w2, top_k=top_k))[0]
    print("parallel rest: max|err| against the single-device versions %s "
          "(tolerance 1e-5)" % {k_: "%.3g" % e for k_, e in out.items()},
          flush=True)
    check(all(e <= 1e-5 for e in out.values()), "parallel: ulysses, the "
          "pipeline or MoE disagrees with its single-device version")
    return out


def parallel_phase(torch, mt, att, batch, replay):
    """Phase 16: (a) data parallel, (b) the ring, (c) long-context
    training, (d) dist_sync, (e) the rest of ``parallel``.  Returns the
    launches of K1-K3 by path, under "bf16" (the d=128 bf16 kernels: (a)
    and (b)'s bf16 cases) and "f32" (the d=128 float32 kernels: (b)'s
    float32 case and (c))."""
    card = card_and_limit()
    # (d)'s worker processes start first and run beside (a)-(c)
    dist_job = start_workers("--dist-worker", DIST_WORKERS, "dist_sync_")
    try:
        dp = dp_phase(torch, mt, batch, replay)
        # (b)-(e) run in float32 as the example does: no TF32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ring = ring_phase(torch, mt, att)
        longctx = longctx_phase(torch, mt)
        dist = dist_phase(torch, mt, dist_job)
    finally:
        stop_workers(dist_job[1])
    rest = rest_phase(torch, mt)
    print(json.dumps({"parallel": {
        "card": card,
        "dp": {k: {x: y for x, y in v.items() if x != "losses"}
               if isinstance(v, dict) else v for k, v in dp.items()},
        "ring": ring,
        "longctx": {k: v for k, v in longctx.items() if k != "losses"},
        "dist": dist, "rest": rest}}), flush=True)

    def total(counts):
        return {k: sum(c.get(k, 0) for c in counts)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return {"bf16": {
                "data parallel": total([dp[t]["launches"] for t in dp
                                        if isinstance(dp[t], dict)]),
                "ring": total([r["launches"] for r in ring
                               if r["case"].startswith("bfloat16")])},
            "f32": {
                "ring": total([r["launches"] for r in ring
                               if r["case"].startswith("float32")]),
                "long-context": total([longctx["launches"]])}}


# ---------------------------------------------------------------------------
# phase 17: the recurrent family
# ---------------------------------------------------------------------------
# BASELINE #3 at the widths of upstream MXNet's example/rnn/lstm_bucketing.py
PTB = dict(vocab=10000, hidden=200, embed=200, layers=2, batch=32,
           buckets=(10, 20, 30, 40, 50, 60))
PTB_SGD = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}
PTB_SENTENCES = 1200   # lengths 2-60: every bucket fills 5 batches or more
PTB_EPOCHS = 2
PTB_SEED = 0
PTB_CPU_STEPS = 2      # the first losses held to the CPU route
PTB_REPLAY = 3         # the first steps replayed bit for bit
PTB_TIMED = (10, 60)   # the buckets whose step is timed
PTB_REPS = 5
# the RNN op alone: (T, N, hidden = input, layers) of (a) and of Zaremba et
# al.'s large PTB LSTM
RNN_OP_SIZES = ((60, 32, 200, 2), (35, 20, 1500, 2))
RNN_OP_REPS = 10
MP_SEQ, MP_STEPS, MP_LR = 35, 3, 0.05   # BASELINE #5
# the CTC OCR net at upstream example/warpctc/lstm_ocr.py's widths; a
# frame is a column of the 30-pixel-high captcha
OCR = dict(seq_len=80, hidden=100, label_len=4, classes=10, feat=30,
           batch=32, batches=10, epochs=3, lr=1e-2)
RECURRENT_TOL = 1e-4


def markov_corpus(vocab, n, lo, hi, seed):
    """examples/rnn/lstm_bucketing.py's synthetic corpus: a Markov chain
    where each word has 4 successors with Dirichlet weights, its table kept
    sparse (vocab x 4) at PTB's vocabulary.  Ids run from 1: 0 is the
    padding label."""
    rng = np.random.RandomState(seed)
    succ = 1 + np.stack([rng.choice(vocab - 1, size=4, replace=False)
                         for _ in range(vocab)])
    weights = rng.dirichlet(np.ones(4), size=vocab)
    sents = []
    for _ in range(n):
        s = [1 + rng.randint(vocab - 1)]
        for _ in range(rng.randint(lo, hi + 1) - 1):
            s.append(int(succ[s[-1], rng.choice(4, p=weights[s[-1]])]))
        sents.append(s)
    return sents


def ptb_iter(mt, sents, seed=PTB_SEED):
    """The bucketed iterator, its shuffles seeded (Python's random and
    numpy's global generator, as BucketSentenceIter draws them)."""
    import random as pyrandom

    pyrandom.seed(seed)
    np.random.seed(seed)
    return mt.rnn.BucketSentenceIter(sents, PTB["batch"],
                                     buckets=list(PTB["buckets"]),
                                     invalid_label=0)


def ptb_sym_gen(mt, fused):
    """lstm_bucketing.py's sym_gen: Embedding, 2 LSTM layers (LSTMCells in a
    SequentialRNNCell, or one FusedRNNCell as cudnn_lstm_bucketing.py),
    FullyConnected to the vocabulary, SoftmaxOutput."""
    h = PTB["hidden"]
    if fused:
        cell = mt.rnn.FusedRNNCell(h, num_layers=PTB["layers"], mode="lstm",
                                   prefix="lstm_")
    else:
        cell = mt.rnn.SequentialRNNCell()
        for i in range(PTB["layers"]):
            cell.add(mt.rnn.LSTMCell(num_hidden=h, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        embed = mt.sym.Embedding(data=mt.sym.Variable("data"),
                                 input_dim=PTB["vocab"],
                                 output_dim=PTB["embed"], name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.FullyConnected(mt.sym.Reshape(outputs, shape=(-1, h)),
                                     num_hidden=PTB["vocab"], name="pred")
        label = mt.sym.Reshape(mt.sym.Variable("softmax_label"), shape=(-1,))
        return (mt.sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def ptb_module(mt, ctx, fused, it, args):
    """A BucketingModule bound on ``ctx`` from the parameters ``args``
    (host arrays), with the example's SGD."""
    mod = mt.mod.BucketingModule(ptb_sym_gen(mt, fused),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mt.nd.array(v, ctx)
                                for k, v in args.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=PTB_SGD)
    return mod


def padded_nll(torch, probs, labels):
    """Mean negative log-likelihood of the non-padding labels (0 pads)."""
    p = probs._data.float()
    lab = labels._data.to(p.device).reshape(-1).long()
    keep = lab != 0
    picked = p.gather(1, lab[:, None]).squeeze(1)[keep]
    return -picked.clamp_min(1e-30).log().mean().item()


def ptb_steps(torch, mod, it, n):
    """``n`` steps through forward_backward/update: the losses and the
    parameters after them (host copies)."""
    losses = []
    for k, batch in enumerate(it):
        if k == n:
            break
        mod.forward_backward(batch)
        mod.update()
        losses.append(padded_nll(torch, mod.get_outputs()[0],
                                 batch.label[0]))
    return losses, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def bucket_batches(it, keys):
    """One batch of each bucket in ``keys``."""
    found = {}
    for batch in it:
        if batch.bucket_key in keys and batch.bucket_key not in found:
            found[batch.bucket_key] = batch
        if len(found) == len(keys):
            break
    it.reset()
    return found


def bucket_step_ms(torch, mod, batches):
    """Mean ms of one forward_backward + update at each bucket, CUDA events
    over back-to-back steps (after one warm-up step)."""
    out = {}
    for key, batch in sorted(batches.items()):
        def step():
            mod.forward_backward(batch)
            mod.update()
        out[key] = cuda_ms(step, PTB_REPS)
    return out


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def ptb_unfused(torch, mt, sents, profile_dir):
    """(a) BASELINE #3 through BucketingModule.fit, then its gates."""
    from mxnet_tpu_torch.metric import Perplexity

    gpu = mt.gpu(0)
    mt.random.seed(PTB_SEED)
    it = ptb_iter(mt, sents)
    mod = mt.mod.BucketingModule(ptb_sym_gen(mt, False),
                                 default_bucket_key=it.default_bucket_key,
                                 context=gpu)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                               magnitude=2.34))
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    record = {"losses": [], "keys": [], "epoch_ppl": {}, "epoch_s": {},
              "tokens": {}}
    marks = {}

    def on_batch(param):
        batch = param.locals["data_batch"]
        e = param.epoch
        if param.nbatch == 0:
            torch.cuda.synchronize()
            marks[e] = time.perf_counter()
        if len(record["losses"]) < PTB_REPLAY and e == 0:
            record["losses"].append(padded_nll(
                torch, mod.get_outputs()[0], batch.label[0]))
            record["keys"].append(batch.bucket_key)
            if len(record["losses"]) == PTB_REPLAY:
                record["after"] = {k: v.asnumpy() for k, v in
                                   mod.get_params()[0].items()}
        record["epoch_ppl"][e] = param.eval_metric.get()[1]
        record["tokens"][e] = record["tokens"].get(e, 0) + \
            int(np.prod(batch.data[0].shape))
        torch.cuda.synchronize()
        record["epoch_s"][e] = time.perf_counter() - marks[e]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=Perplexity(ignore_label=0), optimizer="sgd",
            optimizer_params=PTB_SGD, num_epoch=PTB_EPOCHS,
            batch_end_callback=on_batch)
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ppl = [record["epoch_ppl"][e] for e in range(PTB_EPOCHS)]
    check(all(math.isfinite(p) for p in ppl) and ppl[1] < ppl[0],
          "recurrent (a): train perplexity did not fall from epoch 1 to "
          "epoch 2: %s" % ppl)
    check(sorted(mod._buckets) == list(PTB["buckets"]),
          "recurrent (a): buckets bound %s" % sorted(mod._buckets))
    for name, arr in mod.get_params()[0].items():
        check(arr._data.is_cuda, "recurrent (a): %s is not on the card"
              % name)
    # the CPU route from the same init and batches
    cpu_losses, _ = ptb_steps(torch, ptb_module(
        mt, mt.cpu(), False, ptb_iter(mt, sents), init),
        ptb_iter(mt, sents), PTB_CPU_STEPS)
    cpu_err = [rel(a, b) for a, b in zip(record["losses"], cpu_losses)]
    check(max(cpu_err) <= RECURRENT_TOL,
          "recurrent (a): the card's first losses %s are not within %g of "
          "the CPU route's %s" % (record["losses"][:PTB_CPU_STEPS],
                                  RECURRENT_TOL, cpu_losses))
    # the first steps again, bit for bit
    rep_losses, rep_after = ptb_steps(torch, ptb_module(
        mt, gpu, False, ptb_iter(mt, sents), init), ptb_iter(mt, sents),
        PTB_REPLAY)
    check(rep_losses == record["losses"] and all(
        np.array_equal(rep_after[k], v) for k, v in record["after"].items()),
        "recurrent (a): the first %d steps did not replay bit for bit "
        "(%s vs %s)" % (PTB_REPLAY, rep_losses, record["losses"]))
    batches = bucket_batches(it, PTB_TIMED)
    step_ms = bucket_step_ms(torch, mod, batches)
    if profile_dir:
        b60 = batches[max(PTB_TIMED)]

        def step():
            mod.forward_backward(b60)
            mod.update()
        profile(torch, step, profile_dir, "ptb_step_b%d" % max(PTB_TIMED))
    last = PTB_EPOCHS - 1
    out = {"perplexity_by_epoch": ppl, "first_losses": record["losses"],
           "first_buckets": record["keys"], "cpu_losses": cpu_losses,
           "cpu_rel_err": cpu_err, "replay": "bitwise",
           "step_ms": {str(k): v for k, v in step_ms.items()},
           "tokens_per_s_by_step": {
               str(k): PTB["batch"] * k / (v / 1e3)
               for k, v in step_ms.items()},
           "fit_tokens_per_s": record["tokens"][last] /
           record["epoch_s"][last],
           "fit_s": fit_s, "peak_gb": peak_gb}
    print("recurrent (a): PTB LSTM 2 x %d, vocab %d, batch %d, buckets %s "
          "through BucketingModule.fit: perplexity by epoch %s; first losses "
          "%s (buckets %s) vs the CPU route %s (rel %s); %d steps replay "
          "bitwise; step %s ms by bucket; fit epoch %d %.1f tokens/s "
          "(padding included); peak %.2f GB; fit %.1f s"
          % (PTB["hidden"], PTB["vocab"], PTB["batch"], list(PTB["buckets"]),
             ppl, record["losses"], record["keys"], cpu_losses, cpu_err,
             PTB_REPLAY, {k: round(v, 3) for k, v in step_ms.items()},
             last + 1, out["fit_tokens_per_s"], peak_gb, fit_s), flush=True)
    return out, init, record["losses"][0]


def ptb_fused(torch, mt, sents, init, loss0):
    """(b) the same model through FusedRNNCell, from (a)'s init packed."""
    gpu = mt.gpu(0)
    cell = mt.rnn.FusedRNNCell(PTB["hidden"], num_layers=PTB["layers"],
                               mode="lstm", prefix="lstm_")
    args = cell.pack_weights(dict(init))
    check(sorted(args) == ["embed_weight", "lstm_parameters", "pred_bias",
                           "pred_weight"],
          "recurrent (b): packed parameters %s" % sorted(args))
    it = ptb_iter(mt, sents)
    mod = ptb_module(mt, gpu, True, it, args)
    losses, _ = ptb_steps(torch, mod, it, 1)
    err = rel(losses[0], loss0)
    check(err <= RECURRENT_TOL, "recurrent (b): FusedRNNCell's step-0 loss "
          "%r is not within %g of the cells' %r" % (losses[0], RECURRENT_TOL,
                                                    loss0))
    step_ms = bucket_step_ms(torch, mod, bucket_batches(it, PTB_TIMED))
    print("recurrent (b): FusedRNNCell (the RNN op): step-0 loss %r vs the "
          "cells' %r (rel %.3g); step %s ms by bucket"
          % (losses[0], loss0, err,
             {k: round(v, 3) for k, v in step_ms.items()}), flush=True)
    return {"loss0": losses[0], "rel_err": err,
            "step_ms": {str(k): v for k, v in step_ms.items()}}


def rnn_op_call(mode, layers, bidirectional=False):
    """The RNN op's function over tensors, in training (gradients by
    autograd)."""
    from mxnet_tpu_torch.ops import OpContext, get_op

    op = get_op("RNN")
    return lambda h, *ins: op.apply(OpContext(is_train=True), op.parse_attrs(
        {"state_size": h, "num_layers": layers, "mode": mode,
         "bidirectional": bidirectional}), list(ins))[0][0]


def cudnn_lstm(torch, packed, size, layers):
    """torch.nn.LSTM (cuDNN) holding the packed vector's weights."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_unpack_layout

    lstm = torch.nn.LSTM(size, size, num_layers=layers).cuda()
    with torch.no_grad():
        for layer, _, kind, off, shape in rnn_unpack_layout(
                size, size, layers, "lstm"):
            name = {"i2h_weight": "weight_ih", "h2h_weight": "weight_hh",
                    "i2h_bias": "bias_ih", "h2h_bias": "bias_hh"}[kind]
            n = int(np.prod(shape))
            getattr(lstm, "%s_l%d" % (name, layer)).copy_(
                packed[off:off + n].reshape(shape))
    return lstm


def rnn_op_timing(torch):
    """The RNN op alone against cuDNN's LSTM on the same weights: outputs
    within 1e-4, forward and forward + backward timed by CUDA events."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(PTB_SEED)
    for T, N, H, L in RNN_OP_SIZES:
        x = torch.randn(T, N, H, device="cuda", generator=gen)
        bound = 1.0 / math.sqrt(H)
        packed = (torch.rand(rnn_param_size(H, H, L, "lstm"), device="cuda",
                             generator=gen) * 2 - 1) * bound
        h0 = torch.zeros(L, N, H, device="cuda")
        head = torch.randn(T, N, H, device="cuda", generator=gen)
        ours = rnn_op_call("lstm", L)
        lstm = cudnn_lstm(torch, packed, H, L)
        with torch.no_grad():
            got = ours(H, x, packed, h0, h0)
            ref = lstm(x, (h0, h0))[0]
        err = float((got - ref).abs().max() / ref.abs().max())
        check(err <= RECURRENT_TOL, "recurrent (b): the RNN op at T %d N %d "
              "2 x %d is %.3g off cuDNN" % (T, N, H, err))
        xg = x.clone().requires_grad_(True)
        pg = packed.clone().requires_grad_(True)

        def fwd():
            with torch.no_grad():
                ours(H, x, packed, h0, h0)

        def fwd_bwd():
            ours(H, xg, pg, h0, h0).backward(head)

        def lib_fwd():
            with torch.no_grad():
                lstm(x, (h0, h0))

        def lib_fwd_bwd():
            lstm(xg, (h0, h0))[0].backward(head)
        row = {"T": T, "N": N, "hidden": H, "layers": L, "rel_err": err,
               "fwd_ms": cuda_ms(fwd, RNN_OP_REPS),
               "fwd_bwd_ms": cuda_ms(fwd_bwd, RNN_OP_REPS),
               "cudnn_fwd_ms": cuda_ms(lib_fwd, RNN_OP_REPS),
               "cudnn_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, RNN_OP_REPS)}
        rows.append(row)
        print("recurrent (b): RNN op lstm T %d N %d %d x %d: forward %.3f ms "
              "(cuDNN %.3f), forward + backward %.3f ms (cuDNN %.3f); "
              "output %.3g off cuDNN"
              % (T, N, L, H, row["fwd_ms"], row["cudnn_fwd_ms"],
                 row["fwd_bwd_ms"], row["cudnn_fwd_bwd_ms"], err),
              flush=True)
        del lstm, xg, pg
    return rows


def rnn_modes_vs_cpu(torch):
    """GRU and a bidirectional LSTM once each: forward and every gradient
    on the card within 1e-4 of the CPU route."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size

    T, N, H, L = 20, 8, 64, 2
    out = {}
    for mode, bidir in (("gru", False), ("lstm", True)):
        d = 2 if bidir else 1
        rng = np.random.RandomState(PTB_SEED)
        host = [rng.randn(T, N, H).astype(np.float32),
                (0.2 * rng.randn(rnn_param_size(H, H, L, mode, bidir)))
                .astype(np.float32),
                (0.1 * rng.randn(L * d, N, H)).astype(np.float32)]
        if mode == "lstm":
            host.append((0.1 * rng.randn(L * d, N, H)).astype(np.float32))
        head = rng.randn(T, N, H * d).astype(np.float32)
        call = rnn_op_call(mode, L, bidir)
        res = []
        for dev in ("cuda", "cpu"):
            ins = [torch.tensor(a, device=dev, requires_grad=True)
                   for a in host]
            y = call(H, *ins)
            y.backward(torch.tensor(head, device=dev))
            res.append([y.detach().cpu().numpy()] +
                       [a.grad.cpu().numpy() for a in ins])
        err = max(float(np.abs(g - r).max() / max(1.0, np.abs(r).max()))
                  for g, r in zip(*res))
        check(err <= RECURRENT_TOL, "recurrent (b): %s%s on the card is "
              "%.3g off the CPU route" % ("bidirectional " if bidir else "",
                                          mode, err))
        out["%s%s" % ("bi-" if bidir else "", mode)] = err
    print("recurrent (b): GRU and bidirectional LSTM (T %d N %d 2 x %d) "
          "forward and gradients vs the CPU route: %s" % (T, N, H, out),
          flush=True)
    return out


def mp_symbol(mt, seq_len, num_layers, num_hidden, num_embed, vocab_size):
    """examples/model_parallel_lstm/lstm.py's build_symbol: one ctx group
    per layer."""
    data = mt.sym.Variable("data")
    label = mt.sym.Variable("softmax_label")
    with mt.AttrScope(ctx_group="embed"):
        hidden = mt.sym.Embedding(data=data, input_dim=vocab_size,
                                  output_dim=num_embed, name="embed")
    for i in range(num_layers):
        with mt.AttrScope(ctx_group="layer%d" % i):
            cell = mt.rnn.LSTMCell(num_hidden=num_hidden,
                                   prefix="lstm_l%d_" % i)
            hidden, _ = cell.unroll(seq_len, inputs=hidden,
                                    merge_outputs=True)
    with mt.AttrScope(ctx_group="decode"):
        pred = mt.sym.Reshape(hidden, shape=(-1, num_hidden))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=vocab_size,
                                     name="pred")
        label_r = mt.sym.Reshape(label, shape=(-1,))
        return mt.sym.SoftmaxOutput(data=pred, label=label_r, name="softmax")


def model_parallel_lstm(torch, mt, sents):
    """(c) BASELINE #5: the example's loop (forward, backward, sgd_update per
    parameter) over group2ctx, each layer on its own context of gpu(0),
    against one context's Module with the same SGD."""
    B, T = PTB["batch"], MP_SEQ
    data = np.array([s[:T + 1] for s in sents if len(s) > T][:B * MP_STEPS],
                    np.float32)
    check(len(data) == B * MP_STEPS, "recurrent (c): %d sentences of %d+ "
          "words" % (len(data), T + 1))
    x, y = data[:, :-1], data[:, 1:]
    net = mp_symbol(mt, T, PTB["layers"], PTB["hidden"], PTB["embed"],
                    PTB["vocab"])
    groups = ["embed", "decode"] + ["layer%d" % i
                                    for i in range(PTB["layers"])]
    group2ctx = {g: mt.Context("gpu", 0) for g in groups}
    exe = net.simple_bind(mt.gpu(0), data=(B, T), softmax_label=(B * T,),
                          grad_req="write", group2ctx=group2ctx)
    check(len(exe._placement) > 0, "recurrent (c): no node was placed")
    rng = np.random.RandomState(PTB_SEED)
    init = {name: rng.uniform(-0.08, 0.08, arr.shape).astype(np.float32)
            for name, arr in sorted(exe.arg_dict.items())
            if name not in ("data", "softmax_label")}
    for name, v in init.items():
        exe.arg_dict[name][:] = v
    placed = []
    t0 = time.perf_counter()
    for b in range(MP_STEPS):
        sl = slice(b * B, (b + 1) * B)
        exe.arg_dict["data"][:] = x[sl]
        exe.arg_dict["softmax_label"][:] = y[sl].reshape(-1)
        probs = exe.forward(is_train=True)[0]
        exe.backward()
        for name, grad in exe.grad_dict.items():
            if name in ("data", "softmax_label") or grad is None:
                continue
            mt.nd.sgd_update(exe.arg_dict[name], grad,
                             out=exe.arg_dict[name], lr=MP_LR)
        placed.append(lm_loss(torch, probs, y[sl]))
    torch.cuda.synchronize()
    placed_ms = (time.perf_counter() - t0) * 1e3 / MP_STEPS
    mod = mt.mod.Module(net, context=mt.gpu(0))
    # Module splits labels by the batch: (B, T), which the net reshapes
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.gpu(0))
                                for k, v in init.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": MP_LR, "rescale_grad": 1.0})
    single = []
    for b in range(MP_STEPS):
        sl = slice(b * B, (b + 1) * B)
        mod.forward_backward(mt.io.DataBatch(
            data=[mt.nd.array(x[sl], mt.cpu())],
            label=[mt.nd.array(y[sl], mt.cpu())]))
        mod.update()
        single.append(lm_loss(torch, mod.get_outputs()[0], y[sl]))
    err = max(rel(a, b) for a, b in zip(placed, single))
    check(err <= 1e-6, "recurrent (c): the placed losses %s are not within "
          "1e-6 of one context's %s" % (placed, single))
    check(placed[-1] < placed[0], "recurrent (c): the loss did not fall: %s"
          % placed)
    print("recurrent (c): model-parallel LSTM over group2ctx (%d groups on "
          "gpu(0), seq %d): losses %s vs one context's Module %s (rel %.3g); "
          "%.2f ms a step (forward, backward that re-runs it, %d updates)"
          % (len(groups), T, placed, single, err, placed_ms, len(init)),
          flush=True)
    return {"losses": placed, "module_losses": single, "rel_err": err,
            "step_ms": placed_ms}


def ocr_data(n, seq_len, label_len, n_classes, feat_dim, seed=PTB_SEED):
    """examples/warpctc/lstm_ocr.py's frames: a template per symbol plus
    noise, each symbol held 2-3 frames, blanks between; labels 0-padded."""
    rng = np.random.RandomState(seed)
    templates = rng.randn(n_classes + 1, feat_dim).astype(np.float32)
    X = np.zeros((n, seq_len, feat_dim), np.float32)
    Y = np.zeros((n, label_len), np.float32)
    for i in range(n):
        syms = rng.randint(1, n_classes + 1, size=rng.randint(1, label_len + 1))
        Y[i, :len(syms)] = syms
        t = 0
        for s in syms:
            for _ in range(rng.randint(2, 4)):
                if t >= seq_len:
                    break
                X[i, t] = templates[s] + rng.randn(feat_dim) * 0.3
                t += 1
            if t < seq_len and rng.rand() < 0.5:
                X[i, t] = templates[0] + rng.randn(feat_dim) * 0.3
                t += 1
    return X, Y


def ocr_net(mt, seq_len, label_len, num_hidden, n_classes):
    """lstm_ocr.py's build_net: an LSTM over the frames, time-major rows,
    FullyConnected to the alphabet, WarpCTC."""
    cell = mt.rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_")
    outputs, _ = cell.unroll(seq_len, inputs=mt.sym.Variable("data"),
                             layout="NTC", merge_outputs=True)
    tm = mt.sym.transpose(outputs, axes=(1, 0, 2))
    pred = mt.sym.FullyConnected(mt.sym.Reshape(tm, shape=(-1, num_hidden)),
                                 num_hidden=n_classes + 1, name="pred")
    return mt.sym.WarpCTC(data=pred, label=mt.sym.Variable("label"),
                          label_length=label_len, input_length=seq_len)


def ctc_f64(torch, data, labels, T):
    """Summed CTC loss in float64: the textbook alpha recursion over the
    blank-extended labels (Graves et al. 2006), independent of the op's.
    -1e30 stands for log 0, so no gradient meets -inf - -inf."""
    n = data.shape[0] // T
    logp = torch.log_softmax(data.reshape(T, n, -1), dim=-1)
    total = data.new_zeros(())
    for b in range(n):
        lab = [int(v) for v in labels[b] if v != 0]
        ext = [0]
        for v in lab:
            ext += [v, 0]
        idx = torch.tensor(ext, device=data.device)
        skip = torch.tensor([s >= 2 and ext[s] != 0 and ext[s] != ext[s - 2]
                             for s in range(len(ext))], device=data.device)
        lp = logp[:, b, idx]                                   # (T, S)
        alpha = torch.full((len(ext),), -1e30, dtype=data.dtype,
                           device=data.device)
        alpha[0] = lp[0, 0]
        if len(ext) > 1:
            alpha[1] = lp[0, 1]
        ninf = alpha.new_full((1,), -1e30)
        for t in range(1, T):
            a1 = torch.cat([ninf, alpha[:-1]])
            a2 = torch.where(skip, torch.cat([ninf, ninf, alpha[:-2]]),
                             ninf.expand(len(ext)))
            alpha = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + lp[t]
        total = total - torch.logsumexp(alpha[-2:], 0)
    return total


def ocr_phase(torch, mt):
    """(d) the CTC OCR net through Module: the loss falls; WarpCTC's
    gradient at the net's shapes against the CPU route and float64."""
    from mxnet_tpu_torch.ops.ctc import _ctc_losses

    c = OCR
    X, Y = ocr_data(c["batch"] * c["batches"], c["seq_len"], c["label_len"],
                    c["classes"], c["feat"])
    net = ocr_net(mt, c["seq_len"], c["label_len"], c["hidden"],
                  c["classes"])
    mt.random.seed(PTB_SEED)
    mod = mt.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (c["batch"], c["seq_len"], c["feat"]))],
             label_shapes=[("label", (c["batch"], c["label_len"]))])
    mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                               magnitude=2.34))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": c["lr"]})
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["epochs"]):
        for b in range(c["batches"]):
            sl = slice(b * c["batch"], (b + 1) * c["batch"])
            label = mt.nd.array(Y[sl], mt.cpu())
            mod.forward_backward(mt.io.DataBatch(
                data=[mt.nd.array(X[sl], mt.cpu())], label=[label]))
            mod.update()
            probs = mod.get_outputs()[0]._data
            losses.append(float(_ctc_losses(
                probs.clamp_min(1e-30).log(), label._data.to(probs.device),
                c["seq_len"], c["label_len"]).mean()))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    check(all(math.isfinite(v) for v in losses) and tail < head,
          "recurrent (d): the CTC loss did not fall: %s" % losses)
    # WarpCTC alone at the net's shapes: (T * N, classes + 1) rows
    rows = c["seq_len"] * c["batch"]
    rng = np.random.RandomState(PTB_SEED + 1)
    data = rng.randn(rows, c["classes"] + 1).astype(np.float32)
    label = Y[:c["batch"]]
    grads = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        ctc = mt.sym.WarpCTC(data=mt.sym.Variable("data"),
                             label=mt.sym.Variable("label"),
                             label_length=c["label_len"],
                             input_length=c["seq_len"])
        ex = ctc.bind(ctx, {"data": mt.nd.array(data, ctx),
                            "label": mt.nd.array(label, ctx)},
                      args_grad={"data": mt.nd.zeros(data.shape, ctx)})
        ex.forward(is_train=True)
        ex.backward()
        grads[ctx.device_type] = ex.grad_dict["data"].asnumpy()
    d64 = torch.tensor(data, dtype=torch.float64, device="cuda",
                       requires_grad=True)
    ctc_f64(torch, d64, label, c["seq_len"]).backward()
    g64 = d64.grad.cpu().numpy()
    card = grads["gpu"]
    scale = max(1.0, float(np.abs(g64).max()))
    cpu_err = float(np.abs(card - grads["cpu"]).max()) / scale
    f64_err = float(np.abs(card - g64).max()) / scale
    check(cpu_err <= 1e-5, "recurrent (d): WarpCTC's gradient on the card "
          "is %.3g off the CPU route" % cpu_err)
    check(f64_err <= RECURRENT_TOL, "recurrent (d): WarpCTC's gradient on "
          "the card is %.3g off float64" % f64_err)
    print("recurrent (d): CTC OCR net (LSTM %d, %d frames, %d labels of %d "
          "classes, batch %d) through Module, adam: loss %.4f -> %.4f over "
          "%d steps (%.2f ms a step, loss included); WarpCTC gradient at "
          "(%d, %d) %.3g off the CPU route, %.3g off float64"
          % (c["hidden"], c["seq_len"], c["label_len"], c["classes"],
             c["batch"], head, tail, len(losses), step_ms, rows,
             c["classes"] + 1, cpu_err, f64_err), flush=True)
    return {"loss_first5": head, "loss_last5": tail, "steps": len(losses),
            "step_ms": step_ms, "grad_cpu_err": cpu_err,
            "grad_f64_err": f64_err}


def sequence_ops_vs_cpu(torch, mt):
    """(e) SequenceLast/Mask/Reverse with lengths on the card: forward and
    data gradient equal to the CPU route's."""
    T, N, C = 60, 32, 200
    rng = np.random.RandomState(PTB_SEED)
    x = rng.randn(T, N, C).astype(np.float32)
    lengths = rng.randint(1, T + 1, size=N).astype(np.float32)
    for op in ("SequenceLast", "SequenceMask", "SequenceReverse"):
        net = getattr(mt.sym, op)(mt.sym.Variable("data"),
                                  mt.sym.Variable("sequence_length"),
                                  use_sequence_length=True)
        shape = (N, C) if op == "SequenceLast" else (T, N, C)
        head = rng.randn(*shape).astype(np.float32)
        res = []
        for ctx in (mt.gpu(0), mt.cpu()):
            ex = net.bind(ctx, {"data": mt.nd.array(x, ctx),
                                "sequence_length": mt.nd.array(lengths, ctx)},
                          args_grad={"data": mt.nd.zeros(x.shape, ctx)})
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward(mt.nd.array(head, ctx))
            res.append((out, ex.grad_dict["data"].asnumpy()))
        check(all(np.array_equal(a, b) for a, b in zip(*res)),
              "recurrent (e): %s on the card differs from the CPU route"
              % op)
    print("recurrent (e): SequenceLast, SequenceMask, SequenceReverse (T %d "
          "N %d C %d, lengths given): forward and gradient on the card equal "
          "to the CPU route" % (T, N, C), flush=True)
    return "equal"


def recurrent_phase(torch, mt, profile_dir=None):
    """Phase 17 (module docstring).  Returns the port's kernel launches in
    the phase (none is on these paths)."""
    before = dict(mt.kernels.LAUNCHES)
    card = card_and_limit()
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sents = markov_corpus(PTB["vocab"], PTB_SENTENCES, 2,
                          max(PTB["buckets"]), PTB_SEED)
    a, init, loss0 = ptb_unfused(torch, mt, sents, profile_dir)
    b = ptb_fused(torch, mt, sents, init, loss0)
    b["rnn_op"] = rnn_op_timing(torch)
    b["modes_vs_cpu"] = rnn_modes_vs_cpu(torch)
    torch.cuda.empty_cache()
    summary = {"card": card, "ptb": a, "ptb_fused": b,
               "model_parallel": model_parallel_lstm(torch, mt, sents),
               "ocr": ocr_phase(torch, mt),
               "sequence_ops": sequence_ops_vs_cpu(torch, mt)}
    torch.cuda.empty_cache()
    summary["wall_s"] = time.perf_counter() - t0
    print("recurrent: phase wall time %.1f s" % summary["wall_s"], flush=True)
    print(json.dumps({"recurrent": summary}), flush=True)
    return {k: v - before.get(k, 0) for k, v in mt.kernels.LAUNCHES.items()
            if v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# phase 18: the GSPMD layer
# ---------------------------------------------------------------------------
SHARD_RUNS = (("tp", "data=1,model=2", 2, 2, 5),   # tag, mesh, shards, warm, timed
              ("2d", "data=2,model=2", 4, 2, 3))
SHARD_AGREE = 3            # the first losses held to the train phase's
SHARD_SAVE_AT = 3          # (d): the checkpoint after (a)'s step 3
SHARD_RESUME = 2           # (d): steps taken from it
SHARD_F32 = dict(FULL, num_layers=2)   # (c)
SHARD_F32_STEPS = 3
SHARD_F32_TOL = 1e-4       # max |difference| / max |value|
SHARD_F32_MOVE_TOL = 1e-3  # max |Δtp - Δone| / max |Δone|, Δ the 3 steps'
# SGD: adam's first steps move a parameter by lr whatever the size of its
# gradient, so a near-zero gradient's rounding could flip a step's sign,
# and a gradient off by a factor would move it as far
SHARD_F32_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
# the witness: at lr 0.05 the loss diverges by step 3 (10.80 -> 69.02);
# the sharded Module's gap there is printed beside the unsharded Module's
# own gap from an init one float32 ulp away, which shows how far 3 such
# steps carry a rounding
SHARD_F32_WITNESS_LR = 0.05
SHARD_BN = dict(batch=32, image=(3, 28, 28), classes=10, steps=3)   # (e)
SHARD_BN_SGD = {"learning_rate": 0.05, "momentum": 0.9}
# the heads of (e): SoftmaxOutput per row (scaled by the default
# rescale_grad, 1 / global batch) and normalized by the global batch
# (rescale_grad 1), which runs on the batch gathered over the group
SHARD_BN_HEADS = {"null": {}, "batch": {"rescale_grad": 1.0}}
SHARD_BN_TOL = 1e-5
SHARD_WORKERS = 2


#: phase 18's parameter-bytes gauges by run tag, read by phase 25 (e)
SHARD_READINGS = {}


def shard_module(mt, net, mesh, shards, arg_params, compute_dtype,
                 optimizer_params, begin_num_update=0, optimizer="adam"):
    """The LM through ``Module`` over ``shards`` contexts of the card, laid
    out by ``transformer_megatron`` on ``mesh``."""
    b, s = BATCH, FULL["seq_len"]
    mod = mt.mod.Module(net, label_names=("softmax_label",),
                        context=[mt.gpu(0)] * shards,
                        compute_dtype=compute_dtype)
    mod.bind(data_shapes=[mt.io.DataDesc("data", (b, s))],
             label_shapes=[mt.io.DataDesc("softmax_label", (b, s))],
             mesh=mesh, partition_rules="transformer_megatron")
    mod.set_params(arg_params, {})
    mod.init_optimizer(optimizer=optimizer, optimizer_params=dict(
        optimizer_params, begin_num_update=begin_num_update))
    return mod


def planned_attention(mod):
    """K1 (and K2, K3) launches a step by the partitioned walk's plan: each
    attention node once, or once per batch shard where it runs per
    shard."""
    ex = mod._exec_group.execs[0]
    dp = ex._dp
    return sum(dp.nb if dp.local[id(n)] else 1 for n in ex._plan.nodes
               if not n.is_variable and
               n.op.name == "_contrib_FlashAttention")


def host_params(mod):
    """Whole host copies of the parameters (gathered from their pieces)."""
    ex = mod._exec_group.execs[0]
    return {n: ex.arg_dict[n].asnumpy() for n in mod._exec_group.param_names}


def shard_pieces_on_card(torch, mod):
    """Every piece of every parameter and optimizer state lies on the
    card."""
    from mxnet_tpu_torch.executor import _items

    ex = mod._exec_group.execs[0]
    arrays = [ex.arg_dict[n]._data for n in mod._exec_group.param_names]
    for st in mod._updater.states.values():
        arrays += [x._data for x in (st if isinstance(st, (tuple, list))
                                     else [st]) if x is not None]
    return all(t.is_cuda for a in arrays for _, t in _items(a))


def shard_steps(torch, mt, mod, batch, Y, n, what, per_step, on_step=None):
    """``n`` steps of ``mod`` with the launch counts read per step:
    (losses, step seconds)."""
    losses, times = [], []
    for step in range(n):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = kernel_delta(mt, before)
        losses.append(lm_loss(torch, mod.get_outputs()[0], Y))
        print("sharding %s: step %d: %.2f ms, loss %.6f, launches %s"
              % (what, step, times[-1] * 1e3, losses[-1], delta), flush=True)
        check(np.isfinite(losses[-1]), "sharding %s: step %d loss is not "
              "finite" % (what, step))
        check(all(v == per_step for v in delta.values()),
              "sharding %s: step %d launched %s, the plan says %d of each"
              % (what, step, delta, per_step))
        if on_step is not None:
            on_step(step + 1)
    return losses, times


def shard_tp_run(torch, mt, batch, replay, tag, mesh_text, shards, warm,
                 timed, ckpt=None):
    """(a) or (b): the train phase's LM, init and batch over ``mesh_text``
    on ``shards`` contexts of the card; with ``ckpt`` (a directory) the
    sharded checkpoint and optimizer states after step SHARD_SAVE_AT and
    the parameters after step SHARD_SAVE_AT + SHARD_RESUME."""
    from mxnet_tpu_torch import sharding

    b, s = BATCH, FULL["seq_len"]
    init = {n: mt.nd.NDArray(t, mt.cpu()) for n, t in replay["init"].items()}
    Y = replay["Y"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = sharding.build_mesh(mesh_text, devices=[mt.gpu(0)] * shards)
    mod = shard_module(mt, replay["net"], mesh, shards, init, "bfloat16",
                       {"learning_rate": TRAIN_LR})
    group = mod._exec_group
    ex = group.execs[0]
    check(mod._fused_ok and mod._update_on_kvstore is False,
          "sharding %s: the update does not run inside the fused step"
          % tag)
    pieces = ex.arg_dict["layer0_qkv_weight"]._data
    shapes = [tuple(p.shape) for p in pieces.shards.values()]
    print("sharding %s: mesh %s over %d contexts of %s; layer0_qkv_weight "
          "stored as pieces %s" % (tag, sharding.mesh_axes(mesh), shards,
                                   mt.gpu(0), shapes), flush=True)
    check(shapes == [(3 * FULL["hidden"] // 2, FULL["hidden"])] * 2,
          "sharding %s: layer0_qkv_weight's pieces are %s" % (tag, shapes))
    snap = mt.telemetry.registry().snapshot()
    gauges = (snap["mxtpu_params_sharded_bytes"],
              snap["mxtpu_params_replicated_bytes"])
    print("sharding %s: parameter bytes per mesh coordinate %d (gauge "
          "mxtpu_params_sharded_bytes) vs %d replicated "
          "(mxtpu_params_replicated_bytes)" % ((tag,) + gauges), flush=True)
    check(gauges[0] < gauges[1], "sharding %s: the sharded bytes are not "
          "below the replicated bytes" % tag)
    SHARD_READINGS[tag] = gauges
    per_step = planned_attention(mod)
    batch_shards = mesh.shape[mesh.axis_names[0]]
    print("sharding %s: the plan runs attention %d times a step (%d layers "
          "x %d batch shard(s), on the whole heads); strategies %s"
          % (tag, per_step, FULL["num_layers"], per_step //
             FULL["num_layers"], sorted({st for st, _ in
                                         ex._dp.strategy.values()})),
          flush=True)
    check(per_step == FULL["num_layers"] * batch_shards,
          "sharding %s: the plan runs attention %d times a step, not once "
          "per layer and batch shard (%d)"
          % (tag, per_step, FULL["num_layers"] * batch_shards))
    saved = {}

    def on_step(k):
        if ckpt is None:
            return
        if k == SHARD_SAVE_AT:
            t0 = time.perf_counter()
            args = {n: ex.arg_dict[n] for n in group.param_names}
            mt.checkpoint.save_sharded_checkpoint(
                os.path.join(ckpt, "lm"), k, None, args, {})
            mod.save_optimizer_states(os.path.join(ckpt, "lm.states"))
            saved["save_s"] = time.perf_counter() - t0
        if k == SHARD_SAVE_AT + SHARD_RESUME:
            saved["params"] = host_params(mod)

    mt.kernels.reset_launches()
    losses, times = shard_steps(torch, mt, mod, batch, Y, warm + timed, tag,
                                per_step, on_step)
    launches = kernel_delta(mt, {})
    check(losses[-1] < losses[0], "sharding %s: the loss did not fall: %s"
          % (tag, losses))
    rel = [abs(a - r) / abs(r) for a, r in
           zip(losses[:SHARD_AGREE], replay["losses"][:SHARD_AGREE])]
    print("sharding %s: first %d losses %s vs one context %s, relative "
          "difference %s (tolerance 1e-3)"
          % (tag, SHARD_AGREE, ["%.6f" % x for x in losses[:SHARD_AGREE]],
             ["%.6f" % x for x in replay["losses"][:SHARD_AGREE]],
             ["%.3g" % x for x in rel]), flush=True)
    check(max(rel) <= 1e-3, "sharding %s: the losses left the one-context "
          "run's" % tag)
    check(shard_pieces_on_card(torch, mod), "sharding %s: a parameter or "
          "optimizer state piece left the card" % tag)
    steady = float(np.mean(times[warm:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"mesh": sharding.mesh_axes(mesh), "step_ms": steady * 1e3,
           "tokens_s": b * s / steady, "peak_gb": peak,
           "sharded_bytes": gauges[0], "replicated_bytes": gauges[1],
           "attention_per_step": per_step, "launches": launches,
           "losses": losses, "loss_rel": max(rel)}
    print("sharding %s: step ms %.2f, tokens/s %.1f, peak device memory "
          "%.2f GB; one context (train phase): step ms %.2f, tokens/s %.1f, "
          "peak %.2f GB (%d shards on one card: the partitioner's own "
          "cost, not a multi-card speed-up)"
          % (tag, steady * 1e3, b * s / steady, peak, replay["step_ms"],
             b * s / replay["step_ms"] * 1e3, replay["peak_gb"], shards),
          flush=True)
    del mod, ex, group
    torch.cuda.empty_cache()
    return out, saved


def shard_resume(torch, mt, batch, replay, ckpt, saved, tp):
    """(d): the checkpoint of (a)'s step SHARD_SAVE_AT restored onto a
    fresh mesh and a fresh Module takes SHARD_RESUME steps: (a)'s losses
    and parameters bit for bit; an incomplete directory raises."""
    from mxnet_tpu_torch import sharding

    prefix = os.path.join(ckpt, "lm")
    t0 = time.perf_counter()
    fresh = sharding.build_mesh("data=1,model=2", devices=[mt.gpu(0)] * 2)
    _, args, auxs = mt.checkpoint.load_sharded_checkpoint(
        prefix, SHARD_SAVE_AT, mesh=fresh)
    w = args["layer0_qkv_weight"]._data
    check(isinstance(w, sharding.ShardedTensor) and w.mesh is fresh and
          all(p.is_cuda for p in w.shards.values()),
          "sharding resume: the restored pieces are not on the fresh mesh")
    mod = shard_module(mt, replay["net"], fresh, 2, args, "bfloat16",
                       {"learning_rate": TRAIN_LR},
                       begin_num_update=SHARD_SAVE_AT)
    mod.load_optimizer_states(prefix + ".states")
    load_s = time.perf_counter() - t0
    del args, auxs, w
    mt.kernels.reset_launches()
    losses, _ = shard_steps(torch, mt, mod, batch, replay["Y"], SHARD_RESUME,
                            "resume", tp["attention_per_step"])
    launches = kernel_delta(mt, {})
    got = host_params(mod)
    want_losses = tp["losses"][SHARD_SAVE_AT:SHARD_SAVE_AT + SHARD_RESUME]
    same_losses = losses == want_losses
    differ = sorted(n for n, v in got.items()
                    if not np.array_equal(v, saved["params"][n]))
    print("sharding resume: saved after step %d in %.2f s, restored onto a "
          "fresh mesh and a fresh Module in %.2f s; losses %s vs (a)'s %s: "
          "%s; parameters after %d steps %s"
          % (SHARD_SAVE_AT, saved["save_s"], load_s,
             ["%.6f" % x for x in losses], ["%.6f" % x for x in want_losses],
             "bitwise" if same_losses else "DIFFERENT", SHARD_RESUME,
             "bitwise" if not differ else "differ: %s" % differ[:5]),
          flush=True)
    check(same_losses and not differ, "sharding resume: the resumed steps "
          "are not (a)'s bit for bit")
    os.remove(os.path.join(prefix + "-%04d.orbax" % SHARD_SAVE_AT,
                           "mxnet_complete"))
    try:
        mt.checkpoint.load_sharded_checkpoint(prefix, SHARD_SAVE_AT,
                                              mesh=fresh)
        raised = None
    except mt.MXNetError as e:
        raised = str(e)
    print("sharding resume: a directory without its completion marker: %s"
          % (raised or "loaded"), flush=True)
    check(raised is not None and "incomplete" in raised,
          "sharding resume: an incomplete checkpoint loaded")
    del mod
    torch.cuda.empty_cache()
    return {"save_s": saved["save_s"], "load_s": load_s, "losses": losses,
            "launches": launches}


def f32_gaps(got, ref, init):
    """Per parameter, max |got - ref| / max |ref| and, with Δ the move from
    ``init``, max |Δgot - Δref| / max |Δref|: (worst value gap, its name,
    worst move gap, its name, max |Δref| of that parameter, the smallest
    max |Δref| of any parameter)."""
    value, move = (0.0, None), (0.0, None, 0.0)
    least = float("inf")
    for n, r in ref.items():
        gap = float(np.abs(got[n] - r).max())
        moved = float(np.abs(r - init[n]).max())
        least = min(least, moved)
        v = gap / max(float(np.abs(r).max()), 1e-30)
        m = float(np.abs((got[n] - init[n]) - (r - init[n])).max()) / \
            max(moved, 1e-30)
        if v > value[0]:
            value = (v, n)
        if m > move[0]:
            move = (m, n, moved)
    return value + move + (least,)


def shard_f32(torch, mt, batch, replay):
    """(c): the LM at 2 layers in float32 (TF32 off) on (a)'s mesh against
    one unsharded Module on the card, from one init: the gated pair at
    SHARD_F32_SGD, then the witness at SHARD_F32_WITNESS_LR."""
    from mxnet_tpu_torch import sharding
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    b, s = BATCH, FULL["seq_len"]
    with mt.NameManager():
        net = get_transformer_lm(**SHARD_F32)
    shapes = {"data": (b, s), "softmax_label": (b, s)}
    init = {k[4:]: v for k, v in lm_params(
        mt, net, shapes, np.random.default_rng(SEED), 0.02).items()}
    start = {k: v.asnumpy() for k, v in init.items()}
    nudged = {k: mt.nd.array(np.nextafter(v, np.float32(np.inf)), mt.cpu())
              for k, v in start.items()}
    Y = replay["Y"]
    per_step = SHARD_F32["num_layers"]
    params, losses = {}, {}
    launches = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    witness = dict(SHARD_F32_SGD, learning_rate=SHARD_F32_WITNESS_LR)
    for tag, sgd, arrays in (("one", SHARD_F32_SGD, init),
                             ("tp", SHARD_F32_SGD, init),
                             ("one@w", witness, init),
                             ("tp@w", witness, init),
                             ("nudged@w", witness, nudged)):
        torch.cuda.empty_cache()
        if not tag.startswith("tp"):
            mod = train_module(mt, net, mt.gpu(0), (b, s),
                               arg_params=arrays, optimizer="sgd",
                               optimizer_params=sgd)
        else:
            mesh = sharding.build_mesh("data=1,model=2",
                                       devices=[mt.gpu(0)] * 2)
            mod = shard_module(mt, net, mesh, 2, arrays, None, sgd,
                               optimizer="sgd")
            check(planned_attention(mod) == per_step, "sharding f32: the "
                  "plan does not run attention once a layer")
        mt.kernels.reset_launches()
        losses[tag], _ = shard_steps(torch, mt, mod, batch, Y,
                                     SHARD_F32_STEPS, "f32 " + tag, per_step)
        if tag.startswith("tp"):
            for k, v in kernel_delta(mt, {}).items():
                launches[k] = launches.get(k, 0) + v
        params[tag] = host_params(mod)
        del mod
    gated = f32_gaps(params["tp"], params["one"], start)
    print("sharding f32: 2 layers, float32, TF32 off, SGD lr %g; after %d "
          "steps the sharded Module's parameters within %.3g of their "
          "largest |value| of the unsharded Module's (worst %s; tolerance "
          "%g); its moves within %.3g of the unsharded moves' largest "
          "|value| (worst %s, which moved at most %.3g; tolerance %g; the "
          "least-moved parameter moved at most %.3g); losses %s vs %s"
          % (SHARD_F32_SGD["learning_rate"], SHARD_F32_STEPS, gated[0],
             gated[1], SHARD_F32_TOL, gated[2], gated[3], gated[4],
             SHARD_F32_MOVE_TOL, gated[5],
             ["%.6f" % x for x in losses["tp"]],
             ["%.6f" % x for x in losses["one"]]), flush=True)
    wit = {k: f32_gaps(params[k], params["one@w"], start)
           for k in ("tp@w", "nudged@w")}
    print("sharding f32 witness at lr %g (losses %s): the sharded Module "
          "within %.3g of the largest |value| (%s) and %.3g of the largest "
          "move (%s) of the unsharded one's; the unsharded Module from an "
          "init one float32 ulp up within %.3g (%s) and %.3g (%s) of it"
          % (SHARD_F32_WITNESS_LR, ["%.4f" % x for x in losses["one@w"]],
             wit["tp@w"][0], wit["tp@w"][1], wit["tp@w"][2], wit["tp@w"][3],
             wit["nudged@w"][0], wit["nudged@w"][1], wit["nudged@w"][2],
             wit["nudged@w"][3]), flush=True)
    check(gated[0] <= SHARD_F32_TOL, "sharding f32: the sharded Module left "
          "the unsharded one's parameters")
    check(gated[2] <= SHARD_F32_MOVE_TOL, "sharding f32: the sharded "
          "Module's parameters did not move as the unsharded one's")
    torch.cuda.empty_cache()
    return {"param_rel": gated[0], "worst": gated[1], "move_rel": gated[2],
            "worst_move": gated[3], "least_move": gated[5],
            "witness_lr": SHARD_F32_WITNESS_LR,
            "witness_tp": wit["tp@w"][0], "witness_tp_move": wit["tp@w"][2],
            "witness_ulp": wit["nudged@w"][0],
            "witness_ulp_move": wit["nudged@w"][2], "launches": launches}


def shard_bn_net(mt, normalization="null"):
    """A small convolutional net with BatchNorm (LeNet's layout)."""
    sym = mt.sym
    with mt.NameManager():
        x = sym.Convolution(sym.Variable("data"), kernel=(5, 5),
                            num_filter=20, name="conv1")
        x = sym.BatchNorm(x, fix_gamma=False, name="bn1")
        x = sym.Activation(x, act_type="relu")
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
        x = sym.Flatten(x)
        x = sym.FullyConnected(x, num_hidden=64, name="fc1")
        x = sym.BatchNorm(x, fix_gamma=False, name="bn2")
        x = sym.Activation(x, act_type="relu")
        x = sym.FullyConnected(x, num_hidden=SHARD_BN["classes"],
                               name="fc2")
        return sym.SoftmaxOutput(x, name="softmax",
                                 normalization=normalization)


def shard_bn_data():
    rng = np.random.RandomState(SEED + 2)
    n = SHARD_WORKERS * SHARD_BN["batch"]
    X = rng.randn(n, *SHARD_BN["image"]).astype(np.float32)
    # the workers' rows differ in their mean, so per-worker statistics
    # would not be the global batch's
    X[n // 2:] += 0.5
    Y = (np.arange(n) % SHARD_BN["classes"]).astype(np.float32)
    return X, Y


def shard_bn_module(mt, batch, dist_mesh=None, kvstore=None, head="null"):
    net = shard_bn_net(mt, head)
    shape = (batch,) + SHARD_BN["image"]
    mod = mt.mod.Module(net, label_names=("softmax_label",),
                        context=mt.gpu(0), dist_mesh=dist_mesh)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (batch,))])
    rng = np.random.RandomState(SEED)
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape)
    args = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        args[name] = (np.ones(shp, np.float32) if name.endswith("gamma")
                      else (rng.randn(*shp) * 0.1).astype(np.float32))
    aux = {name: (np.ones if name.endswith("var") else np.zeros)(
        shp, np.float32) for name, shp in zip(net.list_auxiliary_states(),
                                              aux_shapes)}
    mod.init_params(arg_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in args.items()},
                    aux_params={k: mt.nd.array(v, mt.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=dict(SHARD_BN_SGD,
                                             **SHARD_BN_HEADS[head]))
    return mod


def shard_bn_batch(mt, X, Y):
    return mt.io.NDArrayIter(X, Y, batch_size=len(X),
                             label_name="softmax_label").next()


def shard_bn_train(torch, mt, mod, X, Y):
    b = shard_bn_batch(mt, X, Y)
    for _ in range(SHARD_BN["steps"]):
        mod.forward_backward(b)
        mod.update()
    torch.cuda.synchronize()
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items()) +
            list(auxs.items())}


def shard_bn_eval(mt, mod, X, Y, times=1):
    """The trained module's inference outputs on (X, Y), forward ``times``
    times."""
    b = shard_bn_batch(mt, X, Y)
    for _ in range(times):
        mod.forward(b, is_train=False)
    return mod.get_outputs()[0].asnumpy()


def shard_worker(outdir):
    """One worker of (e) (run by ``--shard-worker``): the DMLC variables
    name its rank; it trains the BatchNorm net under each head on its rows
    of the global batch, then evaluates it alone (rank r forwards 2r + 1
    times: no collective), and writes its parameters, moving statistics
    and outputs to ``outdir``."""
    import torch

    import mxnet_tpu_torch as mt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kv = mt.kv.create("dist_sync")
    rank = kv.rank
    X, Y = shard_bn_data()
    rows = slice(rank * SHARD_BN["batch"], (rank + 1) * SHARD_BN["batch"])
    got = {}
    for head in SHARD_BN_HEADS:
        mod = shard_bn_module(mt, SHARD_BN["batch"], head=head,
                              kvstore=kv if head == "null" else None)
        trained = shard_bn_train(torch, mt, mod, X[rows], Y[rows])
        got.update({"%s:%s" % (head, k): v for k, v in trained.items()})
        got[head + ":multiprocess"] = np.array(
            mod._exec_group._multiprocess)
        got[head + ":gathered"] = np.array(
            mod._exec_group.execs[0]._dp.gathered_ops())
        got[head + ":eval"] = shard_bn_eval(mt, mod, X[rows], Y[rows],
                                            2 * rank + 1)
    np.savez(os.path.join(outdir, "rank%d.npz" % rank), **got)
    kv._barrier()


def shard_global_batch(torch, mt, job):
    """(e): two dist_sync workers over gloo on the card (``job``, started
    by ``sharding_phase`` beside (a)-(d)) train the BatchNorm net, each on
    its rows of the global batch, against one process on the concatenated
    batch."""
    outdir, procs = job
    logs = join_workers(job, DIST_TIMEOUT)
    for r, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.strip().splitlines()[-8:])
        print("sharding global batch: worker %d exit %s; log tail:\n%s"
              % (r, p.returncode, tail), flush=True)
        check(p.returncode == 0, "sharding global batch: worker %d failed "
              "(exit %s):\n%s" % (r, p.returncode, tail))
    got = [dict(np.load(os.path.join(outdir, "rank%d.npz" % r)))
           for r in range(SHARD_WORKERS)]
    X, Y = shard_bn_data()
    n = SHARD_BN["batch"]
    out, refs = {}, {}
    for head in SHARD_BN_HEADS:
        mod = shard_bn_module(mt, SHARD_WORKERS * n, head=head)
        refs[head] = ref = shard_bn_train(torch, mt, mod, X, Y)
        ref_eval = shard_bn_eval(mt, mod, X, Y)
        worst = max(float(np.abs(g["%s:%s" % (head, k)] - v).max()) /
                    max(float(np.abs(v).max()), 1e-30)
                    for g in got for k, v in ref.items())
        evals = max(float(np.abs(g[head + ":eval"] -
                                 ref_eval[r * n:(r + 1) * n]).max())
                    for r, g in enumerate(got))
        for r, g in enumerate(got):
            check(bool(g[head + ":multiprocess"]) and
                  "BatchNorm" in list(g[head + ":gathered"]),
                  "sharding global batch: worker %d did not run BatchNorm "
                  "on the global batch" % r)
        print("sharding global batch, SoftmaxOutput normalization %r: %d "
              "workers x batch %d, ops run on the batch gathered over the "
              "group %s; parameters and moving statistics within %.3g of "
              "their largest |value| of one process at batch %d (tolerance "
              "%g); each worker's inference outputs alone (forwards 1 and "
              "3) within %.3g of that process's rows"
              % (head, SHARD_WORKERS, n,
                 [str(x) for x in got[0][head + ":gathered"]], worst,
                 SHARD_WORKERS * n, SHARD_BN_TOL, evals), flush=True)
        check(worst <= SHARD_BN_TOL and evals <= SHARD_BN_TOL,
              "sharding global batch: the workers disagree with one "
              "process on the concatenated batch (normalization %r)" % head)
        out[head] = {"param_rel": worst, "eval_abs": evals}
    local = shard_bn_train(torch, mt, shard_bn_module(mt, n), X[:n], Y[:n])
    own = float(np.abs(local["bn1_moving_mean"] -
                       refs["null"]["bn1_moving_mean"]).max())
    print("sharding global batch: one worker's own statistics would differ "
          "by %.3g" % own, flush=True)
    check(own > 1e-3, "sharding global batch: the check cannot tell the "
          "global statistics from a worker's own")
    out["own_stat_gap"] = own
    return out


def sharding_phase(torch, mt, batch, replay):
    """Phase 18 (module docstring).  Returns the launches of K1-K3 by path,
    as ``parallel_phase`` does."""
    import shutil

    card = card_and_limit()
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="shard_ckpt_")
    # (e)'s worker processes start first and run beside (a)-(d)
    bn_job = start_workers("--shard-worker", SHARD_WORKERS, "shard_bn_")
    try:
        runs, saved = {}, None
        for tag, mesh, shards, warm, timed in SHARD_RUNS:
            runs[tag], got = shard_tp_run(
                torch, mt, batch, replay, tag, mesh, shards, warm, timed,
                ckpt if tag == "tp" else None)
            saved = saved or got
        resume = shard_resume(torch, mt, batch, replay, ckpt, saved,
                              runs["tp"])
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f32 = shard_f32(torch, mt, batch, replay)
        global_batch = shard_global_batch(torch, mt, bn_job)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        stop_workers(bn_job[1])
    wall = time.perf_counter() - t0
    print("sharding: phase wall time %.1f s on %s" % (wall, card),
          flush=True)
    print(json.dumps({"sharding": {
        "card": card, "wall_s": wall,
        "runs": {k: {x: y for x, y in v.items() if x != "losses"}
                 for k, v in runs.items()},
        "resume": {k: v for k, v in resume.items() if k != "losses"},
        "f32": f32, "global_batch": global_batch,
        "note": "shards share one card: the times are the partitioner's "
                "own cost, not a multi-card speed-up"}}), flush=True)

    def total(counts):
        return {k: sum(c.get(k, 0) for c in counts)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return {"bf16": {"tensor parallel": total(
                [runs[t]["launches"] for t in runs] + [resume["launches"]])},
            "f32": {"tensor parallel": f32["launches"]}}


# ---------------------------------------------------------------------------
# phase 19: the parameter server
# ---------------------------------------------------------------------------
PS_WORKERS, PS_SERVERS = 2, 2
PS_BATCH = BATCH // PS_WORKERS      # the train phase's batch split in halves
# tag, case, warm-up, timed steps (cut from 2 + 3, 5, 2 + 3 to make room
# for phase 22, and (c) from 4 to 3 for phase 23: the gates compare the
# first PS_LOSSES losses, two updates after the init's, and the async loss
# falls over 3 steps).  (a) and (d) run one after the other, beside only
# the end of lane A; (c) runs beside (b), (e1) and (e2)
PS_RUNS = (("a", "sync", 1, 2),
           ("c", "async", 0, 3),
           ("d", "fp16", 1, 2))
PS_LOSSES = 3
# (c): each worker's push is an adam update of its own, two a step from
# stale gradients; at the train phase's lr 3e-4 the loss spiked at step 4
# (9.45 -> 12.71), at 1.5e-4 too (9.61 -> 10.63, back to 9.22 at step 5);
# at a quarter of it the loss falls every step
PS_ASYNC_LR = TRAIN_LR / 4
PS_F32 = dict(FULL, num_layers=2)   # (b)
# phase 18 (c)'s setting for this LM in float32: at lr 0.01 the parameters
# moved by up to their own size in 3 steps and the two routes' rounding
# grew to 2.78e-5 of the largest value
PS_F32_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
PS_F32_STEPS = 3
PS_F32_TOL = 1e-5
PS_LOSS_TOL = 1e-3
PS_FP16_BYTES = 0.51
PS_CHURN = dict(steps=10, preempt=3, gate=6, workers=3)       # (e1)
PS_DURABLE = dict(steps=8, snapshot_at=4, batch=16, features=32,
                  hidden=64, classes=4)                        # (e2)
PS_DURABLE_SGD = {"learning_rate": 0.05, "momentum": 0.9}
PS_TIMEOUT = 600
PS_FILE_WAIT = 300
PS_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def ps_batch():
    """The train phase's batch (train_lm.py::_synth_iter from SEED)."""
    rng = np.random.RandomState(SEED)
    X = rng.randint(0, FULL["vocab_size"],
                    size=(BATCH, FULL["seq_len"])).astype(np.float32)
    return X, (X + 1) % FULL["vocab_size"]


def ps_f32_init(mt, net):
    """(b)'s parameters from SEED: N(0, 0.02) weights, zero biases and
    shifts, unit LayerNorm gains, as CPU NDArrays."""
    shape = (PS_BATCH, PS_F32["seq_len"])
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    rng = np.random.RandomState(SEED)
    out = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            arr = np.ones(shp, np.float32)
        elif name.endswith(("bias", "beta")):
            arr = np.zeros(shp, np.float32)
        else:
            arr = (rng.randn(*shp) * 0.02).astype(np.float32)
        out[name] = mt.nd.array(arr, mt.cpu())
    return out


def ps_init_crc(tensors):
    """crc32 of the first 4096 elements of every parameter, in name order:
    whether two inits are the same bits."""
    import zlib

    crc = 0
    for name in sorted(tensors):
        head = tensors[name].reshape(-1)[:4096].detach().float().cpu()
        crc = zlib.crc32(head.numpy().tobytes(), crc)
    return crc


def touch(path):
    with open(path, "w"):
        pass


def wait_for(path, timeout=PS_FILE_WAIT):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise SystemExit("param_server: timed out waiting for %s" % path)
        time.sleep(0.05)


def ps_lm_worker(outdir, case):
    """A worker of (a)-(d): the LM on its half of the train phase's batch
    through Module over dist_async; writes its losses, times, wire bytes
    and launches per step to ``outdir``."""
    import torch

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    rank = int(os.environ["DMLC_WORKER_ID"])
    f32 = case == "f32"
    marks = [("start", time.perf_counter())]
    if f32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = PS_F32 if f32 else FULL
    X, Y = ps_batch()
    rows = slice(rank * PS_BATCH, (rank + 1) * PS_BATCH)
    with mt.NameManager():
        net = get_transformer_lm(**cfg)
    shape = (PS_BATCH, cfg["seq_len"])
    mod = mt.mod.Module(net, label_names=("softmax_label",),
                        context=mt.gpu(0),
                        compute_dtype=None if f32 else "bfloat16")
    mod.bind(data_shapes=[mt.io.DataDesc("data", shape)],
             label_shapes=[mt.io.DataDesc("softmax_label", shape)],
             for_training=True)
    if f32:
        mod.init_params(arg_params=ps_f32_init(mt, net), aux_params={})
        name, params = "sgd", dict(PS_F32_SGD)
        steps = PS_F32_STEPS
    else:
        mt.random.seed(SEED)
        mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                                   magnitude=2.34))
        name, params = "adam", {"learning_rate": PS_ASYNC_LR
                                if case == "async" else TRAIN_LR}
        steps = sum(r[2] + r[3] for r in PS_RUNS if r[1] == case)
    ex = mod._exec_group.execs[0]
    init_crc = ps_init_crc({n: ex.arg_dict[n]._data
                            for n in mod._exec_group.param_names})
    marks.append(("bind and init", time.perf_counter()))
    # the server sums the workers' gradients: scale by the global batch
    params["rescale_grad"] = 1.0 / (PS_WORKERS * PS_BATCH)
    mod.init_optimizer(kvstore="dist_async", optimizer=name,
                       optimizer_params=params)
    kv = mod._kvstore
    store = kv.inner
    kv.wait_all()
    marks.append(("store init, pulls, optimizer", time.perf_counter()))
    batch = mt.io.NDArrayIter(X[rows], Y[rows], batch_size=PS_BATCH,
                              label_name="softmax_label").next()
    rec = {k: [] for k in ("loss", "compute_ms", "push_ms", "pull_ms",
                           "push_bytes", "pull_bytes", "launches")}
    mt.kernels.reset_launches()
    for step in range(steps):
        before, wire = dict(mt.kernels.LAUNCHES), dict(store.wire)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec["loss"].append(lm_loss(torch, mod.get_outputs()[0], Y[rows]))
        t2 = time.perf_counter()
        mod.update()  # pushes, the sync-round barrier, pulls issued
        t3 = time.perf_counter()
        kv.wait_all()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        rec["compute_ms"].append((t1 - t0) * 1e3)
        rec["push_ms"].append((t3 - t2) * 1e3)
        rec["pull_ms"].append((t4 - t3) * 1e3)
        rec["push_bytes"].append(store.wire["push_bytes"] -
                                 wire["push_bytes"])
        rec["pull_bytes"].append(store.wire["pull_bytes"] -
                                 wire["pull_bytes"])
        rec["launches"].append({n: mt.kernels.LAUNCHES[n] - before[n]
                                for n in PS_NAMES})
        print("param_server %s worker %d: step %d loss %.6f compute %.1f ms "
              "push %.1f ms pull %.1f ms" % (
                  case, rank, step, rec["loss"][-1], rec["compute_ms"][-1],
                  rec["push_ms"][-1], rec["pull_ms"][-1]), flush=True)
    marks.append(("steps", time.perf_counter()))
    params = {n: ex.arg_dict[n]._data for n in mod._exec_group.param_names}
    rec.update(
        rank=rank, init_crc=init_crc,
        rescale_grad=mod._optimizer.rescale_grad,
        peak_bytes=torch.cuda.max_memory_allocated(), wire=store.wire,
        comm={k: v for k, v in kv.comm_stats().items()
              if k.startswith("bucket")},
        finite=all(bool(torch.isfinite(t).all()) for t in params.values()),
        final_crc=ps_init_crc(params))
    if f32 and rank == 0:
        np.savez(os.path.join(outdir, "params.npz"),
                 **{k: t.cpu().numpy() for k, t in params.items()})
    kv._barrier()  # both done before the driver reads the servers
    kv.close()
    marks.append(("teardown", time.perf_counter()))
    rec["stages_s"] = {name: t - marks[i][1]
                       for i, (name, t) in enumerate(marks[1:])}
    print("param_server %s worker %d: seconds by stage %s" % (
        case, rank, {k: round(v, 2) for k, v in rec["stages_s"].items()}),
        flush=True)
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(rec, f)


def ps_churn_worker(outdir):
    """(e1): tests/elastic_churn_worker.py's loop on the card.  Rank 2
    waits after step 3 for SIGTERM (its preemption handler leaves and
    exits 0); the survivors wait at step 6 for the joiner."""
    import mxnet_tpu_torch as mt

    rank = int(os.environ["DMLC_WORKER_ID"])
    joiner = os.environ.get("MXNET_KVSTORE_ELASTIC_JOIN") == "1"
    n, gate = PS_CHURN["steps"], PS_CHURN["gate"]
    kv = mt.kv.create("dist_async")
    mt.kvstore.install_preemption_handler(kv)
    deadline = time.monotonic() + PS_FILE_WAIT
    while not joiner and len(kv.membership()["ranks"]) < PS_CHURN["workers"]:
        # the job forms first: a barrier counts the ranks that joined, so
        # a lone early rank would run ahead
        check(time.monotonic() < deadline, "churn: the workers never all "
              "joined")
        time.sleep(0.05)
    kv.init("w", mt.nd.zeros((4,), mt.gpu(0)))
    if joiner:
        touch(os.path.join(outdir, "joined"))
    grad = mt.nd.ones((4,), mt.gpu(0))
    for it in range(gate if joiner else 0, n):
        if not joiner and it == gate:
            touch(os.path.join(outdir, "gate%d" % rank))
            wait_for(os.path.join(outdir, "joined"))
        kv.push("w", grad)
        kv._barrier()
        print("churn worker %d: step %d" % (rank, it), flush=True)
        if rank == 2 and not joiner and it == PS_CHURN["preempt"]:
            touch(os.path.join(outdir, "preempt_ready"))
            time.sleep(PS_FILE_WAIT)
            raise SystemExit("the preemption handler never ran")
    target = float(n * PS_CHURN["workers"])
    out = mt.nd.zeros((4,), mt.gpu(0))
    deadline = time.monotonic() + PS_FILE_WAIT
    while True:
        kv.pull("w", out)
        final = out.asnumpy()
        if final[0] >= target or joiner or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    with open(os.path.join(outdir, "churn%s.json" % ("j" if joiner
                                                     else rank)), "w") as f:
        json.dump({"rank": rank, "joiner": joiner,
                   "final": final.tolist()}, f)
    kv.close()


def ps_durable_data(rank):
    rng = np.random.RandomState(SEED + 10 + rank)
    d = PS_DURABLE
    return (rng.randn(d["batch"], d["features"]).astype(np.float32),
            rng.randint(0, d["classes"], d["batch"]).astype(np.float32))


def ps_durable_worker(outdir):
    """(e2): a float32 MLP through Module over a sync server; after step
    ``snapshot_at`` rank 0 snapshots the server, both wait at a barrier,
    then for the driver's ``go`` (the driver may kill and restart the
    server in between)."""
    import mxnet_tpu_torch as mt

    rank = int(os.environ["DMLC_WORKER_ID"])
    d = PS_DURABLE
    with mt.NameManager():
        net = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(net, num_hidden=d["hidden"], name="fc1")
        net = mt.sym.Activation(net, act_type="tanh")
        net = mt.sym.FullyConnected(net, num_hidden=d["classes"], name="fc2")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(SEED)
    init = {"fc1_weight": rng.randn(d["hidden"], d["features"]) * 0.3,
            "fc1_bias": np.zeros(d["hidden"]),
            "fc2_weight": rng.randn(d["classes"], d["hidden"]) * 0.3,
            "fc2_bias": np.zeros(d["classes"])}
    X, Y = ps_durable_data(rank)
    mod = mt.mod.Module(net, label_names=("softmax_label",),
                        context=mt.gpu(0))
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("softmax_label", Y.shape)])
    mod.init_params(arg_params={k: mt.nd.array(v.astype(np.float32),
                                               mt.cpu())
                                for k, v in init.items()}, aux_params={})
    mod.init_optimizer(kvstore="dist_async", optimizer="sgd",
                       optimizer_params=dict(PS_DURABLE_SGD,
                                             rescale_grad=1.0 / 32))
    kv = mod._kvstore
    batch = mt.io.DataBatch([mt.nd.array(X, mt.gpu(0))],
                            [mt.nd.array(Y, mt.gpu(0))])
    losses = []
    for step in range(d["steps"]):
        mod.forward_backward(batch)
        probs = mod.get_outputs()[0].asnumpy()
        losses.append(float(-np.log(probs[np.arange(len(Y)),
                                          Y.astype(int)]).mean()))
        mod.update()
        kv.wait_all()
        if step + 1 == d["snapshot_at"]:
            if rank == 0:
                kv.inner._clients[0].snapshot()
            kv._barrier()
            touch(os.path.join(outdir, "quiesced%d" % rank))
            wait_for(os.path.join(outdir, "go"))
    args, _ = mod.get_params()
    np.savez(os.path.join(outdir, "durable%d.npz" % rank),
             losses=np.array(losses),
             **{k: v.asnumpy() for k, v in args.items()})
    kv._barrier()
    kv.close()


def ps_worker(outdir):
    """A worker process of phase 19 (run by ``--ps-worker``): PS_CASE
    names the sub-phase, the DMLC variables its rank and servers."""
    case = os.environ["PS_CASE"]
    if case == "churn":
        ps_churn_worker(outdir)
    elif case == "durable":
        ps_durable_worker(outdir)
    else:
        ps_lm_worker(outdir, case)


#: ports free_ports has handed out in this process (under its lock): jobs
#: started side by side must not get the same ones before their servers
#: bind them
PS_PORTS, PS_PORTS_LOCK = set(), threading.Lock()
#: the PSJobs not yet closed: main closes them when the script fails
PS_JOBS = set()


def free_ports(n):
    """A port p with p..p+n-1 free on 127.0.0.1, none handed out before."""
    import socket

    with PS_PORTS_LOCK:
        for _ in range(100):
            base = free_port()
            if PS_PORTS & set(range(base, base + n)):
                continue
            socks = []
            try:
                for i in range(n):
                    s = socket.socket()
                    socks.append(s)
                    s.bind(("127.0.0.1", base + i))
            except OSError:
                continue
            finally:
                for s in socks:
                    s.close()
            PS_PORTS.update(range(base, base + n))
            return base
    raise SystemExit("param_server: no %d free consecutive ports" % n)


class PSJob:
    """Server and worker processes of one sub-phase, their logs in
    ``outdir``; every process is reaped on exit."""

    def __init__(self, tag, servers, workers, sync, **env):
        self.tag = tag
        self.outdir = tempfile.mkdtemp(prefix="ps_%s_" % tag)
        self.port = free_ports(servers)
        self.env = dict(os.environ, DMLC_PS_ROOT_URI="127.0.0.1",
                        DMLC_PS_ROOT_PORT=str(self.port),
                        DMLC_NUM_SERVER=str(servers),
                        DMLC_NUM_WORKER=str(workers),
                        MXNET_KVSTORE_SYNC="1" if sync else "0",
                        MXNET_KVSTORE_RETRY_MAX="200",
                        MXNET_KVSTORE_RETRY_MAX_MS="100", **env)
        self.procs, self.servers = [], {}
        PS_JOBS.add(self)
        for i in range(servers):
            self.server(i)

    def spawn(self, name, argv, **env):
        import sys

        log = open(os.path.join(self.outdir, name + ".log"), "w")
        p = subprocess.Popen([sys.executable] + argv,
                             env=dict(self.env, **env), stdout=log,
                             stderr=subprocess.STDOUT,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        log.close()
        p.name = name
        self.procs.append(p)
        return p

    def server(self, i):
        self.servers[i] = self.spawn("server%d" % i,
                                     ["-c", "import mxnet_tpu_torch"],
                                     DMLC_ROLE="server",
                                     DMLC_SERVER_ID=str(i))
        return self.servers[i]

    def worker(self, rank, name=None, **env):
        return self.spawn(name or "worker%d" % rank,
                          [os.path.abspath(__file__), "--ps-worker",
                           self.outdir], DMLC_ROLE="worker",
                          DMLC_WORKER_ID=str(rank), **env)

    def tail(self, p, n=8):
        with open(os.path.join(self.outdir, p.name + ".log")) as f:
            return "\n".join(f.read().strip().splitlines()[-n:])

    def wait(self, procs, expect=0):
        deadline = time.monotonic() + PS_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            if p.returncode != expect:
                print("param_server %s: %s exit %s; log tail:\n%s" % (
                    self.tag, p.name, p.returncode, self.tail(p)),
                    flush=True)
            check(p.returncode == expect, "param_server %s: %s exited %s, "
                  "expected %s" % (self.tag, p.name, p.returncode, expect))

    def stats_and_stop(self):
        """Each server's counters; then stop them (exit 0, snapshot
        written where configured)."""
        from mxnet_tpu_torch import kvstore_server as kvs

        out = []
        for i in sorted(self.servers):
            with kvs.ServerClient("127.0.0.1", self.port + i) as c:
                out.append(c.stats())
                c.stop_server()
        self.wait(list(self.servers.values()))
        return out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        PS_JOBS.discard(self)


def ps_lm_run(tag, case, sync, **env):
    """One LM sub-phase: PS_SERVERS servers and PS_WORKERS workers."""
    t0 = time.perf_counter()
    job = PSJob(tag, PS_SERVERS, PS_WORKERS, sync, PS_CASE=case, **env)
    try:
        job.wait([job.worker(r) for r in range(PS_WORKERS)])
        stats = job.stats_and_stop()
    finally:
        job.close()
    print("param_server (%s): %.1f s from the first process started to the "
          "last stopped" % (tag, time.perf_counter() - t0), flush=True)
    got = []
    for r in range(PS_WORKERS):
        with open(os.path.join(job.outdir, "rank%d.json" % r)) as f:
            got.append(json.load(f))
    return got, stats, job.outdir


def ps_summary(got, stats, warm):
    """Per-step means over the timed steps and the workers."""
    def mean(key):
        return float(np.mean([g[key][warm:] for g in got]))

    push_b, pull_b = mean("push_bytes"), mean("pull_bytes")
    push_ms, pull_ms = mean("push_ms"), mean("pull_ms")
    steps = len(got[0]["loss"])
    return {
        "compute_ms": mean("compute_ms"), "push_ms": push_ms,
        "pull_ms": pull_ms,
        "step_ms": mean("compute_ms") + push_ms + pull_ms,
        "server_update_ms": [s["update_seconds"] * 1e3 / steps
                             for s in stats],
        "push_bytes": push_b, "pull_bytes": pull_b,
        "wire_gbs": (push_b + pull_b) / ((push_ms + pull_ms) / 1e3) / 1e9,
        "worker_peak_gb": [g["peak_bytes"] / 1e9 for g in got],
        "server_peak_gb": [s["device_peak_bytes"] / 1e9 for s in stats],
        "server_ctx": [s["ctx"] for s in stats],
        "buckets": got[0]["comm"],
        "stages_s": got[0]["stages_s"],
        "mean_losses": [float(np.mean([g["loss"][s] for g in got]))
                        for s in range(steps)]}


def ps_print(tag, what, s, card):
    print("param_server (%s) %s: step ms %.1f = compute %.1f + push (to the "
          "round's barrier) %.1f + pull wait %.1f; server update ms per "
          "step %s; bytes per step per worker pushed %.0f, pulled %.0f; "
          "wire %.3f GB/s; peak GB workers %s, servers %s; updater on %s; "
          "buckets %s; rank 0's seconds by stage %s; mean losses %s (%s)"
          % (tag, what, s["step_ms"], s["compute_ms"], s["push_ms"],
             s["pull_ms"], ["%.1f" % x for x in s["server_update_ms"]],
             s["push_bytes"], s["pull_bytes"], s["wire_gbs"],
             ["%.2f" % x for x in s["worker_peak_gb"]],
             ["%.2f" % x for x in s["server_peak_gb"]], s["server_ctx"],
             s["buckets"], {k: round(v, 2) for k, v in s["stages_s"].items()},
             ["%.6f" % x for x in s["mean_losses"]], card),
          flush=True)


def ps_lm_one(tag, case, warm, want_crc, card, note=""):
    """One of (a), (c), (d): the full-width LM over two servers, its
    per-run gates; its summary."""
    per_layer = FULL["num_layers"]
    env = {"MXNET_KVSTORE_COMPRESS": "fp16"} if case == "fp16" else {}
    got, stats, _ = ps_lm_run(tag, case, case != "async", **env)
    s = ps_summary(got, stats, warm)
    ps_print(tag, case + note, s, card)
    for g in got:
        check(g["rescale_grad"] == 1.0 / BATCH, "param_server (%s): "
              "worker %d's rescale_grad %r is not 1/(global batch)"
              % (tag, g["rank"], g["rescale_grad"]))
        check(all(d == {n: per_layer for n in PS_NAMES}
                  for d in g["launches"]), "param_server (%s): worker "
              "%d launched %s, expected %d of each K1-K3 a step"
              % (tag, g["rank"], g["launches"], per_layer))
        check(g["finite"], "param_server (%s): worker %d has a "
              "parameter that is not finite" % (tag, g["rank"]))
    check(got[0]["init_crc"] == want_crc, "param_server (%s): rank "
          "0's init is not the train phase's" % tag)
    check(len({g["final_crc"] for g in got}) == 1 or case == "async",
          "param_server (%s): the workers end on different parameters"
          % tag)
    s["launches"] = {n: sum(d[n] for g in got for d in g["launches"])
                     for n in PS_NAMES}
    s["applied_pushes"] = sum(st["applied_pushes"] for st in stats)
    s["push_items"] = sum(g["wire"]["push_items"] for g in got)
    s["losses"] = [g["loss"] for g in got]
    return s


def ps_lm_gates(runs, train_losses):
    """The gates across (a), (c), (d) (``runs``, by tag)."""
    a, c, d = runs["a"], runs["c"], runs["d"]
    gaps = [rel(a["mean_losses"][i], train_losses[i])
            for i in range(PS_LOSSES)]
    print("param_server (a): mean of the workers' first %d losses %s vs the "
          "train phase's one-context %s: relative gaps %s (tolerance %g)"
          % (PS_LOSSES, ["%.6f" % x for x in a["mean_losses"][:PS_LOSSES]],
             ["%.6f" % x for x in train_losses[:PS_LOSSES]],
             ["%.2e" % x for x in gaps], PS_LOSS_TOL), flush=True)
    check(max(gaps) <= PS_LOSS_TOL, "param_server (a): the losses leave "
          "the train phase's")
    print("param_server (c): servers applied %d pushes, the workers sent "
          "%d push items (a range-split key once per server, a bucket's "
          "keys once each); losses %s" % (
              c["applied_pushes"], c["push_items"],
              [["%.4f" % x for x in l] for l in c["losses"]]), flush=True)
    check(c["applied_pushes"] == c["push_items"], "param_server (c): "
          "pushes were lost or applied twice")
    check(all(l[-1] < l[0] for l in c["losses"]), "param_server (c): the "
          "async loss did not fall")
    ratio = d["push_bytes"] / a["push_bytes"]
    gaps = [rel(d["mean_losses"][i], a["mean_losses"][i])
            for i in range(PS_LOSSES)]
    print("param_server (d): fp16 wire pushes %.4fx (a)'s bytes (limit "
          "%g); first %d losses' relative gaps to (a) %s (tolerance %g)"
          % (ratio, PS_FP16_BYTES, PS_LOSSES, ["%.2e" % x for x in gaps],
             PS_LOSS_TOL),
          flush=True)
    check(ratio <= PS_FP16_BYTES, "param_server (d): fp16 did not halve "
          "the pushed bytes")
    check(max(gaps) <= PS_LOSS_TOL, "param_server (d): the fp16 losses "
          "leave (a)'s")
    return runs


def ps_f32(torch, mt, card):
    """(b): 2 sync workers against one process on the concatenated batch,
    float32, TF32 off, SGD with momentum."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with mt.NameManager():
        net = get_transformer_lm(**PS_F32)
    init = ps_f32_init(mt, net)
    X, Y = ps_batch()
    shape = (BATCH, PS_F32["seq_len"])
    mod = mt.mod.Module(net, label_names=("softmax_label",),
                        context=mt.gpu(0))
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", shape)])
    mod.init_params(arg_params=init, aux_params={})
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(PS_F32_SGD))
    batch = mt.io.NDArrayIter(X, Y, batch_size=BATCH,
                              label_name="softmax_label").next()
    for _ in range(PS_F32_STEPS):
        mod.forward_backward(batch)
        mod.update()
    args, _ = mod.get_params()
    ref = {k: v.asnumpy() for k, v in args.items()}
    del mod, args
    torch.cuda.empty_cache()
    got, stats, outdir = ps_lm_run("b", "f32", True)
    with np.load(os.path.join(outdir, "params.npz")) as f:
        worker = {k: f[k] for k in f.files}
    gap = max(float(np.abs(worker[k] - v).max()) /
              max(float(np.abs(v).max()), 1e-30) for k, v in ref.items())
    moves = sorted(float(np.abs(v - init[k].asnumpy()).max()) /
                   max(float(np.abs(v).max()), 1e-30)
                   for k, v in ref.items())
    move = moves[0]
    print("param_server (b): 2 layers float32, 2 sync workers vs one "
          "process at batch %d: after %d SGD steps every parameter within "
          "%.3g of its largest |value| (tolerance %g); each parameter's "
          "%d-step move relative to its largest |value|: smallest %.3g, "
          "median %.3g; workers agree %s (%s)"
          % (BATCH, PS_F32_STEPS, gap, PS_F32_TOL, PS_F32_STEPS, move,
             moves[len(moves) // 2],
             got[0]["final_crc"] == got[1]["final_crc"], card), flush=True)
    check(gap <= PS_F32_TOL, "param_server (b): the workers disagree with "
          "one process at the combined batch")
    check(got[0]["final_crc"] == got[1]["final_crc"], "param_server (b): "
          "the workers end on different parameters")
    for g in got:
        check(all(d == {n: PS_F32["num_layers"] for n in PS_NAMES}
                  for d in g["launches"]), "param_server (b): worker %d "
              "launched %s" % (g["rank"], g["launches"]))
    return {"param_gap": gap, "move": move,
            "launches": {n: sum(d[n] for g in got for d in g["launches"])
                         for n in PS_NAMES}}


def ps_churn_start():
    """(e1) up to the joiner: one sync server, three elastic workers."""
    job = PSJob("e1", 1, PS_CHURN["workers"], True, PS_CASE="churn",
                MXNET_KVSTORE_ELASTIC="1")
    job.first = [job.worker(r) for r in range(PS_CHURN["workers"])]
    return job


def ps_churn_finish(job):
    import signal

    wait_for(os.path.join(job.outdir, "preempt_ready"))
    victim = job.first[2]
    victim.send_signal(signal.SIGTERM)
    job.wait([victim])  # exit 0 through the preemption handler
    for r in (0, 1):
        wait_for(os.path.join(job.outdir, "gate%d" % r))
    joiner = job.worker(2, name="joiner", MXNET_KVSTORE_ELASTIC_JOIN="1")
    job.wait(job.first[:2] + [joiner])
    stats = job.stats_and_stop()[0]
    finals = {}
    for name in ("0", "1", "j"):
        with open(os.path.join(job.outdir, "churn%s.json" % name)) as f:
            finals[name] = json.load(f)["final"]
    target = float(PS_CHURN["steps"] * PS_CHURN["workers"])
    rounds = {int(k): v for k, v in stats["round_sizes"].items()}
    print("param_server (e1): SIGTERM after step %d: rank 2 exited 0 "
          "through its preemption handler; a joiner entered at step %d; "
          "final weights %s (the churn invariant %g); round sizes %s"
          % (PS_CHURN["preempt"], PS_CHURN["gate"], finals, target,
             rounds), flush=True)
    check(all(v == [target] * 4 for v in finals.values()),
          "param_server (e1): the final weight breaks the churn invariant")
    check(3 in rounds and 2 in rounds, "param_server (e1): the rounds did "
          "not shrink and grow")
    return {"finals": finals, "round_sizes": rounds}


def ps_durable_start(kill):
    job = PSJob("e2" + ("kill" if kill else "ref"), 1, 2, True,
                PS_CASE="durable",
                MXNET_KVSTORE_SNAPSHOT_PATH=os.path.join(
                    tempfile.mkdtemp(prefix="ps_snap_"), "kv.snap"),
                MXNET_KVSTORE_SNAPSHOT_INTERVAL="0")
    job.first = [job.worker(r) for r in range(2)]
    job.kill = kill
    return job


def ps_durable_release(job):
    """Once both workers quiesced: SIGKILL the server, let the workers go
    on (their pushes retry), restart the server from its snapshot."""
    import signal

    for r in (0, 1):
        wait_for(os.path.join(job.outdir, "quiesced%d" % r))
    if job.kill:
        srv = job.servers[0]
        srv.send_signal(signal.SIGKILL)
        srv.wait(timeout=60)
        job.procs.remove(srv)
        touch(os.path.join(job.outdir, "go"))
        time.sleep(0.5)  # the workers' next pushes meet no server
        job.server(0)
    else:
        touch(os.path.join(job.outdir, "go"))


def ps_durable_finish(job):
    job.wait(job.first)
    stats = job.stats_and_stop()[0]
    got = []
    for r in (0, 1):
        with np.load(os.path.join(job.outdir, "durable%d.npz" % r)) as f:
            got.append({k: f[k] for k in f.files})
    return got, stats


def ps_nonfinite(mt, card):
    """(e3): a NaN push raises NonFiniteGradientError and leaves the store
    (and the updater's momentum) as it was, bit for bit; the in-process
    server's updater on the card."""
    from mxnet_tpu_torch.kvstore_server import NonFiniteGradientError

    with mt.gpu(0):
        kv = mt.kv.create("dist_async")
    try:
        rng = np.random.RandomState(SEED)
        kv.init("w", mt.nd.array(rng.randn(1024).astype(np.float32),
                                 mt.gpu(0)))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.push("w", mt.nd.array(rng.randn(1024).astype(np.float32),
                                 mt.gpu(0)))
        srv = kv._server
        before = srv.store["w"].tobytes()
        mom = srv.updater.states["w"]
        mom_before = mom.asnumpy().tobytes()
        bad = rng.randn(1024).astype(np.float32)
        bad[7] = np.nan
        raised = False
        try:
            kv.push("w", mt.nd.array(bad, mt.gpu(0)))
        except NonFiniteGradientError:
            raised = True
        same = srv.store["w"].tobytes() == before and \
            srv.updater.states["w"].asnumpy().tobytes() == mom_before
        print("param_server (e3): a NaN push raised NonFiniteGradientError "
              "%s; store and momentum unchanged bit for bit %s; rejected %d; "
              "updater on %s (%s)" % (raised, same, srv.rejected_pushes,
                                      srv.ctx, card), flush=True)
        check(raised and same and mom.context == mt.gpu(0),
              "param_server (e3): the NaN push was not contained")
        return {"raised": raised, "unchanged": same}
    finally:
        kv.close()


def param_server_phase(torch, mt, replay, train_losses, before_side=None):
    """Phase 19 (module docstring).  ``before_side`` is called after (a)
    and (d), before the processes of (b), (c), (e1) and (e2) start.
    Returns the launches of K1-K3 by path, as ``parallel_phase`` does."""
    card = card_and_limit()
    t0 = time.perf_counter()
    print("param_server: servers and workers are processes sharing one "
          "card (%s): the times measure the parameter server's own cost, "
          "not a multi-host speed-up" % card, flush=True)
    torch.cuda.empty_cache()
    want_crc = ps_init_crc(replay["init"])
    runs = {tag: ps_lm_one(tag, case, warm, want_crc, card)
            for tag, case, warm, _ in PS_RUNS if case != "async"}
    torch.cuda.empty_cache()
    if before_side is not None:
        before_side()
    # (b), (c), (e1) and (e2) gate on results, not times: their processes
    # run side by side, (c), (e1) and (e2) driven from threads
    churn = ps_churn_start()
    durable = [ps_durable_start(kill) for kill in (False, True)]
    side = {}

    def drive_e():
        for job in durable:
            ps_durable_release(job)
        side["elastic"] = ps_churn_finish(churn)
        side["durable"] = [ps_durable_finish(j) for j in durable]

    def drive_c():
        tag, case, warm, _ = next(r for r in PS_RUNS if r[1] == "async")
        side[tag] = ps_lm_one(tag, case, warm, want_crc, card,
                              " (beside (b), (e1) and (e2))")

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # check() raises SystemExit
                side.setdefault("error", exc)
        return run

    threads = [threading.Thread(target=guarded(fn), daemon=True)
               for fn in (drive_e, drive_c)]
    for t in threads:
        t.start()
    try:
        f32 = ps_f32(torch, mt, card)
        for t in threads:
            t.join()
    finally:
        for job in [churn] + durable:
            job.close()
    if "error" in side:
        raise side["error"]
    runs["c"] = side["c"]
    ps_lm_gates(runs, train_losses)
    elastic = side["elastic"]
    (ref, _), (got, stats) = side["durable"]
    equal = all(ref[r][k].tobytes() == got[r][k].tobytes()
                for r in (0, 1) for k in ref[r])
    print("param_server (e2): the server SIGKILLed after step %d and "
          "restarted from its snapshot (restored %s): both workers' "
          "parameters and losses bitwise equal to the uninterrupted run's "
          "%s; losses %s" % (PS_DURABLE["snapshot_at"], stats["restored"],
                             equal, ["%.6f" % x for x in got[0]["losses"]]),
          flush=True)
    check(stats["restored"] and equal, "param_server (e2): the restarted "
          "run left the uninterrupted one")
    nonfinite = ps_nonfinite(mt, card)
    wall = time.perf_counter() - t0
    print("param_server: phase wall time %.1f s on %s" % (wall, card),
          flush=True)
    print(json.dumps({"param_server": {
        "card": card, "wall_s": wall,
        "runs": {k: {x: y for x, y in v.items() if x != "losses"}
                 for k, v in runs.items()},
        "f32": f32, "elastic": elastic,
        "durable": {"restored": stats["restored"], "bitwise": equal},
        "nonfinite": nonfinite,
        "note": "servers and workers share one card: the times are the "
                "parameter server's own cost, not a multi-host speed-up"}}),
        flush=True)

    def total(tags):
        return {n: sum(runs[t]["launches"][n] for t in tags)
                for n in PS_NAMES}
    return {"bf16": {"parameter server": total(("a", "c", "d"))},
            "f32": {"parameter server": f32["launches"]}}


# -- phase 20: the serving tier ---------------------------------------------

#: (a): the full-width LM scored through InferenceServer at buckets (1, 2)
SRV_LM_SHAPES = {"data": (2, FULL["seq_len"]),
                 "softmax_label": (2, FULL["seq_len"])}
SRV_LM_REQUESTS = 6
#: (c): a smaller engine of the full-width LM: 4 lanes of 1152 tokens
SRV_GEN = dict(GEN_MODEL, lane_buckets=(1, 2, 4), page_size=16,
               num_pages=4 * 72 + 1, prefill_len_buckets=(128, 512, 1024),
               prefill_batch_buckets=(1, 2))
SRV_GEN_PROMPTS = (100, 300, 700, 1000)   # one at a time over HTTP
SRV_GEN_CONCURRENT = 8
SRV_GEN_NEW = 32
SRV_RESUME = (200, 128, 32)   # (d3): prompt, new tokens, stop after
#: (b): BASELINE.md's inference configuration (benchmark_score.py)
SRV_RESNET_SHAPES = {"data": (32,) + RESNET["image_shape"]}
SRV_RESNET_REQUESTS = 256
SRV_RESNET_IMAGES = 32        # distinct images, cycled over the requests
SRV_CLIENTS = 32
#: the random ResNet's init: Xavier("in", 6) keeps each conv + relu's
#: variance (He's), and the residual branch's last BatchNorm at 0.25 keeps
#: 16 residual additions from saturating the softmax (at Xavier("in",
#: 2.34) the activations fade and the softmax is uniform, at unit gamma it
#: is one-hot; these give a top probability near 0.15 on U(-1, 1) images)
SRV_RESNET_INIT = (6.0, 0.25)
SRV_P100_IMG_S = 713.17       # BASELINE.md, a yardstick only
SRV_CROWD = (64, 5.0)         # (e): clients, seconds
SRV_MEM_SLACK = 64 << 20
SRV_TOL = 1e-4
#: the JAX package's serving series (mxnet_tpu/serving/metrics.py)
SRV_SERIES = {"mxtpu_serving_" + k for k in (
    "requests_total", "requests_completed", "requests_rejected",
    "requests_expired", "requests_failed", "worker_crashes",
    "batches_total", "padded_items_total", "queue_depth",
    "queue_depth_peak", "batch_size", "batch_occupancy", "latency_ms",
    "qps")}


def srv_lm_checkpoint(torch, mt, net, prefix, seed=SEED):
    """The LM's weights, N(0, 0.02) from ``seed`` drawn on the card (unit
    LayerNorm gains, zero biases and shifts), saved by save_checkpoint."""
    arg_shapes, _, _ = net.infer_shape(**SRV_LM_SHAPES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in SRV_LM_SHAPES:
            continue
        if name.endswith("_gamma"):
            t = torch.ones(shape, device="cuda")
        elif name.endswith(("_beta", "_bias")):
            t = torch.zeros(shape, device="cuda")
        else:
            t = torch.randn(shape, generator=gen, device="cuda") * 0.02
        params[name] = mt.nd.NDArray(t, mt.gpu(0))
    mt.model.save_checkpoint(prefix, 0, net, params, {})
    return sum(int(np.prod(p.shape)) for p in params.values())


def srv_resnet_checkpoint(mt, net, prefix, epoch, seed, **kw):
    """ResNet-50 initialized from ``seed`` on the CPU as SRV_RESNET_INIT
    says, saved by save_checkpoint."""
    mt.random.seed(seed)
    mod = mt.mod.Module(net, context=mt.cpu())
    shape = (1,) + RESNET["image_shape"]
    mod.bind(data_shapes=[mt.io.DataDesc("data", shape)],
             label_shapes=[mt.io.DataDesc("softmax_label", (1,))],
             for_training=False)
    magnitude, gamma = SRV_RESNET_INIT
    mod.init_params(initializer=mt.init.Xavier(factor_type="in",
                                               magnitude=magnitude))
    args, aux = mod.get_params()
    for k in args:
        if k.endswith("_c_bn_gamma"):
            args[k] = mt.nd.array(np.full(args[k].shape, gamma, np.float32),
                                  mt.cpu())
    mt.model.save_checkpoint(prefix, epoch, net, args, aux, **kw)


def srv_rel(torch, got, ref):
    """max |got - ref| over the largest |ref|, on the card."""
    g = torch.as_tensor(np.asarray(got), device="cuda")
    r = torch.as_tensor(np.asarray(ref), device="cuda")
    return float((g - r).abs().max() / r.abs().max())


def srv_post(url, payload, timeout=600):
    """(status, body bytes) of one JSON POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        body = exc.read()
        exc.close()
        return exc.code, body


def srv_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        exc.close()
        return exc.code, body


def srv_stream(url, payload):
    """One NDJSON /generate stream: (tokens, final record, the client's
    ttft ms, its inter-token gaps in ms, key sets seen)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, final, gaps, keys = [], None, [], set()
    t0 = time.perf_counter()
    t_prev, ttft = None, None
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.headers["Content-Type"] == "application/x-ndjson",
              "(c) /generate answered %s" % resp.headers["Content-Type"])
        for line in resp:
            obj = json.loads(line)
            keys.add(tuple(sorted(obj)))
            now = time.perf_counter()
            if "token" in obj:
                if t_prev is None:
                    ttft = (now - t0) * 1e3
                else:
                    gaps.append((now - t_prev) * 1e3)
                t_prev = now
                toks.append(obj["token"])
            else:
                final = obj
                break
    return toks, final, ttft, gaps, keys


def srv_load(fn, n, clients):
    """Run ``fn(i)`` for i < n from ``clients`` threads; (results by i,
    errors, per-call latency ms, wall s)."""
    import threading

    out, errors, lat = {}, [], {}
    lock = threading.Lock()
    nxt = iter(range(n))

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                res = fn(i)
            except Exception as exc:  # counted, then fatal at the caller
                with lock:
                    errors.append(repr(exc))
                continue
            with lock:
                out[i] = res
                lat[i] = (time.perf_counter() - t0) * 1e3
    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return out, errors, [lat[i] for i in sorted(lat)], \
        time.perf_counter() - t0


class SrvLoop:
    """``fn(i)`` called in a loop from ``clients`` threads until stopped;
    records (i, submit time, result) and every error."""

    def __init__(self, fn, clients):
        import threading

        self.fn, self.done, self.errors = fn, [], []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(k,
                                                                  clients))
                         for k in range(clients)]
        for t in self._threads:
            t.start()

    def _run(self, k, step):
        i = k
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                res = self.fn(i)
            except Exception as exc:  # counted, then fatal at the caller
                with self._lock:
                    self.errors.append(repr(exc))
            else:
                with self._lock:
                    self.done.append((i, t0, res))
            i += step

    def wait_for(self, n, timeout=120):
        t_end = time.monotonic() + timeout
        while len(self.done) < n and not self.errors:
            check(time.monotonic() < t_end, "serving: the load stalled at "
                  "%d answers" % len(self.done))
            time.sleep(0.005)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(600)
        return self.done, self.errors


def srv_batch_index(srv):
    """Record, for each request's future, its row within the batch the
    batcher ran it in (the LM's flattened output gives every item the whole
    batch's rows); returns the dict it fills."""
    index = {}
    batcher = srv._batcher
    run = batcher._execute

    def execute(replica, batch):
        live = [it for it in batch if not it.future.done()]
        for i, it in enumerate(live):
            index[id(it.future)] = (i, time.monotonic() - it.t_enqueue)
        return run(replica, batch)
    batcher._execute = execute
    return index


def srv_lm_scoring(torch, mt, srv, prefix, card):
    """(a): 6 requests from 6 threads against a direct batch-1 Predictor;
    returns the K1 launches of the scoring window and the readings."""
    s = FULL["seq_len"]
    rng = np.random.default_rng(SEED + 20)
    reqs = [rng.integers(0, FULL["vocab_size"], (s,)).astype(np.float32)
            for _ in range(SRV_LM_REQUESTS)]
    label = np.zeros((s,), np.float32)
    index = srv_batch_index(srv)
    rep = srv._replicas[0]
    calls0 = rep.executor_calls
    torch.cuda.reset_peak_memory_stats()
    mt.kernels.reset_launches()
    futs = {}

    def one(i):
        fut = srv.submit(data=reqs[i], softmax_label=label)
        futs[i] = fut
        return fut.result(600)[0]
    outs, errors, lat, wall = srv_load(one, SRV_LM_REQUESTS,
                                       SRV_LM_REQUESTS)
    torch.cuda.synchronize()
    launches = dict(mt.kernels.LAUNCHES)
    calls = rep.executor_calls - calls0
    peak = torch.cuda.max_memory_allocated()
    check(not errors, "(a) failed requests %s" % errors[:3])
    check(launches["flash_fwd"] == FULL["num_layers"] * calls,
          "(a) flash_fwd launched %d times in %d executor calls, expected %d"
          % (launches["flash_fwd"], calls, FULL["num_layers"] * calls))
    check(srv.cold_bucket_runs() == 0, "(a) %d cold bucket runs"
          % srv.cold_bucket_runs())
    direct = mt.Predictor.from_checkpoint(
        prefix, 0, {"data": (1, s), "softmax_label": (1, s)})
    worst, row_err = 0.0, 0.0
    for i in range(SRV_LM_REQUESTS):
        row, _ = index[id(futs[i])]
        got = torch.as_tensor(outs[i][row * s:(row + 1) * s], device="cuda")
        ref = direct.forward(data=reqs[i][None],
                             softmax_label=label[None])[0]._data
        err = float((got - ref).abs().max() / ref.abs().max())
        worst = max(worst, err)
        row_err = max(row_err, float((got.sum(-1) - 1).abs().max()))
        check(err <= SRV_TOL, "(a) request %d: %.3g of the largest |value| "
              "off a direct batch-1 Predictor" % (i, err))
    check(row_err <= SRV_TOL, "(a) rows sum to 1 only within %.3g" % row_err)
    del direct, got, ref
    outs.clear()
    # the executor alone per bucket, and one bucket-2 output's host copy
    item = {"data": reqs[0], "softmax_label": label}
    exec_ms, copy_ms = {}, None
    for b in srv.buckets:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, o = rep.forward_padded([item] * b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if b == srv.buckets[-1]:
                t0 = time.perf_counter()
                host = o[0].asnumpy()
                copy_ms = (time.perf_counter() - t0) * 1e3
                copy_gb = host.nbytes / 1e9
                del host
            del o
        exec_ms[b] = float(np.median(times))
    snap = srv.metrics.snapshot()
    waits = [w * 1e3 for _, w in index.values()]
    res = {"latency_ms_p50": pct(lat, 50), "latency_ms_p99": pct(lat, 99),
           "server_latency_ms_p50": snap["latency_ms_p50"],
           "server_latency_ms_p99": snap["latency_ms_p99"],
           "queue_wait_ms_p50": pct(waits, 50),
           "queue_wait_ms_p99": pct(waits, 99),
           "executor_ms": exec_ms,
           "serve_phase_predictor_ms_b4": SERVE_READINGS.get("steady_ms"),
           "host_copy_ms": copy_ms, "host_copy_gb": copy_gb,
           "batch_size_hist": snap["batch_size_hist"],
           "occupancy_hist": snap["occupancy_hist"],
           "executor_calls": calls, "flash_fwd": launches["flash_fwd"],
           "max_rel_err": worst, "row_sum_err": row_err,
           "peak_gb": peak / 1e9, "wall_s": wall}
    print("serving (a) LM scoring (%s): %d requests from %d threads: "
          "latency p50 %.1f / p99 %.1f ms (client), queue wait p50 %.1f / "
          "p99 %.1f ms; executor ms by bucket %s beside the serve phase's "
          "Predictor %.2f ms at batch 4; the bucket-2 output's host copy "
          "%.1f ms for %.2f GB; buckets %s, occupancy %s; %d executor "
          "calls, flash_fwd %d; max error %.3g of the largest |value|, rows "
          "sum to 1 within %.2g; peak device memory %.2f GB"
          % (card, SRV_LM_REQUESTS, SRV_LM_REQUESTS, res["latency_ms_p50"],
             res["latency_ms_p99"], res["queue_wait_ms_p50"],
             res["queue_wait_ms_p99"],
             {b: round(v, 2) for b, v in exec_ms.items()},
             res["serve_phase_predictor_ms_b4"] or float("nan"), copy_ms,
             copy_gb, snap["batch_size_hist"], snap["occupancy_hist"], calls,
             launches["flash_fwd"], worst, row_err, peak / 1e9), flush=True)
    return {k: launches[k] for k in PS_NAMES}, res


def srv_generate(torch, mt, srv, ref_srv, card):
    """(c): /generate over HTTP, one at a time and 8 at once, against
    ``ref_srv``'s engine one request at a time."""
    host, port = srv.serve_http()
    url = "http://%s:%d/generate" % (host, port)
    rng = np.random.default_rng(SEED + 21)
    vocab = GEN_MODEL["vocab_size"]
    one_prompts = [[int(t) for t in rng.integers(0, vocab, n)]
                   for n in SRV_GEN_PROMPTS]
    many_prompts = [[int(t) for t in rng.integers(0, vocab, int(n))]
                    for n in rng.choice(SRV_GEN_PROMPTS, SRV_GEN_CONCURRENT)]
    ref_eng = ref_srv._generator
    ref = {tuple(p): ref_eng.submit(p, SRV_GEN_NEW).result(600)
           for p in one_prompts + many_prompts}
    key_sets = set()
    for p in one_prompts:
        toks, final, _, _, keys = srv_stream(
            url, {"prompt": p, "max_new_tokens": SRV_GEN_NEW})
        key_sets |= keys
        check(final is not None and final.get("done") is True,
              "(c) a stream ended without its final record")
        check(toks == ref[tuple(p)], "(c) the HTTP stream of a %d-token "
              "prompt differs from the engine's one-at-a-time transcript"
              % len(p))
    check(key_sets == {("token",), ("done", "n", "ttft_ms")},
          "(c) stream records %s, not the JAX server's" % sorted(key_sets))
    itl_before = (srv._generator.metrics.itl.count,
                  srv._generator.metrics.itl.sum)
    t0 = time.perf_counter()
    outs, errors, _, _ = srv_load(
        lambda i: srv_stream(url, {"prompt": many_prompts[i],
                                   "max_new_tokens": SRV_GEN_NEW}),
        SRV_GEN_CONCURRENT, SRV_GEN_CONCURRENT)
    wall = time.perf_counter() - t0
    check(not errors and len(outs) == SRV_GEN_CONCURRENT,
          "(c) concurrent streams failed: %s" % errors[:3])
    got = [outs[i][0] for i in range(SRV_GEN_CONCURRENT)]
    check(all(outs[i][1] and outs[i][1]["done"]
              for i in range(SRV_GEN_CONCURRENT)),
          "(c) a concurrent stream did not end")
    logits_at = GenLogits(mt, ref_eng, ref_srv._model_params)
    ties = near_tie_compare(got, [ref[tuple(p)] for p in many_prompts],
                            [(p, SRV_GEN_NEW) for p in many_prompts],
                            logits_at, "serving (c) concurrent")
    del logits_at
    n_itl = srv._generator.metrics.itl.count - itl_before[0]
    eng_itl = (srv._generator.metrics.itl.sum - itl_before[1]) / max(1, n_itl)
    ttft = [outs[i][2] for i in range(SRV_GEN_CONCURRENT)]
    itl = [g for i in range(SRV_GEN_CONCURRENT) for g in outs[i][3]]
    eng_ttft = [outs[i][1]["ttft_ms"] for i in range(SRV_GEN_CONCURRENT)]
    tokens = sum(len(t) for t in got)
    res = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
           "itl_ms_p50": pct(itl, 50), "itl_ms_p99": pct(itl, 99),
           "engine_ttft_ms_p50": pct(eng_ttft, 50),
           "engine_ttft_ms_p99": pct(eng_ttft, 99),
           "engine_itl_ms_mean": eng_itl, "near_ties": ties}
    print("serving (c) /generate (%s): %d streams one at a time equal the "
          "engine's transcripts; %d at once: %d tokens in %.2f s = %.1f "
          "tokens/s, client TTFT p50 %.1f / p99 %.1f ms, ITL p50 %.1f / p99 "
          "%.1f ms; the engine's TTFT p50 %.1f / p99 %.1f ms, ITL mean %.1f "
          "ms; K1 launches none (prefill is dense)"
          % (card, len(one_prompts), SRV_GEN_CONCURRENT, tokens, wall,
             tokens / wall, res["ttft_ms_p50"], res["ttft_ms_p99"],
             res["itl_ms_p50"], res["itl_ms_p99"], res["engine_ttft_ms_p50"],
             res["engine_ttft_ms_p99"], eng_itl), flush=True)
    return res


def srv_resume(torch, mt, servers, card):
    """(d3): one 128-token stream through a router over two LM servers;
    the serving replica stopped after 32 tokens."""
    import threading

    from mxnet_tpu_torch import serving

    plen, new, cut = SRV_RESUME
    rng = np.random.default_rng(SEED + 23)
    prompt = [int(t) for t in rng.integers(0, GEN_MODEL["vocab_size"], plen)]
    ref = servers[1]._generator.submit(prompt, new).result(600)
    router = serving.Router(servers, seed=3)
    try:
        out, victim, killer = [], None, None
        t0 = time.perf_counter()
        for tok in router.generate(prompt, new):
            out.append(tok)
            if len(out) == cut and victim is None:
                victim = next(s for s in servers
                              if s._generator.active_lanes() > 0)
                killer = threading.Thread(target=victim.stop,
                                          kwargs={"drain": False})
                killer.start()
        wall = time.perf_counter() - t0
        killer.join(600)
        resumes = router.metrics.snapshot()["stream_resumes"]
    finally:
        router.close()
    check(len(out) == new, "(d3) the stream ended after %d of %d tokens"
          % (len(out), new))
    survivor = next(s for s in servers if s is not victim)
    logits_at = GenLogits(mt, survivor._generator, survivor._model_params)
    ties = near_tie_compare([out], [ref], [(prompt, new)], logits_at,
                            "serving (d3) resumed")
    check(resumes == 1, "(d3) %d stream resumes counted" % resumes)
    print("serving (d3) stream resume (%s): replica %d of 2 stopped after %d "
          "tokens, the stream completed on the other (%d tokens in %.2f s), "
          "resumes counted %d, near ties %d"
          % (card, servers.index(victim), cut, len(out), wall, resumes,
             ties), flush=True)
    return {"resumes": resumes, "near_ties": ties, "wall_s": wall}


def srv_images(n, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n,) + RESNET["image_shape"]).astype(
        np.float32)


def srv_direct(mt, prefix, epoch, images):
    """A direct batch-1 Predictor's answers, one image at a time."""
    pred = mt.Predictor.from_checkpoint(
        prefix, epoch, {"data": (1,) + RESNET["image_shape"]})
    out = np.stack([pred.forward(data=x[None])[0].asnumpy()[0]
                    for x in images])
    del pred
    return out


def srv_resnet_load(torch, srv, images, direct, what, card):
    """256 single-image requests from 32 threads, each answer held to its
    image's direct answer."""
    h0 = dict(srv.metrics.snapshot()["batch_size_hist"])
    o0 = dict(srv.metrics.snapshot()["occupancy_hist"])
    outs, errors, lat, wall = srv_load(
        lambda i: srv.predict(data=images[i % len(images)])[0],
        SRV_RESNET_REQUESTS, SRV_CLIENTS)
    check(not errors, "(b) %s: failed requests %s" % (what, errors[:3]))
    got = np.stack([outs[i] for i in range(SRV_RESNET_REQUESTS)])
    ref = direct[np.arange(SRV_RESNET_REQUESTS) % len(images)]
    err = float((np.abs(got - ref).max(axis=1) /
                 np.abs(ref).max(axis=1)).max())
    check(err <= SRV_TOL, "(b) %s: an answer %.3g of its largest |value| off "
          "the direct batch-1 Predictor" % (what, err))
    snap = srv.metrics.snapshot()
    hist = {b: c - h0.get(b, 0) for b, c in snap["batch_size_hist"].items()
            if c - h0.get(b, 0)}
    occ = {n: c - o0.get(n, 0) for n, c in snap["occupancy_hist"].items()
           if c - o0.get(n, 0)}
    mean_occ = sum(n * c for n, c in occ.items()) / max(1, sum(occ.values()))
    res = {"img_s": SRV_RESNET_REQUESTS / wall, "latency_ms_p50":
           pct(lat, 50), "latency_ms_p99": pct(lat, 99),
           "mean_occupancy": mean_occ, "batch_size_hist": hist,
           "max_rel_err": err, "wall_s": wall}
    print("serving (b) ResNet-50 %s (%s): %d requests from %d threads: %.1f "
          "img/s (the reference's P100 %.2f img/s at batch 32 is a yardstick "
          "only), latency p50 %.1f / p99 %.1f ms, mean occupancy %.1f, "
          "batches per bucket %s, max error %.3g"
          % (what, card, SRV_RESNET_REQUESTS, SRV_CLIENTS, res["img_s"],
             SRV_P100_IMG_S, res["latency_ms_p50"], res["latency_ms_p99"],
             mean_occ, hist, err), flush=True)
    return res


def srv_series_names(text):
    names = set()
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            names.add(re.split(r"[{ ]", line, 1)[0])
    return names


def srv_resnet_http(torch, mt, srv, images, card):
    """(b)'s HTTP part: 4 POST /predict equal to in-process answers bit
    for bit; /healthz, /readyz, /metrics; /generate 404."""
    host, port = srv.serve_http()
    base = "http://%s:%d" % (host, port)
    for i in range(4):
        local = srv.predict(data=images[i])[0]
        code, body = srv_post(base + "/predict",
                              {"inputs": {"data": images[i].tolist()}})
        check(code == 200, "(b) POST /predict answered %d" % code)
        remote = np.asarray(json.loads(body)["outputs"][0], np.float32)
        check(remote.tobytes() == local.tobytes(), "(b) the HTTP answer for "
              "image %d is not the in-process answer bit for bit" % i)
    health, ready = srv_get(base + "/healthz"), srv_get(base + "/readyz")
    check(health == (200, "ok") and ready == (200, "ready"),
          "(b) /healthz %s, /readyz %s" % (health, ready))
    code, text = srv_get(base + "/metrics")
    names = srv_series_names(text)
    check(code == 200 and names == SRV_SERIES, "(b) /metrics series %s, "
          "expected the JAX package's %s" % (sorted(names),
                                             sorted(SRV_SERIES)))
    code, _ = srv_post(base + "/generate", {"prompt": [1],
                                            "max_new_tokens": 2})
    check(code == 404, "(c) /generate answered %d on a server without a "
          "generator" % code)
    js = srv.http_json_ms()
    print("serving (b) HTTP (%s): 4 POST /predict bit for bit the "
          "in-process answers; JSON decode %.2f ms and encode %.3f ms per "
          "request in the handler; /healthz, /readyz 200, /metrics has the "
          "JAX package's %d series; /generate without a generator 404"
          % (card, js["decode"], js["encode"], len(names)), flush=True)
    return {"json_decode_ms": js["decode"], "json_encode_ms": js["encode"]}


def srv_failover(torch, mt, prefix, images, direct, card):
    """(d1): a router over two ResNet servers; one stopped mid-load and a
    new one added in its place.  Returns the readings and every server."""
    from mxnet_tpu_torch import serving

    servers = [serving.InferenceServer.from_checkpoint(
        prefix, 0, SRV_RESNET_SHAPES) for _ in range(2)]
    # one failed call opens a breaker, and a long cooldown keeps it open
    # until r1 is replaced
    router = serving.Router(servers, seed=1, breaker_threshold=1,
                            breaker_cooldown_ms=600000, workers=SRV_CLIENTS)
    loop = SrvLoop(lambda i: (i % len(images), router.predict(
        data=images[i % len(images)])[0]), SRV_CLIENTS)
    try:
        loop.wait_for(64)
        # stopped with requests in its queue: they fail over to r0
        t_wait = time.monotonic() + 60
        while servers[1].queue_depth() == 0:
            check(time.monotonic() < t_wait, "(d1) r1's queue stayed empty")
        t_stop = time.perf_counter()
        servers[1].stop(drain=False)
        loop.wait_for(len(loop.done) + 64)
        opened = router.metrics.snapshot()["breaker_transitions"].get(
            "open", 0)
        router.remove_replica("r1", drain=False)
        servers.append(serving.InferenceServer.from_checkpoint(
            prefix, 0, SRV_RESNET_SHAPES))
        router.add_replica(servers[-1], name="r1")
        calls0 = router.describe()[1]["calls"]
        loop.wait_for(len(loop.done) + 64)
        done, errors = loop.stop()
        d = router.describe()
        snap = router.metrics.snapshot()
    finally:
        loop.stop()
        router.close(stop_backends=True)
    wall = time.perf_counter() - t_stop
    check(not errors and snap["failed"] == {}, "(d1) failed requests %s %s"
          % (errors[:3], snap["failed"]))
    check(opened >= 1, "(d1) r1's breaker never opened")
    check(d[1]["state"] == "closed" and d[1]["calls"] > calls0,
          "(d1) the re-added r1 is %s with %d calls" % (d[1]["state"],
                                                        d[1]["calls"]))
    err = max(float(np.abs(out - direct[k]).max() / np.abs(direct[k]).max())
              for _, _, (k, out) in done)
    check(err <= SRV_TOL, "(d1) an answer %.3g off" % err)
    print("serving (d1) failover (%s): %d requests from %d threads, r1 "
          "stopped mid-load: 0 failed, %d retries, r1's breaker opened %d "
          "times, then a new server in its place closed and serving; breaker "
          "transitions "
          "%s; max error %.3g; %.1f s"
          % (card, len(done), SRV_CLIENTS, snap["retries"], opened,
             snap["breaker_transitions"], err, wall), flush=True)
    return {"requests": len(done), "retries": snap["retries"],
            "breaker_transitions": snap["breaker_transitions"]}, servers


def srv_swap(torch, mt, net, prefix, images, direct0, card):
    """(d2): the ring of 2, a corrupt epoch 2, then router.swap to epoch 1
    under load.  Returns the readings and every server."""
    import threading

    from mxnet_tpu_torch import serving

    servers = [serving.InferenceServer.from_checkpoint(
        prefix, 0, SRV_RESNET_SHAPES) for _ in range(2)]
    for epoch in (1, 2):
        srv_resnet_checkpoint(mt, net, prefix, epoch, SEED + epoch,
                              max_to_keep=2)
    path = "%s-0002.params" % prefix
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    pruned = not any(os.path.exists("%s-0000%s" % (prefix, s))
                     for s in (".params", ".params.crc32", ".state"))
    latest = mt.model.find_latest_checkpoint(prefix)
    check(pruned and latest == 1, "(d2) epoch 0 pruned %s, latest %s"
          % (pruned, latest))
    direct1 = srv_direct(mt, prefix, 1, images)
    router = serving.Router(servers, seed=2, workers=SRV_CLIENTS)
    ready_min = [2]
    watching = threading.Event()

    def watch():
        while not watching.is_set():
            now = time.monotonic()
            ready_min[0] = min(ready_min[0], sum(
                1 for r in router.replicas() if r.routable(now)))
            time.sleep(0.001)
    watcher = threading.Thread(target=watch)
    mem0 = srv_mem(torch)
    loop = SrvLoop(lambda i: (i % len(images), router.predict(
        data=images[i % len(images)])[0]), SRV_CLIENTS)
    try:
        loop.wait_for(64)
        watcher.start()
        t0 = time.perf_counter()
        swapped = router.swap(prefix, 1)
        swap_s = time.perf_counter() - t0
        t_after = time.monotonic()
        loop.wait_for(len(loop.done) + 64)
        done, errors = loop.stop()
        watching.set()
        watcher.join(60)
        snap = router.metrics.snapshot()
        servers += [r.server for r in router.replicas()]
        mem1 = srv_mem(torch)
    finally:
        loop.stop()
        watching.set()
        router.close(stop_backends=True)
    check(swapped == 2 and not errors and snap["failed"] == {},
          "(d2) swapped %d, failed %s %s" % (swapped, errors[:3],
                                             snap["failed"]))
    check(ready_min[0] >= 1, "(d2) no replica was ready during the swap")
    late = 0
    for i, t_submit, (k, out) in done:
        e0 = float(np.abs(out - direct0[k]).max() / np.abs(direct0[k]).max())
        e1 = float(np.abs(out - direct1[k]).max() / np.abs(direct1[k]).max())
        check(min(e0, e1) <= SRV_TOL, "(d2) an answer matches neither epoch "
              "(%.3g, %.3g)" % (e0, e1))
        if t_submit > t_after:
            late += 1
            check(e1 <= SRV_TOL, "(d2) a request submitted after the swap "
                  "returned got epoch 0's answer")
    check(late > 0, "(d2) no request was submitted after the swap")
    check(abs(mem1 - mem0) <= SRV_MEM_SLACK, "(d2) device memory %.1f MB "
          "after the swap, %.1f MB before" % (mem1 / 2**20, mem0 / 2**20))
    print("serving (d2) hot swap (%s): epoch 0 pruned by the ring of 2, a "
          "corrupt epoch 2 skipped: find_latest_checkpoint 1; router.swap "
          "took %.2f s under %d-thread load: %d requests, 0 failed, at least "
          "%d replica ready throughout, %d submitted after the swap all "
          "epoch 1's; device memory %.1f MB after vs %.1f MB before"
          % (card, swap_s, SRV_CLIENTS, len(done), ready_min[0], late,
             mem1 / 2**20, mem0 / 2**20), flush=True)
    return {"swap_s": swap_s, "requests": len(done), "after_swap": late,
            "mem_delta_mb": (mem1 - mem0) / 2**20}, servers


def srv_remote(torch, mt, srv, images, card):
    """(d4): a router over one server through HTTP."""
    from mxnet_tpu_torch import serving

    host, port = srv._httpd.server_address[:2]
    router = serving.Router(registry=serving.ReplicaRegistry())
    try:
        router.add_replica("%s:%d" % (host, port))
        local_ms, remote_ms = [], []
        for i in range(8):
            t0 = time.perf_counter()
            local = srv.predict(data=images[i])[0]
            t1 = time.perf_counter()
            remote = router.predict(data=images[i])[0]
            t2 = time.perf_counter()
            local_ms.append((t1 - t0) * 1e3)
            remote_ms.append((t2 - t1) * 1e3)
            check(remote.tobytes() == local.tobytes(), "(d4) the remote "
                  "replica's answer for image %d differs" % i)
        kind = router.describe()[0]["kind"]
    finally:
        router.close()
    over = float(np.median(remote_ms) - np.median(local_ms))
    print("serving (d4) remote replica (%s): 8 answers through the router "
          "over HTTP bit for bit the local ones (replica kind %s); median "
          "%.2f ms through the router, %.2f ms in-process: %.2f ms overhead "
          "per request" % (card, kind, np.median(remote_ms),
                           np.median(local_ms), over), flush=True)
    return {"router_ms": float(np.median(remote_ms)),
            "local_ms": float(np.median(local_ms)), "overhead_ms": over}


def srv_fleet_start(mt, net, prefix):
    """(e)'s registry over HTTP and its ProcessProvider replica process,
    started before (d1) so that the process's start-up (imports, CUDA, the
    checkpoint) overlaps (d1)-(d2); its checkpoint is a prefix of its own,
    epoch 1's init, which (d2)'s ring does not touch."""
    from mxnet_tpu_torch import serving

    srv_resnet_checkpoint(mt, net, prefix, 1, SEED + 1)
    registry = serving.ReplicaRegistry(ttl_ms=60000)
    registry.serve_http()
    provider = serving.ProcessProvider(
        registry.addr, prefix, 1, {"data": (1,) + RESNET["image_shape"]})
    t0 = time.perf_counter()
    name, proc = provider.spawn()
    return {"registry": registry, "provider": provider, "name": name,
            "proc": proc, "t0": t0}


def srv_fleet_kill(fleet):
    proc = fleet["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)
    fleet["registry"].close()


def srv_fleet(torch, mt, prefix, images, card, fleet):
    """(e): the autoscaler under a flash crowd over ``fleet``'s registry,
    then ``fleet``'s replica process."""
    from mxnet_tpu_torch import serving

    registry, proc_provider = fleet["registry"], fleet["provider"]
    pname, proc, t_proc = fleet["name"], fleet["proc"], fleet["t0"]
    spawned = []

    class Recording(serving.LocalCheckpointProvider):
        def spawn(self):
            t0 = time.perf_counter()
            name, server = super().spawn()
            spawned.append((name, server, time.perf_counter() - t0))
            return name, server

    seed = serving.InferenceServer.from_checkpoint(
        prefix, 1, SRV_RESNET_SHAPES, max_queue=64)
    # the spawned replicas announce themselves in the registry and the
    # router adopts its model's members (the replica process registers
    # under no model and stays out of the crowd)
    router = serving.Router([seed], seed=4, registry=registry,
                            registry_sync_ms=100, model="resnet",
                            workers=SRV_CROWD[0])
    provider = Recording(prefix, 1, SRV_RESNET_SHAPES, registry=registry,
                         meta={"model": "resnet"}, max_queue=64)
    asc = serving.Autoscaler(router, provider, min_replicas=1,
                             max_replicas=3, interval_ms=100,
                             out_pressure=0.25, in_pressure=0.05,
                             hysteresis=2, cooldown_ms=500)
    sizes = []
    try:
        asc.start()
        clients, seconds = SRV_CROWD
        loop = SrvLoop(lambda i: router.predict(
            data=images[i % len(images)])[0], clients)
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end and not loop.errors:
            sizes.append(len(router.replicas()))
            time.sleep(0.05)
        done, errors = loop.stop()
        peak = max(sizes)
        t_idle = time.monotonic() + 60
        while len(router.replicas()) > 1:
            check(time.monotonic() < t_idle, "(e) the fleet stayed at %d "
                  "replicas after the crowd" % len(router.replicas()))
            time.sleep(0.05)
        scale_in_s = 60 - (t_idle - time.monotonic())
        snap = router.metrics.snapshot()
    finally:
        asc.stop(retire_owned=True)
        router.close(stop_backends=True)
    check(not errors and snap["failed"] == {}, "(e) failed requests %s %s"
          % (errors[:3], snap["failed"]))
    check(peak >= 2, "(e) the fleet never scaled out (%s)" % sorted(
        set(sizes)))
    colds = [s.cold_bucket_runs() for _, s, _ in spawned]
    check(spawned and not any(colds), "(e) spawned replicas' cold bucket "
          "runs %s" % colds)
    events = [(e["op"], e["ok"]) for e in asc.events]
    print("serving (e) flash crowd (%s): %d clients for %.0f s: %d requests, "
          "0 failed, replicas peaked at %d, back to 1 %.1f s after the crowd; "
          "spawn-to-ready s %s (warm-up runs every bucket; no claim), cold "
          "bucket runs %s; decisions %s"
          % (card, clients, seconds, len(done), peak, scale_in_s,
             ["%.2f" % s for _, _, s in spawned], colds, events), flush=True)
    # the replica process: registered, answers, exits 0 on SIGTERM
    local = serving.InferenceServer.from_checkpoint(
        prefix, 1, {"data": (1,) + RESNET["image_shape"]})
    try:
        t_wait = time.monotonic() + 300
        while pname not in registry.live()["replicas"]:
            check(proc.poll() is None, "(e) the replica process exited %s"
                  % proc.poll())
            check(time.monotonic() < t_wait, "(e) the replica process never "
                  "registered")
            time.sleep(0.05)
        ready_s = time.perf_counter() - t_proc
        backend = registry.live()["replicas"][pname]
        code, body = srv_post("http://%s/predict" % backend,
                              {"inputs": {"data": images[0].tolist()}})
        check(code == 200, "(e) the replica process answered %d" % code)
        remote = np.asarray(json.loads(body)["outputs"][0], np.float32)
        want = local.predict(data=images[0])[0]
        check(remote.tobytes() == want.tobytes(), "(e) the replica process's "
              "answer differs from the in-process answer")
        t0 = time.perf_counter()
        proc_provider.retire(pname, proc)
        exit_s = time.perf_counter() - t0
        check(proc.returncode == 0, "(e) the replica process exited %s on "
              "SIGTERM" % proc.returncode)
        check(pname not in registry.live()["replicas"], "(e) the retired "
              "replica is still registered")
    finally:
        local.stop()
        srv_fleet_kill(fleet)
    print("serving (e) replica process (%s): python -m "
          "mxnet_tpu_torch.serving.launch registered %.1f s after its spawn "
          "(started before (d1)), "
          "answered POST /predict bit for bit the in-process answer, exited "
          "0 %.2f s after SIGTERM and left the registry"
          % (card, ready_s, exit_s), flush=True)
    return {"requests": len(done), "peak_replicas": peak,
            "spawn_s": [s for _, _, s in spawned], "scale_in_s": scale_in_s,
            "process_ready_s": ready_s, "process_exit_s": exit_s,
            "stopped": [s for _, s, _ in spawned] + [seed, local]}


def gc_collect():
    import gc

    gc.collect()


def srv_mem(torch):
    """Bytes of live tensors on the card after a collection, without
    cuBLAS's workspaces: PyTorch keeps one per thread that ran a product
    (32 MiB each on this card) until they are cleared, and the serving
    tier's worker threads come and go."""
    gc_collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def serving_phase(torch, mt):
    """Phase 20 (module docstring).  Returns the K1-K3 launches of (a)'s
    scoring window, by path, as ``parallel_phase`` does."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import get_resnet
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_and_limit()
    t_phase = time.perf_counter()
    walls = {}
    torch.cuda.empty_cache()
    mem_start = srv_mem(torch)
    stopped = []
    with tempfile.TemporaryDirectory() as tmp:
        # -- (a) and (c): the LM -------------------------------------------
        t0 = time.perf_counter()
        lm = os.path.join(tmp, "lm")
        with mt.NameManager():
            net = get_transformer_lm(**FULL)
        n_params = srv_lm_checkpoint(torch, mt, net, lm)
        walls["lm checkpoint"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm_srv = [serving.InferenceServer.from_checkpoint(
            lm, 0, SRV_LM_SHAPES, generator_spec=dict(SRV_GEN))
            for _ in range(2)]
        stopped += lm_srv
        check(lm_srv[0].swap_config()["ctx"] == [mt.gpu(0)],
              "(a) the server resolved its context to %s"
              % lm_srv[0].swap_config()["ctx"])
        walls["lm servers"] = time.perf_counter() - t0
        print("serving: LM checkpoint of %d parameters; two servers with "
              "generators built and warmed in %.1f s" % (
                  n_params, walls["lm servers"]), flush=True)
        t0 = time.perf_counter()
        launches, scoring = srv_lm_scoring(torch, mt, lm_srv[0], lm, card)
        walls["(a)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        generate = srv_generate(torch, mt, lm_srv[0], lm_srv[1], card)
        walls["(c)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume = srv_resume(torch, mt, lm_srv, card)
        walls["(d3)"] = time.perf_counter() - t0
        for s in lm_srv:
            s.stop()
        gc_collect()

        # -- (b), (d) and (e): ResNet-50 -------------------------------------
        t0 = time.perf_counter()
        rn = os.path.join(tmp, "resnet")
        with mt.NameManager():
            rnet = get_resnet(**RESNET)
        srv_resnet_checkpoint(mt, rnet, rn, 0, SEED)
        images = srv_images(SRV_RESNET_IMAGES, SEED)
        direct0 = srv_direct(mt, rn, 0, images)
        top = float(direct0.max(axis=1).mean())
        walls["resnet checkpoint"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = serving.InferenceServer.from_checkpoint(
            rn, 0, SRV_RESNET_SHAPES, ctx=[mt.gpu(0), mt.gpu(0)])
        one = serving.InferenceServer.from_checkpoint(
            rn, 0, SRV_RESNET_SHAPES)
        stopped += [two, one]
        walls["resnet servers"] = time.perf_counter() - t0
        print("serving (b): two replicas share one card's SMs: their img/s "
              "is not a two-card number; mean top probability %.3f"
              % top, flush=True)
        t0 = time.perf_counter()
        resnet = {"2 replicas": srv_resnet_load(torch, two, images, direct0,
                                                "2 replicas", card)}
        two.stop()
        resnet["1 replica"] = srv_resnet_load(torch, one, images, direct0,
                                              "1 replica", card)
        resnet["http"] = srv_resnet_http(torch, mt, one, images, card)
        walls["(b)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fl = os.path.join(tmp, "fleet")
        fleet_proc = srv_fleet_start(mt, rnet, fl)
        walls["(e) start"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            failover, servers = srv_failover(torch, mt, rn, images, direct0,
                                             card)
            stopped += servers
            walls["(d1)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            remote = srv_remote(torch, mt, one, images, card)
            one.stop()
            walls["(d4)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            swap, servers = srv_swap(torch, mt, rnet, rn, images, direct0,
                                     card)
            stopped += servers
            del servers
            walls["(d2)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fleet = srv_fleet(torch, mt, fl, images, card, fleet_proc)
            stopped += fleet.pop("stopped")
            walls["(e)"] = time.perf_counter() - t0
        finally:
            srv_fleet_kill(fleet_proc)

    # -- (f) release -------------------------------------------------------
    resident = [s.resident_bytes() for s in stopped]
    mem_end = srv_mem(torch)
    check(not any(resident), "(f) resident bytes after stop %s" % resident)
    check(abs(mem_end - mem_start) <= SRV_MEM_SLACK, "(f) device memory "
          "%.1f MB at the phase's end, %.1f MB at its start"
          % (mem_end / 2**20, mem_start / 2**20))
    wall = time.perf_counter() - t_phase
    print("serving (f) release (%s): %d servers stopped, resident bytes all "
          "0; device memory (live tensors, cuBLAS's per-thread workspaces "
          "cleared) %.1f MB at the end vs %.1f MB at the start"
          % (card, len(stopped), mem_end / 2**20, mem_start / 2**20),
          flush=True)
    print("serving: walls %s; phase %.1f s on %s"
          % ({k: round(v, 2) for k, v in walls.items()}, wall, card),
          flush=True)
    print(json.dumps({"serving": {
        "card": card, "scoring": scoring, "generate": generate,
        "resnet": resnet, "failover": failover, "swap": swap,
        "resume": resume, "remote": remote, "fleet": fleet,
        "release": {"mem_start_mb": mem_start / 2**20,
                    "mem_end_mb": mem_end / 2**20},
        "walls_s": walls, "wall_s": wall,
        "note": "replicas share one card: img/s of two replicas is not a "
                "two-card number"}}, default=str), flush=True)
    return {"f32": {"serving": launches}}


# -- phase 21: the multi-model platform ---------------------------------------

#: the MLPerf DLRM's widths (26 slots of dimension 128, bottom MLP
#: 13-512-256-128, top MLP 1024-1024-512-256, then get_dlrm's CTR head),
#: served at batch 2048 with get_dlrm's bags of 8 ids: a batch touches at
#: most 2048 x 8 = 16384 rows of a slot, the capacity each served table
#: binds; phase 24 trains the full vocabularies on the parameter servers'
#: row plane
PLAT_DLRM = dict(num_slots=26, embed_dim=128, dense_dim=13, bag_len=8,
                 capacity=16384, bottom_hidden=(512, 256, 128),
                 top_hidden=(1024, 1024, 512, 256))
PLAT_DLRM_BATCH = 2048
PLAT_PROMPTS = (100, 700)     # (b): /generate one at a time
PLAT_NEW = 32
PLAT_ARRIVALS = 2             # (a): requests sent into lm-b's fault-in window
PLAT_SCORE = 2                # (b): LM scoring requests, one at a time
PLAT_OVERHEAD_REPS = 20       # (b): DLRM requests each way, interleaved
PLAT_ADS = dict(rate=20.0, burst=10.0)   # (c): the flooding tenant's quota
PLAT_FLOOD = (16, 40)         # (c): threads, at most requests each
PLAT_VISION = 12              # (c): vision's steady requests, one at a time
PLAT_RESUME = (200, 64, 16)   # (e): prompt, new tokens, page out after


def plat_post(url, payload, tenant=None, model=None, timeout=600):
    """(status, JSON body, Retry-After) of one POST to a front door."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant
    if model:
        headers["X-MXNet-Model"] = model
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), None
    except urllib.error.HTTPError as exc:
        body, retry = exc.read(), exc.headers.get("Retry-After")
        exc.close()
        return exc.code, json.loads(body), retry


def plat_stream(url, payload, tenant, on_token=None):
    """One NDJSON /generate stream through a front door: (tokens, the final
    record); ``on_token(n)`` after the n-th token."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "X-Tenant": tenant})
    toks, final = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.headers["Content-Type"] == "application/x-ndjson",
              "platform: /generate answered %s" % resp.headers["Content-Type"])
        for line in resp:
            obj = json.loads(line)
            if "token" not in obj:
                final = obj
                break
            toks.append(obj["token"])
            if on_token is not None:
                on_token(len(toks))
    return toks, final


def plat_dlrm_shapes(batch):
    shapes = {"dense": (batch, PLAT_DLRM["dense_dim"])}
    for i in range(PLAT_DLRM["num_slots"]):
        shapes["slot%d_indices" % i] = (batch, PLAT_DLRM["bag_len"])
    return shapes


def plat_dlrm_items(n, seed):
    """``n`` single-sample requests: 13 dense features and 26 bags of 8 ids
    drawn in [0, capacity) (the port's Embedding clips an id past its table,
    where the JAX package gives NaN)."""
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        item = {"dense": rng.randn(PLAT_DLRM["dense_dim"]).astype(np.float32)}
        for i in range(PLAT_DLRM["num_slots"]):
            item["slot%d_indices" % i] = rng.randint(
                0, PLAT_DLRM["capacity"], PLAT_DLRM["bag_len"]).astype(
                    np.float32)
        items.append(item)
    return items


def plat_dlrm_checkpoint(torch, mt, net, prefix):
    """DLRM weights drawn on the card from SEED: the tables U(-0.01, 0.01)
    (get_dlrm's init), the FullyConnected weights N(0, 1 / fan-in), zero
    biases; saved by save_checkpoint.  Returns the parameter count."""
    shapes = plat_dlrm_shapes(1)
    arg_shapes, _, _ = net.infer_shape(**shapes)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in shapes or name.endswith("_label"):
            continue
        if name.endswith("_embed_weight"):
            t = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) \
                * 0.01
        elif name.endswith("_bias"):
            t = torch.zeros(shape, device="cuda")
        else:
            t = torch.randn(shape, generator=gen, device="cuda") \
                / math.sqrt(shape[1])
        params[name] = mt.nd.NDArray(t, mt.gpu(0))
    mt.model.save_checkpoint(prefix, 0, net, params, {})
    return sum(int(np.prod(p.shape)) for p in params.values())


def plat_direct(mt, prefix, shapes, items):
    """A direct batch-1 Predictor's answers, one item at a time."""
    pred = mt.Predictor.from_checkpoint(prefix, 0, shapes)
    out = [pred.forward(**{k: v[None] for k, v in item.items()})[0]
           .asnumpy()[0] for item in items]
    del pred
    return out


class PlatMeter:
    """Wraps a manager's ``fault_in`` and ``page_out``: for each call that
    builds or releases a server, the card's live tensors (``srv_mem``) before
    and after, the wall seconds and what the server reports.  While ``on``
    is False calls pass through unmeasured: ``srv_mem`` clears cuBLAS's
    workspaces, which is safe only while no other thread runs a product."""

    def __init__(self, torch, mgr):
        self.torch, self.mgr, self.on = torch, mgr, True
        self.fault_ins, self.page_outs = [], []
        self._fault_in, self._page_out = mgr.fault_in, mgr.page_out
        mgr.fault_in, mgr.page_out = self.fault_in, self.page_out

    def fault_in(self, name, device=None, replica=0):
        if not self.on or int(replica) in \
                self.mgr.replica_placement().get(name, {}):
            return self._fault_in(name, device, replica)
        before = srv_mem(self.torch)
        t0 = time.perf_counter()
        srv = self._fault_in(name, device, replica)
        wall = time.perf_counter() - t0
        self.fault_ins.append({
            "model": name, "replica": int(replica), "before": before,
            "after": srv_mem(self.torch), "wall_s": wall,
            "manager_ms": self.mgr.fault_in_latency_ms(name),
            "cold_runs": srv.cold_bucket_runs(),
            "ctx": [str(c) for c in srv.swap_config()["ctx"]]})
        return srv

    def page_out(self, name, replica=None, graceful=False):
        reps = {i: s for i, s in self.mgr._servers.get(name, {}).items()
                if replica is None or i == int(replica)}
        if not self.on or not reps:
            return self._page_out(name, replica=replica, graceful=graceful)
        before = srv_mem(self.torch)
        t0 = time.perf_counter()
        self._page_out(name, replica=replica, graceful=graceful)
        wall = time.perf_counter() - t0
        rec = {"model": name, "replicas": sorted(reps), "wall_s": wall,
               "resident": [s.resident_bytes() for s in reps.values()],
               "cold_runs": [s.cold_bucket_runs() for s in reps.values()],
               "before": before}
        del reps
        rec["after"] = srv_mem(self.torch)
        self.page_outs.append(rec)

    def held(self, rec):
        """The fault-in that built what ``rec`` (a page-out) released."""
        ins = [r for r in self.fault_ins if r["model"] == rec["model"]
               and r["replica"] in rec["replicas"]]
        return ins[-1] if ins else None


def plat_checkpoints(torch, mt, tmp):
    """lm-a and lm-b (the full-width LM from SEED and SEED + 1), ResNet-50
    and the DLRM, each saved by save_checkpoint; name -> prefix."""
    from mxnet_tpu_torch.models import get_dlrm, get_resnet
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    ck = {}
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    for i, name in enumerate(("lm-a", "lm-b")):
        ck[name] = os.path.join(tmp, name)
        n_lm = srv_lm_checkpoint(torch, mt, net, ck[name], seed=SEED + i)
    with mt.NameManager():
        rnet = get_resnet(**RESNET)
    ck["resnet"] = os.path.join(tmp, "resnet")
    srv_resnet_checkpoint(mt, rnet, ck["resnet"], 0, SEED)
    with mt.NameManager():
        dnet, slots = get_dlrm(**PLAT_DLRM)
    ck["dlrm"] = os.path.join(tmp, "dlrm")
    n_dlrm = plat_dlrm_checkpoint(torch, mt, dnet, ck["dlrm"])
    print("platform: checkpoints of lm-a and lm-b (%d parameters each), "
          "ResNet-50 and the DLRM (%d parameters: %d slots of %d rows x %d, "
          "the rows one batch of %d bags of %d ids can touch; the full "
          "vocabularies, %d rows a slot here by get_dlrm's default, live on "
          "the parameter server's row plane, ROADMAP.md A.6b)"
          % (n_lm, n_dlrm, PLAT_DLRM["num_slots"], PLAT_DLRM["capacity"],
             PLAT_DLRM["embed_dim"], PLAT_DLRM_BATCH, PLAT_DLRM["bag_len"],
             slots["slot0"]["num_rows"]), flush=True)
    return ck


def plat_specs(plat, ck):
    lm = dict(slo="generate", tenant="chat", generator_spec=dict(SRV_GEN),
              server_kwargs={"buckets": (1, 2)})
    return [plat.ModelSpec("lm-a", ck["lm-a"], 0, SRV_LM_SHAPES, **lm),
            plat.ModelSpec("lm-b", ck["lm-b"], 0, SRV_LM_SHAPES,
                           replicas=2, **lm),
            plat.ModelSpec("resnet", ck["resnet"], 0, SRV_RESNET_SHAPES,
                           tenant="vision", slo="interactive"),
            plat.ModelSpec("dlrm", ck["dlrm"], 0,
                           plat_dlrm_shapes(PLAT_DLRM_BATCH), tenant="ads",
                           slo="batch")]


def plat_plan(mgr, what):
    """One replan: the plan, its generation one above the last."""
    gen = mgr.plan_generation()
    t0 = time.perf_counter()
    plan = mgr.replan()
    wall = time.perf_counter() - t0
    check(mgr.plan_generation() == gen + 1, "(a) %s: plan generation %d "
          "after %d" % (what, mgr.plan_generation(), gen))
    d = plan.describe()
    print("platform (a) %s: generation %d, resident %s, paged %s, actions "
          "%s, free bytes %s; actuated in %.2f s"
          % (what, gen + 1, d["resident"], d["paged"], d["actions"],
             d["free_bytes"], wall), flush=True)
    return d, wall


def plat_page(torch, mt, plat, ck, card):
    """(a): plan, demand-page lm-b through the front door, page lm-a out."""
    import threading

    specs = plat_specs(plat, ck)
    fp = {s.name: s.footprint() for s in specs}
    budget = sum(fp[n]["total"] for n in ("lm-a", "resnet", "dlrm")) \
        + (1 << 20)
    check(fp["lm-b"]["total"] > budget - fp["lm-a"]["total"]
          - fp["resnet"]["total"], "(a) the pool would hold both LMs")
    mgr = plat.ModelManager(plat.DevicePool(1, budget))
    door = plat.FrontDoor(mgr)
    meter = PlatMeter(torch, mgr)
    host, port = door.serve_http()
    base = "http://%s:%d" % (host, port)
    for s in specs:
        mgr.register_model(s)
    mgr.record_demand("lm-a", 1.0)
    plan1, _ = plat_plan(mgr, "plan with demand on lm-a")
    check(sorted(plan1["resident"]) == ["dlrm", "lm-a", "resnet"]
          and plan1["paged"] == ["lm-b"], "(a) the first plan %s" % plan1)
    # the first request for lm-b faults it in on its handler thread; two
    # more arrive inside the fault-in window
    rng = np.random.default_rng(SEED + 24)
    vocab = GEN_MODEL["vocab_size"]
    prompt0 = [int(t) for t in rng.integers(0, vocab, 300)]
    owner = {}

    def first():
        try:
            owner["out"] = plat_stream(
                base + "/v1/lm-b/generate",
                {"prompt": prompt0, "max_new_tokens": PLAT_NEW}, "chat")
        except Exception as exc:  # fatal below
            owner["error"] = repr(exc)
    th = threading.Thread(target=first)
    th.start()
    t_end = time.monotonic() + 600
    while mgr.fault_in_window("lm-b") is None:
        check(th.is_alive() and time.monotonic() < t_end,
              "(a) lm-b's fault-in window never opened: %s" % owner)
        time.sleep(0.002)
    arrivals = [plat_post(base + "/v1/lm-b/generate",
                          {"prompt": prompt0[:8], "max_new_tokens": 2},
                          "chat") for _ in range(PLAT_ARRIVALS)]
    th.join(600)
    check("out" in owner, "(a) lm-b's first request: %s" % owner)
    toks0, final0 = owner["out"]
    check(final0 == {"done": True, "n": PLAT_NEW}, "(a) lm-b's first stream "
          "ended with %s" % final0)
    for code, body, retry in arrivals:
        check(code == 503 and retry is not None and float(retry) > 0
              and "faulting in" in body.get("error", ""),
              "(a) an arrival in lm-b's fault-in window got %d %s "
              "(Retry-After %s), not 503 with a Retry-After"
              % (code, body, retry))
    mgr.record_demand("lm-a", -mgr.demand()["lm-a"])
    plan2, _ = plat_plan(mgr, "plan with demand on lm-b")
    check(sorted(plan2["resident"]) == ["dlrm", "lm-b", "resnet"]
          and plan2["paged"] == ["lm-a"] and {"op": "page_out",
                                              "model": "lm-a", "device": 0}
          in plan2["actions"], "(a) the second plan %s" % plan2)
    print("platform (a) (%s): %d arrivals in lm-b's fault-in window got 503 "
          "with Retry-After %s s; lm-b's first stream %d tokens; the pool "
          "one device of %d bytes (the footprints of lm-a, resnet and dlrm, "
          "+1 MiB)" % (card, len(arrivals), [a[2] for a in arrivals],
                       len(toks0), budget), flush=True)
    return mgr, door, meter, base, fp, (prompt0, toks0), \
        {"budget": budget, "plans": [plan1, plan2],
         "arrivals": [(a[0], a[2]) for a in arrivals]}


def plat_memory(meter, fp, card, what, released_only=False):
    """The gates and readings of every metered fault-in and page-out: cold
    runs 0, the manager's context, resident bytes 0 after a page-out, and a
    page-out hands back what its fault-in took within SRV_MEM_SLACK (the
    card's memory back to its level before that fault-in, net of the models
    that came and stayed in between)."""
    rows = {}
    for r in meter.fault_ins:
        check(r["cold_runs"] == 0, "%s: %s replica %d faulted in with %d "
              "cold bucket runs" % (what, r["model"], r["replica"],
                                    r["cold_runs"]))
        check(r["ctx"] == ["gpu(0)"], "%s: %s runs on %s" % (
            what, r["model"], r["ctx"]))
        delta = r["after"] - r["before"]
        total = fp[r["model"]]["total"]
        rows.setdefault(r["model"], {}).update(
            fault_in_s=r["wall_s"], manager_ms=r["manager_ms"],
            footprint=total, measured=delta, ratio=total / max(delta, 1))
    for r in meter.page_outs:
        check(not any(r["resident"]), "%s: %s resident bytes %s after its "
              "page-out" % (what, r["model"], r["resident"]))
        held = meter.held(r)
        check(held is not None, "%s: no metered fault-in of %s %s"
              % (what, r["model"], r["replicas"]))
        took = held["after"] - held["before"]
        gave = r["before"] - r["after"]
        check(abs(gave - took) <= SRV_MEM_SLACK, "%s: the page-out of %s "
              "handed back %.1f MB, its fault-in took %.1f MB"
              % (what, r["model"], gave / 2**20, took / 2**20))
        rows[r["model"]].update(page_out_s=r["wall_s"], released=gave)
    for name, row in sorted(rows.items()):
        if released_only and "released" not in row:
            continue
        print("platform %s %s (%s): fault-in %.2f s (the manager's %.1f ms: "
              "build + warm-up of every bucket, the compile cache off in "
              "this phase)%s; "
              "footprint() %d bytes vs the card's measured %d (%.3fx)%s"
              % (what, name, card, row["fault_in_s"], row["manager_ms"],
                 "" if "page_out_s" not in row else
                 "; page-out %.2f s" % row["page_out_s"], row["footprint"],
                 row["measured"], row["ratio"],
                 "" if "released" not in row else
                 ", released %d" % row["released"]), flush=True)
    return rows


def plat_serve(torch, mt, mgr, door, base, ck, first, card):
    """(b): LM scoring, ResNet-50, DLRM and /generate through the door."""
    import statistics

    srv = mgr.server_for("lm-b")
    rep = srv._replicas[0]
    s = FULL["seq_len"]
    rng = np.random.default_rng(SEED + 25)
    reqs = [rng.integers(0, FULL["vocab_size"], (s,)).astype(np.float32)
            for _ in range(PLAT_SCORE)]
    label = np.zeros((s,), np.float32)
    calls0 = rep.executor_calls
    mt.kernels.reset_launches()
    outs = [door.predict("lm-b", tenant="chat", data=x, softmax_label=label)
            [0] for x in reqs]
    torch.cuda.synchronize()
    launches = dict(mt.kernels.LAUNCHES)
    calls = rep.executor_calls - calls0
    check(calls == PLAT_SCORE and launches["flash_fwd"] ==
          FULL["num_layers"] * calls, "(b) flash_fwd launched %d times in "
          "%d LM executor calls, expected %d a call"
          % (launches["flash_fwd"], calls, FULL["num_layers"]))
    direct = mt.Predictor.from_checkpoint(
        ck["lm-b"], 0, {"data": (1, s), "softmax_label": (1, s)})
    lm_err = 0.0
    for x, out in zip(reqs, outs):
        check(out.shape == (s, FULL["vocab_size"]), "(b) an LM answer of "
              "shape %s" % (out.shape,))
        ref = direct.forward(data=x[None], softmax_label=label[None])[0]._data
        got = torch.as_tensor(out, device="cuda")
        lm_err = max(lm_err, float((got - ref).abs().max()
                                   / ref.abs().max()))
        del got, ref
    del direct, outs
    check(lm_err <= SRV_TOL, "(b) LM scoring %.3g off a direct Predictor"
          % lm_err)
    images = srv_images(2, SEED + 26)
    rn_direct = srv_direct(mt, ck["resnet"], 0, images)
    rn_err = 0.0
    for img, ref in zip(images, rn_direct):
        code, body, _ = plat_post(base + "/v1/resnet/predict",
                                  {"inputs": {"data": img.tolist()}},
                                  "vision")
        check(code == 200, "(b) ResNet-50 /predict answered %d %s"
              % (code, body))
        rn_err = max(rn_err, srv_rel(torch, body["outputs"][0], ref))
    check(rn_err <= SRV_TOL, "(b) ResNet-50 %.3g off a direct Predictor"
          % rn_err)
    items = plat_dlrm_items(4, SEED + 27)
    dl_direct = plat_direct(mt, ck["dlrm"], plat_dlrm_shapes(1), items)
    payloads = [{"inputs": {k: v.tolist() for k, v in it.items()}}
                for it in items]
    dl_err = 0.0
    for payload, ref in zip(payloads, dl_direct):
        code, body, _ = plat_post(base + "/predict", payload, "ads",
                                  model="dlrm")
        check(code == 200, "(b) DLRM /predict (X-MXNet-Model) answered %d "
              "%s" % (code, body))
        dl_err = max(dl_err, srv_rel(torch, body["outputs"][0], ref))
    check(dl_err <= SRV_TOL, "(b) DLRM %.3g off a direct Predictor" % dl_err)
    # /generate one at a time against the served engine driven directly
    eng = srv._generator
    prompts = [first[0]] + [[int(t) for t in rng.integers(
        0, FULL["vocab_size"], n)] for n in PLAT_PROMPTS]
    got = [first[1]]
    for p in prompts[1:]:
        toks, final = plat_stream(base + "/v1/lm-b/generate",
                                  {"prompt": p, "max_new_tokens": PLAT_NEW},
                                  "chat")
        check(final == {"done": True, "n": PLAT_NEW}, "(b) a stream ended "
              "with %s" % final)
        got.append(toks)
    ref = [eng.submit(p, PLAT_NEW).result(600) for p in prompts]
    logits_at = GenLogits(mt, eng, srv._model_params)
    ties = near_tie_compare(got, ref, [(p, PLAT_NEW) for p in prompts],
                            logits_at, "platform (b)")
    del logits_at
    # the front door's cost per request over the model's own server
    dsrv = mgr.server_for("dlrm")
    dhost, dport = dsrv.serve_http()
    straight_url = "http://%s:%d/predict" % (dhost, dport)
    via, straight, via_in, straight_in = [], [], [], []
    for i in range(PLAT_OVERHEAD_REPS):
        payload, item = payloads[i % len(payloads)], items[i % len(items)]
        for url, tenant, sink in ((base + "/v1/dlrm/predict", "ads", via),
                                  (straight_url, None, straight)):
            t0 = time.perf_counter()
            code, _, _ = plat_post(url, payload, tenant)
            sink.append((time.perf_counter() - t0) * 1e3)
            check(code == 200, "(b) overhead: %s answered %d" % (url, code))
        t0 = time.perf_counter()
        door.predict("dlrm", tenant="ads", **item)
        via_in.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        dsrv.predict(**item)
        straight_in.append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in (
        ("http_door", via), ("http_server", straight),
        ("door", via_in), ("server", straight_in))}
    res = {"lm_calls": calls, "flash_fwd": launches["flash_fwd"],
           "lm_err": lm_err, "resnet_err": rn_err, "dlrm_err": dl_err,
           "near_ties": ties, "median_ms": med,
           "overhead_http_ms": med["http_door"] - med["http_server"],
           "overhead_in_process_ms": med["door"] - med["server"]}
    print("platform (b) (%s): LM scoring through the front door, %d "
          "requests one at a time (in process: an answer is 4096 x 32000 "
          "floats), %d executor calls, flash_fwd %d, %.3g off a direct "
          "Predictor; ResNet-50 /v1/resnet/predict %.3g; DLRM /predict with "
          "X-MXNet-Model %.3g; %d /generate streams equal to the engine "
          "driven directly (%d near ties); the front door's overhead per "
          "DLRM request %.2f ms over HTTP (median %.2f vs %.2f straight to "
          "its InferenceServer), %.2f ms in process (%.2f vs %.2f)"
          % (card, PLAT_SCORE, calls, launches["flash_fwd"], lm_err, rn_err,
             dl_err, len(prompts), ties, res["overhead_http_ms"],
             med["http_door"], med["http_server"],
             res["overhead_in_process_ms"], med["door"], med["server"]),
          flush=True)
    return {k: launches[k] for k in PS_NAMES}, res, items, images, \
        rn_direct, dl_direct


def plat_tenants(door, base, items, card):
    """(c): ads floods the DLRM past its quota from 16 threads while vision
    streams ResNet-50 requests."""
    import threading

    door.quotas.set_quota("ads", rate=PLAT_ADS["rate"],
                          burst=PLAT_ADS["burst"])
    snap0 = door.quotas.snapshot()
    payloads = [{"inputs": {k: v.tolist() for k, v in it.items()}}
                for it in items]
    images = srv_images(PLAT_VISION, SEED + 28)
    lock = threading.Lock()
    ads = {"ok": 0, "shed": 0, "other": []}
    vision = {"ok": 0, "other": []}
    vision_done = threading.Event()

    def flood(k):
        for i in range(PLAT_FLOOD[1]):
            if vision_done.is_set():
                return
            code, body, retry = plat_post(base + "/v1/dlrm/predict",
                                          payloads[(k + i) % len(payloads)],
                                          "ads")
            with lock:
                if code == 200:
                    ads["ok"] += 1
                elif code == 429 and retry is not None and float(retry) > 0:
                    ads["shed"] += 1
                else:
                    ads["other"].append((code, body, retry))

    def steady():
        try:
            for img in images:
                code, body, retry = plat_post(
                    base + "/v1/resnet/predict",
                    {"inputs": {"data": img.tolist()}}, "vision")
                with lock:
                    if code == 200:
                        vision["ok"] += 1
                    else:
                        vision["other"].append((code, body, retry))
        finally:
            vision_done.set()
    threads = [threading.Thread(target=flood, args=(k,))
               for k in range(PLAT_FLOOD[0])]
    threads.append(threading.Thread(target=steady))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    snap = door.quotas.snapshot()
    sent = ads["ok"] + ads["shed"] + len(ads["other"])
    check(not ads["other"] and ads["shed"] > 0, "(c) ads: %d shed with "
          "429, other answers %s" % (ads["shed"], ads["other"][:3]))
    check(vision["ok"] == PLAT_VISION and not vision["other"]
          and snap["vision"]["shed"] == snap0.get("vision", {}).get(
              "shed", 0), "(c) vision: %d of %d answered, others %s, shed "
          "%s" % (vision["ok"], PLAT_VISION, vision["other"][:3],
                  snap["vision"]))
    counts = {t: {"admitted": snap[t]["admitted"]
                  - snap0.get(t, {}).get("admitted", 0),
                  "shed": snap[t]["shed"] - snap0.get(t, {}).get("shed", 0)}
              for t in ("ads", "vision")}
    print("platform (c) tenants (%s): ads sent %d DLRM requests from %d "
          "threads in %.2f s against a quota of %g/s (burst %g): %d "
          "answered, %d shed with 429 + Retry-After; vision's %d ResNet-50 "
          "requests all answered; the gate's counts %s"
          % (card, sent, PLAT_FLOOD[0], wall, PLAT_ADS["rate"],
             PLAT_ADS["burst"], ads["ok"], ads["shed"], PLAT_VISION,
             counts), flush=True)
    return {"ads_sent": sent, "ads_ok": ads["ok"], "ads_429": ads["shed"],
            "vision_ok": vision["ok"], "gate": counts, "wall_s": wall}


def plat_ladder(torch, mt, plat, ck, items, images, rn_direct, dl_direct,
                card):
    """(d): two failure domains of the card (bookkeeping), ResNet-50 on
    both, the DLRM demand-paged onto domain 0; domain 1 killed by an
    injected probe fault, then marked up."""
    import threading

    from mxnet_tpu_torch.serving.batcher import ServerClosedError
    from mxnet_tpu_torch.serving.router import NoReplicaAvailableError

    rspec = plat.ModelSpec("resnet", ck["resnet"], 0, SRV_RESNET_SHAPES,
                           tenant="vision", slo="interactive", replicas=2)
    dspec = plat.ModelSpec("dlrm", ck["dlrm"], 0,
                           plat_dlrm_shapes(PLAT_DLRM_BATCH), tenant="ads",
                           slo="batch")
    r, d = rspec.footprint()["total"], dspec.footprint()["total"]
    check(d > r, "(d) the ladder's scenario needs the DLRM's footprint above "
          "ResNet-50's: %d vs %d" % (d, r))
    # a device holds two ResNets, or the DLRM, but not a ResNet and the DLRM
    per_device = max(2 * r, d) + (r + d - max(2 * r, d)) // 2
    pool = plat.DevicePool(2, per_device, devices_per_host=1)
    mgr = plat.ModelManager(pool)
    hp = mgr.attach_health(plat.HealthPlane(pool, registry=mgr.registry,
                                            probe_fails=1))
    door = plat.FrontDoor(mgr)
    host, port = door.serve_http()
    base = "http://%s:%d" % (host, port)
    retryable = (ServerClosedError, NoReplicaAvailableError,
                 plat.FaultInProgressError)
    loop = {"ok": 0, "retryable": [], "bad": []}
    stop = threading.Event()

    def interactive():
        i = 0
        while not stop.is_set():
            try:
                door.predict("resnet", tenant="vision",
                             data=images[i % len(images)])
                loop["ok"] += 1
            except retryable as exc:
                loop["retryable"].append(type(exc).__name__)
            except Exception as exc:  # fatal below
                loop["bad"].append(repr(exc))
            i += 1
    th = None
    try:
        mgr.register_model(rspec)
        mgr.record_demand("resnet", 5.0)
        mgr.replan()
        check(mgr.replica_placement() == {"resnet": {0: 0, 1: 1}},
              "(d) ResNet-50's replicas placed %s, not one per domain"
              % mgr.replica_placement())
        mgr.register_model(dspec)
        payload = {"inputs": {k: v.tolist() for k, v in items[0].items()}}
        code, body, _ = plat_post(base + "/v1/dlrm/predict", payload, "ads")
        check(code == 200 and mgr.replica_placement().get("dlrm")
              == {0: 0}, "(d) the DLRM's demand paging: %d, placed %s"
              % (code, mgr.replica_placement()))
        th = threading.Thread(target=interactive)
        th.start()
        gen0 = mgr.plan_generation()
        t0 = time.perf_counter()
        with mt.faults.inject("platform.health.domain.1:ioerr=1", seed=SEED):
            trans = hp.probe()
        ladder_s = time.perf_counter() - t0
        placed = mgr.replica_placement()
        brown = door.quotas.brownout()
        check(trans == [(1, False)] and hp.dead_domains() == [1],
              "(d) the probe under the injected fault: %s" % trans)
        check(placed == {"resnet": {0: 0, 1: 0}}, "(d) after the ladder %s: "
              "ResNet-50's second replica not re-faulted onto domain 0, or "
              "the DLRM kept" % placed)
        check(brown is not None and brown[0] == 1, "(d) brownout %s, "
              "expected the batch class shed (floor 1)" % (brown,))
        check(all(s.cold_bucket_runs() == 0
                  for s in mgr._servers["resnet"].values()),
              "(d) a re-faulted replica ran a cold bucket")
        code, body, retry = plat_post(base + "/v1/dlrm/predict", payload,
                                      "ads")
        check(code == 503 and retry is not None and float(retry) > 0
              and "platform degraded" in body.get("error", ""),
              "(d) the DLRM in brownout answered %d %s (Retry-After %s)"
              % (code, body, retry))
        code, body, _ = plat_post(base + "/v1/resnet/predict",
                                  {"inputs": {"data": images[0].tolist()}},
                                  "vision")
        check(code == 200 and srv_rel(torch, body["outputs"][0],
                                      rn_direct[0]) <= SRV_TOL,
              "(d) ResNet-50 in brownout answered %d" % code)
        t0 = time.perf_counter()
        hp.mark_up(1)
        recover_s = time.perf_counter() - t0
        check(door.quotas.brownout() is None and
              mgr.replica_placement().get("dlrm") == {0: 1},
              "(d) after mark_up: brownout %s, placed %s"
              % (door.quotas.brownout(), mgr.replica_placement()))
        code, body, _ = plat_post(base + "/v1/dlrm/predict", payload, "ads")
        check(code == 200 and srv_rel(torch, body["outputs"][0],
                                      dl_direct[0]) <= SRV_TOL,
              "(d) the DLRM after recovery answered %d" % code)
        gens = (gen0, mgr.plan_generation())
    finally:
        stop.set()
        if th is not None:
            th.join(600)
        door.close()
        mgr.close()
    check(not loop["bad"] and loop["ok"] > 0, "(d) interactive requests "
          "failed outside the retryable family: %s (%d answered)"
          % (loop["bad"][:3], loop["ok"]))
    print("platform (d) ladder (%s): 2 domains of %d bytes (bookkeeping, "
          "both on gpu(0)); domain 1 killed by an injected probe fault: the "
          "ladder reaped its replica, re-faulted ResNet-50's second replica "
          "onto domain 0, paged the DLRM out and browned out the batch "
          "class in %.2f s (plan generation %d -> %d); the DLRM 503 with "
          "Retry-After, ResNet-50 served; mark_up cleared the brownout and "
          "brought the DLRM back on domain 1 in %.2f s; the interactive "
          "loop: %d answered, retryable failures %s"
          % (card, per_device, ladder_s, gens[0], gens[1], recover_s,
             loop["ok"], loop["retryable"]), flush=True)
    return {"ladder_s": ladder_s, "recover_s": recover_s,
            "interactive_ok": loop["ok"],
            "interactive_retryable": len(loop["retryable"]),
            "generations": gens}


def plat_graceful(torch, mgr, door, base, card):
    """(e): lm-b's second replica by hand (the one-device pool plans one),
    then one stream paged out from under mid-way, gracefully."""
    import threading

    before = srv_mem(torch)
    t0 = time.perf_counter()
    mgr.fault_in("lm-b", 0, replica=1)
    fault_s = time.perf_counter() - t0
    took = srv_mem(torch) - before
    router = door.router_for("lm-b")
    router.sync_registry()
    check(len(router.replicas()) == 2, "(e) lm-b's router sees %d replicas"
          % len(router.replicas()))
    plen, new, cut = PLAT_RESUME
    rng = np.random.default_rng(SEED + 29)
    prompt = [int(t) for t in rng.integers(0, FULL["vocab_size"], plen)]
    url = base + "/v1/lm-b/generate"
    payload = {"prompt": prompt, "max_new_tokens": new}
    ref, final = plat_stream(url, payload, "chat")
    check(final == {"done": True, "n": new}, "(e) the uninterrupted stream "
          "ended with %s" % final)
    resumes0 = router.metrics.snapshot()["stream_resumes"]
    state = {}

    def page_out():
        try:
            t1 = time.perf_counter()
            mgr.page_out("lm-b", replica=state["victim"], graceful=True)
            state["page_out_s"] = time.perf_counter() - t1
        except Exception as exc:  # fatal below
            state["error"] = repr(exc)

    def on_token(n):
        if n == cut and "thread" not in state:
            reps = dict(mgr._servers["lm-b"])
            live = [i for i, s in reps.items()
                    if s._generator.active_lanes() > 0]
            check(len(live) == 1, "(e) %d replicas hold the stream"
                  % len(live))
            state["victim"] = live[0]
            state["server"] = reps[live[0]]
            state["thread"] = threading.Thread(target=page_out)
            state["thread"].start()
    t0 = time.perf_counter()
    out, final = plat_stream(url, payload, "chat", on_token)
    wall = time.perf_counter() - t0
    check("thread" in state, "(e) the stream never reached token %d" % cut)
    state["thread"].join(600)
    check("error" not in state and "page_out_s" in state,
          "(e) the graceful page-out: %s" % state.get("error"))
    resumes = router.metrics.snapshot()["stream_resumes"] - resumes0
    check(final == {"done": True, "n": new} and out == ref,
          "(e) the stream across the graceful page-out (%d tokens, final "
          "%s) differs from the uninterrupted one at %s"
          % (len(out), final, [j for j, (a, b) in enumerate(zip(out, ref))
                               if a != b][:3]))
    check(resumes == 1, "(e) %d stream resumes counted" % resumes)
    resident = state.pop("server").resident_bytes()
    check(resident == 0, "(e) the paged-out replica holds %d bytes"
          % resident)
    gave = srv_mem(torch) - before
    check(abs(gave) <= SRV_MEM_SLACK, "(e) device memory %.1f MB off its "
          "level before the second replica's fault-in (which took %.1f MB)"
          % (gave / 2**20, took / 2**20))
    print("platform (e) graceful page-out (%s): lm-b's replica %d faulted in "
          "in %.2f s (%.1f MB), a %d-token stream paged out from under "
          "after %d tokens (page-out %.2f s): finished through the router's "
          "failover (%d resume) in %.2f s, bit for bit the uninterrupted "
          "transcript; memory back within %.1f MB"
          % (card, 1, fault_s, took / 2**20, new, cut, state["page_out_s"],
             resumes, wall, gave / 2**20), flush=True)
    return {"fault_in_s": fault_s, "page_out_s": state["page_out_s"],
            "victim": state["victim"], "resumes": resumes, "wall_s": wall,
            "took_mb": took / 2**20, "left_mb": gave / 2**20}, \
        {"model": "lm-b", "replica": 1, "before": before,
         "after": before + took, "wall_s": fault_s,
         "manager_ms": mgr.fault_in_latency_ms("lm-b"), "cold_runs": 0,
         "ctx": ["gpu(0)"]}


def platform_phase(torch, mt):
    """Phase 21 (module docstring).  Returns the K1-K3 launches of (b)'s LM
    scoring, by path, as ``serving_phase`` does."""
    from mxnet_tpu_torch import platform as plat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_and_limit()
    t_phase = time.perf_counter()
    walls = {}
    torch.cuda.empty_cache()
    mem_start = srv_mem(torch)
    env_before = os.environ.get("MXNET_PLATFORM_MIN_RESIDENT_S")
    # a replan evicts a model however recently it came in
    os.environ["MXNET_PLATFORM_MIN_RESIDENT_S"] = "0"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ck = plat_checkpoints(torch, mt, tmp)
            walls["checkpoints"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mgr, door, meter, base, fp, first, res_a = plat_page(
                torch, mt, plat, ck, card)
            meter.on = False  # traffic from here to (f)
            res_a["models"] = plat_memory(meter, fp, card, "(a)")
            walls["(a)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            launches, res_b, items, images, rn_direct, dl_direct = \
                plat_serve(torch, mt, mgr, door, base, ck, first, card)
            walls["(b)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res_c = plat_tenants(door, base, items, card)
            walls["(c)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res_d = plat_ladder(torch, mt, plat, ck, items, images,
                                rn_direct, dl_direct, card)
            walls["(d)"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res_e, second = plat_graceful(torch, mgr, door, base, card)
            meter.fault_ins.append(second)
            walls["(e)"] = time.perf_counter() - t0
            # -- (f) close: every model paged out, metered ---------------
            t0 = time.perf_counter()
            door.close()
            meter.on = True
            meter.page_outs.clear()
            mgr.close()
            res_f = plat_memory(meter, fp, card, "(f)", released_only=True)
            walls["(f)"] = time.perf_counter() - t0
    finally:
        if env_before is None:
            os.environ.pop("MXNET_PLATFORM_MIN_RESIDENT_S", None)
        else:
            os.environ["MXNET_PLATFORM_MIN_RESIDENT_S"] = env_before
    check(mgr.resident_bytes() == 0, "(f) the manager holds %d bytes after "
          "close" % mgr.resident_bytes())
    del mgr, door, meter
    mem_end = srv_mem(torch)
    check(abs(mem_end - mem_start) <= SRV_MEM_SLACK, "(f) device memory "
          "%.1f MB after close, %.1f MB at the phase's start"
          % (mem_end / 2**20, mem_start / 2**20))
    wall = time.perf_counter() - t_phase
    print("platform (f) close (%s): every model paged out; device memory "
          "(live tensors, cuBLAS's per-thread workspaces cleared) %.1f MB "
          "at the end vs %.1f MB at the start" % (
              card, mem_end / 2**20, mem_start / 2**20), flush=True)
    print("platform: walls %s; phase %.1f s on %s"
          % ({k: round(v, 2) for k, v in walls.items()}, wall, card),
          flush=True)
    print(json.dumps({"platform": {
        "card": card, "plan_and_page": res_a, "serve": res_b,
        "tenants": res_c, "ladder": res_d, "graceful": res_e,
        "close": {"models": res_f, "mem_start_mb": mem_start / 2**20,
                  "mem_end_mb": mem_end / 2**20},
        "walls_s": walls, "wall_s": wall,
        "note": "one card: the pool's devices and domains are bookkeeping, "
                "every replica runs on gpu(0)"}}, default=str), flush=True)
    return {"f32": {"platform": launches}}


# ---------------------------------------------------------------------------
# phase 22: compile-once, cold against warm
# ---------------------------------------------------------------------------

#: the LM server of phase 22: scoring buckets 1 and 2 and an engine with
#: lanes 1/2/4/8 over GEN_ENGINE's pool (S.7's decode step at 8 lanes)
CC_GEN = dict(GEN_MODEL, lane_buckets=(1, 2, 4, 8), page_size=16,
              num_pages=577, prefill_len_buckets=(128, 1024),
              prefill_batch_buckets=(1,))
#: entries of that server: 2 scoring buckets, 2 prefill, 4 decode lanes;
#: the first 4 are CUDA graphs, the lane buckets run eagerly
CC_ENTRIES = 8
CC_GRAPHS = 4
CC_SCORE = 2                # (c): scoring calls whose K1 launches count
CC_REPS = (1, 3)            # (c): eager/graph scoring runs, warm-up, timed
CC_PROMPTS = (128, 1024) * 4   # (c): the engine's prompts, 8 live lanes
CC_NEW = 24                 # (c): tokens generated for each prompt
CC_TOL = 1e-4               # (c): replies against a direct batch-1 forward
CC_ULPS = 1                 # (b): K4/K5 from cached cubins, plain versions
CC_RTC = (4096, 4096)       # (a)/(b): the axpy and gelu shape
CC_TIMEOUT = 600


def cc_rtc(torch, mt):
    """K4 (``rtc`` axpy, float32) and K5 (the ``rtc_gelu`` op, gelu_fwd and
    gelu_bwd, bf16) on the card: (launches, ulps from the plain versions)."""
    from mxnet_tpu_torch import rtc_kernels as rk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)
    x, y = (torch.randn(CC_RTC, generator=gen, device="cuda")
            for _ in range(2))
    xb, dyb = (torch.randn(CC_RTC, generator=gen, device="cuda")
               .to(torch.bfloat16) * 3 for _ in range(2))
    rk.register_rtc_gelu()
    mt.kernels.reset_launches()
    out = rk.axpy(x, y, torch.empty_like(x))
    fwd = mt.nd.rtc_gelu(mt.nd.NDArray(xb, mt.gpu(0)))._data
    bwd = rk.gelu_backward(xb, dyb)
    torch.cuda.synchronize()
    launches = {k: v for k, v in mt.kernels.LAUNCHES.items()
                if k.startswith("rtc:") and v}
    return launches, {"rtc:axpy": ulps(torch, out, rk.axpy_plain(x, y)),
                      "rtc:gelu_fwd": ulps(torch, fwd, rk.gelu_plain(xb)),
                      "rtc:gelu_bwd": ulps(torch, bwd,
                                           rk.gelu_grad_plain(xb, dyb))}


def cc_reserved(torch):
    """Bytes the caching allocator holds on the card after a collection,
    cuBLAS's workspaces cleared and the free cached segments released: a
    CUDA graph's pool is reserved whole (its freed intermediates stay in
    it), which ``srv_mem``'s live tensors do not show."""
    srv_mem(torch)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def cc_fault_in(torch, mt, prefix, what, card):
    """The LM at ``prefix`` as a platform model, faulted in on a fresh
    manager: (manager, server, readings).  The seconds split into load (the
    params file read onto the card, timed apart), the entries' load and
    restore, the first runs, the captures and the rest (building the
    server); ``footprint()`` against the card's delta."""
    from mxnet_tpu_torch import compile_cache as cc
    from mxnet_tpu_torch.platform import DevicePool, ModelManager, ModelSpec

    os.environ["MXNET_PLATFORM_MIN_RESIDENT_S"] = "0"
    t0 = time.perf_counter()
    arrays = mt.nd.load("%s-0000.params" % prefix, mt.gpu(0))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del arrays
    mgr = ModelManager(DevicePool(1, 78 << 30))
    mspec = ModelSpec("lm", prefix, 0, SRV_LM_SHAPES,
                      tenant="chat", slo="generate",
                      generator_spec=dict(CC_GEN))
    mgr.register_model(mspec)
    estimate = mspec.footprint()
    reserved = cc_reserved(torch)
    before = srv_mem(torch)
    s0 = cc.stats()
    t0 = time.perf_counter()
    srv = mgr.fault_in("lm")
    wall = time.perf_counter() - t0
    s1 = cc.stats()
    took = srv_mem(torch) - before
    took_reserved = cc_reserved(torch) - reserved
    fp = mspec.footprint()
    split = {k: (s1[k] - s0[k]) / 1e3 for k in
             ("deserialize_ms", "first_run_ms", "capture_ms")}
    entries = srv.compiled_entries()
    res = {"fault_in_s": wall, "load_s": load_s,
           "entries_s": split["deserialize_ms"],
           "first_runs_s": split["first_run_ms"],
           "captures_s": split["capture_ms"],
           "build_s": wall - load_s - sum(split.values()),
           "states": [e.cache_state for e in entries],
           "graphs": [(e._kind, r["graph"]) for e in entries
                      for r in e.records],
           "cold_runs": srv.cold_bucket_runs(), "before": before,
           "took": took, "reserved_before": reserved,
           "took_reserved": took_reserved, "footprint": fp["total"],
           "exec_bytes": fp["exec_bytes"],
           "estimate_exec_bytes": estimate["exec_bytes"],
           "ratio": fp["total"] / max(took, 1),
           "ratio_reserved": fp["total"] / max(took_reserved, 1)}
    check(len(entries) == CC_ENTRIES and
          all(g == (k in cc.GRAPH_KINDS) for k, g in res["graphs"]) and
          sum(g for _, g in res["graphs"]) == CC_GRAPHS,
          "(e) %s: %d entries, graphs %s" % (what, len(entries),
                                             res["graphs"]))
    check(res["cold_runs"] == 0, "(e) %s: %d cold bucket runs"
          % (what, res["cold_runs"]))
    print("compile_once (e) %s fault-in (%s): %.2f s = load %.2f (the params "
          "file onto the card, timed apart) + entries %.3f + first runs %.2f "
          "+ captures %.2f + build %.2f; entries %s; cold bucket runs 0; "
          "footprint() %d bytes (exec %d measured, %d estimated before) vs "
          "the card's measured delta %d allocated (%.3fx), %d reserved "
          "(%.3fx)"
          % (what, card, wall, load_s, res["entries_s"], res["first_runs_s"],
             res["captures_s"], res["build_s"], sorted(set(res["states"])),
             fp["total"], fp["exec_bytes"], estimate["exec_bytes"], took,
             res["ratio"], took_reserved, res["ratio_reserved"]), flush=True)
    return mgr, srv, res


def cc_page_out(torch, mgr, res, what, card):
    """Page the LM out (its bundle refreshed before the server stops): the
    memory handed back against what its fault-in took."""
    t0 = time.perf_counter()
    mgr.page_out("lm")
    res["page_out_s"] = time.perf_counter() - t0
    mgr.close()
    res["gave"] = res["took"] - (srv_mem(torch) - res["before"])
    res["gave_reserved"] = res["took_reserved"] - (
        cc_reserved(torch) - res["reserved_before"])
    for k in ("", "_reserved"):
        check(abs(res["gave" + k] - res["took" + k]) <= SRV_MEM_SLACK,
              "(e) %s: the page-out handed back %.1f MB%s, its fault-in "
              "took %.1f MB" % (what, res["gave" + k] / 2**20,
                                k.replace("_", " "), res["took" + k] / 2**20))
    print("compile_once (e) %s page-out (%s): %.2f s, handed back %.1f MB of "
          "%.1f MB allocated, %.1f MB of %.1f MB reserved (the graphs' pools "
          "freed)" % (what, card, res["page_out_s"], res["gave"] / 2**20,
                      res["took"] / 2**20, res["gave_reserved"] / 2**20,
                      res["took_reserved"] / 2**20), flush=True)


def cc_bitwise(torch, pred):
    """The executor's graph replay against its eager walk on the same bound
    inputs: (outputs equal bit for bit, replayed through a graph)."""
    ex = pred._exec
    got = [o._data.clone() for o in ex.forward(is_train=False)]
    ex._output_arrays = []
    ref, _ = ex._infer(*ex._bound())
    graph = any(r["graph"] for fn in ex._jit_cache.values()
                for r in fn.records)
    return all(torch.equal(a, b) for a, b in zip(got, ref)), graph


def cc_keep_graphs(torch):
    """CUDA graphs captured from here on keep their cudaGraph_t
    (``keep_graph``: instantiated at the first replay, not at the capture's
    end), so (c) can read a graph's nodes from its DOT dump
    (``cc_graph_kernels``): what every replay of it launches."""
    real = torch.cuda.CUDAGraph

    def kept(*args, **kwargs):
        graph = real(*args, **dict(kwargs, keep_graph=True))
        graph.enable_debug_mode()
        return graph

    torch.cuda.CUDAGraph = kept


#: kernel families, each a substring of a kernel's mangled name in a
#: graph's DOT dump and of its demangled name in a trace: (c) holds a
#: graph's kernel nodes against a traced replay's kernel records by family
CC_FAMILIES = ("flash_fwd_tf32_kernel", "gemm", "elementwise_kernel",
               "reduce_kernel", "gather", "softmax")


def cc_families(texts):
    """A Counter of ``texts`` (kernel names or node blocks) by family."""
    import collections

    out = collections.Counter()
    for text in texts:
        low = text.lower()
        out[next((f for f in CC_FAMILIES if f in low), "other")] += 1
    return out


def cc_graph_kernels(mt, ex):
    """The kernel nodes of ``ex``'s one CUDA graph by family, from its DOT
    dump: what every replay of the graph launches."""
    from mxnet_tpu_torch import compile_cache as cc

    graphs = [run for fn in ex._jit_cache.values()
              for run in fn._by_sig.values() if isinstance(run, cc._Graph)]
    check(len(graphs) == 1, "(c) %d CUDA graphs in a scoring executor, "
          "expected 1" % len(graphs))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graphs[0].graph.debug_dump(path)
        check(os.path.exists(path), "(c) the graph left no DOT dump")
        with open(path) as f:
            text = f.read()
    # a node's definition starts its line ("name"[...]); an edge's
    # ("a" -> "b" [...]) does not match
    nodes = {}
    for m in re.finditer(r'(?m)^"(graph_\d+_node_\d+)"\[(.*?)\];$', text,
                         re.S):
        nodes.setdefault(m.group(1), m.group(2))
    kernels = [blk for blk in nodes.values() if 'label="{KERNEL' in blk]
    check(kernels and len(kernels) == len(nodes), "(c) the graph's DOT dump "
          "holds %d nodes, %d of them kernels" % (len(nodes), len(kernels)))
    return cc_families(kernels)


def cc_traced_k1(torch, mt, ex):
    """One replay of ``ex`` traced with torch.profiler: (K1 launches the
    host counted, the trace's kernel records by family)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    before = mt.kernels.LAUNCHES["flash_fwd"]
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.forward(is_train=False)
        torch.cuda.synchronize()
    ex._output_arrays = []
    host = mt.kernels.LAUNCHES["flash_fwd"] - before
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as trace:
            events = json.load(trace)["traceEvents"]
    return host, cc_families(e.get("name", "") for e in events
                             if e.get("cat") == "kernel")


def cc_generate(torch, srv, prompts):
    """``prompts`` through ``srv.submit_generate`` at once, CC_NEW tokens
    each: (the token lists, the ms of every step of the widest lane bucket
    through ``_run_lanes``, by CUDA events around the loop thread's
    calls)."""
    eng = srv._generator
    widest = eng._decode[eng.lane_buckets[-1]]
    real, marks = eng._run_lanes, []

    def run_lanes(pred, *args):
        if pred is not widest:
            return real(pred, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits = real(pred, *args)
        end.record()
        marks.append((start, end))
        return logits

    eng._run_lanes = run_lanes
    try:
        streams = [srv.submit_generate(p, CC_NEW) for p in prompts]
        tokens = [s.result(600) for s in streams]
    finally:
        del eng._run_lanes
    torch.cuda.synchronize()
    return tokens, [a.elapsed_time(b) for a, b in marks]


def cc_ms(torch, fn, reps):
    """Median ms of ``fn`` by CUDA events after ``reps[0]`` warm-up runs."""
    warm, timed = reps
    times = []
    for i in range(warm + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def cc_again(torch, mt, spec, what, card):
    """(e) once more in this process, now that it ran CUDA work: the
    in-memory entries dropped, the second checkpoint (its own bundle) with
    the second cache directory."""
    from mxnet_tpu_torch import compile_cache as cc

    cc.reset_stats()
    mt.autotune.reset_for_tests()
    os.environ["MXNET_COMPILE_CACHE_DIR"] = spec["cc2"]
    mgr, srv, res = cc_fault_in(torch, mt, spec["prefix2"], what, card)
    want = "miss" if what.startswith("cold") else "hit"
    check(res["states"] == [want] * CC_ENTRIES, "(e) %s: entries %s"
          % (what, res["states"]))
    del srv
    cc_page_out(torch, mgr, res, what, card)
    return res


def cc_cold(torch, mt, spec, card):
    """The cold worker (the repo tree, its ``_build/`` built by the build
    phase, an empty cache directory): (a) the LM faulted in from its
    checkpoint through the platform (``InferenceServer.from_checkpoint``,
    warm-up with every entry a miss, ``save_aot_bundle`` at the first
    build), paged out (the bundle refreshed); K4/K5 through NVRTC."""
    from mxnet_tpu_torch import compile_cache as cc

    mgr, srv, fault = cc_fault_in(torch, mt, spec["prefix"], "cold", card)
    check(fault["states"] == ["miss"] * CC_ENTRIES, "(a) cold entries %s, "
          "expected %d misses" % (fault["states"], CC_ENTRIES))
    bundle = mt.checkpoint.aot_bundle_path(spec["prefix"], 0)
    check(os.path.exists(os.path.join(bundle, cc.MANIFEST_NAME)),
          "(a) the first build wrote no bundle")
    del srv
    cc_page_out(torch, mgr, fault, "cold", card)
    manifest = cc.read_manifest(bundle)
    res = {"fault": fault, "stats_a": cc.stats(),
           "autotune_a": mt.autotune.stats(),
           "bundle_entries": len(manifest["entries"]),
           "bundle_blobs": [b["name"] for b in manifest["blobs"]],
           "bundle_mb": sum(os.path.getsize(os.path.join(bundle, n))
                            for n in os.listdir(bundle)) / 2**20}
    check(res["bundle_entries"] == CC_ENTRIES and res["bundle_blobs"],
          "(a) the bundle holds %d entries and blobs %s"
          % (res["bundle_entries"], res["bundle_blobs"]))
    res["rtc_launches"], res["rtc_ulps"] = cc_rtc(torch, mt)
    res["nvrtc_compiles"] = mt.cuda_rtc.COMPILES["n"]
    check(res["nvrtc_compiles"] == 3, "(a) %d NVRTC compiles, expected 3 "
          "(axpy, gelu_fwd, gelu_bwd)" % res["nvrtc_compiles"])
    check(res["autotune_a"]["tuning_ms"] > 0, "(a) no tuning ran cold")
    print("compile_once (a) cold (%s): the LM faulted in from its checkpoint "
          "with %d entries, all misses, %d of them CUDA graphs (scoring and "
          "prefill; the lane buckets eager); its bundle of %d "
          "entries and blobs %s (%.1f MB) written at the first build and "
          "refreshed at the page-out; %d NVRTC compiles; tuning %.1f ms, %d "
          "winners stored"
          % (card, CC_ENTRIES, CC_GRAPHS, res["bundle_entries"],
             res["bundle_blobs"],
             res["bundle_mb"], res["nvrtc_compiles"],
             res["autotune_a"]["tuning_ms"], res["autotune_a"]["stores"]),
          flush=True)
    res["again"] = cc_again(torch, mt, spec, "cold, a warm process", card)
    return res


def cc_warm(torch, mt, spec, card):
    """The warm worker (a fresh copy of the package, no ``_build/``, the
    same cache directory and the bundle): (b) nothing built, (c) the graphs
    on the card, (d) the bundle's refusals, (e) the fault-in warm."""
    from mxnet_tpu_torch import compile_cache as cc

    res = {"package": os.path.dirname(os.path.abspath(mt.__file__))}
    check(not os.path.isdir(mt.kernels._BUILD), "(b) the fresh copy has "
          "a _build directory before anything ran")
    mgr, srv, fault = cc_fault_in(torch, mt, spec["prefix"], "warm", card)
    res["fault"] = fault
    rtc_launches, rtc_ulps = cc_rtc(torch, mt)
    s = cc.stats()
    at = mt.autotune.stats()
    res.update(stats_b=s, autotune_b=at, rtc_launches=rtc_launches,
               rtc_ulps=rtc_ulps, nvcc_builds=sorted(mt.kernels.BUILD_LOGS),
               nvrtc_compiles=mt.cuda_rtc.COMPILES["n"],
               restored=sorted(os.listdir(mt.kernels._BUILD)))
    check(srv._generator is not None, "(b) the bundle did not restore the "
          "generator")
    check(not res["nvcc_builds"], "(b) nvcc ran: %s" % res["nvcc_builds"])
    check(res["nvrtc_compiles"] == 0, "(b) %d NVRTC compiles"
          % res["nvrtc_compiles"])
    check(at["tuning_ms"] == 0 and at["misses"] == 0 and at["hits"] > 0,
          "(b) the autotuner tuned or missed: %s" % at)
    check(s["misses"] == 0 and s["hits"] == CC_ENTRIES and
          s["bypass"] == 0 and s["errors"] == 0,
          "(b) compile cache %s, expected %d hits" % (s, CC_ENTRIES))
    check(fault["states"] == ["hit"] * CC_ENTRIES, "(b) entry states %s"
          % fault["states"])
    check(all(d <= CC_ULPS for d in rtc_ulps.values()), "(b) K4/K5 from "
          "cached cubins: %s ulps from the plain versions" % rtc_ulps)
    check(set(rtc_launches) == {"rtc:axpy", "rtc:gelu_fwd", "rtc:gelu_bwd"},
          "(b) user-kernel launches %s" % rtc_launches)
    print("compile_once (b) warm (%s): a fresh copy of the package without "
          "_build/ served from the bundle and the cache: %d hits, 0 misses, "
          "0 bypass; nvcc builds none (libraries restored: %s), NVRTC "
          "compiles 0, tuning 0 ms (%d DB hits, 0 misses), cold bucket runs "
          "0; K4/K5 from cached cubins %s ulps from the plain versions"
          % (card, s["hits"], res["restored"], at["hits"], rtc_ulps),
          flush=True)

    # -- (c) the graphs on the card --------------------------------------
    rep = srv._replicas[0]
    eng = srv._generator
    preds = [("score b%d" % b, rep._preds[b]) for b in rep.buckets]
    preds += [("prefill %d" % L, bp._preds[b])
              for L, bp in sorted(eng._prefill.items())
              for b in bp.buckets]
    s_len = FULL["seq_len"]
    rng = np.random.default_rng(SEED + 22)
    tokens = rng.integers(0, FULL["vocab_size"], (2, s_len)).astype(
        np.float32)
    for name, pred in preds:
        shape = pred._input_shapes["data"]
        pred.set_input("data", tokens[:shape[0], :shape[1]])
        same, graph = cc_bitwise(torch, pred)
        check(graph, "(c) %s runs without a CUDA graph" % name)
        check(same, "(c) %s: the replay differs from its eager walk" % name)
    res["bitwise"] = [name for name, _ in preds]
    for b in eng.lane_buckets:
        fns = eng._decode[b]._exec._jit_cache.values()
        check(fns and not any(r["graph"] for fn in fns for r in fn.records),
              "(c) decode %d: not an entry that runs eagerly" % b)
    # replies against a direct batch-1 forward (eager: no graph), and K1
    # counted through the replays, then traced on the device
    label = np.zeros((s_len,), np.float32)
    mt.kernels.reset_launches()
    calls0 = rep.executor_calls
    replies = [srv.predict(data=tokens[i], softmax_label=label)[0]
               for i in range(CC_SCORE)]
    torch.cuda.synchronize()
    k1 = mt.kernels.LAUNCHES["flash_fwd"]
    calls = rep.executor_calls - calls0
    check(calls == CC_SCORE and k1 == FULL["num_layers"] * calls,
          "(c) flash_fwd launched %d times in %d executor calls, expected "
          "%d" % (k1, calls, FULL["num_layers"] * calls))
    res["k1_launches"] = k1
    traced = {}
    for b in rep.buckets:
        # one traced replay: 6 K1 on the host and 6 device ops.  The
        # graph's own nodes (its DOT dump) say what every replay launches;
        # a trace short of K1 passes only if the graph holds 6 K1 nodes and
        # the trace holds no record the graph lacks (the missing ones are
        # records the profiler lost, not launches)
        ex = rep._preds[b]._exec
        host, seen = cc_traced_k1(torch, mt, ex)
        graph = cc_graph_kernels(mt, ex)
        n, fam = FULL["num_layers"], CC_FAMILIES[0]
        missing, extra = graph - seen, seen - graph
        traced["score b%d" % b] = {
            "host": host, "device": seen[fam], "graph_k1_nodes": graph[fam],
            "kernel_records": sum(seen.values()),
            "graph_kernel_nodes": sum(graph.values()),
            "missing": dict(missing), "extra": dict(extra)}
        check(host == graph[fam] == n and (seen[fam] == n or not extra),
              "(c) score b%d: one traced replay counted %d K1 on the host "
              "and ran %d flash_fwd_tf32_kernel on the device; its graph "
              "holds %d of them; kernel records by family %s, the graph's "
              "kernel nodes %s; expected %d"
              % (b, host, seen[fam], graph[fam], dict(seen), dict(graph), n))
        if seen[fam] != n:
            print("compile_once (c) score b%d: the trace lacks %d of the "
                  "graph's %d kernel records (%s), %d of them K1's: records "
                  "the profiler lost (PERF.md section 7)"
                  % (b, sum(missing.values()), sum(graph.values()),
                     dict(missing), n - seen[fam]), flush=True)
    res["k1_traced"] = traced
    direct = mt.Predictor.from_checkpoint(
        spec["prefix"], 0, {"data": (1, s_len), "softmax_label": (1, s_len)})
    worst = 0.0
    for i, got in enumerate(replies):
        direct.set_input("data", tokens[i:i + 1])
        ref = direct._exec._infer(*direct._exec._bound())[0][0]
        got = torch.as_tensor(got, device="cuda")
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    del direct, replies, ref, got
    check(worst <= CC_TOL, "(c) replies %.3g of the largest |value| off a "
          "direct batch-1 forward" % worst)
    res["max_rel_err"] = worst
    # the LM executor eager against graph
    ms = {}
    for b in rep.buckets:
        ex = rep._preds[b]._exec
        ms["score b%d" % b] = (
            cc_ms(torch, lambda: ex._infer(*ex._bound()), CC_REPS),
            cc_ms(torch, lambda: ex.forward(is_train=False), CC_REPS))
        ex._output_arrays = []
    res["eager_graph_ms"] = ms
    # the engine's own path: 8 live lanes through submit_generate
    prompts = [[int(t) for t in rng.integers(0, FULL["vocab_size"], n)]
               for n in CC_PROMPTS]
    gen_tokens, steps = cc_generate(torch, srv, prompts)
    check(len(steps) >= CC_NEW // 2, "(c) %d steps of %d lanes"
          % (len(steps), eng.lane_buckets[-1]))
    print("compile_once (c) graphs (%s): %d executors replay bit for bit "
          "their eager walks (%s); the %d lane buckets are entries that run "
          "eagerly; %d scoring replies within %.3g of the largest |value| "
          "of a direct batch-1 forward (eager; limit %g); flash_fwd %d in "
          "%d executor calls (6 a call, counted through the replays), "
          "one traced replay each %s; ms eager vs graph: %s "
          "(phase 20's executor: 72.93 and 143.22 ms)"
          % (card, len(preds), ", ".join(res["bitwise"]),
             len(eng.lane_buckets), CC_SCORE, worst, CC_TOL, k1, calls,
             traced, {k: "%.3f vs %.3f" % v for k, v in ms.items()}),
          flush=True)
    del srv, rep, eng, preds, pred, ex
    cc_page_out(torch, mgr, fault, "warm", card)
    # the same prompts through an eager engine: the cache off, no bundle
    os.environ["MXNET_COMPILE_CACHE_DIR"] = ""
    cc.detach_bundles()
    eager = mt.serving.InferenceServer.from_checkpoint(
        spec["prefix"], 0, {"data": (1, s_len), "softmax_label": (1, s_len)},
        attach_aot=False, generator_spec=dict(CC_GEN))
    check(not eager.compiled_entries(), "(c) the eager engine has entries")
    eager_tokens, eager_steps = cc_generate(torch, eager, prompts)
    eager.stop()
    del eager
    os.environ["MXNET_COMPILE_CACHE_DIR"] = spec["cc"]
    same = sum(a == b for a, b in zip(gen_tokens, eager_tokens))
    check(same == len(prompts), "(c) %d of %d prompts generated the eager "
          "engine's tokens" % (same, len(prompts)))
    res["step_ms"] = {"warm server": steps, "eager engine": eager_steps}
    print("compile_once (c) engine (%s): %d prompts (%s tokens) through "
          "submit_generate, %d new tokens each, token for token those of an "
          "eager engine (cache off, attach_aot=False); the %d-lane step "
          "through _run_lanes (inputs, forward, the planes adopted) median "
          "%.3f ms over %d steps on the warm server (prefill graphs, lanes "
          "eager) vs %.3f ms over %d on the eager engine (S.7's synthetic "
          "step 11.854-11.971 ms)"
          % (card, len(prompts), "/".join(map(str, sorted(set(CC_PROMPTS)))),
             CC_NEW, CC_GEN["lane_buckets"][-1], float(np.median(steps)),
             len(steps), float(np.median(eager_steps)), len(eager_steps)),
          flush=True)

    # -- (d) the bundle's refusals ---------------------------------------
    bundle = mt.checkpoint.aot_bundle_path(spec["prefix"], 0)
    refused = {}
    for tag in ("device_kind", "jax"):
        prefix = os.path.join(spec["tmp"], "refuse_" + tag)
        for suffix in ("-symbol.json", "-0000.params"):
            os.link(spec["prefix"] + suffix, prefix + suffix)
        copy = mt.checkpoint.aot_bundle_path(prefix, 0)
        shutil.copytree(bundle, copy)
        manifest = cc.read_manifest(copy)
        if tag == "jax":
            manifest["env"] = {"schema": 1, "jax": "0.4.35",
                               "jaxlib": "0.4.35", "platform": "gpu",
                               "device_kind": torch.cuda.get_device_name(0),
                               "device_count": 1, "process_count": 1}
        else:
            manifest["env"]["device_kind"] = "TPU v5 lite"
        with open(os.path.join(copy, cc.MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
        try:
            mt.serving.InferenceServer.from_checkpoint(
                prefix, 0, {"data": (1, s_len), "softmax_label": (1, s_len)})
            refused[tag] = None
        except mt.base.MXNetError as exc:
            refused[tag] = str(exc)[:160]
        check(refused[tag] is not None, "(d) the %s manifest was attached"
              % tag)
    plain = mt.serving.InferenceServer.from_checkpoint(
        prefix, 0, {"data": (1, s_len), "softmax_label": (1, s_len)},
        attach_aot=False)
    answer = plain.predict(data=tokens[0], softmax_label=label)[0]
    plain.stop()
    check(answer.shape == (s_len, FULL["vocab_size"]) and
          np.isfinite(answer).all(), "(d) attach_aot=False answered %s"
          % (answer.shape,))
    res["refused"] = refused
    print("compile_once (d) refusals (%s): a manifest edited to another "
          "device_kind raised MXNetError (%s); a JAX-shaped manifest raised "
          "MXNetError (%s); attach_aot=False served the checkpoint, a finite "
          "(%d, %d) answer" % (card, refused["device_kind"],
                              refused["jax"], s_len, FULL["vocab_size"]),
          flush=True)
    res["again"] = cc_again(torch, mt, spec, "warm, a warm process", card)
    return res


def cc_worker(path):
    """``--cc-worker SPEC``: one process of phase 22 (cold or warm), its
    readings written to SPEC's ``out`` as JSON."""
    import torch

    import mxnet_tpu_torch as mt

    with open(path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_and_limit()
    t0 = time.perf_counter()
    # the CUDA context and the profiler (CUPTI) start before any graph is
    # captured, in both workers: (c) traces replays of the fault-in's graphs
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    if spec["role"] == "warm":
        cc_keep_graphs(torch)
    fn = cc_cold if spec["role"] == "cold" else cc_warm
    res = fn(torch, mt, spec, card)
    res["cuda_start_s"] = start_s
    res["wall_s"] = time.perf_counter() - t0
    with open(spec["out"], "w") as f:
        json.dump(res, f, default=str)


def cc_process(spec, root, job):
    """Run one worker of phase 22 from ``root`` (its ``chip_smoke.py`` and
    package), its process kept in ``job["procs"]`` while it runs and its
    output lines added to ``job["lines"]``; its readings returned."""
    path = os.path.join(spec["tmp"], spec["role"] + ".spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, MXNET_COMPILE_CACHE_DIR=spec["cc"],
               MXNET_AUTOTUNE="record")
    for name in ("MXNET_AUTOTUNE_DIR", "MXNET_COMPILE_CACHE_STRICT"):
        env.pop(name, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(root, "chip_smoke.py"), "--cc-worker",
         path], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    job["procs"].append(proc)
    try:
        out, err = proc.communicate(timeout=CC_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    job["lines"] += out.splitlines()
    check(proc.returncode == 0, "the %s worker exited %s:\n%s"
          % (spec["role"], proc.returncode, err[-3000:]))
    with open(spec["out"]) as f:
        res = json.load(f)
    res["process_s"] = wall
    return res


def cc_workers(job):
    """Phase 22's cold worker, then its warm one in a fresh copy of the
    package (no _build/); their readings."""
    spec, here, walls = job["spec"], job["here"], job["walls"]
    t0 = time.perf_counter()
    cold = cc_process(dict(spec, role="cold",
                           out=os.path.join(spec["tmp"], "cold.json")),
                      here, job)
    walls["cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = os.path.join(spec["tmp"], "fresh")
    shutil.copytree(os.path.join(here, "mxnet_tpu_torch"),
                    os.path.join(fresh, "mxnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(here, "chip_smoke.py"), fresh)
    warm = cc_process(dict(spec, role="warm",
                           out=os.path.join(spec["tmp"], "warm.json")),
                      fresh, job)
    walls["warm"] = time.perf_counter() - t0
    return cold, warm, fresh


def compile_once_start(torch, mt):
    """Phase 22 (module docstring), its first half: the checkpoint, then
    the cold and the warm worker on a thread (``Background``), beside the
    phases main runs until ``compile_once_finish``.  The workers are
    processes of their own: nothing they launch reaches this process's
    counts.  Returns the job; ``compile_once_close`` stops it."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    job = {"card": card_and_limit(), "t_phase": time.perf_counter(),
           "walls": {}, "procs": [], "lines": [],
           "here": os.path.dirname(os.path.abspath(__file__)),
           "tmp": tempfile.mkdtemp(prefix="compile_once_")}
    tmp = job["tmp"]
    t0 = time.perf_counter()
    prefix, prefix2 = os.path.join(tmp, "lm"), os.path.join(tmp, "lm2")
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    srv_lm_checkpoint(torch, mt, net, prefix)
    for suffix in ("-symbol.json", "-0000.params"):
        os.link(prefix + suffix, prefix2 + suffix)
    del net
    torch.cuda.empty_cache()
    job["walls"]["checkpoint"] = time.perf_counter() - t0
    job["spec"] = {"tmp": tmp, "prefix": prefix, "prefix2": prefix2,
                   "cc": os.path.join(tmp, "cc"),
                   "cc2": os.path.join(tmp, "cc2")}
    job["workers"] = Background(cc_workers, job)
    print("compile_once: checkpoint written in %.2f s; the cold and warm "
          "workers run beside the phases that follow (their times are not "
          "the card's alone)" % job["walls"]["checkpoint"], flush=True)
    return job


def compile_once_close(job):
    """Stop phase 22's workers if they still run; remove its folder."""
    for proc in job["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(job["tmp"], ignore_errors=True)


def compile_once_finish(job):
    """Phase 22, its second half: the workers joined, their output and
    readings printed.  Returns the K1 launches of (c)'s scoring window
    and the user kernels' of (b), by path."""
    card, walls = job["card"], job["walls"]
    try:
        cold, warm, fresh = job["workers"].result()
    finally:
        for line in job["lines"]:
            print(line, flush=True)
        compile_once_close(job)
    check(warm["package"].startswith(fresh), "(b) the warm worker imported "
          "%s" % warm["package"])
    wall = time.perf_counter() - job["t_phase"]
    fc, fw = cold["fault"], warm["fault"]
    ac, aw = cold["again"], warm["again"]
    print("compile_once (e) (%s): the platform LM's fault-in as its "
          "process's first model work (after %.2f s cold, %.2f s warm of "
          "CUDA context and profiler start) %.2f s cold against %.2f s warm "
          "(%.2fx), in a process that ran the LM %.2f s cold against "
          "%.2f s warm (%.2fx; phase 21's cold fault-ins 5.05-6.40 s); "
          "footprint() against the card's reserved delta %.3fx cold, %.3fx "
          "warm (allocated %.3fx, %.3fx; S.13 with the estimate and no "
          "graphs: 0.668x allocated)"
          % (card, cold["cuda_start_s"], warm["cuda_start_s"],
             fc["fault_in_s"], fw["fault_in_s"],
             fc["fault_in_s"] / fw["fault_in_s"], ac["fault_in_s"],
             aw["fault_in_s"], ac["fault_in_s"] / aw["fault_in_s"],
             fc["ratio_reserved"], fw["ratio_reserved"], fc["ratio"],
             fw["ratio"]), flush=True)
    print("compile_once: walls %s; workers %.1f s cold, %.1f s warm; phase "
          "%.1f s from its checkpoint to its join on %s"
          % ({k: round(v, 2) for k, v in walls.items()}, cold["process_s"],
             warm["process_s"], wall, card), flush=True)
    print(json.dumps({"compile_once": {"card": card, "cold": cold,
                                       "warm": warm, "walls_s": walls,
                                       "wall_s": wall}}, default=str),
          flush=True)
    zero = {k: 0 for k in PS_NAMES}
    return ({"f32": {"compile_once": dict(zero,
                                          flash_fwd=warm["k1_launches"])}},
            warm["rtc_launches"])



# ---------------------------------------------------------------------------
# phase 23: observability and the guardian
# ---------------------------------------------------------------------------
OBS_WARMUP, OBS_STEPS = 2, 5
#: (b)'s iterator: batches of the train phase's shape; the poison lands
#: after batch OBS_POISON, the next snapshot is due at OBS_SNAP_EVERY
OBS_BATCHES, OBS_POISON, OBS_SNAP_EVERY = 11, 4, 4
OBS_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
#: the small LM's adam rollback, card against CPU: 10 applied float32
#: steps at the agree phase's adam (its 3 steps are held to 1e-4)
OBS_ADAM_TOL = 1e-3
OBS_ENV = {"MXNET_GUARDIAN_SNAPSHOT_EVERY": str(OBS_SNAP_EVERY),
           "MXNET_GUARDIAN_SKIP_MAX": "2", "MXNET_GUARDIAN_REWARM_STEPS": "50",
           "MXNET_GUARDIAN_ROLLBACK_MAX": "2", "MXNET_GUARDIAN_RING": "2"}


def obs_batch(mt, cfg, b, seed=SEED):
    """One batch as the train phase makes it (X, its next tokens)."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, cfg["vocab_size"], size=(b, cfg["seq_len"])).astype(
        np.float32)
    Y = (X + 1) % cfg["vocab_size"]
    return mt.io.NDArrayIter(X, Y, batch_size=b,
                             label_name="softmax_label").next(), Y


def obs_hand_flops(net, cfg, b):
    """PERF.md's hand count of one LM step: 6 x the product parameters x
    the tokens, plus the causal attention's products (forward 2, backward
    5, 2·d per visible pair) per layer."""
    shapes = {"data": (b, cfg["seq_len"]),
              "softmax_label": (b, cfg["seq_len"])}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    products = sum(int(np.prod(s)) for n, s in zip(net.list_arguments(),
                                                   arg_shapes)
                   if len(s) == 2 and not n.startswith("tok_embed"))
    s, h = cfg["seq_len"], cfg["num_heads"]
    d = cfg["hidden"] // h
    pairs = s * (s + 1) // 2
    attention = cfg["num_layers"] * 7 * 2 * d * pairs * b * h
    return 6 * products * b * s, attention, products


def obs_steps(torch, mt, mod, batch, n, per_step):
    """``n`` steps: their ms (host clock to a synchronize) and each step's
    K1-K3 launches held to ``per_step``."""
    times = []
    for i in range(n):
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: mt.kernels.LAUNCHES[k] - before[k] for k in PS_NAMES}
        check(all(v == per_step for v in got.values()),
              "observe: a step launched %s, expected %d of each"
              % (got, per_step))
    return times


def obs_guard_pass(torch, mt, mod):
    """The fused step's guard alone (``executor._guard_check``) on arrays of
    the step's shapes, float32 gradients one per parameter and the
    module's output: (ms by CUDA events, the bytes bound: each array read
    once over the card's memory rate)."""
    from mxnet_tpu_torch.executor import _guard_check

    ex = mod._exec_group.execs[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(ex.arg_dict[n].shape, device="cuda", generator=gen)
             for n in mod._exec_group.param_names]
    outs = [o._data for o in mod.get_outputs()]
    ms = cuda_ms(lambda: _guard_check(grads, outs), 10)
    nbytes = sum(t.numel() * t.element_size() for t in grads + outs)
    _, peak = peaks_for(torch.cuda.get_device_name(0))
    # the verdicts on the card: one NaN or inf in the output, one finite
    # gradient whose square overflows
    verdicts = {"clean": _guard_check(grads, outs)[0]}
    bad = outs[0].clone(memory_format=torch.contiguous_format)
    for what, value in (("nan output", np.nan), ("inf output", np.inf)):
        bad.view(-1)[bad.numel() // 2] = value
        verdicts[what] = _guard_check(grads, [bad] + outs[1:])[0]
    big = grads[0].clone()
    big.view(-1)[0] = 3e38
    verdicts["overflowing gradient"] = _guard_check([big] + grads[1:],
                                                    outs)[0]
    del grads, bad, big
    check(verdicts == {"clean": True, "nan output": False,
                       "inf output": False, "overflowing gradient": False},
          "observe (a): the guard's verdicts on the card %s" % verdicts)
    return ms, nbytes / (peak["tbs"] * 1e12) * 1e3, verdicts


def obs_cost(torch, mt, net, cfg, b, per_step, card):
    """(a): the LM's steps with telemetry and the guardian off and on, in
    turns.  Returns the module and its batch, for (d)."""
    tm, gd = mt.telemetry, mt.guardian
    batch, _ = obs_batch(mt, cfg, b)
    mt.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    mod = train_module(mt, net, None, (b, cfg["seq_len"]),
                       init=mt.init.Xavier(factor_type="in", magnitude=2.34),
                       compute_dtype="bfloat16")

    def turn(on):
        if on:
            tm.enable(trace=True)
            gd.enable()
            mod._guardian = gd.Guardian()
        else:
            tm.disable()
            gd.disable()
            mod._guardian = None

    got = {False: [], True: []}
    for on in (False, True):  # warm-up: each way's first build
        turn(on)
        obs_steps(torch, mt, mod, batch, OBS_WARMUP, per_step)
    trace = report = None
    for on in (False, True, True, False):
        turn(on)
        got[on] += obs_steps(torch, mt, mod, batch, OBS_STEPS, per_step)
        if on and len(got[on]) == 2 * OBS_STEPS:
            check(all(a == "ok" for a, _, _ in mod._guardian.history) and
                  mod._guardian_action == "ok", "observe (a): the guardian "
                  "answered %s on clean steps" % mod._guardian.history)
            ok, gnorm = mod._exec_group.execs[0]._guard_verdict
            check(ok and np.isfinite(gnorm), "observe (a): the step's "
                  "verdict (%s, %s)" % (ok, gnorm))
            report = tm.current_step_monitor().report()
            peak = torch.cuda.max_memory_allocated()
            trace = tm.merged_trace()
    parts = {}
    for name, (tele, guard) in (("telemetry only", (True, False)),
                                ("guardian only", (False, True))):
        turn(False)
        if tele:
            tm.enable(trace=True)
        if guard:
            gd.enable()
            mod._guardian = gd.Guardian()
        obs_steps(torch, mt, mod, batch, 1, per_step)
        parts[name] = float(np.mean(obs_steps(torch, mt, mod, batch,
                                              OBS_STEPS, per_step)))
    turn(False)
    guard_ms, guard_bound_ms, verdicts = obs_guard_pass(torch, mt, mod)
    off, on = float(np.mean(got[False])), float(np.mean(got[True]))
    hand, attention, products = obs_hand_flops(net, cfg, b)
    flops = report["flops_per_step"]
    check(flops and abs(flops / (hand + attention) - 1) <= 0.10,
          "observe (a): the step monitor counts %s flops a step, the hand "
          "count %.4g" % (flops, hand + attention))
    mfu = flops / (on / 1e3) / tm.peak_flops()
    check(report["device_peak_bytes"] == peak, "observe (a): the monitor's "
          "device_peak_bytes %s, torch.cuda.max_memory_allocated() %s"
          % (report["device_peak_bytes"], peak))
    tm.validate_trace(trace)
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    check({"Executor.fused_step"} <= names, "observe (a): the merged trace "
          "holds %s" % sorted(names))
    print("observe (a) (%s): step ms off %s, on %s; mean %.2f off, %.2f on: "
          "on/off %.4f; %d launches of each of K1-K3 a step both ways"
          % (card, ["%.2f" % t for t in got[False]],
             ["%.2f" % t for t in got[True]], off, on, on / off, per_step),
          flush=True)
    print("observe (a): after them, 1 + 5 steps each: %s; the guard's "
          "pass alone over the step's gradients and output %.4f ms by CUDA "
          "events (its host read included), its bytes bound %.4f ms; its "
          "verdicts (finite?) %s"
          % (", ".join("%s %.2f ms (%.4fx off)" % (k, v, v / off)
                       for k, v in parts.items()), guard_ms, guard_bound_ms,
             verdicts), flush=True)
    print("observe (a): the step monitor's flops_per_step %.6g (the eager "
          "plan's cost model), PERF.md's hand count %.6g = 6 x %d product "
          "parameters x %d tokens (%.6g) + causal attention (%.6g): %.4fx; "
          "MFU %.4f over %.0f TFLOP/s at the on steps' mean; the monitor's "
          "report %s" % (flops, hand + attention, products,
                         b * cfg["seq_len"], hand, attention,
                         flops / (hand + attention), mfu,
                         tm.peak_flops() / 1e12, report), flush=True)
    print("observe (a): device_peak_bytes %s == max_memory_allocated; the "
          "merged trace: %d events, spans %s"
          % (peak, len(trace["traceEvents"]), sorted(names)), flush=True)
    return mod, batch, {"off_ms": got[False], "on_ms": got[True],
                        "ratio": on / off, "parts_ms": parts,
                        "guard_ms": guard_ms, "guard_bound_ms": guard_bound_ms,
                        "flops": flops,
                        "hand_flops": hand + attention, "mfu": mfu,
                        "peak_bytes": peak}


def obs_profile(torch, mt, mod, batch, per_step, card):
    """(d): one step under ``profiler_set_state("run")``: the kineto trace
    holds K1-K3's device ops inside the ``Executor.fused_step`` range."""
    prof = mt.profiler
    with tempfile.TemporaryDirectory() as tmp:
        prof.profiler_set_config(mode="all",
                                 filename=os.path.join(tmp, "prof.json"))
        t0 = time.perf_counter()
        prof.profiler_set_state("run")
        t_start = time.perf_counter() - t0
        before = dict(mt.kernels.LAUNCHES)
        with prof.Frame("Module.fit:step", "fit"):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        host = {k: mt.kernels.LAUNCHES[k] - before[k] for k in PS_NAMES}
        t0 = time.perf_counter()
        prof.profiler_set_state("stop")
        t_stop = time.perf_counter() - t0
        path = prof.device_trace_path()
        check(path is not None and os.path.exists(path), "observe (d): no "
              "torch.profiler trace was written")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dump = prof.dump_profile()
        with open(dump) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]}
    # the range on the host (any thread: the backward's kernels launch
    # from autograd's device thread) and its projection on the card's
    # timeline (the launching thread's own kernels)
    cpu = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "user_annotation"
           and e.get("name") == "Executor.fused_step"]
    gpu = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "gpu_user_annotation"
           and e.get("name") == "Executor.fused_step"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    inside = {k: 0 for k in PS_NAMES}
    on_card = {k: 0 for k in PS_NAMES}
    for e in kernels:
        group = device_op_group(e)
        for k in PS_NAMES:
            if not group.endswith(k):
                continue
            t = launched.get(e.get("args", {}).get("correlation"))
            if t is not None and any(lo <= t <= hi for lo, hi in cpu):
                inside[k] += 1
            if any(lo <= e["ts"] < hi for lo, hi in gpu):
                on_card[k] += 1
    check(cpu and all(v == per_step for v in inside.values()) and
          host == inside, "observe (d): K1-K3 device ops launched inside "
          "the Executor.fused_step range %s (on its device range %s), host "
          "launches %s, expected %d" % (inside, on_card, host, per_step))
    check({"Module.fit:step", "Executor.fused_step"} <= spans,
          "observe (d): dump_profile holds %s" % sorted(spans))
    print("observe (d) (%s): profiler start %.2f s, stop and export %.2f s; "
          "%d device kernels in the step, K1-K3 launched inside the "
          "Executor.fused_step range %s (host count %s; inside its range on "
          "the card's timeline, the main thread's: %s); dump_profile spans "
          "%s" % (card, t_start, t_stop, len(kernels), inside, host,
                  on_card, sorted(spans)), flush=True)
    return {"start_s": t_start, "stop_s": t_stop, "inside": inside,
            "on_card_range": on_card}


def obs_bits(torch, tensors):
    """A tensor's bits as an integer view (NaN compares equal to itself)."""
    return [t.view(torch.int32) if t.element_size() == 4 else
            t.view(torch.int16) for t in tensors]


def obs_state(mod):
    """The module's parameters and optimizer states on the card."""
    ex = mod._exec_group.execs[0]
    out = [ex.arg_dict[n]._data for n in mod._exec_group.param_names]
    for idx in sorted(mod._updater.states):
        st = mod._updater.states[idx]
        for s in (st if isinstance(st, (list, tuple)) else [st]):
            if s is not None:
                out.append(s._data)
    return out


def obs_fit(torch, mt, net, cfg, b, optimizer, params, poison, ctx=None,
            compute_dtype="bfloat16", watch=False, arg_params=None,
            snapshot_every=OBS_SNAP_EVERY):
    """``Module.fit`` over OBS_BATCHES batches under the guardian; with
    ``poison`` a batch-end callback sets one element of the first weight
    to NaN once, after batch OBS_POISON.  Returns (losses of the applied
    steps by batch, the final parameters, guardian stats, the ring's
    snapshot and rollback seconds and bytes, the skipped steps checked)."""
    rng = np.random.RandomState(SEED + 1)
    X = rng.randint(0, cfg["vocab_size"], size=(
        OBS_BATCHES * b, cfg["seq_len"])).astype(np.float32)
    it = mt.io.NDArrayIter(X, (X + 1) % cfg["vocab_size"], batch_size=b,
                           label_name="softmax_label")
    mod = mt.mod.Module(net, label_names=("softmax_label",), context=ctx,
                        compute_dtype=compute_dtype)
    mt.guardian.reset_stats()
    losses, fired, held, checked = {}, [], [], [0]
    timing = {"snapshot_s": [], "snapshot_bytes": [], "rollback_s": [],
              "rollback_bytes": []}

    def nbytes(snapshot):
        return sum(v._data.numel() * v._data.element_size()
                   for part in ("arg", "aux")
                   for v in snapshot[part].values()) + \
            len(snapshot["updater"] or b"")

    def on_batch(param):
        outs = mod.get_outputs()[0]
        act = mod._guardian_action
        if act == "ok":
            lab = param.locals["data_batch"].label[0].asnumpy()
            losses[param.nbatch] = lm_loss(torch, outs, lab)
        elif watch and held:
            # a skipped step: every parameter and state keeps its bits
            now = obs_bits(torch, obs_state(mod))
            check(all(torch.equal(a, c) for a, c in zip(held[0], now)),
                  "observe (b): a %s step changed a parameter or an "
                  "optimizer state" % act)
            checked[0] += 1
        if poison and not fired and param.nbatch == OBS_POISON:
            fired.append(param.nbatch)
            arg, aux = mod.get_params()
            w = arg["layer0_qkv_weight"].asnumpy().copy()
            w[0, 0] = np.nan
            arg = dict(arg)
            arg["layer0_qkv_weight"] = mt.nd.array(w, arg[
                "layer0_qkv_weight"].context)
            mod.set_params(arg, aux)
            if watch:
                held.append([t.clone() for t in obs_bits(
                    torch, obs_state(mod))])

    snap, roll = mod._guardian_snapshot, mod._guardian_rollback

    def timed_snapshot(*a, **k):
        t0 = time.perf_counter()
        n = mt.guardian.stats()["snapshots"]
        snap(*a, **k)
        if mt.guardian.stats()["snapshots"] > n:
            timing["snapshot_s"].append(time.perf_counter() - t0)
            timing["snapshot_bytes"].append(nbytes(
                mod._guardian._ring[-1][1]))

    def timed_rollback(*a, **k):
        target = mod._guardian.rollback_target(
            lambda snapshot: snapshot.get("epoch") == 0)
        timing["rollback_bytes"].append(nbytes(target[1]))
        timing["rollback_nbatch"] = target[1]["nbatch"]
        t0 = time.perf_counter()
        out = roll(*a, **k)
        timing["rollback_s"].append(time.perf_counter() - t0)
        return out  # the replay's losses overwrite the poisoned batches

    mod._guardian_snapshot, mod._guardian_rollback = timed_snapshot, \
        timed_rollback
    os.environ["MXNET_GUARDIAN_SNAPSHOT_EVERY"] = str(snapshot_every)
    mt.random.seed(SEED)
    mod.fit(it, num_epoch=1, optimizer=optimizer, optimizer_params=params,
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
            arg_params=arg_params, batch_end_callback=on_batch,
            eval_metric="acc")
    check(mod._fused_ok, "observe (b): fit did not take the fused step")
    final = [t.clone() for t in obs_state(mod)[:len(
        mod._exec_group.param_names)]]
    return losses, final, mt.guardian.stats(), timing, checked[0], mod


def obs_guardian(torch, mt, net, cfg, b, card):
    """(b): the guardian on the fused path through ``Module.fit``: an
    uninterrupted run, then one poisoned after batch OBS_POISON whose
    ladder climbs skip -> re-warm -> rollback and replays."""
    tm = mt.telemetry
    per = {k: os.environ.get(k) for k in OBS_ENV}
    os.environ.update(OBS_ENV)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["MXNET_TELEMETRY_POSTMORTEM_DIR"] = tmp
            tm.enable(trace=True)
            mt.guardian.enable()
            t0 = time.perf_counter()
            # no snapshot but the first (the ring's copies change no
            # number; each full one takes seconds)
            clean, clean_final, st0, tc, _, mod = obs_fit(
                torch, mt, net, cfg, b, "sgd", OBS_SGD, poison=False,
                snapshot_every=OBS_BATCHES + 1)
            t_clean = time.perf_counter() - t0
            del mod
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            got, final, st, tp, checked, mod = obs_fit(
                torch, mt, net, cfg, b, "sgd", OBS_SGD, poison=True,
                watch=True)
            t_poisoned = time.perf_counter() - t0
            history = [a for a, _, _ in mod._guardian.history
                       if a != "ok"]
            trace = tm.merged_trace()
            post = tm.flight_recorder.last_path()
            reason = None
            if post:
                with open(post) as f:
                    reason = json.load(f)["reason"]
            del mod
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("MXNET_TELEMETRY_POSTMORTEM_DIR", None)
        for k, v in per.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tm.disable()
        mt.guardian.disable()
    check(st0["anomalies"] == 0 and st0["rollbacks"] == 0,
          "observe (b): the uninterrupted run's guardian %s" % st0)
    check(history == ["skip", "skip", "rewarm", "skip", "skip", "rollback"],
          "observe (b): the ladder answered %s" % history)
    check(st["rollbacks"] == 1 and checked == 5,
          "observe (b): %d rollbacks, %d skipped steps checked"
          % (st["rollbacks"], checked))
    check(reason == "guardian-rollback", "observe (b): the rollback's "
          "postmortem %s (%s)" % (post, reason))
    tm.validate_trace(trace)
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    check({"Module.fit:step", "Module.fit:epoch0",
           "Executor.fused_step"} <= names, "observe (b): the merged trace "
          "holds %s" % sorted(names))
    check(sorted(got) == sorted(clean) == list(range(OBS_BATCHES)) and
          all(got[k] == clean[k] for k in clean),
          "observe (b): the replay's losses %s, the uninterrupted run's %s"
          % (got, clean))
    same = all(torch.equal(a, c) for a, c in zip(
        obs_bits(torch, clean_final), obs_bits(torch, final)))
    check(same, "observe (b): the replay's parameters are not the "
          "uninterrupted run's bits")
    nbytes = tp["rollback_bytes"][0]
    check(tp["rollback_nbatch"] == OBS_POISON and
          nbytes == max(tp["snapshot_bytes"]), "observe (b): the rollback "
          "restored the snapshot of batch %s, %d bytes"
          % (tp["rollback_nbatch"], nbytes))
    snaps = ["%.3f s, %d bytes" % sb for sb in zip(
        tc["snapshot_s"] + tp["snapshot_s"],
        tc["snapshot_bytes"] + tp["snapshot_bytes"])]
    print("observe (b) (%s): fit over %d batches of %s, SGD momentum; the "
          "poisoned run's ladder %s, %d skipped steps held bit for bit, "
          "the rollback %.3f s to the snapshot of batch %d, %d bytes "
          "(%.2f GB: parameters and the pickled momentum); snapshots %s; "
          "the replay's %d losses and every parameter the uninterrupted "
          "run's bits; postmortem %s; fits %.1f s clean, %.1f s poisoned; "
          "guardian %s"
          % (card, OBS_BATCHES, (b, cfg["seq_len"]), history, checked,
             tp["rollback_s"][0], tp["rollback_nbatch"], nbytes,
             nbytes / 1e9, snaps, len(got), reason, t_clean, t_poisoned,
             st), flush=True)
    return {"rollback_s": tp["rollback_s"][0], "rollback_bytes": nbytes,
            "snapshots": snaps,
            "clean_losses": [clean[k] for k in sorted(clean)]}


def obs_adam_cpu(torch, mt, card):
    """(b) under adam, on the small LM: the ring's updater snapshot keeps
    adam's moments but not its update counts (ROADMAP.md C), so the
    replay is not an uninterrupted run's; the card's rolled-back run
    matches the CPU route's."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    with mt.NameManager():
        net = get_transformer_lm(**SMALL)
    shape = (BATCH, SMALL["seq_len"])
    # one numpy init for both routes, at the agree phase's float32 spread
    init = {k[4:]: v for k, v in lm_params(
        mt, net, {"data": shape, "softmax_label": shape},
        np.random.default_rng(SEED + 2), AGREE[None][0]).items()}
    per = {k: os.environ.get(k) for k in OBS_ENV}
    os.environ.update(OBS_ENV)
    mt.guardian.enable()
    got = {}
    try:
        for where, ctx in (("card", None), ("cpu", mt.cpu())):
            for poison in (False, True):
                _, final, st, _, _, mod = obs_fit(
                    torch, mt, net, SMALL, BATCH, AGREE_ADAM[0],
                    AGREE_ADAM[1], poison, ctx=ctx, compute_dtype=None,
                    arg_params=init)
                got[where, poison] = ([t.cpu() for t in final], st)
                del mod
    finally:
        mt.guardian.disable()
        for k, v in per.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gap = max((a - c).abs().max().item() for a, c in zip(
        got["card", True][0], got["card", False][0]))
    scale = max(c.abs().max().item() for c in got["cpu", True][0])
    err = max((a - c).abs().max().item() for a, c in zip(
        got["card", True][0], got["cpu", True][0])) / scale
    check(got["card", True][1]["rollbacks"] == 1 and gap > 0,
          "observe (b, adam): rollbacks %s, gap to the uninterrupted run %g"
          % (got["card", True][1], gap))
    check(err <= OBS_ADAM_TOL, "observe (b, adam): the card's rolled-back "
          "run within %.3g of the CPU route's (tolerance %g)"
          % (err, OBS_ADAM_TOL))
    print("observe (b, adam) (%s): the small LM under adam, rolled back "
          "once: its parameters %.3g (largest |difference|) from an "
          "uninterrupted run's (update counts run on, ROADMAP.md C), and "
          "within %.3g of the largest parameter (tolerance %g) of the CPU "
          "route's rolled-back run" % (card, gap, err, OBS_ADAM_TOL),
          flush=True)


#: (c)'s fault: the exponent's top bit of one element of the second
#: gradient the eager loop hands the fault site, the position embedding's,
#: which every token reads.  The first, the token embedding's, is zero in
#: every row the batch does not read, and the flip turns 0.0 into 2.0,
#: which is no anomaly.
OBS_FAULT = "guardian.grad:bitflip@#2"


def obs_eager(torch, mt, card):
    """(c): ``OBS_FAULT`` on a 2-layer LM at the full widths: the plan
    keeps the eager loop, whose guard reads every gradient's host copy;
    the answer is skip and nothing changes."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    cfg = dict(FULL, num_layers=2)
    with mt.NameManager():
        net = get_transformer_lm(**cfg)
    batch, _ = obs_batch(mt, cfg, BATCH)
    mt.guardian.enable()
    mt.guardian.reset_stats()
    mt.faults.install(mt.faults.FaultPlan(OBS_FAULT, seed=0))
    try:
        mt.random.seed(SEED)
        mod = train_module(mt, net, None, (BATCH, cfg["seq_len"]),
                           init=mt.init.Xavier(factor_type="in",
                                               magnitude=2.34),
                           compute_dtype="bfloat16")
        check(not mod._fused_ok, "observe (c): a guardian.grad plan left "
              "the fused step on")
        mod._guardian = mt.guardian.Guardian()
        before = [t.clone() for t in obs_bits(torch, obs_state(mod))]
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        action = mod._guardian_action
        same = all(torch.equal(a, c) for a, c in zip(
            before, obs_bits(torch, obs_state(mod))))
        st = mt.guardian.stats()
        del mod, before
    finally:
        mt.faults.uninstall()
        mt.guardian.disable()
    torch.cuda.empty_cache()
    check(action == "skip" and same and st["anomalies"] == 1,
          "observe (c): the eager guard answered %s, parameters unchanged "
          "%s, stats %s" % (action, same, st))
    print("observe (c) (%s): a 2-layer LM at the full widths, %s on the "
          "eager path: %s, every parameter and state the same bits, "
          "guardian %s; the step with the host guard %.1f ms"
          % (card, OBS_FAULT, action, st, ms), flush=True)
    return ms


def observe_phase(torch, mt, after_timed=None):
    """Phase 23 (module docstring).  Returns the K1-K3 launches of the
    phase's full-width bf16 runs.  ``after_timed()`` runs once the timed
    steps (a) and (d) are done."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    card = card_and_limit()
    t_phase = time.perf_counter()
    walls = {}
    with mt.NameManager():
        net = get_transformer_lm(**FULL)
    per_step = FULL["num_layers"]
    mt.kernels.reset_launches()
    t0 = time.perf_counter()
    mod, batch, cost = obs_cost(torch, mt, net, FULL, BATCH, per_step, card)
    walls["cost"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = obs_profile(torch, mt, mod, batch, per_step, card)
    walls["profile"] = time.perf_counter() - t0
    if after_timed is not None:
        after_timed()
    del mod, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    guard = obs_guardian(torch, mt, net, FULL, BATCH, card)
    walls["guardian"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager_ms = obs_eager(torch, mt, card)
    walls["eager"] = time.perf_counter() - t0
    launches = {k: mt.kernels.LAUNCHES[k] for k in PS_NAMES}
    t0 = time.perf_counter()
    obs_adam_cpu(torch, mt, card)
    walls["adam"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    print("observe: walls %s; phase %.1f s on %s; K1-K3 launches of the "
          "full-width runs %s" % ({k: round(v, 2) for k, v in walls.items()},
                                  wall, card, launches), flush=True)
    print(json.dumps({"observe": {"card": card, "cost": cost,
                                  "profile": prof, "guardian": guard,
                                  "eager_ms": eager_ms, "walls_s": walls,
                                  "wall_s": wall}}, default=str), flush=True)
    return {"bf16": {"observe": launches}}


# ---------------------------------------------------------------------------
# phase 24: the sparse plane
# ---------------------------------------------------------------------------
#: the MLPerf Training DLRM reference, facebookresearch/dlrm on Criteo
#: Terabyte with --max-ind-range=40000000: its 26 vocabularies (187,767,399
#: rows, 96.1 GB of float32 at dimension 128), at phase 21's widths
SPARSE_VOCABS = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
                 38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14,
                 39979771, 25641295, 39664984, 585935, 12972, 108, 36)
SPARSE_BATCH = PLAT_DLRM_BATCH
SPARSE_STEPS = 3           # (a), (b)
SPARSE_SNAP_AFTER = 2      # (b): both shards snapshot after this step
#: SGD as the reference's dlrm_s_criteo_terabyte.sh trains it (lr 1.0, no
#: momentum, no weight decay), the loss averaged over the batch (the
#: Module's rescale 1/batch)
SPARSE_SGD = {"learning_rate": 1.0}
SPARSE_RATIO = 10          # (a): logical bytes over resident bytes, at least
SPARSE_CMP_ROWS = 65536    # (c): every table's rows
SPARSE_CMP_STEPS = 2
#: (c)'s bound, 2 float32 ulps of each array's largest |value|: the server's
#: numpy rounds g x rescale and w - lr x g apart, the card's list update may
#: fuse them into one rounding.  At lr 1 and rescale 2^-11 both products
#: are exact and every id is unique within a batch (no sum in the table's
#: gradient), so the bits are expected to agree, and whether they do is
#: printed
SPARSE_TOL_ULPS = 2
SPARSE_TIMEOUT = 300


def sparse_symbols(mt, capacity, vocabs):
    with mt.NameManager():
        return mt.models.get_dlrm(vocab_sizes=list(vocabs), **dict(
            PLAT_DLRM, capacity=capacity))


def sparse_params(mt, net):
    """The dense layers' weights N(0, 1 / fan-in) from SEED, zero biases
    (numpy, so every run of the phase starts from the same bits); the
    tables' values come from the servers."""
    shapes = plat_dlrm_shapes(SPARSE_BATCH)
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(SEED + 24)
    params = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in shapes or name.endswith("_label") or \
                name.endswith("_embed_weight"):
            continue
        params[name] = (np.zeros(shape, np.float32) if name.endswith("_bias")
                        else (rng.standard_normal(shape)
                              / math.sqrt(shape[1])).astype(np.float32))
    return params


def sparse_batches(steps, vocabs, seed, unique=False):
    """Batches of 13 dense features, 26 bags of 8 ids (uniform in each
    table's vocabulary, or unique within the batch) and a click label.  The
    ids are int32: float32 holds integers exactly only up to 2^24, and four
    of the vocabularies pass 3.8e7."""
    rng = np.random.RandomState(seed)
    n = SPARSE_BATCH * PLAT_DLRM["bag_len"]
    out = []
    for _ in range(steps):
        data = [rng.randn(SPARSE_BATCH, PLAT_DLRM["dense_dim"]).astype(
            np.float32)]
        for v in vocabs:
            ids = rng.permutation(v)[:n] if unique else rng.randint(0, v, n)
            data.append(ids.reshape(SPARSE_BATCH, -1).astype(np.int32))
        label = rng.randint(0, 2, (SPARSE_BATCH, 1)).astype(np.float32)
        out.append((data, label))
    return out


def sparse_data_batch(mt, batch):
    data, label = batch
    return mt.io.DataBatch([mt.nd.array(d, mt.gpu(0)) for d in data],
                           [mt.nd.array(label, mt.gpu(0))])


class SparseEnv:
    """``env`` set in this process's environment, restored on exit; with
    ``lock``, held so no other thread sees it (a kvstore reads the DMLC
    variables when it is created, a client its retry budget whenever it
    connects)."""

    LOCK = threading.Lock()

    def __init__(self, env, lock=False):
        self.env, self.lock = env, lock

    def __enter__(self):
        if self.lock:
            self.LOCK.acquire()
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if self.lock:
            self.LOCK.release()


def sparse_worker_env(job):
    """The DMLC environment of this process as ``job``'s one worker."""
    return SparseEnv(dict(DMLC_PS_ROOT_URI="127.0.0.1",
                          DMLC_PS_ROOT_PORT=str(job.port),
                          DMLC_NUM_SERVER="2", DMLC_NUM_WORKER="1",
                          DMLC_WORKER_ID="0", MXNET_KVSTORE_SYNC="0"),
                     lock=True)


class SparseThread(threading.Thread):
    """``fn()`` on a thread of its own; ``result()`` joins it and returns
    its value or raises what it raised (a failed check included)."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.value, self.exc = fn, None, None
        self.start()

    def run(self):
        try:
            self.value = self.fn()
        except BaseException as e:
            self.exc = e

    def result(self):
        self.join()
        if self.exc is not None:
            raise self.exc
        return self.value


class SparseFleet:
    """Two servers in this process on gpu(0) (for (c), whose servers are
    killed by no one): what ``sparse_module`` and ``sparse_server_stats``
    read of a ``PSJob``."""

    def __init__(self, mt):
        from mxnet_tpu_torch import kvstore_server as kvs

        self.port = free_ports(2)
        self.servers = [kvs.start_server(port=self.port + i, ctx=mt.gpu(0))
                        for i in range(2)]

    def close(self):
        for srv in self.servers:
            srv.stop()


def sparse_start():
    """Start (a)'s and (b)'s server processes; the caller starts them while
    an earlier phase runs, so their start-up is over when phase 24 begins.
    Returns the jobs and the snapshot directory."""
    snap_dir = tempfile.mkdtemp(prefix="sparse_snap_")
    return {"a": PSJob("sparse_a", 2, 0, False),
            "b": PSJob("sparse_b", 2, 0, False,
                       MXNET_KVSTORE_SNAPSHOT_PATH=os.path.join(
                           snap_dir, "kv.snap"),
                       MXNET_KVSTORE_SNAPSHOT_INTERVAL="0"),
            "snap_dir": snap_dir}


def sparse_module(mt, net, slots, params, job):
    """A SparseEmbeddingModule on gpu(0) over ``job``'s two servers."""
    names = list(plat_dlrm_shapes(1))
    mod = mt.sparse.SparseEmbeddingModule(
        net, sparse_slots=slots, data_names=names,
        label_names=["ctr_label"], context=mt.gpu(0))
    shapes = plat_dlrm_shapes(SPARSE_BATCH)
    mod.bind(data_shapes=[(n, shapes[n]) for n in names],
             label_shapes=[("ctr_label", (SPARSE_BATCH, 1))])
    mod.init_params(arg_params={k: mt.nd.array(v, mt.gpu(0))
                                for k, v in params.items()},
                    aux_params={}, allow_missing=True)
    with sparse_worker_env(job):
        mod.init_optimizer(kvstore="dist_async", optimizer="sgd",
                           optimizer_params=dict(SPARSE_SGD))
    return mod


def sparse_server_stats(job):
    from mxnet_tpu_torch import kvstore_server as kvs

    out = []
    for i in range(2):
        with kvs.ServerClient("127.0.0.1", job.port + i) as c:
            out.append(c.stats())
    return out


def sparse_steps(torch, mt, mod, batches, job, tag, card, after_step=None):
    """Train ``batches`` through ``mod``; print each step's split: the
    route (ids uniquified, rows pulled, rows copied to the card), the
    executor's forward and backward on the card (CUDA events), the update
    (gradient rows to the host, the push submitted, then the wait for the
    servers to apply it), the servers' seconds in the row store and in the
    dense updater, and the bytes moved."""
    eg = mod._exec_group
    run_fb = eg.forward_backward
    events = []

    def timed_fb(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        run_fb(*a, **kw)
        ev[1].record()
        events.append(ev)

    eg.forward_backward = timed_fb
    kv = mod._kvstore
    rows = []
    before = sparse_server_stats(job)
    try:
        for step, batch in enumerate(batches):
            wire0 = dict(kv.inner.wire)
            t0 = time.perf_counter()
            mod.forward_backward(sparse_data_batch(mt, batch))
            t1 = time.perf_counter()
            mod.update()
            t2 = time.perf_counter()
            kv.wait_all()
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            st = mod.sparse_stats()["step"]
            after = sparse_server_stats(job)
            ev0, ev1 = events[-1]
            row = {"step": step, "route_s": {k: round(st[k], 4) for k in
                                             ("unique_s", "pull_s",
                                              "copy_s")},
                   "fb_ms": ev0.elapsed_time(ev1),
                   "forward_backward_s": t1 - t0,
                   "update_s": {"to_host_s": round(st["to_host_s"], 4),
                                "push_s": round(st["push_s"], 4),
                                "wait_s": round(t3 - t2, 4)},
                   "step_s": t3 - t0,
                   "server_rows_s": [round(a["sparse_seconds"]
                                           - b["sparse_seconds"], 4)
                                     for a, b in zip(after, before)],
                   "server_dense_s": [round(a["update_seconds"]
                                            - b["update_seconds"], 4)
                                      for a, b in zip(after, before)],
                   "pulled_rows_bytes": st["pulled_bytes"],
                   "pushed_rows_bytes": st["pushed_bytes"],
                   "dense_push_bytes": kv.inner.wire["push_bytes"]
                   - wire0["push_bytes"],
                   "dense_pull_bytes": kv.inner.wire["pull_bytes"]
                   - wire0["pull_bytes"]}
            rows.append(row)
            before = after
            print("sparse %s: step %d %.3f s: route unique %.3f, pull %.3f, "
                  "copy to the card %.3f s; forward+backward %.3f ms on the "
                  "card; update: rows to the host %.3f, push %.3f, wait for "
                  "the servers %.3f s; servers' row store %s s, dense "
                  "updater %s s; rows pulled %d B, pushed %d B; dense %d B "
                  "pushed, %d B pulled (%s)"
                  % (tag, step, row["step_s"], st["unique_s"], st["pull_s"],
                     st["copy_s"], row["fb_ms"], st["to_host_s"],
                     st["push_s"], t3 - t2, row["server_rows_s"],
                     row["server_dense_s"], st["pulled_bytes"],
                     st["pushed_bytes"], row["dense_push_bytes"],
                     row["dense_pull_bytes"], card), flush=True)
            if after_step is not None:
                after_step(step)
                before = sparse_server_stats(job)
    finally:
        eg.forward_backward = run_fb
    return rows


def sparse_touched(batches, nslots):
    ids = [set() for _ in range(nslots)]
    for data, _label in batches:
        for i in range(nslots):
            ids[i].update(np.unique(data[1 + i]).astype(np.int64).tolist())
    return [np.array(sorted(s), np.int64) for s in ids]


def sparse_digest(mod, touched, keys):
    """Each table's touched rows, pulled, as a sha256 of their bytes."""
    import hashlib

    out = []
    for key, ids in zip(keys, touched):
        out.append(hashlib.sha256(
            mod.sparse_plane.pull_rows(key, ids).tobytes()).hexdigest())
    return out


def sparse_train(torch, mt, net, slots, params, batches, probe, job, tag,
                 card, kill=False):
    """(a), or with ``kill`` (b): SPARSE_STEPS steps over ``job``'s
    fleet.  Returns the per-step rows, the touched rows' digests, the probe
    batch's outputs, the servers' table_info and the module's stats."""
    mod = sparse_module(mt, net, slots, params, job)
    kv = mod._kvstore
    kill_s = {}

    def after_step(step):
        if not kill or step + 1 != SPARSE_SNAP_AFTER:
            return
        from mxnet_tpu_torch import kvstore_server as kvs

        t0 = time.perf_counter()
        mod.sparse_plane.wait()
        kv.wait_all()
        for i in range(2):
            with kvs.ServerClient("127.0.0.1", job.port + i) as c:
                check(c.snapshot() is not None, "sparse (b): server %d "
                      "wrote no snapshot" % i)
        t1 = time.perf_counter()
        victim = job.servers[1]
        victim.kill()
        victim.wait(timeout=SPARSE_TIMEOUT)
        check(victim.returncode == -9, "sparse (b): server 1 exited %s, "
              "not by SIGKILL" % victim.returncode)
        job.server(1)
        with kvs.ServerClient("127.0.0.1", job.port + 1) as c:
            c.membership()  # answered once it has restored and listens
        t2 = time.perf_counter()
        kill_s.update(snapshot_s=t1 - t0, restart_s=t2 - t1)
        print("sparse (b): both shards snapshotted in %.3f s after step %d; "
              "server 1 SIGKILLed, restarted and restored in %.3f s (%s)"
              % (t1 - t0, step, t2 - t1, card), flush=True)

    try:
        rows = sparse_steps(torch, mt, mod, batches, job, tag, card,
                            after_step)
        mod.sparse_plane.wait()
        kv.wait_all()
        keys = [slots["slot%d" % i]["weight"] for i in range(len(slots))]
        infos = mod.sparse_plane.table_info()
        t0 = time.perf_counter()
        digests = sparse_digest(mod, sparse_touched(batches, len(slots)),
                                keys)
        digest_s = time.perf_counter() - t0
        mod.forward(sparse_data_batch(mt, probe), is_train=False)
        out = mod.get_outputs()[0].asnumpy()
        stats = mod.sparse_stats()
    finally:
        kv.close()
    return {"rows": rows, "digests": digests, "out": out, "infos": infos,
            "stats": stats, "keys": keys, "kill_s": kill_s,
            "digest_s": digest_s}


def sparse_gates(run, card):
    """(a)'s gates: each server holds part of every table (0 < rows <
    total), no row on the wrong shard, the worker's logical bytes at least
    SPARSE_RATIO times its resident bytes; every output finite."""
    infos, stats = run["infos"], run["stats"]
    for key in run["keys"]:
        rows = [info[key]["rows"] for info in infos]
        check(all(0 < r < sum(rows) for r in rows), "sparse (a): table %s "
              "rows by server %s" % (key, rows))
        check(all(info[key]["misplaced"] == 0 for info in infos),
              "sparse (a): table %s holds misplaced rows" % key)
    logical = sum(s["logical_bytes"] for s in stats["slots"].values())
    resident = sum(s["resident_bytes"] for s in stats["slots"].values())
    check(logical >= SPARSE_RATIO * resident, "sparse (a): logical %d B < "
          "%d x resident %d B" % (logical, SPARSE_RATIO, resident))
    check(run["out"].shape == (SPARSE_BATCH, 1) and
          bool(np.all(np.isfinite(run["out"]))), "sparse (a): the probe's "
          "outputs are not finite of shape (%d, 1)" % SPARSE_BATCH)
    held = [sum(info[k]["rows"] for k in run["keys"]) for info in infos]
    nbytes = [sum(info[k]["bytes"] for k in run["keys"]) for info in infos]
    print("sparse (a): %d logical rows, %d rows held by the servers %s "
          "(%s B), misplaced 0; worker logical %d B / resident %d B = %.1fx; the "
          "touched rows' digests pulled in %.3f s (%s)"
          % (sum(SPARSE_VOCABS), sum(held), held, nbytes, logical, resident,
             logical / resident, run["digest_s"], card), flush=True)
    return {"held_rows": held, "held_bytes": nbytes,
            "logical_over_resident": logical / resident}


def sparse_against_dense(torch, mt, params, job, card):
    """(c): SPARSE_CMP_STEPS steps of SparseEmbeddingModule over ``job``'s
    servers against a plain Module holding the full tables on the card,
    from the same tables (the touched rows pulled from the servers first)
    and dense weights, with ids unique within a batch."""
    vocabs = (SPARSE_CMP_ROWS,) * PLAT_DLRM["num_slots"]
    snet, slots = sparse_symbols(mt, PLAT_DLRM["capacity"], vocabs)
    dnet, _ = sparse_symbols(mt, SPARSE_CMP_ROWS, vocabs)
    batches = sparse_batches(SPARSE_CMP_STEPS, vocabs, SEED + 243,
                             unique=True)
    touched = sparse_touched(batches, len(vocabs))
    smod = sparse_module(mt, snet, slots, params, job)
    keys = [slots["slot%d" % i]["weight"] for i in range(len(vocabs))]
    try:
        init = dict(params)
        for key, ids in zip(keys, touched):
            table = np.zeros((SPARSE_CMP_ROWS, PLAT_DLRM["embed_dim"]),
                             np.float32)
            table[ids] = smod.sparse_plane.pull_rows(key, ids)
            init[key] = table
        names = list(plat_dlrm_shapes(1))
        shapes = plat_dlrm_shapes(SPARSE_BATCH)
        dmod = mt.mod.Module(dnet, data_names=names,
                             label_names=["ctr_label"], context=mt.gpu(0))
        dmod.bind(data_shapes=[(n, shapes[n]) for n in names],
                  label_shapes=[("ctr_label", (SPARSE_BATCH, 1))])
        dmod.init_params(arg_params={k: mt.nd.array(v, mt.gpu(0))
                                     for k, v in init.items()},
                         aux_params={})
        dmod.init_optimizer(kvstore=None, optimizer="sgd",
                            optimizer_params=dict(SPARSE_SGD))
        del init
        for batch in batches:
            for mod in (dmod, smod):
                mod.forward_backward(sparse_data_batch(mt, batch))
                mod.update()
        smod.sparse_plane.wait()
        smod._kvstore.wait_all()
        dargs = dmod.get_params()[0]
        sargs = smod.get_params()[0]
        worst, bitwise = {}, True
        pairs = [(key, smod.sparse_plane.pull_rows(key, ids),
                  dargs[key].asnumpy()[ids])
                 for key, ids in zip(keys, touched)]
        pairs += [(name, sargs[name].asnumpy(), dargs[name].asnumpy())
                  for name in sorted(params)]
        for name, got, ref in pairs:
            err = float(np.abs(got - ref).max())
            bound = SPARSE_TOL_ULPS * np.finfo(np.float32).eps * \
                float(np.abs(ref).max())
            check(err <= bound, "sparse (c): %s off the dense Module by %.3g "
                  "> %.3g (%d ulps of its largest |value|)"
                  % (name, err, bound, SPARSE_TOL_ULPS))
            worst[name] = err
            bitwise = bitwise and got.tobytes() == ref.tobytes()
    finally:
        smod._kvstore.close()
    tables = max(worst[k] for k in keys)
    dense = max(worst[n] for n in params)
    print("sparse (c): %d steps, 26 tables of %d rows, ids unique within a "
          "batch: SparseEmbeddingModule over 2 servers against a Module "
          "holding the tables on the card: rows off by %.3g, dense weights "
          "by %.3g (bound %d ulps of each array's largest |value|); every "
          "array bit for bit: %s (%s)"
          % (SPARSE_CMP_STEPS, SPARSE_CMP_ROWS, tables, dense,
             SPARSE_TOL_ULPS, bitwise, card), flush=True)
    return {"rows_err": tables, "dense_err": dense, "bitwise": bitwise}


def sparse_phase(torch, mt, started=None):
    """Phase 24 (module docstring).  ``started``: sparse_start()'s servers,
    else they start here."""
    card = card_and_limit()
    t_phase = time.perf_counter()
    # a restarted server takes seconds to come back: every client of the
    # phase keeps retrying for up to a minute
    retry = SparseEnv(dict(MXNET_KVSTORE_RETRY_MAX="600",
                           MXNET_KVSTORE_RETRY_MAX_MS="100"))
    retry.__enter__()
    jobs = dict(started or sparse_start())
    snap_dir = jobs.pop("snap_dir")
    walls, servers = {}, {}
    try:
        t0 = time.perf_counter()
        net, slots = sparse_symbols(mt, PLAT_DLRM["capacity"], SPARSE_VOCABS)
        params = sparse_params(mt, net)
        walls["symbol"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = sparse_batches(SPARSE_STEPS, SPARSE_VOCABS, SEED + 24)
        probe = sparse_batches(1, SPARSE_VOCABS, SEED + 241)[0]
        walls["data"] = time.perf_counter() - t0
        runs = {}
        t0 = time.perf_counter()
        runs["a"] = sparse_train(torch, mt, net, slots, params, batches,
                                 probe, jobs["a"], "a", card)
        walls["a"] = time.perf_counter() - t0
        servers["a"] = sparse_server_stats(jobs["a"])
        jobs["a"].close()
        # (c) runs beside (b), which gates on bits: (b)'s times are
        # printed as such
        t0 = time.perf_counter()
        jobs["c"] = SparseFleet(mt)
        cmp_thread = SparseThread(lambda: sparse_against_dense(
            torch, mt, params, jobs["c"], card))
        runs["b"] = sparse_train(torch, mt, net, slots, params, batches,
                                 probe, jobs["b"], "b (beside (c))", card,
                                 kill=True)
        walls["b"] = time.perf_counter() - t0
        servers["b"] = sparse_server_stats(jobs["b"])
        jobs["b"].close()
        cmp = cmp_thread.result()
        walls["b+c"] = time.perf_counter() - t0
        servers["c"] = sparse_server_stats(jobs["c"])
        gates = sparse_gates(runs["a"], card)
        check(runs["b"]["digests"] == runs["a"]["digests"], "sparse (b): "
              "the touched rows after a SIGKILL and restart differ from "
              "(a)'s")
        check(runs["b"]["out"].tobytes() == runs["a"]["out"].tobytes(),
              "sparse (b): the probe's outputs after a SIGKILL and restart "
              "differ from (a)'s")
        check(servers["b"][1]["restored"], "sparse (b): server 1's stats "
              "do not say it was restored")
        print("sparse (b): touched rows of the 26 tables and the probe's "
              "outputs bit for bit (a)'s; server 1 restored from its "
              "snapshot (%s)" % card, flush=True)
    finally:
        for job in jobs.values():
            job.close()
        shutil.rmtree(snap_dir, ignore_errors=True)
        retry.__exit__()
    wall = time.perf_counter() - t_phase
    print("sparse: walls %s; phase %.1f s on %s"
          % ({k: round(v, 2) for k, v in walls.items()}, wall, card),
          flush=True)
    print(json.dumps({"sparse": {
        "card": card, "rows": sum(SPARSE_VOCABS),
        "a": runs["a"]["rows"], "b": runs["b"]["rows"],
        "b_kill_s": runs["b"]["kill_s"], "gates": gates, "c": cmp,
        "servers": {t: [{k: s[k] for k in ("applied_pushes",
                                           "applied_row_pushes",
                                           "sparse_seconds",
                                           "update_seconds", "ctx",
                                           "device_peak_bytes", "restored")}
                        for s in ss] for t, ss in servers.items()},
        "walls_s": walls, "wall_s": wall}}, default=str), flush=True)

# ---------------------------------------------------------------------------
# phase 25: the long tail
# ---------------------------------------------------------------------------
LT_WARMUP, LT_STEPS = 1, 3      # (a): each way, in turns
LT_NAIVE_STEPS = 1 + 3          # (b)
LT_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: (a): the remat step's K1 runs forward and recompute (12, 6, 6)
LT_REMAT_LAUNCHES = {"flash_fwd": 2 * FULL["num_layers"],
                     "flash_bwd_dq": FULL["num_layers"],
                     "flash_bwd_dkv": FULL["num_layers"]}
LT_FLOPS_TOL = 0.10             # (a): the cost model against the hand count
# (c): BVLC AlexNet's published deploy.prototxt (models/bvlc_alexnet in
# BVLC/caffe), its input batch set to ALEX_BATCH
ALEX_BATCH = 32
ALEX_PROTOTXT = """
name: "AlexNet"
layer { name: "data" type: "Input" top: "data"
  input_param { shape: { dim: %d dim: 3 dim: 227 dim: 227 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 96 kernel_size: 11 stride: 4 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 256 pad: 2 kernel_size: 5 group: 2 } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "norm2" type: "LRN" bottom: "conv2" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool2" type: "Pooling" bottom: "norm2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "conv3" type: "Convolution" bottom: "pool2" top: "conv3"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 } }
layer { name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3" }
layer { name: "conv4" type: "Convolution" bottom: "conv3" top: "conv4"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu4" type: "ReLU" bottom: "conv4" top: "conv4" }
layer { name: "conv5" type: "Convolution" bottom: "conv4" top: "conv5"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 256 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu5" type: "ReLU" bottom: "conv5" top: "conv5" }
layer { name: "pool5" type: "Pooling" bottom: "conv5" top: "pool5"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "fc6" type: "InnerProduct" bottom: "pool5" top: "fc6"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 4096 } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 4096 } }
layer { name: "relu7" type: "ReLU" bottom: "fc7" top: "fc7" }
layer { name: "drop7" type: "Dropout" bottom: "fc7" top: "fc7"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc8" type: "InnerProduct" bottom: "fc7" top: "fc8"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 1000 } }
layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }
""" % ALEX_BATCH
#: (c): the blobs' shapes (the grouped convolutions see half the channels)
ALEX_BLOBS = {"conv1": (96, 3, 11, 11), "conv2": (256, 48, 5, 5),
              "conv3": (384, 256, 3, 3), "conv4": (384, 192, 3, 3),
              "conv5": (256, 192, 3, 3), "fc6": (4096, 9216),
              "fc7": (4096, 4096), "fc8": (1000, 4096)}
# per image: 2 x its 724,406,816 multiply-adds (conv1-5 105.4M, 223.9M,
# 149.5M, 112.1M, 74.8M; fc6-8 37.7M, 16.8M, 4.1M)
ALEX_GFLOP = 1.448813632
ALEX_P100_IMG_S = 4883.77       # BASELINE.md: MXNet's AlexNet, batch 32
ALEX_REPS = (2, 10)             # warm-up, timed batches
LT_TOL = 1e-4                   # (c), (d)
LT_CAPI_REPS = (1, 3)           # (d): warm-up, timed forwards
LT_DEMO = (10, 6)               # (d): the demo's batch and input width
LT_SHARD_TOL = 1e-3             # (e): as phase 18's limits
LT_SHARD_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
LT_SHARD_STEPS = 3
LT_PROBE_CTX = "gpu"            # (e): the probe's contexts


class LtEnv:
    """Environment variables set for a block, restored after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lt_step(torch, mt, mod, batch, Y, two_phase=False):
    """One train step: (ms on the host clock to a synchronize, the step's
    peak device memory above its start in GB, the loss, its K1-K3
    launches)."""
    before = dict(mt.kernels.LAUNCHES)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if two_phase:
        mod._exec_group.forward_backward(batch)
    else:
        mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - start) / 1e9
    return (ms, peak, lm_loss(torch, mod.get_outputs()[0], Y),
            kernel_delta(mt, before))


def lt_same_params(torch, a, b):
    """Whether two LM Modules' parameters are the same bits."""
    ea, eb = a._exec_group.execs[0], b._exec_group.execs[0]
    return all(torch.equal(ea.arg_dict[n]._data, eb.arg_dict[n]._data)
               for n in a._exec_group.param_names)


def lt_lm(torch, mt, net):
    """The train phase's Module: bf16, adam, Xavier from SEED."""
    mt.random.seed(SEED)
    return train_module(mt, net, None, (BATCH, FULL["seq_len"]),
                        init=mt.init.Xavier(factor_type="in",
                                            magnitude=2.34),
                        compute_dtype="bfloat16")


def lt_remat(torch, mt, net, batch, Y, card):
    """(a): remat off and on in turns, from one init."""
    from mxnet_tpu_torch.telemetry.step_monitor import fused_cost_analysis

    mods = {False: lt_lm(torch, mt, net), True: lt_lm(torch, mt, net)}
    check(lt_same_params(torch, mods[False], mods[True]), "long_tail (a): "
          "the two Modules' inits differ")
    want = {False: {n: FULL["num_layers"] for n in LT_NAMES},
            True: LT_REMAT_LAUNCHES}
    got = {False: [], True: []}
    order = [False, True] * LT_WARMUP + [False, True, True, False, False,
                                         True][:2 * LT_STEPS]
    for on in order:
        # the flag is read when a step key is first built: the remat
        # Module's first step builds it with the flag on, and it stays so
        with LtEnv(**({"MXNET_BACKWARD_DO_MIRROR": "1"} if on else {})):
            step = lt_step(torch, mt, mods[on], batch, Y)
        check(step[3] == want[on], "long_tail (a): a step with remat %s "
              "launched %s, expected %s" % (on, step[3], want[on]))
        check(np.isfinite(step[2]), "long_tail (a): a loss is not finite")
        got[on].append(step)
    losses = {on: [s[2] for s in got[on]] for on in got}
    check(losses[True] == losses[False], "long_tail (a): remat on gave the "
          "losses %s, off %s" % (losses[True], losses[False]))
    check(lt_same_params(torch, mods[False], mods[True]), "long_tail (a): "
          "the parameters after the steps differ with remat on and off")
    ex_on = mods[True]._exec_group.execs[0]
    check(all(ex_on._remat.values()) and ex_on._remat, "long_tail (a): the "
          "remat Module's step keys %s" % ex_on._remat)
    timed = {on: got[on][LT_WARMUP:] for on in got}
    ms = {on: float(np.mean([s[0] for s in timed[on]])) for on in got}
    peak = {on: max(s[1] for s in timed[on]) for on in got}
    tokens = BATCH * FULL["seq_len"]
    hand, attention, products = obs_hand_flops(net, FULL, BATCH)
    # the recomputed forward adds 2 of the 6 product units and 2 of the
    # attention's 7 (forward 2, backward 5)
    hand_remat = hand * 8 / 6 + attention * 9 / 7
    flops = {on: fused_cost_analysis(mods[on]._exec_group.execs[0])["flops"]
             for on in got}
    check(abs(flops[True] / hand_remat - 1) <= LT_FLOPS_TOL,
          "long_tail (a): the cost model counts %.6g flops in a remat "
          "step, the hand count with the forward twice %.6g"
          % (flops[True], hand_remat))
    for on in (False, True):
        print("long_tail (a) remat %s (%s): step ms %s (mean %.2f), tokens/s "
              "%.1f, the step's peak above its start %.3f GB, losses %s, "
              "launches a step %s"
              % ("on" if on else "off", card,
                 ["%.2f" % s[0] for s in timed[on]], ms[on],
                 tokens / ms[on] * 1e3, peak[on],
                 ["%.6f" % s[2] for s in got[on]], want[on]), flush=True)
    print("long_tail (a): on/off step %.4fx, peak %.4fx; losses and "
          "parameters after %d steps the same bits; the step monitor's "
          "flops_per_step %.6g off, %.6g on; the hand count with the "
          "forward twice %.6g (%.4fx)"
          % (ms[True] / ms[False], peak[True] / peak[False],
             LT_WARMUP + LT_STEPS, flops[False], flops[True], hand_remat,
             flops[True] / hand_remat), flush=True)
    return mods, {"off_ms": [s[0] for s in timed[False]],
                  "on_ms": [s[0] for s in timed[True]],
                  "on_off": ms[True] / ms[False],
                  "off_peak_gb": peak[False], "on_peak_gb": peak[True],
                  "tokens_s_off": tokens / ms[False] * 1e3,
                  "tokens_s_on": tokens / ms[True] * 1e3,
                  "flops_off": flops[False], "flops_on": flops[True],
                  "hand_remat": hand_remat}


def lt_two_phase_and_site(torch, mt, mods, batch, Y, card):
    """(a), after (b): the two-phase ``forward_backward`` route with remat
    against it without, one step from the same parameters; then the
    ``fused_step`` site once in record mode on the remat-off Module."""
    import importlib

    steps = {}
    for on in (False, True):
        with LtEnv(**({"MXNET_BACKWARD_DO_MIRROR": "1"} if on else {})):
            steps[on] = lt_step(torch, mt, mods[on], batch, Y,
                                two_phase=True)
    check(steps[True][3] == LT_REMAT_LAUNCHES, "long_tail (a): the "
          "two-phase remat step launched %s" % (steps[True][3],))
    check(steps[True][2] == steps[False][2] and
          lt_same_params(torch, mods[False], mods[True]), "long_tail (a): "
          "the two-phase step with remat is not the bits of the one "
          "without")
    print("long_tail (a): the two-phase route, one step each way: %.2f ms "
          "off, %.2f ms remat on, the same loss %.6f and parameters; remat "
          "launches %s" % (steps[False][0], steps[True][0], steps[True][2],
                           steps[True][3]), flush=True)
    atdb = importlib.import_module("mxnet_tpu_torch.autotune.db")
    tune_dir = tempfile.mkdtemp(prefix="lt_autotune_")
    ex = mods[False]._exec_group.execs[0]
    try:
        with LtEnv(MXNET_AUTOTUNE="record", MXNET_AUTOTUNE_DIR=tune_dir):
            mt.autotune.reset_for_tests()
            ex._fused_sites.clear()   # the site is consulted again
            ex._remat.clear()
            t0 = time.perf_counter()
            step = lt_step(torch, mt, mods[False], batch, Y)
            site_s = time.perf_counter() - t0
        entries = [e for e in atdb.ls_entries(tune_dir)
                   if e["site"] == "fused_step"]
        check(len(entries) == 1, "long_tail (a): the fused_step site "
              "recorded %d entries" % len(entries))
        win = atdb.show_winner(entries[0]["path"])
    finally:
        mt.autotune.reset_for_tests()
        shutil.rmtree(tune_dir, ignore_errors=True)
    scores = {int(c["remat"]): s for c, s in win["provenance"]["scores"]}
    winner = bool(win["config"]["remat"])
    (key,) = [k for k in ex._remat if k[0] == "fused"]
    check(sorted(scores) == [0, 1], "long_tail (a): the site scored %s"
          % scores)
    check(ex._remat[key] == winner, "long_tail (a): the step runs remat "
          "%s, the site's winner %s" % (ex._remat[key], winner))
    check(step[3] == (LT_REMAT_LAUNCHES if winner else
                      {n: FULL["num_layers"] for n in LT_NAMES}),
          "long_tail (a): the step after the site launched %s" % step[3])
    print("long_tail (a): the fused_step site in record mode (%s): roofline "
          "ms remat off %.4f, on %.4f; winner %s; the step ran remat %s "
          "(%s launches) in %.2f s, the site's scoring included"
          % (card, scores[0], scores[1], win["config"], ex._remat[key],
             step[3], site_s), flush=True)
    return {"two_phase_ms": {"off": steps[False][0], "on": steps[True][0]},
            "site_scores_ms": scores, "site_winner": win["config"],
            "site_s": site_s}


def lt_naive(torch, mt, net, batch, Y, ref, card):
    """(b): the same LM under the NaiveEngine, the compile cache's
    directory set, against the remat-off Module ``ref`` (LT_NAIVE_STEPS
    steps from the same init)."""
    from mxnet_tpu_torch import compile_cache

    cache_dir = tempfile.mkdtemp(prefix="lt_cache_")
    try:
        with LtEnv(MXNET_ENGINE_TYPE="NaiveEngine",
                   MXNET_COMPILE_CACHE_DIR=cache_dir):
            compile_cache.reset_stats()
            mod = lt_lm(torch, mt, net)
            ex = mod._exec_group.execs[0]
            check(ex._naive, "long_tail (b): the executor is not naive")
            steps = [lt_step(torch, mt, mod, batch, Y)
                     for _ in range(LT_NAIVE_STEPS)]
            mod.forward(batch, is_train=False)
            mod.get_outputs()[0].wait_to_read()
            torch.cuda.synchronize()
            stats = compile_cache.stats()
            files = [f for _, _, fs in os.walk(cache_dir) for f in fs]
        check(not files and stats["stores"] == 0 and stats["hits"] == 0
              and stats["misses"] == 0, "long_tail (b): the NaiveEngine "
              "made cache entries %s (stats %s)" % (files, stats))
        check(not ex._jit_cache and ex._graph_pool is None, "long_tail (b): "
              "the NaiveEngine made a wrapper or a CUDA graph")
        for s in steps:
            check(s[3] == {n: FULL["num_layers"] for n in LT_NAMES},
                  "long_tail (b): a step launched %s" % s[3])
        check(lt_same_params(torch, mod, ref), "long_tail (b): the "
              "NaiveEngine's parameters are not the default engine's bits")
        losses = [s[2] for s in steps]
    finally:
        compile_cache.reset_stats()
        shutil.rmtree(cache_dir, ignore_errors=True)
    ms = float(np.mean([s[0] for s in steps[1:]]))
    print("long_tail (b) NaiveEngine (%s): step ms %s (mean %.2f after the "
          "first), losses %s, parameters the default engine's bits; no "
          "cache entry (stats %s) and no CUDA graph, with an inference "
          "forward too" % (card, ["%.2f" % s[0] for s in steps], ms,
                           ["%.6f" % x for x in losses], stats), flush=True)
    del mod, ex
    return {"ms": [s[0] for s in steps], "losses": losses}


def lt_alexnet_blobs(rng):
    """Seeded AlexNet blobs: He-scaled N(0, 2 / fan-in) weights, zero
    biases."""
    blobs = {}
    for name, shape in ALEX_BLOBS.items():
        fan_in = int(np.prod(shape[1:]))
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(np.sqrt(2.0 / fan_in))
        blobs[name] = [w, np.zeros(shape[0], np.float32)]
    return blobs


def lt_caffe(torch, mt, card):
    """(c): AlexNet from its prototxt and a seeded caffemodel, scored in
    float32 at batch ALEX_BATCH through ``Predictor`` on the card and on
    the CPU route."""
    rng = np.random.default_rng(SEED + 25)
    t0 = time.perf_counter()
    model = mt.caffe.encode_caffemodel(lt_alexnet_blobs(rng))
    with mt.cpu(), mt.NameManager():
        sym, args, aux = mt.caffe.convert_model(ALEX_PROTOTXT, model)
    convert_s = time.perf_counter() - t0
    x = rng.standard_normal((ALEX_BATCH, 3, 227, 227), dtype=np.float32)
    shapes = {"data": x.shape}
    params = dict(args)
    params.update({"aux:" + k: v for k, v in aux.items()})
    pred = mt.Predictor(sym, params, shapes, ctx=mt.gpu(0))
    out = pred.forward(data=x)[0]
    check(out.context == mt.gpu(0) and out.shape == (ALEX_BATCH, 1000),
          "long_tail (c): AlexNet answered %s on %s" % (out.shape,
                                                       out.context))
    card_out = out.asnumpy()
    for _ in range(ALEX_REPS[0]):
        pred.forward(data=x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ALEX_REPS[1]):
        pred.forward(data=x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ALEX_REPS[1] * 1e3
    cpu = mt.Predictor(sym, params, shapes, ctx=mt.cpu())
    t0 = time.perf_counter()
    cpu_out = cpu.forward(data=x)[0].asnumpy()
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card_out - cpu_out).max() / np.abs(cpu_out).max())
    check(np.isfinite(card_out).all() and err <= LT_TOL, "long_tail (c): "
          "AlexNet on the card within %.3g of the CPU route's" % err)
    img_s = ALEX_BATCH / ms * 1e3
    print("long_tail (c) Caffe AlexNet (%s): BVLC deploy.prototxt, %d "
          "blobs (%d parameters) encoded and converted in %.2f s; float32 "
          "batch %d through Predictor: %.3f ms a batch (mean of %d after "
          "%d), %.1f img/s, %.1f TFLOP/s (BASELINE.md's P100 reading for "
          "MXNet: %.2f img/s, a yardstick); the card within %.3g of the "
          "CPU route's outputs (tolerance %g; CPU forward %.2f s)"
          % (card, len(ALEX_BLOBS), sum(int(np.prod(s)) + s[0]
                                        for s in ALEX_BLOBS.values()),
             convert_s, ALEX_BATCH, ms, ALEX_REPS[1], ALEX_REPS[0], img_s,
             ALEX_GFLOP * img_s / 1e3, ALEX_P100_IMG_S, err, LT_TOL, cpu_s),
          flush=True)
    return {"ms": ms, "img_s": img_s, "rel_err": err}


def lt_capi_lib():
    """Builds the port's C library (``native.capi_lib_path``); (path,
    seconds)."""
    from mxnet_tpu_torch import native

    t0 = time.perf_counter()
    path = native.capi_lib_path()
    return path, time.perf_counter() - t0


def lt_child_env():
    """The environment of a program that embeds this interpreter: the
    repository and this interpreter's import path on PYTHONPATH."""
    paths = [os.path.abspath(".")] + [p for p in sys.path if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths))


def lt_demo_data():
    """examples/c_predict/demo.c's input batch."""
    b, d = LT_DEMO
    return np.array([((i % 7) - 3) / 3.0 for i in range(b * d)],
                    np.float32).reshape(b, d)


def lt_demo_checkpoint(mt, folder):
    """A small MLP checkpoint the demo reads (seeded weights)."""
    with mt.NameManager():
        net = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(net, num_hidden=8, name="fc1")
        net = mt.sym.Activation(net, act_type="relu")
        net = mt.sym.FullyConnected(net, num_hidden=2, name="fc2")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.default_rng(SEED + 251)
    shapes = {"fc1_weight": (8, LT_DEMO[1]), "fc1_bias": (8,),
              "fc2_weight": (2, 8), "fc2_bias": (2,)}
    args = {k: mt.nd.array(rng.standard_normal(s, dtype=np.float32) * 0.5,
                           mt.cpu()) for k, s in shapes.items()}
    prefix = os.path.join(folder, "mlp")
    mt.model.save_checkpoint(prefix, 3, net, args, {})
    return prefix


def lt_demo(lib_path, prefix):
    """demo.c compiled against the port's library and run as a process of
    its own (it asks for dev_type 1): its printed row."""
    import sysconfig

    exe = os.path.join(os.path.dirname(prefix), "demo")
    libdir = sysconfig.get_config_var("LIBDIR")
    build = subprocess.run(
        ["gcc", "-O2", os.path.join("examples", "c_predict", "demo.c"),
         "-I", "include", lib_path, "-Wl,-rpath," + libdir, "-o", exe],
        capture_output=True, text=True)
    check(build.returncode == 0, "long_tail (d): demo.c does not build: "
          "%s" % build.stderr[-1500:])
    run = subprocess.run([exe, prefix, "3"] + [str(v) for v in LT_DEMO],
                         capture_output=True, text=True, timeout=300,
                         env=lt_child_env())
    check(run.returncode == 0, "long_tail (d): demo exited %d: %s"
          % (run.returncode, run.stderr[-1500:]))
    return run.stdout.strip()


def lt_pred_create(lib, prefix, epoch, shapes, dev_type):
    """MXTPUPredCreate over a checkpoint: the handle."""
    import ctypes

    with open(prefix + "-symbol.json") as f:
        sym_json = f.read().encode()
    with open(prefix + "-%04d.params" % epoch, "rb") as f:
        params = f.read()
    keys = (ctypes.c_char_p * len(shapes))(*[k.encode() for k in shapes])
    dims = [d for s in shapes.values() for d in s]
    indptr = [0]
    for s in shapes.values():
        indptr.append(indptr[-1] + len(s))
    h = ctypes.c_void_p()
    rc = lib.MXTPUPredCreate(
        sym_json, params, len(params), dev_type, 0, len(shapes), keys,
        (ctypes.c_uint32 * len(indptr))(*indptr),
        (ctypes.c_uint32 * len(dims))(*dims), ctypes.byref(h))
    check(rc == 0, "long_tail (d): MXTPUPredCreate: %s"
          % lib.MXTPUGetLastError())
    return h


def lt_pred_output(lib, h):
    """MXTPUPredGetOutputShape + MXTPUPredGetOutput of output 0: the host
    array."""
    import ctypes

    sdata = ctypes.POINTER(ctypes.c_uint32)()
    ndim = ctypes.c_uint32()
    check(lib.MXTPUPredGetOutputShape(h, 0, ctypes.byref(sdata),
                                      ctypes.byref(ndim)) == 0,
          "long_tail (d): MXTPUPredGetOutputShape: %s"
          % lib.MXTPUGetLastError())
    shape = tuple(sdata[i] for i in range(ndim.value))
    out = np.empty(shape, np.float32)
    check(lib.MXTPUPredGetOutput(
        h, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size) == 0, "long_tail (d): MXTPUPredGetOutput: %s"
        % lib.MXTPUGetLastError())
    return out


def lt_pred_run(lib, h, name, x):
    import ctypes

    check(lib.MXTPUPredSetInput(
        h, name.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size) == 0 and lib.MXTPUPredForward(h) == 0,
        "long_tail (d): set input / forward: %s" % lib.MXTPUGetLastError())


def lt_capi(torch, mt, net, params, lib_path, build_s, folder, small,
            demo_job, card):
    """(d): the full-width LM through the C ABI in this process on the
    card, against ``Predictor``; the demo's row against the in-process
    route at dev_type 1."""
    import ctypes

    lib = ctypes.CDLL(lib_path)
    lib.MXTPUGetLastError.restype = ctypes.c_char_p
    s = FULL["seq_len"]
    prefix = os.path.join(folder, "lm")
    t0 = time.perf_counter()
    mt.model.save_checkpoint(prefix, 0, net, params, {})
    save_s = time.perf_counter() - t0
    shapes = {"data": (1, s), "softmax_label": (1, s)}
    t0 = time.perf_counter()
    h = lt_pred_create(lib, prefix, 0, shapes, 2)
    create_s = time.perf_counter() - t0
    tokens = np.random.default_rng(SEED + 252).integers(
        0, FULL["vocab_size"], (1, s)).astype(np.float32)
    times = []
    for i in range(sum(LT_CAPI_REPS)):
        before = dict(mt.kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt_pred_run(lib, h, "data", tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = kernel_delta(mt, before)
        check(delta == {"flash_fwd": FULL["num_layers"], "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}, "long_tail (d): a C-ABI "
              "forward launched %s" % delta)
    t0 = time.perf_counter()
    got = lt_pred_output(lib, h)
    copy_ms = (time.perf_counter() - t0) * 1e3
    pred = mt.Predictor.from_checkpoint(prefix, 0, shapes)
    ref = pred.forward(data=tokens)[0].asnumpy()
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    check(got.shape == ref.shape and err <= LT_TOL, "long_tail (d): the "
          "C-ABI forward within %.3g of Predictor's" % err)
    check(lib.MXTPUPredFree(h) == 0, "long_tail (d): MXTPUPredFree")
    del pred
    # dev_type 1 in this process, against the demo's process
    hs = lt_pred_create(lib, small, 3, {"data": LT_DEMO,
                                        "softmax_label": LT_DEMO[:1]}, 1)
    lt_pred_run(lib, hs, "data", lt_demo_data())
    row = lt_pred_output(lib, hs)[0]
    lib.MXTPUPredFree(hs)
    mine = ",".join("%g" % float(v) for v in row)
    theirs = demo_job.result()
    check(theirs == mine, "long_tail (d): the demo printed %r, the "
          "in-process route at dev_type 1 %r" % (theirs, mine))
    ms = float(np.mean(times[LT_CAPI_REPS[0]:]))
    print("long_tail (d) C ABI (%s): libmxtpu_torch_capi built in %.2f s; "
          "the LM's checkpoint written in %.2f s, MXTPUPredCreate "
          "(dev_type 2, 1 x %d) %.2f s; forward %s ms (mean %.2f, %d K1 "
          "launches each), the output's host copy (%d x %d float32) %.2f "
          "ms; within %.3g of Predictor's on the card; the serve phase's "
          "Predictor %.2f ms a request of %d x %d"
          % (card, build_s, save_s, s, create_s,
             ["%.2f" % t for t in times], ms, FULL["num_layers"],
             got.shape[0], got.shape[1], copy_ms, err,
             SERVE_READINGS.get("steady_ms", float("nan")), BATCH, s),
          flush=True)
    print("long_tail (d): examples/c_predict/demo.c against the port's "
          "library in a process of its own (dev_type 1) printed %s, the "
          "in-process route the same" % theirs, flush=True)
    return {"forward_ms": times, "copy_ms": copy_ms, "create_s": create_s,
            "rel_err": err, "demo": theirs, "build_s": build_s}


def lt_probe_start():
    """The shard probe at the LM's widths over [gpu(0)] * 2, in a process
    of its own."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.shard_probe",
           "--ctx", LT_PROBE_CTX,
           "--model", "transformer", "--mesh", "data=1,model=2",
           "--devices", "2", "--rules", "transformer_megatron",
           "--steps", "0", "--batch-size", str(BATCH),
           "--vocab", str(FULL["vocab_size"]),
           "--seq-len", str(FULL["seq_len"]),
           "--hidden", str(FULL["hidden"]),
           "--layers", str(FULL["num_layers"]),
           "--heads", str(FULL["num_heads"])]
    return Background(lambda: subprocess.run(
        cmd, capture_output=True, text=True, timeout=600,
        env=lt_child_env()))


def lt_shard(torch, mt, probe_job, emb, card):
    """(e): the probe's bytes against phase 18's gauge; the embedding under
    a tuple split; 3 float32 steps of the 2-layer LM with a tuple-split
    dim against one context."""
    from mxnet_tpu_torch import sharding
    from mxnet_tpu_torch.models.transformer import get_transformer_lm
    from mxnet_tpu_torch.parallel.mesh import PartitionSpec as P

    run = probe_job.result()
    check(run.returncode == 0, "long_tail (e): shard_probe exited %d: %s"
          % (run.returncode, run.stderr[-1500:]))
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    gauge = SHARD_READINGS.get("tp", (None,))[0]
    check(rec["params_sharded_bytes"] == gauge, "long_tail (e): the probe's "
          "per-device bytes %s, phase 18's gauge %s"
          % (rec["params_sharded_bytes"], gauge))
    print("long_tail (e): python -m mxnet_tpu_torch.tools.shard_probe at "
          "the LM's widths, data=1 x model=2 over %s: %d bytes a device "
          "(phase 18's mxtpu_params_sharded_bytes %s), %d replicated; the "
          "walk's plan %s" % (rec["contexts"], rec["params_sharded_bytes"],
                              gauge, rec["params_replicated_bytes"],
                              rec["walk"]), flush=True)
    # the embedding's rows over ("data", "model") on data=2 x model=2
    mesh = sharding.build_mesh("data=2,model=2", devices=[mt.gpu(0)] * 4)
    st = sharding.place(emb, mesh, P(("data", "model"), None))
    rows = emb.shape[0] // 4
    for (i, j), piece in sorted(st.shards.items()):
        k = i * 2 + j
        check(piece.is_cuda and torch.equal(piece, emb.narrow(
            0, k * rows, rows)), "long_tail (e): coordinate %s's piece is "
            "not rows %d:%d" % ((i, j), k * rows, (k + 1) * rows))
    check(len(st.shards) == 4 and torch.equal(st.full(), emb),
          "long_tail (e): the gathered embedding is not the array")
    # 3 float32 steps with a tuple-split dim, against one context
    b, s = BATCH, FULL["seq_len"]
    with mt.NameManager():
        lm = get_transformer_lm(**SHARD_F32)
    init = {k[4:]: v for k, v in lm_params(
        mt, lm, {"data": (b, s), "softmax_label": (b, s)},
        np.random.default_rng(SEED), 0.02).items()}
    batch, Y = obs_batch(mt, FULL, b)
    rules = sharding.PartitionRules(
        [(r"tok_embed_weight$", P(("data", "model"), None))]
        + sharding.get_preset("transformer_megatron").rules,
        fallback=P(), name="tuple_embed")
    losses = {}
    for tag in ("one", "tuple"):
        torch.cuda.empty_cache()
        if tag == "one":
            mod = train_module(mt, lm, mt.gpu(0), (b, s), arg_params=init,
                               optimizer="sgd",
                               optimizer_params=LT_SHARD_SGD)
            per_step = SHARD_F32["num_layers"]
        else:
            mod = mt.mod.Module(lm, label_names=("softmax_label",),
                                context=[mt.gpu(0)] * 4)
            mod.bind(data_shapes=[mt.io.DataDesc("data", (b, s))],
                     label_shapes=[mt.io.DataDesc("softmax_label", (b, s))],
                     mesh=mesh, partition_rules=rules)
            mod.set_params(init, {})
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params=LT_SHARD_SGD)
            per_step = planned_attention(mod)
            piece = mod._exec_group.execs[0].arg_dict[
                "tok_embed_weight"]._data
            check(sorted(tuple(p.shape) for p in piece.shards.values()) ==
                  [(FULL["vocab_size"] // 4, FULL["hidden"])] * 4,
                  "long_tail (e): the bound embedding's pieces")
        losses[tag], _ = shard_steps(torch, mt, mod, batch, Y,
                                     LT_SHARD_STEPS, "long_tail " + tag,
                                     per_step)
        del mod
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses["tuple"],
                                                  losses["one"]))
    check(rel <= LT_SHARD_TOL, "long_tail (e): the tuple-split LM's losses "
          "%s, one context's %s" % (losses["tuple"], losses["one"]))
    print("long_tail (e): tok_embed_weight under P((\"data\", \"model\"), "
          "None) on data=2 x model=2 over [gpu(0)] * 4: 4 row blocks of %d, "
          "gathered bit for bit; the 2-layer float32 LM with it (and the "
          "Megatron rules) for %d steps: losses %s, one context's %s, "
          "within %.3g (tolerance %g) (%s)"
          % (rows, LT_SHARD_STEPS, ["%.6f" % x for x in losses["tuple"]],
             ["%.6f" % x for x in losses["one"]], rel, LT_SHARD_TOL, card),
          flush=True)
    return {"probe_bytes": rec["params_sharded_bytes"],
            "replicated_bytes": rec["params_replicated_bytes"],
            "losses": losses, "rel": rel}


def long_tail_phase(torch, mt):
    """Phase 25 (module docstring).  Returns the phase's launches of
    K1-K3: {"bf16": {"long_tail": {...}}, "f32": {"long_tail": {...}}}."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    card = card_and_limit()
    t_phase = time.perf_counter()
    walls = {}
    folder = tempfile.mkdtemp(prefix="long_tail_")
    try:
        lib_job = Background(lt_capi_lib)
        with mt.NameManager():
            net = get_transformer_lm(**FULL)
        batch, Y = obs_batch(mt, FULL, BATCH)
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        mods, remat = lt_remat(torch, mt, net, batch, Y, card)
        walls["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        naive = lt_naive(torch, mt, net, batch, Y, mods[False], card)
        walls["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        remat.update(lt_two_phase_and_site(torch, mt, mods, batch, Y, card))
        walls["a (two-phase, site)"] = time.perf_counter() - t0
        bf16 = kernel_delta(mt, before)
        params, _ = mods[True].get_params()
        emb = mods[True]._exec_group.execs[0].arg_dict[
            "tok_embed_weight"]._data.clone()
        del mods
        gc_collect()
        # beside (c): the probe's process, and the demo once the library
        # is built
        probe_job = lt_probe_start()
        lib_path, build_s = lib_job.result()
        small = lt_demo_checkpoint(mt, folder)
        demo_job = Background(lt_demo, lib_path, small)
        t0 = time.perf_counter()
        alex = lt_caffe(torch, mt, card)
        walls["c"] = time.perf_counter() - t0
        before = dict(mt.kernels.LAUNCHES)
        t0 = time.perf_counter()
        capi = lt_capi(torch, mt, net, params, lib_path, build_s, folder,
                       small, demo_job, card)
        walls["d"] = time.perf_counter() - t0
        del params
        gc_collect()
        t0 = time.perf_counter()
        shard = lt_shard(torch, mt, probe_job, emb, card)
        walls["e"] = time.perf_counter() - t0
        f32 = kernel_delta(mt, before)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print("long_tail: walls %s; phase %.1f s on %s"
          % ({k: round(v, 2) for k, v in walls.items()}, wall, card),
          flush=True)
    print(json.dumps({"long_tail": {
        "card": card, "remat": remat, "naive": naive, "alexnet": alex,
        "capi": capi, "shard": shard, "launches": {"bf16": bf16,
                                                   "f32": f32},
        "walls_s": walls, "wall_s": wall}}, default=str), flush=True)
    return {"bf16": {"long_tail": bf16}, "f32": {"long_tail": f32}}


def device_op_group(event):
    """The group a device op of a profiler trace counts under."""
    name = event["name"]
    for key, group in (("gelu_fwd", "rtc:gelu_fwd"),
                       ("gelu_bwd", "rtc:gelu_bwd"),
                       ("flash_bwd_dkv", "K3 flash_bwd_dkv"),
                       ("flash_bwd_dq", "K2 flash_bwd_dq"),
                       ("flash_fwd", "K1 flash_fwd")):
        if key in name:
            if key == "flash_fwd" and re.search(
                    r"flash_fwd_tc_kernel<\d+, true", name):
                return "K1 flash_fwd split-P"
            return group
    if event.get("cat") != "kernel":
        return event["cat"]
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv (cuDNN)"
    if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "GEMM (cuBLAS)"
    for key, group in (("reduce", "reductions"), ("softmax", "softmax"),
                       ("index", "gather/scatter"),
                       ("gather", "gather/scatter"),
                       ("scatter", "gather/scatter")):
        if key in low:
            return group
    return "elementwise"


def profile(torch, fn, outdir, label):
    """Run ``fn`` once under torch.profiler: device time by kernel name
    (table in DIR/<label>.txt, timeline in DIR/<label>.json; the groups
    printed) and the device's idle share between the first and the last
    device op.  Returns the device ops' names by group."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    os.makedirs(outdir, exist_ok=True)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30)
    with open(os.path.join(outdir, label + ".txt"), "w") as f:
        f.write(table)
    trace = os.path.join(outdir, label + ".json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        trace_events = json.load(f)["traceEvents"]
    events = [e for e in trace_events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # the detection ops' profiler ranges on the device timeline
    # (contrib_ops._detecting): their kernels form one group
    detect = [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
              if e.get("cat") == "gpu_user_annotation"
              and e.get("name", "").startswith("_contrib_")]
    # and the optimizer's list update's (optimizer.update_tensors_list)
    update = [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
              if e.get("cat") == "gpu_user_annotation"
              and e.get("name", "").startswith("list_update:")]
    # and the paged-attention ops' (ops/paged.py)
    paged = [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
             if e.get("cat") == "gpu_user_annotation"
             and e.get("name") == "paged attention"]
    span = max(e["ts"] + e["dur"] for e in events) - \
        min(e["ts"] for e in events)
    busy = sum(e["dur"] for e in events)
    groups, names = {}, {}
    for e in events:
        group = device_op_group(e)
        if any(lo <= e["ts"] < hi for lo, hi in detect):
            group = "detection (MultiBox)"
        elif any(lo <= e["ts"] < hi for lo, hi in update):
            group = "optimizer (list update)"
        elif any(lo <= e["ts"] < hi for lo, hi in paged):
            group = "paged attention"
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e["dur"] / 1e3, n + 1)
        names.setdefault(group, set()).add(e["name"])
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print("profile %s: %-26s %10.3f ms %7.2f%% %5d ops"
              % (label, group, ms, 100 * ms * 1e3 / busy, n), flush=True)
    print("profile %s: %d device ops, busy %.1f us of a %.1f us span: idle "
          "share %.4f" % (label, len(events), busy, span, 1 - busy / span),
          flush=True)
    copies = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            n, nbytes, top = copies.get(e["name"], (0, 0, 0))
            b = e.get("args", {}).get("bytes", 0)
            copies[e["name"]] = (n + 1, nbytes + b, max(top, b))
    for name, (n, nbytes, top) in sorted(copies.items()):
        print("profile %s: %s: %d ops, %d bytes, the largest %d"
              % (label, name, n, nbytes, top), flush=True)
    return names


def parent_axpy(folder):
    """(``AXPY_CUDA``, ``axpy_dims``) of another version's
    ``mxnet_tpu_torch/rtc_kernels.py`` under ``folder``, read from its
    source without importing that module."""
    import ast

    path = os.path.join(folder, "mxnet_tpu_torch", "rtc_kernels.py")
    tree = ast.parse(open(path).read(), path)
    body, ns = None, {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "AXPY_CUDA" for t in node.targets):
            body = ast.literal_eval(node.value)
        elif isinstance(node, ast.FunctionDef) and node.name == "axpy_dims":
            exec(compile(ast.Module([node], []), path, "exec"), ns)
    check(body is not None and "axpy_dims" in ns,
          "%s has no AXPY_CUDA or axpy_dims" % path)
    return body, ns["axpy_dims"]


def build_phase(torch, mt, parent_csrcs=()):
    """Build every kernel (and flash_fwd.cu of each directory of
    ``parent_csrcs``, beside them), print ptxas's report and the
    tensor-core instruction counts; fatal on a spill or a bf16 or float32
    attention kernel without one.  Returns {label: ``mxtt_flash_fwd`` of
    each parent build}, the label the directory's name."""
    import ctypes

    kernels = mt.kernels
    t0 = time.perf_counter()
    os.makedirs(kernels._BUILD, exist_ok=True)
    procs = {}
    for folder in parent_csrcs:
        label = os.path.basename(os.path.normpath(folder))
        out = os.path.join(kernels._BUILD, "libflash_fwd-parent-%s.so" % label)
        procs[label] = (subprocess.Popen(
            [kernels._nvcc()] + kernels.NVCC_FLAGS +
            ["-o", out, os.path.join(folder, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    secs = kernels.build_all()
    print("build: %s built in %.2f s" % (
        sorted(set(kernels.SOURCES.values())), secs), flush=True)
    logs, parents = {}, {}
    for label, (proc, out) in procs.items():
        logs["parent " + label], _ = proc.communicate()
        check(proc.returncode == 0, "the build of %s failed:\n%s"
              % (label, logs["parent " + label]))
        parents[label] = fwd_entry(ctypes.CDLL(out))
    if procs:
        print("build: flash_fwd.cu of %s built beside them, %.2f s in all"
              % (sorted(procs), time.perf_counter() - t0), flush=True)
    print("build: NVRTC %d.%d from %s, options %s" % (
        mt.cuda_rtc.nvrtc_version() + (mt.cuda_rtc._LIBS["nvrtc"]._name,
                                       " ".join(mt.cuda_rtc.nvrtc_options()))),
          flush=True)
    faults = []
    for source, log in sorted(mt.kernels.BUILD_LOGS.items()):
        faults += ptxas_report(source, log)
    for tag, log in sorted(logs.items()):
        faults += ptxas_report(tag, log)
    check(not faults, "; ".join(faults))
    mma = sass_mma([kernels._lib_path(s) for s in ("flash_fwd.cu",
                                                   "flash_bwd.cu")])
    print("build: tensor-core instructions (HGMMA + HMMA) per attention "
          "kernel (cuobjdump -sass): "
          "%s" % ", ".join("%s<%s> %d" % (k, ",".join(map(str, a)), n)
                           for (k, a), n in sorted(mma.items())),
          flush=True)
    # every bf16 instantiation: K1 at each width, plain and split-P; K2 at
    # each width; K3 fused (outputs 3) up to 128, as its dV (2) and dK (1)
    # launches at 256; and K1 at each width and the same K2/K3
    # instantiations in float32
    tc_kernels = [("flash_fwd_tc_kernel", (w, split)) for w in (64, 128, 256)
                  for split in (0, 1)]
    tc_kernels += [("flash_fwd_tf32_kernel", (w,)) for w in (64, 128, 256)]
    for tag in ("_tc", "_tf32"):
        tc_kernels += [("flash_bwd_dq%s_kernel" % tag, (w,))
                       for w in (64, 128, 256)]
        tc_kernels += [("flash_bwd_dkv%s_kernel" % tag, (w, 3))
                       for w in (64, 128)]
        tc_kernels += [("flash_bwd_dkv%s_kernel" % tag, (256, out))
                       for out in (1, 2)]
    for kernel, args in tc_kernels:
        found = [n for (k, a), n in mma.items()
                 if k == kernel and a[:len(args)] == args]
        check(found and min(found) > 0, "%s<%s...> has no tensor-core "
              "instruction (HGMMA or HMMA): it does not run on the tensor "
              "cores" % (kernel, ",".join(map(str, args))))

    return parents


# ---------------------------------------------------------------------------
# lanes: phases in a process of their own, beside the main sequence
# ---------------------------------------------------------------------------
#: the phases of lane A, in order.  None of them reads the main sequence's
#: state, adds to the kernel table (their launches are printed only) or
#: times a kernel for it; main starts the lane after the extend phase,
#: whose readings close the table's timings, and joins it before phase
#: 19's side-by-side block.  Their times, and the main sequence's from
#: the agree phase to phase 19's (d), are read with the other process on
#: the card.
LANE_A = ("resnet", "ssd", "random", "spatial", "image_io", "generate",
          "recurrent")
LANE_TIMEOUT = 900


def lane_phase(torch, mt, name, profile_dir, state):
    """Run phase ``name`` of a lane, with what main printed after it."""
    if name == "resnet":
        launches = resnet_phase(torch, mt, profile_dir)
        print("resnet: kernel launches of the port's own in the phase: %s"
              % (launches or "none (cuDNN and plain torch)"), flush=True)
    elif name == "ssd":
        launches, state["ssd_step_ms"] = ssd_phase(torch, mt, profile_dir)
        print("ssd: kernel launches of the port's own in the phase: %s"
              % (launches or "none (cuDNN, torch's CUDA convolution and "
                 "plain torch)"), flush=True)
    elif name == "random":
        random_phase(torch, mt)
    elif name == "spatial":
        launches = spatial_phase(torch, mt)
        print("spatial: kernel launches of the port's own in the phase: %s"
              % ({k: v for k, v in launches.items() if v} or
                 "none (plain torch and cuDNN)"), flush=True)
    elif name == "image_io":
        launches = image_io_phase(torch, mt, state["ssd_step_ms"],
                                  profile_dir)
        print("image_io: kernel launches of the port's own in the phase: %s"
              % ({k: v for k, v in launches.items() if v} or
                 "none (host decoding, cuDNN and plain torch)"), flush=True)
    elif name == "generate":
        launches = generate_phase(torch, mt, profile_dir)
        print("generate: kernel launches of the port's own in the flash "
              "prefill check: %s" % {k: v for k, v in launches.items() if v},
              flush=True)
    elif name == "recurrent":
        launches = recurrent_phase(torch, mt, profile_dir)
        print("recurrent: kernel launches of the port's own: %s"
              % (launches or "none (plain torch and cuBLAS)"), flush=True)
    else:
        raise SystemExit("chip_smoke: no lane phase %r" % name)


def lane_worker(path):
    """``--lane SPEC``: the phases SPEC names, in order, in this process."""
    import torch

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import attention  # noqa: F401 (as main)

    with open(path) as f:
        spec = json.load(f)
    # as the main sequence has them when it reaches these phases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock, state = PhaseClock(), {}
    for name in spec["phases"]:
        lane_phase(torch, mt, name, spec["profile"], state)
        clock.mark("%s (lane %s)" % (name, spec["tag"]))


class LaneJob:
    """The phases ``names`` in a process of their own (``--lane``) beside
    the main sequence, its output in a file that ``finish`` prints."""

    def __init__(self, tag, names, profile_dir):
        self.tag, self.names, self.rc = tag, names, None
        self.tmp = tempfile.mkdtemp(prefix="lane_%s_" % tag)
        spec = os.path.join(self.tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"tag": tag, "phases": list(names),
                       "profile": profile_dir}, f)
        self.log = os.path.join(self.tmp, "lane.log")
        here = os.path.dirname(os.path.abspath(__file__))
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--lane", spec], cwd=here, stdout=log,
                stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()
        print("lane %s: %s in process %d beside the main sequence"
              % (tag, ", ".join(names), self.proc.pid), flush=True)

    def fail_early(self):
        """Fail the script at once if the lane has already failed."""
        if self.rc is None and self.proc.poll() not in (None, 0):
            self.finish()

    def finish(self):
        """Wait for the lane, print its output; fatal unless it exited 0."""
        if self.rc is not None:
            return
        try:
            self.proc.wait(timeout=max(
                1.0, LANE_TIMEOUT - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            pass
        wall = time.perf_counter() - self.t0
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.rc = self.proc.returncode
        with open(self.log) as f:
            text = f.read().rstrip()
        self.close()
        print("lane %s: its output:\n%s\nlane %s: %.1f s from its start "
              "to its end, exit %s" % (self.tag, text, self.tag, wall,
                                       self.rc), flush=True)
        check(self.rc == 0, "lane %s (%s) exited %s" % (
            self.tag, ", ".join(self.names), self.rc))

    def close(self):
        """Stop the lane if it still runs; remove its folder."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra request, one extra train step "
                         "(bf16 and float32), one extra splash step, one "
                         "extra rtc_gelu train step, one extra ResNet-50 "
                         "bf16 step, one extra SSD train step, one extra "
                         "SSD request, one 8-lane generation iteration "
                         "and one bucket-60 PTB LSTM step with "
                         "torch.profiler (the optimizer's list update and "
                         "the paged ops groups of their own)")
    ap.add_argument("--parent-csrc", metavar="DIR", action="append",
                    default=[],
                    help="a csrc directory of another version (flash_fwd.cu "
                         "and its headers), repeatable: its bf16 K1 and "
                         "split-P are held bit for bit and timed in turns "
                         "against this one's at every bf16 main-length case")
    ap.add_argument("--parent-rtc", metavar="DIR", action="append",
                    default=[],
                    help="a checkout of another version, repeatable: the "
                         "axpy user kernel of its mxnet_tpu_torch/"
                         "rtc_kernels.py (AXPY_CUDA launched with its "
                         "axpy_dims) is held bit for bit and timed in turns "
                         "beside this one's at every axpy timing case")
    ap.add_argument("--dist-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--shard-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--ps-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--cc-worker", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--lane", metavar="SPEC", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.dist_worker:
        dist_worker(opts.dist_worker)
        return
    if opts.shard_worker:
        shard_worker(opts.shard_worker)
        return
    if opts.ps_worker:
        ps_worker(opts.ps_worker)
        return
    if opts.cc_worker:
        cc_worker(opts.cc_worker)
        return
    if opts.lane:
        lane_worker(opts.lane)
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a machine with an NVIDIA card")
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import attention as att

    jobs = []  # what stops the processes a phase left running beside
    try:
        main_sequence(torch, mt, att, opts, jobs)
    finally:
        for close in jobs:
            close()
        for job in list(PS_JOBS):  # one a failed phase's thread still ran
            job.close()


def main_sequence(torch, mt, att, opts, jobs):
    """The phases in order, with lane A beside them; each process started
    beside them adds its stop to ``jobs``."""
    from mxnet_tpu_torch.models.transformer import get_transformer_lm

    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)
    clock = PhaseClock()
    # the serve phase's 441M weights are drawn and written beside the
    # build's nvcc processes, and joined before any kernel is timed
    with mt.NameManager():
        serve_net = get_transformer_lm(**FULL)
    serve_dir = tempfile.mkdtemp(prefix="serve_")
    jobs.append(lambda: shutil.rmtree(serve_dir, ignore_errors=True))
    serve_ckpt = Background(serve_checkpoint, mt, serve_net, serve_dir)
    parents = build_phase(torch, mt, opts.parent_csrc)
    clock.mark("build")
    ckpt = serve_ckpt.result()
    clock.mark("the serve checkpoint's wait after the build")
    device = torch.device("cuda", 0)
    main_rows, dim_rows = kernel_phase(torch, att, device, parents)
    clock.mark("kernel")
    splitp_row = main_rows.pop("flash_fwd_splitp")
    rows = list(main_rows.values())
    rtc_rows = rtc_kernel_phase(torch, mt, device, {
        os.path.basename(os.path.normpath(d)): parent_axpy(d)
        for d in opts.parent_rtc})
    clock.mark("rtc")
    pred, tokens, flash_out = serve_phase(torch, mt, ckpt)
    clock.mark("serve")
    mod, batch, launches, losses, step_ms, replay = train_phase(torch, mt)
    clock.mark("train")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] > 0, "the training path never launched %s"
              % name)
    for r in rows:
        r["launches"] = launches[r["name"]]
    step_paths(torch, mod, batch)
    if opts.profile:
        k1 = sorted(profile(torch, lambda: pred.forward(data=tokens),
                            opts.profile, "serve_request")
                    .get("K1 flash_fwd", ()))
        print("profile serve_request: K1 kernels %s" % k1, flush=True)
        check(k1 and all("flash_fwd_tf32_kernel<128>" in n for n in k1),
              "the float32 request's K1 is not flash_fwd_tf32_kernel<128>")

        def step():
            mod.forward_backward(batch)
            mod.update()
        k1 = sorted(profile(torch, step, opts.profile,
                            "train_step").get("K1 flash_fwd", ()))
        print("profile train_step: K1 kernels %s" % k1, flush=True)
        check(k1 and all("flash_fwd_tc_kernel<128, false>" in n for n in k1),
              "the bf16 train step's K1 is not "
              "flash_fwd_tc_kernel<128, false>")
    del pred, mod
    torch.cuda.empty_cache()
    f32_launches = train_f32_phase(torch, mt, batch, replay["Y"], losses,
                                   opts.profile)
    clock.mark("train_f32")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        dim_rows[(name, FULL["hidden"] // FULL["num_heads"], "f32")][
            "launches"] = f32_launches[name]
        check(f32_launches[name] > 0, "the float32 training path never "
              "launched %s" % name)
    replay_phase(torch, mt, batch, replay)
    clock.mark("replay")
    splash_launches = splash_phase(torch, mt, batch, replay, losses, step_ms,
                                   tokens, flash_out, opts.profile)
    clock.mark("splash")
    SERVE_INPUTS.clear()
    splitp_row["launches"] = splash_launches["flash_fwd_splitp"]
    check(splitp_row["launches"] > 0, "the splash path never launched "
          "flash_fwd_splitp")
    rows.append(splitp_row)
    del flash_out  # the train phase's batch and init serve train_api too
    torch.cuda.empty_cache()
    ext_launches, sgd_row = extend_phase(torch, mt, losses, step_ms,
                                         opts.profile)
    clock.mark("extend")
    rtc_rows.insert(1, sgd_row)
    for r in rtc_rows:
        r["launches"] = ext_launches.get(r["name"], 0)
        check(r["launches"] > 0, "the extension path never launched %s"
              % r["name"])
    rows += rtc_rows
    # the table's timings are all read: lane A starts beside the rest
    lane = LaneJob("A", LANE_A, opts.profile)
    jobs.append(lane.close)
    clock.lanes.append(lane)
    small_agreement(mt)
    for dtype in (None, "bfloat16"):
        small_train_agreement(torch, mt, dtype)
        small_train_agreement(torch, mt, dtype, cfg=SMALL_SPLASH)
        for d, cfg in sorted(SMALL_HEAD_DIMS.items()):
            got = small_train_agreement(torch, mt, dtype, cfg=cfg,
                                        std_width=64)
            tag = "bf16" if dtype else "f32"
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                dim_rows[(name, d, tag)]["launches"] = got[name]
                check(got[name] > 0, "the d=%d LM never launched %s"
                      % (d, name))
    rows += [dim_rows[k] for k in sorted(dim_rows)]
    clock.mark("agree (small LMs)")
    spread_witness(torch, mt)
    small_train_agreement(torch, mt, None, rtc_gelu=True)
    for optimizer in AGREE_MORE:
        small_train_agreement(torch, mt, None, optimizer=optimizer)
    lenet_consistency(mt)
    custom_op_agreement(mt)
    nd_agreement(mt)
    conv_precision_check(torch, mt)
    for dtype in (None, "bfloat16"):
        for what in SMALL_IMAGE:
            image_agreement(torch, mt, what, dtype)
    small_ssd_agreement(torch, mt)
    clock.mark("agree (the rest)")
    train_api_phase(torch, mt, batch, replay)
    clock.mark("train_api")
    par_launches = parallel_phase(torch, mt, att, batch, replay)
    clock.mark("parallel")
    shard_launches = sharding_phase(torch, mt, batch, replay)
    clock.mark("sharding")
    for tag in ("bf16", "f32"):
        par_launches[tag].update(shard_launches[tag])
    del batch
    torch.cuda.empty_cache()
    # lane A ends before the side-by-side block's processes start: their
    # memory and lane A's together would crowd the card
    ps_launches = param_server_phase(torch, mt, replay, losses,
                                     before_side=lane.finish)
    clock.mark("param_server")
    for tag in ("bf16", "f32"):
        par_launches[tag].update(ps_launches[tag])
    del replay
    torch.cuda.empty_cache()
    cc_job = compile_once_start(torch, mt)
    jobs.append(lambda: compile_once_close(cc_job))
    clock.mark("compile_once's checkpoint")
    serving_launches = serving_phase(torch, mt)
    clock.mark("serving")
    par_launches["f32"].update(serving_launches["f32"])
    platform_launches = platform_phase(torch, mt)
    clock.mark("platform")
    par_launches["f32"].update(platform_launches["f32"])
    cc_launches, cc_rtc_launches = compile_once_finish(cc_job)
    clock.mark("compile_once's join")
    par_launches["f32"].update(cc_launches["f32"])
    sparse_jobs = {}
    try:
        # phase 24's server processes start up beside phase 23's untimed
        # half
        obs_launches = observe_phase(
            torch, mt, after_timed=lambda: sparse_jobs.update(sparse_start()))
        clock.mark("observe")
        par_launches["bf16"].update(obs_launches["bf16"])
    except BaseException:
        for job in sparse_jobs.values():
            if isinstance(job, PSJob):
                job.close()
        shutil.rmtree(sparse_jobs.get("snap_dir", ""), ignore_errors=True)
        raise
    sparse_phase(torch, mt, sparse_jobs)
    clock.mark("sparse")
    lt_launches = long_tail_phase(torch, mt)
    clock.mark("long_tail")
    for tag in ("bf16", "f32"):
        par_launches[tag].update(lt_launches[tag])
    for r in rtc_rows:
        r["launches_by_path"] = {
            "extend": r["launches"],
            "compile_once": cc_rtc_launches.get(r["name"], 0)}
        r["launches"] = sum(r["launches_by_path"].values())
    d_main = FULL["hidden"] // FULL["num_heads"]
    for tag, kernel_rows in (
            ("bf16", main_rows),
            ("f32", {n: dim_rows[(n, d_main, "f32")]
                     for n in ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")})):
        for name, r in kernel_rows.items():
            r["launches_by_path"] = dict(
                {"train": r["launches"]},
                **{path: c[name] for path, c in par_launches[tag].items()})
            r["launches"] = sum(r["launches_by_path"].values())

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
