#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and builds the kernels from ``csrc/`` itself.

Phases (any failure exits non-zero and prints no result line):

1. Environment and build: the card's name and power limit (nvidia-smi),
   torch/CUDA versions, and the time to build every kernel (one nvcc
   per source, all at once), with ptxas's registers and spills.
2. Kernels vs their plain PyTorch versions on the card, at the stated
   tolerances, with kernel / plain / library timings (CUDA events, L2
   flushed before each launch) and bounds (the peak rate printed beside
   each) at the shapes the main paths give them: B1 flash forward, B2/B3
   flash backward (dQ; dK and dV), B4 paged attention (its split walk and
   merge), each kernel also held to repeat bit for bit.  B4's main-path
   case is also timed by torch.profiler's device time, since the events
   there read the wrapper's host work.
3. The serving path at full width: GPT-2 124M (12 layers, 768 units, 12
   heads, vocab 50257, 1024 positions; random weights from a seed)
   served by ``InferenceEngine`` with paged KV and the paged-attention
   kernel: 8 requests of 300-500 prompt tokens (the 512 seq bucket, so
   prefill runs the flash kernel) and 32 new tokens each, through the
   engine's default on the card: its programs are CUDA graphs, captured
   by ``warmup()`` and replayed.  Both kernels' launch counters (which
   replays advance by what their capture counted) must move.  The same
   requests replay through the gather read arm; per-step logits of the
   two arms are held together at the model level; the whole phase
   repeats with int8 KV pages.  Then
   ``torch.profiler`` shows where one prefill and 8 decode steps spend
   their time (wall, device-busy share, top kernels).
4. The training path at full width: the same GPT-2 124M (float32, seed
   0, dropout 0) takes Adam steps through ``parallel.ShardedTrainer``
   with ``gpt2_lm_loss`` on 16 x 1024 tokens: one warm-up step, then 5
   timed steps on the same batch.  B1, B2 and B3 must each launch 12
   times per step, every loss must be finite and the last below the
   first.  Before it, one step's loss and every gradient at batch 4 are
   held to the same step with ``impl='ref'`` attention.  Then
   ``torch.profiler`` shows where one step spends its time.
5. The MXNet imperative loop at the same width, on a fresh net from the
   same seed and batch: ``mx.nd`` inputs, ``with autograd.record()``,
   ``gluon.loss.SoftmaxCrossEntropyLoss``, ``loss.backward()`` and
   ``gluon.Trainer(..., "adam").step(16)``, one warm-up step and 5 timed
   ones.  B1, B2 and B3 must each launch 12 times per step, every step's
   loss must be within ``TOL_LOSS`` of phase 4's for the same step, and
   step 1's ``p.grad()`` (over the batch size) within ``TOL_GRAD`` of
   ``torch.autograd.grad`` of ``gpt2_lm_loss``.  Then ``torch.profiler``
   shows where one step spends its time.
6. The reference's canonical program (MXNet's Gluon MNIST MLP) on the
   card, through the public surface only: ``nn.HybridSequential`` of
   ``Flatten``, ``Dense(128, activation="relu")`` and ``Dense(10)``,
   ``initialize(mx.init.Xavier())`` (every shape deferred to the first
   batch), ``hybridize(static_alloc=True)``, SGD 0.1 and
   ``SoftmaxCrossEntropyLoss`` on 20 seeded MNIST-shaped batches (128 x
   1 x 28 x 28 in [0, 1), labels of a fixed random teacher).  The
   deferred shapes must materialize on the card, the hybridized and
   imperative outputs agree, every step's loss be within
   ``TOL_MLP_LOSS`` of the same program on the CPU from the same
   weights, and the loss fall.  No kernel of the port runs here.
7. Phase 5's loop under ``mx.amp.init("bfloat16")`` on a fresh net from
   the same seed and batch: one warm-up step and 5 timed ones.  B1, B2
   and B3 must each launch 12 times per step with bf16 q/k/v (and never
   in float32), step 1's forward give the dtypes of ``AMP_DTYPES`` at
   the named points of every layer, every parameter and gradient stay
   float32, the losses be finite and falling, and step 1's loss be
   within ``TOL_AMP_STEP1`` of phase 5's float32 step 1 and its
   gradients within ``TOL_AMP_GRAD``.  Before it, the same step 1 under
   each policy of ``AMP_CONTROLS`` (float32 ops forced to bf16) must
   fail at least one of those three checks; its errors are printed, to
   show what each check can see.  Then
   ``torch.profiler`` shows where one step spends its time.
8. The routed family at full width: GPT-2 124M with 8 experts (top 2,
   capacity factor 1.25) in every second layer (h1, h3, ..., h11),
   ``remat=True``, float32, seed 0, dropout 0, trained by
   ``ShardedTrainer(net, "lamb", loss=gpt2_lm_loss)`` at lr 1e-3, wd
   0.01 on phase 4's batch: one warm-up step, 5 timed ones, then 2
   without remat.  B1 launches 24 times a step under remat (12 in the
   forward, 12 when each layer is recomputed in backward: its attention
   runs again before the activations backward needs), B2 and B3 12, all
   in float32; the losses are finite and falling and the aux collector
   is empty after every step; each MoE layer's aux loss and dropped
   share are printed.  Before it, at batch 4 with dropout 0.1 from one
   seed: a step with remat against one without (``TOL_REMAT_LOSS``,
   ``TOL_REMAT_GRAD``) and against ``impl='ref'`` attention
   (``TOL_LOSS``, ``TOL_GRAD``); one LAMB step over every parameter
   through the list-wise update against the per-parameter loop from one
   state, and every registered optimizer's 3 list-wise updates of a few
   card tensors against the CPU's (``TOL_MULTI``).  Then
   ``torch.profiler`` shows where one step spends its time.
9. The serving engine's features at phase 3's width, paged KV with
   16-position pages, 8 slots, buckets 64-512 and chunks of 256
   (``FEATURES``), kernel arm in float32 unless named, graphed as
   phase 3 at one batch bucket (8).  (a) Chunked
   prefill: 8 prompts of 600-1000 tokens, 16 new each; every request
   completes and B4 runs with ``Tq`` the chunk bucket; a 1000-token
   prompt's last logits after 4 chunks through B4 are held within
   ``TOL_LOGITS`` of one T = 1024 prefill (B1); the gather arm and int8
   pages repeat it (token-identity shares printed).  (b) Prefix reuse:
   two waves of 8 requests sharing a 512-token prefix, each with its
   own 32-64-token suffix, wave 2 after wave 1 completed: at least 8
   hits reusing 8 x 496 tokens, wave 2's suffixes on B4 with Tq > 1;
   the dense layout without a prefix cache repeats it.  (c) Page
   pressure: 8 prompts of 400-500 tokens, 128 new, a pool of 160 pages:
   preemptions happen and every stream completes at full length;
   against a pool of 512.  (d) Speculative decode: phase 3's prompts
   (chunks of 512: the full path, B1), 64 new, ``spec_tokens=4``,
   ``draft_layers=2``: a 5-token
   ``verify_slots`` window is held within ``TOL_LOGITS`` of 5 decode
   steps, a drafter over all 12 layers must propose the tokens of 4
   greedy decode steps (at least 0.9 of them: the control that reads
   acceptance as the 2-layer drafter's quality), B4 runs at Tq 5;
   acceptance and tokens/s with speculation on and off.  Each prints tokens/s, TTFT p50 and peak memory, and the
   phase its wall time.
10. The vision family at full width: ``bench.py``'s ResNet-50 arm
   (``bench.py:370-394``), cut in nothing: ResNet-50 v1
   (``get_resnet(1, 50, classes=1000, layout="NHWC")``, seed 0), batch
   128 of 224 x 224 x 3 images uniform in [-1, 1), labels in [0, 100),
   float32 with TF32 off.  Gates first, at batch 8, from one set of
   weights: one ``ShardedTrainer`` SGD step on the card against the
   same step on the CPU (loss ``TOL_VISION_LOSS``; the moving
   statistics after it ``TOL_VISION_STATE``; the gradients,
   read as the momentum, -lr times step 1's gradient, held to the CPU's
   float64 step no further than ``TOL_VISION_GRAD_RATIO`` times the
   CPU's float32 step is), a predict-mode forward from the card's state
   after it on both (``TOL_VISION_LOGITS``, and it must differ from a
   batch-statistics forward: the moving statistics are used), and NCHW
   against NHWC logits on the card from the same (O, I, kH, kW) weights; cuDNN's
   modes are printed beside them.  (a) ``ShardedTrainer(net, "sgd",
   loss=ce)`` at lr 0.1, momentum 0.9, ``ce`` as ``bench.py:101-104``:
   one warm-up step and 5 timed ones on the same batch, ms/step,
   images/s, peak memory, and the share of float32's peak outside the
   tensor cores at ``3 x 4.1e9`` FLOP per image; then untimed steps to
   ``VISION_TRAIN_STEPS`` (the configuration overshoots for ~10 steps),
   every loss finite and the last below the first.  (b) A fresh net from the same seed through the Gluon loop
   (``record`` → ``SoftmaxCrossEntropyLoss`` → ``backward`` →
   ``gluon.Trainer(..., "sgd").step(128)``) under
   ``mx.amp.init("bfloat16")``: every convolution's output bf16, every
   BatchNorm's float32, parameters and gradients float32, step 1 within
   ``TOL_VISION_AMP`` of (a)'s; the same timed and untimed steps and
   loss gate as (a).  (c)
   ``torch.profiler`` over one step of each: wall, device busy, idle
   share, the shares of convolution, BatchNorm, elementwise, copy and
   layout-transpose kernels, and the top kernels.  No kernel of the port
   launches in this phase.
11. BERT-large pretraining at full width: ``bench.py``'s arm
   (``bench.py:731-790``), cut in nothing: 24 x 1024, 16 heads, vocab
   30522, ``max_length`` 512, batch 8 x 512, 64 masked positions a row,
   MLM + NSP loss, Adam lr 1e-4, ``remat='dots'``, dropout 0.1, float32
   with TF32 off.  Gate first, at batch 4 and dropout 0 without
   ``valid_length``: one step's loss and gradients with the kernels
   against ``impl='ref'`` attention (phase 4's tolerances; B1 48
   launches, B2 and B3 24: remat relaunches B1).  ``'dots'`` keeps each
   layer's products and recomputes the rest, with no per-op hook.  (a)
   ``ShardedTrainer`` with ``valid_length``, as bench.py passes it: the
   key mask sends attention to the reference path, no kernel launches.
   (b) The Gluon loop under ``mx.amp.init("bfloat16")`` without
   ``valid_length`` (the same function on full rows): B1-B3 in bf16 at
   48 / 24 / 24 launches a step.  Each: one warm-up step and 5 timed
   ones, ms/step, samples/s, peak memory, the share of the peak at
   bench.py's FLOP per sample, launches a step, a profile of one step,
   losses finite and falling; (b) also the host's CPU time a step.
12. Transformer-big training and translation: ``bench.py``'s arm
   (``bench.py:679-725``): 6 + 6 layers, 1024 units, 4096 hidden, 16
   heads, vocab 32000, batch 16, source and target 256 tokens, dropout
   0, Adam lr 1e-4, ``ShardedTrainer``, float32.  Gate at batch 4: loss
   and gradients against ``impl='ref'``.  The warm-up step credits each
   flash launch to the attention module it ran in (forward and
   backward hooks): encoder, decoder and cross-attention, 6 of each
   kernel each.  5 timed steps: tokens/s, peak memory, the share of
   the peak.  Then greedy ``translate`` of 8 random 64-token sources to
   32 tokens: each emitted token's teacher-forced logit within
   ``TOL_GREEDY`` (relative) of its position's largest; then beam 4:
   ids in range, nothing but EOS after an EOS, and both teacher-forced
   length-normalized scores printed.
13. The LSTM language model: the "medium" PTB word model of Zaremba,
   Sutskever and Vinyals (2014): embedding 650, ``gluon.rnn.LSTM(650,
   num_layers=2, dropout=0.5)`` with dropout 0.5 before and after it,
   vocab 10000, an untied ``Dense`` decoder, 35 steps x batch 20 of
   random ids, SGD lr 1, the summed gradient clipped at 5 x tokens by
   ``gluon.utils.clip_global_norm``, state carried across steps.  Gate:
   the fused ``RNN`` route (cuDNN) against the step-by-step route,
   logits and every gradient, ``TOL_RNN``.  A warm-up step and 10
   timed ones: ms/step, tokens/s, peak memory, losses finite and
   falling, a profile of one step; no kernel of the port launches.
14. The ``nd`` op surface at the sizes of the public models that use
   it, each part held against the same port op on the CPU from the same
   inputs (``TOL_OPS``, gradients ``TOL_OPS_GRAD``), timed by CUDA
   events with L2 flushed, with its peak memory; every output on the
   card.  (a) SSD-300 (VGG16 on VOC): ``MultiBoxPrior`` over the six
   maps (8732 anchors), ``MultiBoxTarget`` at batch 32 and 21 classes
   with hard-negative mining, ``MultiBoxDetection`` (threshold 0.01,
   NMS 0.45, top 400), ``box_nms`` alone over 8732 rows: class targets,
   masks and kept sets identical but for NMS rows within
   ``TOL_NMS_EDGE`` of the threshold.  (b) Faster R-CNN's ROI head:
   ``ROIPooling`` on (2, 512, 38, 63), 256 ROIs, 7 x 7, with the data
   gradient.  (c) Mask R-CNN's C4 head: ``ROIAlign`` on (2, 1024, 38,
   63), 1024 ROIs, 14 x 14, sample ratio 2 (held at 128 of the ROIs).
   (d) ``SpatialTransformer`` on (64, 3, 448, 448) to 224 x 224, with
   gradients to the data and the affine parameters.  (e) ``potrf``,
   ``trsm`` (four flag combinations), ``slogdet`` and ``inverse`` of 64
   SPD 1024-matrices, ``det`` of 64 x 64 ones, held to float64 by
   residual.  (f) 2^24 draws of each of the 18 samplers: mean and
   variance within ``SIGMAS`` standard errors of the law, a seed
   repeats bit for bit and another differs; ``sample_multinomial`` over
   GPT-2's vocabulary; ``shuffle`` of 2^20 rows a permutation.  (g)
   ``scatter_nd`` of 2^20 updates (duplicates add) into 4096 x 4096.  No
   kernel of the port launches (``launches_by_path["ops"]``).
15. The serving engine's compiled programs.  (a) Phase 3's engine at
   full width, eager (``_graphs = False``) and graphed arms in turns,
   ``GRAPH_ROUNDS`` rounds (one batch bucket, 8), each arm a fresh
   engine serving phase 3's
   prompts with 32 then 256 new tokens: warm-up seconds and program
   count, tokens/s, TTFT p50 by wave and peak memory above the model
   for each; greedy streams identical across every arm, kernel launches
   (from replays) equal to the eager arm's, and the graphed arm's
   ``compiles`` after traffic equal to its ``warmup()`` return.  (b)
   Each program kind (prefill at 512, chunk at 256, decode, draft +
   verify at k = 4 over 2 draft layers, the prefix copy) replayed
   against the eager call from the same inputs, twice with new inputs:
   tokens identical, the caches they wrote within ``TOL_REPLAY``.  (c)
   ``torch.profiler`` over the engine's own cycles driven by hand, the
   first (prefill B8 T512 and one decode) and 8 decode cycles, graphed
   and eager: wall, device busy and idle share.  (d) Forward mode:
   ResNet-50 v1 NHWC (seed 0, float32, TF32 off) at ``max_batch`` 32,
   96 requests of 224 x 224 x 3 in 3 waves, eager and graphed arms in
   turns: each output within ``TOL_FORWARD`` of the block's direct
   forward, images/s, latency p50, the freeze; the B32 forward
   program's replay against its eager call, and a profile of one call
   of each; no kernel of the port
   launches (``launches_by_path["forward"]``).
16. The compiled training programs: a hybridized block's CachedOp
   (forward and backward graphs replayed as one autograd node) and
   ``ShardedTrainer``'s step as one CUDA graph, each against its eager
   arm (not hybridized; the trainer's private ``_graphs = False``), the
   arms in turns over ``GRAPH_ROUNDS`` rounds (16c over
   ``VISION_GRAPH_ROUNDS``).  (a) Phase 11 (b)'s
   BERT-large loop (amp, ``remat='dots'``, dropout 0.1, B8 x T512), the
   net hybridized in the graphed arm: ms/step, samples/s, host CPU ms a
   step, the idle share of a profiled step, peak memory, and B1/B2/B3
   48/24/24 bf16 launches a step in both arms; gate at batch 4 and
   dropout 0: the loss and every gradient, hybridized against not
   (``TOL_GRAPHED``).  (b) Phase 4's GPT-2 124M ``ShardedTrainer`` (16 x
   1024, Adam), float32 and under amp: ms/step, tokens/s, idle share,
   peak memory, 12/12/12 launches; gate: the six losses and the final
   parameters graphed against eager.  (c) Phase 10's ResNet-50 v1 NHWC
   ``ShardedTrainer``: images/s; gate: the moving statistics after 3
   steps graphed against eager under deterministic cuDNN algorithms
   (with cuDNN's default ones two eager runs part too: printed as a
   control).  (d) A guarded GPT-2 replay whose loss is NaN: parameters,
   aux and optimizer state bit-identical, the loss scale halved, the
   next finite replay updates.  (e) GPT-2 at dropout 0.1 under remat,
   learning rate 0: replays draw new masks, the recomputation draws its
   forward's (B1 24 a step), a reseeded run repeats the losses.
17. Resilient training at full width, ``RES_LAYERS`` of the depth:
   phase 4's GPT-2 124M step under
   amp (B1-B3 in bf16), guarded with the dynamic loss scaler, dropout
   0.1, driven by ``ResilientLoop`` (8 seeded batches, a commit every
   4, two kept, in a temporary directory the phase removes).  (a) The
   fault-free run under a tracer: its spans (``loop.step``,
   ``trainer.step``, ``checkpoint.save``, ``checkpoint.commit``), each
   commit's bytes and ms (snapshot to the host, write with its digest,
   rename), B1/B2/B3 12 a step from replays; then ms/step of the bare
   trainer against the loop with tracing off and on, in turns (the
   timed arms' loops write no commit).  (b) A
   ``FaultPlan`` kills at three ``trainer.step`` hits and at one commit
   and raises one retried fault; a fresh trainer and loop resume after
   each kill, and parameters, optimizer state, loss scale, finite-step
   count and the last loss end bit-identical to (a).  (c) Loss and
   gradient poisons at two replays: each step non-finite, every other
   tensor bit-identical across it, the scale halved; under
   ``on_bad_step='rewind'`` two poisoned steps in a row restore the
   last commit.  (d) Bit rot in a commit: the resume quarantines it,
   falls back one commit and still ends bit-identical to (a).  (e)
   SIGTERM mid-run: a final commit, ``preempted``, and a fresh loop
   ends bit-identical to (a).  (f) The registry's Prometheus text, a
   flight-recorder bundle with the card's facts, and a torch.profiler
   trace of one replayed step with the spans as ranges
   (``span:trainer.step``, ``RES_LAYERS`` B1-B3 records each).
18. The hardened serving engine at full width: phase 3's engine,
   prompts and 32 new tokens, its lattice cut to the B8 x T512 point
   (``HARD_LATTICE``), graphs captured by ``warmup()``.  (a) The NaN
   guard on float32 and int8 pages: row ``HARD_NAN_POS`` of the
   position embedding NaN before ``warmup()`` (a position only the
   longest prompt's decode reaches): that request fails with
   ``NonFiniteOutputError``, the other 7 streams equal a clean
   engine's, the next tenant (its cycles driven by hand so that it
   takes the victim's slot and scrubbed pages) equals the clean
   engine's stream, ``nonfinite_outputs`` is 1 and the pool finite;
   int8 also a ``serving.kv_scale`` poison: one typed failure, one
   dequant fault.  (b) A retryable raise at the third
   ``serving.decode_step``: the fault-free streams bit for bit, one
   retry, ``compiles`` at ``warmup()``'s; a kill at
   ``serving.scheduler``: the watchdog trips within ``hang_timeout``
   plus two intervals, every rider fails with ``EngineCrashedError``,
   a fresh engine serves.  (c) 24 arrivals in one burst (8 a class) at
   ``queue_depth`` 8: no interactive request shed, sheds printed by
   reason and class; an interactive arrival preempts a best_effort
   decode whose resumed stream equals its clean stream; a cancel
   mid-decode returns its pages.  (d) ``debug_parity``: the int8 and
   float32 kernel arms against their float32 gather twins, the
   histogram's count, p50 and max, float32 held to ``TOL_LOGITS``.
   (f) The registry's ``mxtpu_serving_*`` series and a flight bundle
   naming the live engine.  B1 and B4 must launch on the path
   (``launches_by_path["hardened"]``).  (e) The cost of the guard,
   the metrics and the watchdog against the guard off, in turns over
   ``HARD_ROUNDS`` rounds: tokens/s and 8 decode cycles' idle share
   (printed, not gated).
19. The data pipeline at full width, each arm against the same batches
   resident on the card, in turns over ``DATA_ROUNDS`` rounds of
   ``DATA_STEPS`` timed steps.  (a) Phase 16's GPT-2 124M step under
   amp, graphed, fed ``TRAIN_B`` x (``TRAIN_T`` + 1)-token records
   written with ``MXIndexedRecordIO``, read through
   ``RecordFileDataset`` → ``transform`` → ``DataLoader(pin_memory=
   True)`` → ``DevicePrefetcher`` → ``ShardedTrainer.step``: every loss
   bit-identical to the resident arm's, B1-B3 12 bf16 launches a step
   (``launches_by_path["data"]``); ms/step, ``input_wait`` p50 and max,
   bytes shipped a step.  (b) Phase 16's ResNet-50 v1 NHWC step at 128 x
   224², graphed, fed seeded ``DATA_IMG``² uint8 images (the card host
   has no libjpeg, so from memory through ``ArrayDataset``, not JPEG
   records) through ``DataLoader(pin_memory=True)`` →
   ``DevicePrefetcher`` → ``DeviceTransform`` (224² crop, mirror,
   ImageNet normalization, channels-last) on the feeder's stream, the
   resident arm sending the same uint8 batches through the same
   transform on the step's stream: transformed batches bit-identical,
   losses held as phase 16 (c) holds them (deterministic cuDNN,
   ``TOL_GRAPHED``); float32 and amp: images/s, ``input_wait``, the
   source's host images/s alone, bytes shipped a step, and from one
   profiled step the host-to-device copies' µs and how many of them ran
   beside the step's kernels.  No kernel of the port launches in (b).
20. Data- and sequence-parallel training, GPT-2 124M at full width
   ((b) and (c) at ``PAR_LAYERS`` of its depth), float32 unless named.
   The card host has one H100 and NCCL refuses two ranks on one device,
   so a real collective runs as two ranks on the one card over gloo
   (``tools/launch.py -n 2`` starts this script with
   ``--phase20-rank``; gloo stages CUDA tensors through pinned host
   memory), and a one-rank mesh runs under NCCL.  (a) ``ShardedTrainer(
   mesh=make_mesh(dp=1))`` under a one-rank NCCL group, amp, 16 x 1024:
   graphed, its losses bit-identical to ``mesh=None``'s over
   ``DP_STEPS`` steps.  (b) dp = 2: two gloo ranks, 8 x 1024 each of
   the global 16 x 1024, Adam, ``DP_STEPS`` steps from rank 0's weights
   (rank 1 seeded apart), against the one-process step: losses
   (``TOL_LOSS``) and final parameters (``TOL_DP_PARAM``); a DCP
   checkpoint at step 2 loaded in this process continues to the ranks'
   step-3 loss; ms/step, the gloo all-reduce's share of it and the
   bytes staged.  (c) sp = 2: two gloo ranks, T = 1024 in chunks of 512
   (``SP_B`` rows), the balanced ring, then Ulysses (6 of 12 heads a
   rank): one step's loss and gradients, summed over the ranks, against
   the one-process step through B1-B3 (phase 11's ``TOL_GRAD``); each
   rank's B1, B2 and B3 launches (all above 0) and B2's by mode.  B2's
   ring modes (``partial``, ``given``) are held to their plain versions
   at the ring's block shapes first.
21. Tensor, expert and pipeline parallel training, two gloo ranks on
   the card (``tools/launch.py -n 2`` starts this script with
   ``--phase21-rank``), float32, dropout 0, Adam at ``TRAIN_LR``,
   ``DP_STEPS`` steps of ``PAR_B`` x ``TRAIN_T`` a part, each part
   against one process from the same weights (rank 1 seeded apart) and
   batches: losses (``TOL_LOSS``), every parameter's block on each rank
   (``TOL_DP_PARAM``), B1-B3 launches a rank a step (``PAR_LAUNCHES``).
   (a) tp = 2: GPT-2 124M with ``PAR_VOCAB`` (nanoGPT's 50304), 6 heads
   a rank, the vocabulary split.  (b) ep = 2: phase 8's routed GPT-2
   124M (``MOE_CFG``), 4 experts a rank; each MoE layer's dropped share
   at each step equal to one process's.  (c) pp = 2: the stacked GPT-2
   124M, 6 layers a stage, ``PAR_MICRO`` microbatches under GPipe; first
   the piped forward's logits against the unpiped model's
   (``TOL_PAR_LOGITS``).  Printed: each part's ms/step against one
   process, its axis's collectives' host seconds and share of the step,
   the bytes staged a step.  (d) is phase 2's: B1-B3 at the tp rank's
   shape (``parallel_shapes``) against their plain versions.
22. Sharded serving and BERT / NMT under tensor parallelism, two gloo
   ranks on the card (``tools/launch.py -n 2`` starts this script with
   ``--phase22-rank``), float32.  (a) GPT-2 124M with ``PAR_VOCAB`` at
   tp = 2 (every rank seeded alike): ``InferenceEngine(mesh=2)`` on each
   rank, rank 0 scheduling, 8 slots, the lattice cut to phase 3's one
   point (``HARD_LATTICE``), the paged gather arm then the dense layout;
   phase 3's prompts and 32 new tokens, request ``SHARD_SAMPLED_ROW``
   sampled (``SHARD_SAMPLED``).  Gates: every stream token-identical to a
   one-process engine's on the same weights, the compile count frozen
   after ``warmup()`` at mesh point ``2dev:tp=2``, B1 launched on each
   rank and B4 not.  Printed: tokens/s and TTFT p50 of that window;
   then, from a second window of other prompts with each program call
   synchronized on rank 0, its tokens/s, bytes staged and the
   collectives' share (the layers' and the plans') over the decode
   steps.  Then a one-rank NCCL mesh engine, graphed, against
   ``mesh=None``: streams bit-identical.  (b) BERT-large at tp = 2,
   phase 11's batch without ``valid_length``, dropout 0, Adam at
   ``SHARD_BERT_LR``; (c) Transformer-big with one shared vocabulary of
   ``NMT_VOCAB`` at tp = 2, phase 12's batch, Adam at ``NMT_LR``; each
   ``DP_STEPS`` steps against one process from rank 0's weights (rank 1
   seeded apart): losses (``TOL_LOSS``), every rank's blocks
   (``TOL_SHARD_PARAM``, or phase 20's 2 * lr a step where tighter) and
   each parameter's travel from its start (``TOL_SHARD_TRAVEL``),
   B1-B3 a rank a step (``SHARD_LAUNCHES``); then
   (c)'s greedy ``translate`` of ``SHARD_SOURCES`` sources on both
   ranks against the one-process net's: token-identical, or split only
   where the one-process net's own logits tie within ``TOL_GREEDY``
   (printed with the margin).
23. Queue A7 on GPT-2 124M, float32, TF32 off (``a7_path``).  (a)
   Disaggregated serving, paged float32 and int8 pages, phase 3's
   prompts with ``A7_NEW`` new tokens (odd requests sampled by seed) on
   one (8, 512) lattice point (``A7_ENG``): a unified engine, then a
   ``role="prefill"`` engine with ``migrate_to(decode.adopt)``; a first
   run starts the decode engine only once every request has migrated,
   so the engines' launches read apart, a second runs both.  Gates:
   every stream identical to the unified engine's, compiles frozen after
   ``warmup()`` on both roles, B1 launched on the prefill engine, B4 on
   the decode engine and B1 not.  Printed: a bundle's bytes, export,
   digest and adopt ms a request, TTFT p50 against the unified engine.
   (b) The tiered prefix cache (``TIER_ENG``: a pool of 48 pages, 4
   system-prompt families of ``TIER_SYSTEM`` tokens over
   ``TIER_ROUNDS`` rounds, ``TIER_HOST_BYTES`` of host pool and a disk
   tier in a temporary directory): streams identical with the tier on
   and off, demotions, promotions and disk spills happen, and one
   ``serving.tier_rot`` fault is refused at verify and quarantined with
   the stream unchanged.  Printed: the counts, hits by tier, promote ms
   (verify on the worker, install), prefill tokens saved.  (c) A
   ``FleetRouter`` over 3 replicas (``FLEET_ENG``) and rounds of
   ``FLEET_FAMILIES`` families x ``FLEET_MEMBERS``: the affinity hit
   rate; one replica killed mid-round (0 lost, streams identical); a
   rolling restart; ``scale_up`` (warm before it joins: 0 compiles on
   traffic); ``scale_down`` of the replica most families route to (its
   seeds planted, each of its families' next requests a hit on a
   survivor).
24. The chaos sweep on the card: ``tools/chaos_sweep_torch.py --device
   cuda --corroborate --kills 2 --steps 6`` in a subprocess (so the lock
   witness is on before the port's first import; ``CHAOS_TIMEOUT``).
   Its serving nets are GPT-2 124M at full width cut to 2 layers, at 32
   times the CPU sweep's lengths (256-token seq bucket and pages, 1024
   positions); its training scenarios train GPT-2 at full width (one
   layer, vocab 512) over 256-token sequences; the engines' programs are
   eager.  Gates: every scenario passed (``training/
   kill_resume_determinism`` bit-identical on the card),
   ``raceguard_corroboration`` with no ``unexercised`` or ``unmapped``
   site, B1 and B4 launched by the serving scenarios' served traffic
   (the fault-free references and the engines' warm-ups counted apart)
   and B1-B3 by the training ones (``launches_by_path["chaos_serve"]``,
   ``["chaos_train"]``).  Printed: each scenario's verdict and seconds,
   the phase's seconds; the report goes to
   ``chiprun_out/chaos_report.json``.
25. The symbolic surface (``symbolic_path``), float32, TF32 off.  (a)
   GPT-2 124M at full width (``get_gpt2("gpt2_124m")``, seed 0, dropout
   0), hybridized, is called at B2 and B4 x T1024, then exported
   (``HybridBlock.export``: ``torch.export`` with a symbolic batch, its
   attention the custom op ``mxnet_tpu_torch::flash_fwd``) and reloaded
   (``SymbolBlock.imports``, no model class).  Gates: the imported
   block's logits at B2 and B4 within ``TOL_SYMBOL`` of the hybridized
   net's, and B1 launched 12 times per call and no other kernel
   (``launches_by_path["symbol_block"]``, both calls).  Printed: export
   and import seconds, the imported block's ms against the net's graphed
   ms at B2.  (b) ``Module.fit`` of the classic MLP symbol
   (``example/train_mnist_module.py``'s) on the synthetic MNIST of
   ``mx.io.MNISTIter`` for ``MODULE_EPOCHS`` epochs on the card: the
   validation accuracy above ``MODULE_ACC``; samples/s printed over
   every epoch after the first (which binds and warms up).  (c)
   ``optimize_for(backend="FUSE_BN")`` of phase 10's ResNet-50 v1 (NHWC,
   BatchNorm statistics drawn from the seed) at B``FUSE_B``: the fused
   net's outputs within ``TOL_FUSE`` of the unfused net's, every
   BatchNorm folded, ms of both (hybridized) printed.  (d) ONNX:
   ``export_model`` and ``import_model`` of ResNet-18 v1 at
   B``ONNX_B`` x 224² on the card, the imported outputs within
   ``TOL_ONNX`` of the net's; the GPT-2 of (a) refused with the typed
   error naming ``mxnet_tpu_torch::flash_fwd``.  (b) to (d) launch no
   kernel of the port.
26. Queue A9.2 (``a92_path``), float32 with TF32 off but (c)'s amp.
   (a) ``example/train_sparse_embedding.py``'s BowClassifier at its
   width (``Embedding(1_000_000, 64, sparse_grad=True)`` and a
   ``Dense(2)``, batch 64 x 16 tokens, the example's task from the
   seed) through ``gluon.Trainer`` in arms one after another: Adam with
   the lazy row update, Adam with ``sparse_grad=False``, SGD on the
   sparse and on the dense gradient, ``BOW_WARM`` + ``BOW_STEPS`` steps
   each from one set of weights.  Gates: the SGD arms' weights within
   ``TOL_BOW_SGD``; the lazy Adam arm's within ``TOL_BOW_ADAM`` of a
   plain numpy lazy Adam on the CPU (float64 forward and backward) from
   the same weights and batches, untouched rows bit-identical; every
   gradient compact (never densified), at most 1024 rows; the sparse
   arm's peak allocated memory at least the dense gradient's
   256,000,000 bytes below the dense arm's; ``row_sparse_pull`` of
   1024 ids from the 1M-row table exactly those rows; ``sparse.dot`` of
   the batch's bag of words (64 x 1M CSR, 16 a row) within
   ``TOL_BOW_DOT`` of the gather-and-sum.  Printed: each arm's ms/step
   and peak MiB, the rows touched a step.  (b) ``mx.np`` on the card:
   every float op of ``tools/np_cases.py`` (the reference's tables) on
   a CUDA array and on the CPU, at each case's tolerance (eigen and QR
   results by absolute value), and the gradients of its sample of
   differentiable ops (``TOL_NP_GRAD``); printed: the count checked.
   (c) ``mx.image`` feeding phase 10's ResNet-50 v1 (NHWC, B128 x 224²,
   amp, ``ShardedTrainer`` SGD): ``IMG_N`` seeded 256² images packed as
   JPEG into a ``.rec`` (``recordio.pack_img``), read by ``ImageIter``
   with ``CreateAugmenter(**IMG_AUG)`` through ``DevicePrefetcher`` for
   8 steps.  Gates: every loss finite, and the prefetched batches equal
   a second ``ImageIter``'s from the same seeds, bit for bit.  Printed:
   ``ImageIter``'s host images/s alone, input wait p50 and max, ms/step
   fed against the same step on the batches resident.  No kernel of the
   port launches in phase 26 (``launches_by_path["a92"]``).
27. A ``{"kernels": [...]}`` line, the card line again, and the last
   line ``{"ok": true, "device": {...}}``.  ``launches_by_path`` holds
   every phase's launches (``bert``, ``bert_amp``, ``nmt``, ``lstm``,
   ``ops``, phase 16's graphed arms ``hybrid_bert_amp``,
   ``graph_train``, ``graph_amp`` and ``graph_vision``, phase 17's
   fault-free run ``resilient``, phase 18's ``hardened`` and phase 19's
   ``data`` among them, phase 20's ``parallel_ring`` /
   ``parallel_ulysses``, phase 21's ``parallel_tp`` / ``parallel_ep``
   / ``parallel_pp``, phase 22's ``sharded_serve`` /
   ``parallel_bert`` / ``parallel_nmt``, rank 0's over its steps, and
   phase 23's ``disagg_prefill``, ``disagg_decode``, ``tiered`` and
   ``fleet``, phase 24's ``chaos_serve`` and ``chaos_train``, phase
   25's ``symbol_block``, ``module_fit`` and ``fuse_bn``, phase 26's
   ``a92``); the
   seconds of every phase are printed and written to
   ``chiprun_out/chip_smoke_phases.json``; the flash kernels carry
   their numbers at phases 11-12's shapes and phase 21's tp shape
   (``shapes``), phase 12's launches by attention and the
   cross-attention call's times.  B2's ring modes are
   entries of their own (``flash_dq[partial]``, ``flash_dq[given]``),
   their launches phase 20 (c)'s ring's on rank 0.

Phase 2 also times B1, B2 and B3 in bf16 at the training shape, the
shape phase 7 gives them, B4 at phase 9's chunk shape (8 rows x 256
queries over tables sharing 32 prefix pages) and verify shape (9 rows x
5 queries), float32 and int8, and B1-B3 at phases 11-12's shapes: BERT's
non-causal B8 T512 H16 D64 (float32 and bf16), Transformer-big's B16
T256 H16 D64 non-causal and causal, and one cross-attention call (q
from one tensor, k and v projections of another) through the flash
route against the reference path, dQ and the memory's gradient
included.  B2 computes each row's delta from its own P and dP (the
reference's kernel is given rowsum(dO * O)) and is held on it too; B3
is fed B2's delta, as the training backward runs them.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
VOCAB = 50257

# tolerances (max-abs, in float32): float32 kernels reassociate the
# softmax sums only; bf16 rounds inputs and the probability tile; int8
# is held against the plain version's own dequantize of the same pages
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
TOL_INT8 = 1e-4
# full-width logits, kernel read arm vs gather arm over the same pages:
# 12 layers of reassociated attention sums in float32
TOL_LOGITS = 1e-3
# B2/B3 are held as max-abs error over the plain version's max-abs:
# gradients reach O(10) at T = 1024, so a fixed absolute bound would
# loosen or tighten with the shape.  float32: the kernels reassociate
# the float32 sums only (1e-4); bf16: both sides round P and dS to bf16
# at the same places, but a product one ulp (2**-8 = 3.9e-3) apart can
# land on another rounding of dS (2e-2)
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
# full-width loss and gradients, flash kernels vs impl='ref' attention,
# each gradient's max-abs error over its own max-abs: 12 layers of
# float32 sums taken in another order, forward and backward
TOL_GRAD = 1e-3
TOL_LOSS = 1e-5
# the canonical MLP program, card vs CPU from the same weights: float32
# on both (TF32 off), sums taken in another order over 20 SGD steps
TOL_MLP_LOSS = 1e-5
# phase 25.  The imported GPT-2 against the hybridized net: the same ops
# and kernels, B1 included, replayed eagerly from the program instead of
# from a CUDA graph; float32 logits at T 1024 (max-abs, the port's
# float32 parity bound)
TOL_SYMBOL = 1e-4
SYMBOL_T = 1024
SYMBOL_BATCHES = (2, 4)
# Module.fit of the classic MLP symbol: the reference's known-good bar
# for it (tests/test_symbol_autovar.py:143, example/train_mnist_module.py)
MODULE_B = 100
MODULE_EPOCHS = 6
MODULE_ACC = 0.95
# FUSE_BN (max-abs error over max-abs, float32): the fold rounds each
# folded weight once more and reorders the BatchNorm arithmetic
FUSE_B = 32
TOL_FUSE = 1e-4
# the ONNX program against the net (max-abs error over max-abs): the
# same convolutions, BatchNorm as its formula
ONNX_B = 8
TOL_ONNX = 1e-4
# phase 26.  (a) example/train_sparse_embedding.py's BowClassifier at its
# own width: a 1M x 64 embedding with sparse gradients and a Dense(2),
# batch 64 x 16 tokens (each class's tokens from its own 1000-row
# region, the example's task), BOW_STEPS steps a Trainer arm after
# BOW_WARM; Adam at the example's 0.02, SGD at BOW_SGD_LR
BOW_VOCAB, BOW_DIM, BOW_B, BOW_T = 1_000_000, 64, 64, 16
BOW_STEPS, BOW_WARM, BOW_ADAM_LR, BOW_SGD_LR = 20, 2, 0.02, 0.5
# the sparse and the dense SGD arm's weights after BOW_STEPS steps, and
# the card's lazy Adam against a plain numpy lazy Adam on the CPU from
# the same initial values and batches (max-abs error over max-abs:
# float32 sums in another order, the sparse gradient's coalesce against
# the dense scatter; Adam's m / sqrt(v) damps them)
TOL_BOW_SGD, TOL_BOW_ADAM = 1e-5, 1e-4
# the dense gradient the sparse arm never allocates (1M x 64 float32)
BOW_DENSE_GRAD_BYTES = BOW_VOCAB * BOW_DIM * 4
# row_sparse_pull's ids; sparse.dot against the gather-and-sum (relative,
# float32 sums of 16 rows in another order)
BOW_PULL_IDS, TOL_BOW_DOT = 1024, 1e-5
# (b) mx.np on the card against the CPU: each case's own tolerance
# (tools/np_cases.py; float32 1e-5 to 1e-4 relative, decompositions
# 1e-4 to 1e-3), eigen and QR results by absolute value (their signs
# are a solver's choice); gradients (max-abs) at TOL_NP_GRAD
TOL_NP_GRAD = 1e-4
NP_SIGN_FREE = ("linalg.eigh[vals]", "linalg.eig", "linalg.qr")
# (c) mx.image feeding phase 10's ResNet-50 v1 (NHWC, B128 x 224^2, amp)
# through DevicePrefetcher: IMG_N seeded IMG_SRC^2 images packed as JPEG
# (recordio.pack_img, quality IMG_QUALITY), IMG_N / VISION_B steps
IMG_N, IMG_SRC, IMG_QUALITY, IMG_DEPTH = 1024, 256, 90, 2
IMG_AUG = dict(rand_crop=True, rand_mirror=True, mean=True, std=True,
               brightness=0.4, contrast=0.4, saturation=0.4, pca_noise=0.1)
# step 1 under amp (bf16 products) against phase 5's float32 step 1 on
# the same weights and batch.  The loss, relative: the sound policy
# reads 1.084e-05 on an H100, the loss computed in bf16 (a control)
# 2.9e-04.  Each gradient's max-abs error over its own max-abs (as
# ``grad_errors``): the sound policy's worst leaf reads 6.3e-02 (the
# last layer's q_proj.weight, a small difference of bf16 scores at
# initialization), and so do the controls; this limit holds the
# gradients' flow (a cast that cut the graph reads 1), the dtypes at
# the named points hold the casts
TOL_AMP_STEP1 = 1e-4
TOL_AMP_GRAD = 1e-1
# the dtype the reference's policy gives at each named point of every
# layer (held against the reference by tests/test_torch_amp.py)
AMP_DTYPES = {"ln1 out": "float32", "q_proj": "bfloat16",
              "k_proj": "bfloat16", "v_proj": "bfloat16",
              "attention out": "bfloat16", "ln2 out": "float32",
              "ffn hidden": "bfloat16", "gelu out": "bfloat16",
              "residual stream": "float32", "ln_f out": "float32",
              "logits": "bfloat16", "loss": "float32"}
# controls for phase 7's step-1 checks: float32 ops of the policy
# forced to bf16 through amp.init's target_precision_ops; each must fail
# at least one of the checks
AMP_CONTROLS = {"LayerNorm in bf16": ["LayerNorm"],
                "the loss in bf16": ["log_softmax", "softmax_cross_entropy",
                                     "logsumexp", "mean"]}

# phase 8, the routed family (``__graft_entry__.py:113-117``'s MoE GPT-2
# with 8 experts): remat against none on the same deterministic kernels
# and dropout masks (the recomputation replays them); the list-wise
# update against the per-parameter one and the card against the CPU
# differ only in the order of float32 sums (norms, reductions)
MOE_CFG = dict(num_experts=8, moe_every=2, moe_top_k=2,
               moe_capacity_factor=1.25)
MOE_LR, MOE_WD, MOE_DROPOUT, MOE_PARITY_B = 1e-3, 0.01, 0.1, 4
TOL_REMAT_LOSS, TOL_REMAT_GRAD, TOL_MULTI = 1e-6, 1e-5, 1e-6

# the training path: bench.py's chip configuration for GPT-2 124M
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 16, 1024, 5, 1e-4
# the canonical program: MNIST's batch shape, SGD at 0.1
MLP_B, MLP_STEPS, MLP_LR = 128, 20, 0.1
# substrings of the GEMM kernels' names (cuBLAS, cuBLASLt, CUTLASS)
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")

# phase 10: bench.py's ResNet-50 arm (bench.py:370-394), SGD at 0.1 with
# momentum 0.9, its gates at batch 8
VISION_B, VISION_SIZE, VISION_STEPS, VISION_PARITY_B = 128, 224, 5, 8
VISION_OPT = {"learning_rate": 0.1, "momentum": 0.9}
# lr 0.1 with momentum 0.9 overshoots on the repeated batch: from 8.65
# the loss climbs to ~18 by step 5, is back under step 1's by step 10
# (float32) or 11 (amp), wavers under amp to step 16 and falls steadily
# from step 20 (6.50 float32, 6.36 amp at step 24 on an H100).  So
# after the timed steps each arm goes on, untimed, to this many steps,
# and its last loss must be below its first
VISION_TRAIN_STEPS = 24
# a training step's FLOP per image (bench.py's 3 x ResNet-50 v1's
# forward), held against float32's peak outside the tensor cores (TF32
# is off): the H100 SXM's published 67 TFLOP/s
VISION_FLOP_PER_IMAGE = 3 * 4.1e9
F32_SIMT_PEAK = 67e12
# card against CPU at batch 8, float32 with TF32 off: cuDNN's algorithms
# (implicit GEMM, Winograd, FFT) sum in another order than the CPU's
# through 53 convolutions and BatchNorms.  The loss relative; the
# moving statistics after the step each as max-abs error over its
# max-abs; logits over their max-abs; NCHW against NHWC on the card the
# same
TOL_VISION_LOSS = 1e-5
TOL_VISION_STATE = 1e-3
TOL_VISION_LOGITS = 1e-4
# ResNet-50's step-1 gradients are ill-conditioned in float32 (against
# float64, the CPU's float32 leaves part by a median 2-3 % of their
# max-abs, the worst by ~30 %): the card's global L2 error to the CPU's
# float64 step may be at most this multiple of the CPU float32's
TOL_VISION_GRAD_RATIO = 2.0
# step 1 under amp (bf16 convolutions, float32 BatchNorm) against (a)'s
# float32 step 1 on the same weights and batch, relative
TOL_VISION_AMP = 2e-2
# phase 10's kernel classes: a kernel counts in the first class one of
# whose marks its lower-cased name holds
VISION_CLASSES = (
    ("layout transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd",
                     "implicit", "xmma", "cudnn", "fft", "gemm")),
    ("copy or cast", ("copy",)),
    ("elementwise", ("elementwise", "reduce")),
)

# phase 11: bench.py's BERT-large arm (bench.py:731-790), cut in nothing:
# batch 8 x 512, 64 masked positions a row, Adam lr 1e-4, dropout 0.1,
# remat='dots'; its kernels-vs-reference gate at batch 4
BERT_B, BERT_T, BERT_MASKED, BERT_VOCAB = 8, 512, 64, 30522
BERT_STEPS, BERT_LR, BERT_DROPOUT, BERT_PARITY_B = 5, 1e-4, 0.1, 4
# a training step's FLOP per sample, bench.py:785-787's count for
# 24 x 1024
BERT_FLOP_PER_SAMPLE = (BERT_T * (6.0 * 12 * 24 * 1024 * 1024 +
                                  12.0 * 24 * 1024 * BERT_T) +
                        6.0 * BERT_MASKED * 1024 * BERT_VOCAB)
# phase 12: bench.py's Transformer-big arm (bench.py:679-725): batch 16,
# source and target 256 tokens, vocab 32000, dropout 0, Adam lr 1e-4;
# its gate at batch 4
NMT_B, NMT_T, NMT_VOCAB, NMT_STEPS, NMT_LR, NMT_PARITY_B = (
    16, 256, 32000, 5, 1e-4, 4)
# FLOP per target token, bench.py:712-718's count for 6 + 6 layers of
# 1024 units, 4096 hidden
NMT_FLOP_PER_TOKEN = (6.0 * (6 * ((4 * 1024 * 1024 + 2 * 1024 * 4096) +
                                  (8 * 1024 * 1024 + 2 * 1024 * 4096)) +
                             1024 * NMT_VOCAB) + 24.0 * 6 * 1024 * NMT_T)
# greedy translate against a teacher-forced forward over its tokens:
# the emitted token's logit at most this far (relative) below the
# position's largest.  The two forwards run other shapes (a growing
# prefix against the whole sequence), so their float32 sums differ in
# order; random weights make near-ties, so no exact argmax is asked
TOL_GREEDY = 1e-4
# phase 13: the "medium" PTB word model of Zaremba, Sutskever and
# Vinyals (2014): 650 units, 2 layers, dropout 0.5, vocab 10000, 35
# steps x batch 20, SGD lr 1, gradients clipped at a global norm of 5
LSTM_VOCAB, LSTM_UNITS, LSTM_T, LSTM_B = 10000, 650, 35, 20
LSTM_DROPOUT, LSTM_LR, LSTM_CLIP, LSTM_STEPS = 0.5, 1.0, 5.0, 10
# cuDNN's fused LSTM against the step-by-step version on the card,
# float32 with TF32 off: the same products summed in another order over
# 35 steps, forward and backward; each over its own max-abs
TOL_RNN = 1e-4

# phase 14: the nd op surface at the sizes of the public models that use
# it.  (a) SSD-300, VGG16 on VOC (Liu et al. 2016; GluonCV's
# ssd_300_vgg16_atrous_voc): six maps, anchor sizes (30, 60, 111, 162,
# 213, 264, 315) / 300 as (s_k, sqrt(s_k s_k+1)), ratios (1, 2, 1/2) on
# maps 1, 5 and 6 and (1, 2, 1/2, 3, 1/3) on maps 2-4, GluonCV's steps
# (8, 16, 32, 64, 100, 300) / 300: 8732 anchors; batch 32, 21 classes,
# 56 label rows of which 1-40 valid
SSD_MAPS = (38, 19, 10, 5, 3, 1)
SSD_SIZES = (30, 60, 111, 162, 213, 264, 315)
SSD_STEPS = (8, 16, 32, 64, 100, 300)
SSD_WIDE = (1, 2, 3)                        # the maps with five ratios
SSD_ANCHORS, SSD_B, SSD_CLASSES, SSD_GT = 8732, 32, 21, 56
# (b) Faster R-CNN's VGG16 ROI head (Ren et al. 2015): conv5 of two
# 600 x 1000 images, 128 ROIs an image; (c) Mask R-CNN's C4 head (He et
# al. 2017): res4 of the same images, 512 ROIs an image
RCNN_MAP, RCNN_ROIS, RCNN_POOL = (2, 512, 38, 63), 256, (7, 7)
MASK_MAP, MASK_ROIS, MASK_POOL = (2, 1024, 38, 63), 1024, (14, 14)
# (c)'s CPU comparison takes these of its ROIs (its CPU run at all 1024
# would hold a 3.3 GB sample tensor for minutes of CPU time)
MASK_HELD_ROIS = 128
# (d) the spatial transformer of Jaderberg et al. (2015) on CUB: 448 x
# 448 crops sampled to 224 x 224 by an affine grid, batch 64
STN_IN, STN_OUT = (64, 3, 448, 448), (224, 224)
# (e) GP-sized linalg: 64 SPD matrices of 1024 (A = X X^T / 1024 + I),
# 64 right-hand sides; det on 64 x 64 (1024 overflows float32)
GP_B, GP_N, GP_RHS, DET_N = 64, 1024, 64, 64
# the float64 residuals on the CPU take these of the 64 matrices (each
# a 1024^3 float64 product there); det's take all
GP_HELD = 8
# (f) draws a sampler, GPT-2's vocabulary for sample_multinomial; (g)
# scatter_nd's updates and shape
SAMPLE_N, MULTI_ROWS, SHUFFLE_ROWS = 1 << 24, 1024, 1 << 20
SCATTER_N, SCATTER_SHAPE = 1 << 20, (4096, 4096)
# card against the CPU (the same port op, float32): values whose float
# ops are the same on both (maxima, products of a few terms, exp/log a
# few ulp apart) at 1e-5 of their max-abs; gradients summed by atomics
# in another order (up to thousands of terms a pixel) at 1e-4.  Kept
# sets, class targets and masks are exact, but for an NMS row whose IoU
# with its suppressor lies within TOL_NMS_EDGE of the threshold
TOL_OPS, TOL_OPS_GRAD, TOL_NMS_EDGE = 1e-5, 1e-4, 1e-5
# linalg against float64 on the CPU by residual: float32 factorizations
# of well conditioned 1024-matrices (condition < 10) reach ~1e-6
TOL_LINALG = {"potrf": 1e-5, "trsm": 1e-5, "inverse": 1e-5,
              "slogdet": 1e-5, "det": 1e-4}
# samplers: mean and variance within this many standard errors
SIGMAS = 6.0

# phase 15: the compiled programs.  (a) phase 3's engine, the eager and
# the graphed arm in turns, GRAPH_ROUNDS rounds, each arm serving phase
# 3's prompts with 32 then 128 new tokens (decode dominates), at one
# batch bucket (8: the prompts come 8 at a time); one round since the
# script outgrew its time, the eager arm first.  16c keeps
# VISION_GRAPH_ROUNDS for its eager-vs-eager control of cuDNN's
# algorithms
GRAPH_ROUNDS, GRAPH_NEW, GRAPH_BATCH_BUCKETS = 1, (32, 128), (8,)
VISION_GRAPH_ROUNDS = 2
# (b) a replay against the eager call from the same inputs: the same
# kernels in the same order, so tokens are identical and the caches the
# programs wrote agree but for a float32 GEMM whose cuBLAS algorithm
# differs under capture (max-abs)
TOL_REPLAY = 1e-5
# (d) ResNet-50 v1 in forward mode: 96 requests of 224 x 224 x 3 in 3
# waves at max_batch 32; each output against the block's direct forward
# of its wave, as max-abs error over the logits' max-abs (float32, TF32
# off; a batch that splits runs cuDNN's algorithms for another batch
# size, which sum in another order)
FWD_REQUESTS, FWD_WAVES, FWD_BATCH = 96, 3, 32
TOL_FORWARD = 1e-4
# phase 16: the compiled training programs, each part's eager and
# graphed arms in turns over GRAPH_ROUNDS rounds.  Graphed against eager
# from the same weights and batches: the same kernels in the same order,
# but cuBLAS and cuDNN may pick another algorithm for a call under
# capture (phase 15's TOL_REPLAY), so losses, gradients, parameters and
# moving statistics are held as max-abs error over their own max-abs
TOL_GRAPHED = 1e-5
# (d) the guarded replay and (e) dropout under replay: GPT-2 124M at
# this batch x 1024 tokens; (e) at dropout 0.1 under remat, learning
# rate 0 so that only the masks move the loss
GUARD_B, DROP_B = 4, 4
# phase 17: phase 4's GPT-2 124M step (16 x 1024, Adam at TRAIN_LR) under
# amp, guarded with the dynamic loss scaler, at dropout 0.1 (so the
# per-step reseed must reach the generator every captured graph
# registered), driven by ResilientLoop over RES_STEPS seeded batches, a
# commit every RES_SAVE steps (two kept), reseeded from RES_SEED.  The
# kill and rot schedules of (b) and (d) are written for RES_STEPS = 2 *
# RES_SAVE (each 1.49 GB commit costs 3-5 s)
RES_STEPS, RES_SAVE, RES_SEED, RES_DROPOUT = 8, 4, 7, 0.1
# GPT-2 124M's widths at RES_LAYERS of its 12 layers: a commit of its
# state (0.81 GB against 1.49) and a capture each fresh trainer makes
# cost less, and the phase keeps every part
RES_LAYERS = 4
RES_SCALE = 2.0 ** 16
# (a)'s timing: the bare trainer and the loop with tracing off and on,
# RES_TIMED steps each, in turns over RES_ROUNDS rounds; a timed loop's
# closing commit is not written (17a's run commits RES_STEPS // RES_SAVE
# times)
RES_TIMED, RES_ROUNDS = 5, 2


# phase 19: the data pipeline.  The card host has no libjpeg (nor its
# headers): its probe found PIL but neither jpeglib.h nor -ljpeg, so the
# native reader cannot build there and (b) reads seeded uint8 images
# from memory (gluon.data.ArrayDataset), not JPEG records; the native
# reader is held to the JAX package's on the CPU (tests).  (a) phase 4's
# GPT-2 124M step under amp, graphed, fed token records:
# DATA_WARM + DATA_ROUNDS x DATA_STEPS batches of TRAIN_B records of
# TRAIN_T + 1 seeded int32 tokens; (b) phase 10's ResNet-50 v1 NHWC
# step, graphed, fed DATA_IMG x DATA_IMG x 3 uint8 images cropped to
# VISION_SIZE and mirrored on the card (DeviceTransform), float32 and
# amp; two more batches for (b)'s profiled step, and a ring's worth
# (DATA_DEPTH) past it, so that the feeder is still copying while that
# step runs
DATA_WARM, DATA_ROUNDS, DATA_STEPS, DATA_PROFILE = 1, 2, 5, 2
DATA_DEPTH = 2
# phase 20: steps of (a) and (b); (b)'s final parameters against the
# one-process run's: Adam moves an element by at most ~lr a step, so two
# runs whose float32 gradients differ only in rounding (the dp sum's
# order) part by at most 2 * lr a step where a near-zero gradient flips
# sign; (c)'s rows of 1024 tokens; the ring's block shape for B2's
# modes (SP_B rows x 256, a zigzag half-chunk of 512)
DP_STEPS = 3
TOL_DP_PARAM = 2 * TRAIN_LR * DP_STEPS
SP_B = 8
RING_BLOCK = (SP_B, 256, 12, 64)
# phase 21: (a) GPT-2 124M at tp = 2 with nanoGPT's vocabulary, GPT-2's
# 50257 rounded up to a multiple of 64 (karpathy/nanoGPT model.py,
# GPTConfig.vocab_size = 50304), which tp divides as the vocabulary
# split needs; (b) phase 8's routed GPT-2 124M at ep = 2; (c) the stacked
# GPT-2 124M at pp = 2, 6 layers a stage, in PAR_MICRO microbatches.
# PAR_B x TRAIN_T rows, DP_STEPS Adam steps at TRAIN_LR each, held to one
# process by TOL_LOSS and TOL_DP_PARAM; (c)'s piped forward logits to the
# unpiped model's, over their max-abs: the same float32 products in other
# GEMM shapes (microbatches of 2 rows)
PAR_B, PAR_VOCAB, PAR_MICRO = 8, 50304, 4
PAR_PARTS = (("tp2", "tp"), ("ep2", "ep"), ("pp2", "pp"))
TOL_PAR_LOGITS = 1e-5
# phase 20 (b) and (c) run GPT-2 124M's widths at PAR_LAYERS of its 12
# layers: gloo's host staging, most of their time, grows with depth, and
# the cut keeps the script inside its time.  Phase 21 keeps the 12: at 6
# its routed part split one token's route at step 3 (a near-tie of
# float32 rounding under an exact gate on the dropped shares; PERF.md)
PAR_LAYERS = 6
# B1, B2, B3 a rank a step: (a) 12 layers of 6 heads; (b) 12 layers;
# (c) 6 layers x 4 microbatches, B1 again in remat's recomputation
PAR_LAUNCHES = {"tp2": [12, 12, 12], "ep2": [12, 12, 12],
                "pp2": [48, 24, 24]}
# phase 22: (a)'s layouts, new tokens and the sampled request; (c)'s
# translate: sources of SHARD_SRC_T tokens, at most SHARD_MAX_LEN out;
# B1, B2, B3 a rank a step of (b) (24 layers, no remat) and (c) (6
# encoder, 6 decoder self- and 6 cross-attention layers); parameters
# held as phase 20 holds them, at (b)'s and (c)'s learning rate
SHARD_LAYOUTS = ("paged", "dense")
SHARD_NEW = 32
SHARD_SAMPLED_ROW, SHARD_SAMPLED = 1, dict(temperature=0.8, top_k=50, seed=5)
SHARD_SOURCES, SHARD_SRC_T, SHARD_MAX_LEN = 4, 64, 16
SHARD_LAUNCHES = {"bert": [24, 24, 24], "nmt": [18, 18, 18]}
# (b)'s learning rate: at phase 11's 1e-4, Adam's sign-like first steps
# turn float32's rounding into a loss that is 4.3e-05 from float64 after
# 3 steps on one process (tools/tp_loss_noise.py), above TOL_LOSS, so no
# two float32 runs can be held to it; at 1e-5 the one-process run stays
# within it (PERF.md).  Parameters are held to TOL_SHARD_PARAM, or
# as phase 20 holds them (2 * lr a step) where that is tighter
SHARD_BERT_LR = 1e-5
TOL_SHARD_PARAM = 1e-4
# at lr 1e-5 that max-abs gate is twice what Adam moves a parameter in
# 3 steps, so it passes a block the step never updated; each parameter's
# travel from its start is held to the one process's as well (relative
# L2: 1.0 for a parameter left unchanged), but for the key projection's
# bias: softmax ignores a shift shared by every key, so its gradient is
# rounding alone, which Adam turns into steps of lr in any direction
TOL_SHARD_TRAVEL = 0.1
NO_GRADIENT = ("k_proj.bias",)
DATA_IMG = 256
DATA_MEAN = (123.68, 116.779, 103.939)
DATA_STD = (58.393, 57.12, 57.375)
# (b)'s gate: 3 steps an arm under deterministic cuDNN algorithms
DATA_GATE_STEPS = 3

# H100 SXM published peaks (dense): HBM bytes/s; bf16 on the tensor
# cores; float32 at float32 accuracy on the tensor cores, which takes
# three TF32 products (3xTF32) per product: 495 / 3 TFLOP/s.  A kernel on
# the tensor cores can beat the CUDA cores' 67 TFLOP/s, so that rate
# would not bound it.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}

# every kernel of the port, and where its Pallas original lives
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "paged_attention")
REPLACES = {"flash_fwd": "mxnet_tpu/ops/flash.py:100",
            "flash_dq": "mxnet_tpu/ops/flash.py:265",
            "flash_dkv": "mxnet_tpu/ops/flash.py:318",
            "paged_attention": "mxnet_tpu/ops/paged.py:82"}
SOURCES = {"flash_fwd": "mxnet_tpu_torch/csrc/flash_fwd.cu",
           "flash_dq": "mxnet_tpu_torch/csrc/flash_bwd.cu",
           "flash_dkv": "mxnet_tpu_torch/csrc/flash_bwd.cu",
           "paged_attention": "mxnet_tpu_torch/csrc/paged_attention.cu"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def maxabs(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def relerr(a, ref) -> float:
    """max-abs error of ``a`` over the max-abs of ``ref``."""
    return maxabs(a, ref) / max(float(ref.float().abs().max()), 1e-30)


def check(name, err, tol):
    ok = err <= tol
    print(f"  {name}: err={err:.3e} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: max-abs error {err} > {tol}")


class Timer:
    """Mean milliseconds per call by CUDA events, with a 128 MiB buffer
    rewritten before each call so every launch starts from a cold L2.
    The events bracket the call as the host issues it, so a call whose
    kernels take less time than the wrapper's host work reads the host
    work; ``device`` reads the kernels' own time."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(32 << 20, dtype=torch.float32,
                                     device=device)

    def __call__(self, fn, iters=20, warm=3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def device(self, fn, mark, iters=20, warm=3):
        """Mean device milliseconds per call of the kernels whose names
        hold ``mark``, from torch.profiler's trace of ``iters`` calls, L2
        flushed before each; None if the profiler saw no such kernel."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                self.flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        ms = sum(t for k, t in _device_rows(torch, prof) if mark in k)
        return ms / iters if ms > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate(by, dtype) -> str:
    """The peak rate a bound of kind ``by`` was taken at."""
    if by == "bytes":
        return f"{HBM_BPS / 1e12:g} TB/s"
    return f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s {dtype}"


# ------------------------------------------------------------- kernels

def attended(torch, dev, b, t, causal, seg):
    """Segment ids (None, or packed rows of three documents of ragged
    lengths, the same in every row) and the (T, T) mask of attended
    (query, key) pairs they and ``causal`` leave."""
    keep = torch.ones((t, t), dtype=torch.bool, device=dev)
    if causal:
        keep = torch.tril(keep)
    if not seg:
        return None, keep
    cuts = torch.tensor([t // 3, t // 3 + t // 4], device=dev)
    qseg = (torch.arange(t, device=dev)[:, None] >= cuts).sum(1)
    qseg = qseg.to(torch.int32)[None].expand(b, t).contiguous()
    return qseg, keep & (qseg[0][:, None] == qseg[0][None, :])


def flash_cases(torch, dev, timer, card):
    """B1 against its plain version in every configuration the port
    takes; returns the main-path case's numbers."""
    from mxnet_tpu_torch.ops import flash as F
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def run(tag, b, t, h, d, dtype, causal, seg=False, tol=TOL_F32):
        q, k, v = (torch.randn((b, t, h, d), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        qseg, keep = attended(torch, dev, b, t, causal, seg)
        scale = d ** -0.5
        o, lse = F.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                             scale=scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = F._fwd_plain(q, k, v, qseg, qseg, causal, scale)
        err = max(maxabs(o, o_ref), maxabs(lse, lse_ref))
        check(f"flash_fwd {tag}", err, tol)
        o2, lse2 = F.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                               scale=scale)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash_fwd {tag}: a second launch gave "
                                 "other bits")
        ms = timer(lambda: F.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                                       scale=scale))
        plain_ms = timer(lambda: F._fwd_plain(q, k, v, qseg, qseg, causal,
                                              scale))
        lib_ms = None
        if not seg:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
        # bytes: q, k, v read and o written once, lse (and segment ids);
        # operations: two multiply-adds per (query, attended key, lane)
        io_bytes = (4 * b * t * h * d * q.element_size() + b * h * t * 4
                    + (2 * b * t * 4 if seg else 0))
        flops = 4 * d * b * h * int(keep.sum())
        dname = str(dtype).split(".")[1]
        b_ms, b_by = bound(io_bytes, flops, dname)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib}, "
              f"bound {b_ms:.4f} ms ({b_by} at {rate(b_by, dname)}) "
              f"[{card}]", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    print("B1 flash_fwd vs plain:", flush=True)
    run("causal B4 T512 H12 D64 f32", 4, 512, 12, 64, torch.float32, True)
    run("causal B4 T512 H12 D64 bf16", 4, 512, 12, 64, torch.bfloat16, True,
        tol=TOL_BF16)
    run("causal+segments B2 T512 H4 D64 f32", 2, 512, 4, 64, torch.float32,
        True, seg=True)
    run("full B2 T256 H4 D128 f32", 2, 256, 4, 128, torch.float32, False)
    run("causal B1 T256 H2 D256 bf16", 1, 256, 2, 256, torch.bfloat16, True,
        tol=TOL_BF16)
    # the serving path's prefill shape: 8 prompts in the 512 bucket, f32
    run("serving-path causal B8 T512 H12 D64 f32", 8, 512, 12, 64,
        torch.float32, True)
    # the training path's shape, the one the kernels line reports (its
    # launches are the training path's), and in bf16 phase 7's
    f32 = run(f"training-path causal B{TRAIN_B} T{TRAIN_T} H12 D64 f32",
              TRAIN_B, TRAIN_T, 12, 64, torch.float32, True)
    bf16 = run(f"training-path causal B{TRAIN_B} T{TRAIN_T} H12 D64 bf16",
               TRAIN_B, TRAIN_T, 12, 64, torch.bfloat16, True, tol=TOL_BF16)
    lang = {tag: run(tag, *shape, tol=TOL_F32 if dt == torch.float32
                     else TOL_BF16)
            for tag, shape, dt in language_shapes(torch)
            + parallel_shapes(torch)}
    return f32, bf16, lang


def language_shapes(torch):
    """(tag, run arguments, dtype) of the shapes phases 11-12 give B1-B3:
    BERT-large's bidirectional attention (B8 T512 H16 D64, float32 and
    bf16) and Transformer-big's at B16 T256 H16 D64, non-causal (the
    encoder and the cross-attention) and causal (the decoder)."""
    out = []
    for b, t, causal, dt in ((BERT_B, BERT_T, False, torch.float32),
                             (BERT_B, BERT_T, False, torch.bfloat16),
                             (NMT_B, NMT_T, False, torch.float32),
                             (NMT_B, NMT_T, True, torch.float32)):
        model = "bert" if t == BERT_T else "nmt"
        kind = "causal" if causal else "full"
        name = str(dt).split(".")[1]
        out.append((f"{model} {kind} B{b} T{t} H16 D64 {name}",
                    (b, t, 16, 64, dt, causal), dt))
    return out


def parallel_shapes(torch):
    """Phase 21 (d): the shape phase 21 (a) gives B1-B3 on each tp rank,
    GPT-2 124M's 12 heads split over tp = 2, at PAR_B x TRAIN_T, float32
    (as ``language_shapes``)."""
    return [(f"tp2 causal B{PAR_B} T{TRAIN_T} H6 D64 float32",
             (PAR_B, TRAIN_T, 6, 64, torch.float32, True), torch.float32)]


def flash_bwd_cases(torch, dev, timer, card):
    """B2 (dQ) and B3 (dK, dV) against their plain versions in every
    configuration the port takes, each held to repeat bit for bit;
    returns the main-path case's numbers for each kernel."""
    from mxnet_tpu_torch.ops import flash as F
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def run(tag, b, t, h, d, dtype, causal, seg=False):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        qseg, keep = attended(torch, dev, b, t, causal, seg)
        scale = d ** -0.5
        _o, lse = F.flash_fwd(q, k, v, qseg, qseg, causal=causal,
                              scale=scale)
        # B2 computes each row's delta from its own P and dP (a first pass
        # over the keys); B3 is fed it, as the training backward runs them
        args = (q, k, v, do, lse, qseg, qseg)
        kw = dict(causal=causal, scale=scale)
        dq, delta = F.flash_dq(*args, **kw)
        dkv_args = (q, k, v, do, lse, delta, qseg, qseg)
        dk, dv = F.flash_dkv(*dkv_args, **kw)
        torch.cuda.synchronize()
        dq_ref, delta_ref = F._dq_plain(*args, causal, scale)
        dk_ref, dv_ref = F._dkv_plain(*dkv_args, causal, scale)
        rel = {"flash_dq": relerr(dq, dq_ref),
               "flash_dkv": max(relerr(dk, dk_ref), relerr(dv, dv_ref))}
        absd = {"flash_dq": maxabs(dq, dq_ref),
                "flash_dkv": max(maxabs(dk, dk_ref), maxabs(dv, dv_ref))}
        for name in rel:
            check(f"{name} {tag} (over plain max-abs)", rel[name],
                  TOL_BWD[dname])
        check(f"flash_dq {tag}: delta (over plain max-abs)",
              relerr(delta, delta_ref), TOL_BWD[dname])
        dq2, delta2 = F.flash_dq(*args, **kw)
        dk2, dv2 = F.flash_dkv(*dkv_args, **kw)
        pairs = ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))
        if not all(torch.equal(a, c) for a, c in pairs):
            raise AssertionError(f"flash_dq/flash_dkv {tag}: a second "
                                 "launch gave other bits")
        ms = {"flash_dq": timer(lambda: F.flash_dq(*args, **kw)),
              "flash_dkv": timer(lambda: F.flash_dkv(*dkv_args, **kw))}
        plain = {"flash_dq": timer(lambda: F._dq_plain(*args, causal,
                                                       scale)),
                 "flash_dkv": timer(lambda: F._dkv_plain(*dkv_args, causal,
                                                         scale))}
        lib_ms = None
        if not seg:
            # the library yardstick: SDPA's backward, dQ, dK and dV in one
            # call (timed here only; the port never calls it)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2)
            lib_ms = timer(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
        # operations per attended (query, key) pair: B2 computes S, dP
        # and dQ (3 products, 6*D; its first pass, which repeats S and dP
        # for its own delta, is the design's and not the function's), B3
        # S, dP, dV and dK (8*D), the whole backward the five distinct
        # products (10*D); bytes: q, k, v, dO (and O for the whole
        # backward) read once, lse and delta (read, or written by B2),
        # the segment ids, each output written once (delta is no input
        # of the whole backward, which reads O instead)
        pairs = b * h * int(keep.sum())
        n = b * t * h * d * q.element_size()
        rows = 2 * b * h * t * 4 + (2 * b * t * 4 if seg else 0)
        work = {"flash_dq": (5 * n + rows, 6 * d * pairs),
                "flash_dkv": (6 * n + rows, 8 * d * pairs),
                "whole backward": (8 * n + rows - b * h * t * 4,
                                   10 * d * pairs)}
        out = {}
        for name, (nbytes, flops) in work.items():
            b_ms, b_by = bound(nbytes, flops, dname)
            if name in ms:
                out[name] = dict(max_abs_err=absd[name], rel_err=rel[name],
                                 ms=ms[name], plain_ms=plain[name],
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms)
                print(f"    {name}: kernel {ms[name]:.4f} ms, plain "
                      f"{plain[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by} "
                      f"at {rate(b_by, dname)}) [{card}]", flush=True)
            else:
                lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a"
                print(f"    whole backward: B2+B3 "
                      f"{ms['flash_dq'] + ms['flash_dkv']:.4f} ms, sdpa "
                      f"backward {lib}, bound {b_ms:.4f} ms ({b_by} at "
                      f"{rate(b_by, dname)}) [{card}]", flush=True)
        return out

    print("B2 flash_dq / B3 flash_dkv vs plain (T = 300: ragged tiles):",
          flush=True)
    for causal, seg, d in ((True, False, 64), (False, False, 128),
                           (True, True, 64), (True, False, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            kind = ("causal+segments" if seg else
                    "causal" if causal else "full")
            run(f"{kind} B2 T300 H3 D{d} {str(dtype).split('.')[1]}", 2,
                300, 3, d, dtype, causal, seg)
    # the training path's shape: GPT-2 124M at batch 16 x 1024, float32
    # (phases 4-5) and bf16 (phase 7)
    main = {dt: run(f"training-path causal B{TRAIN_B} T{TRAIN_T} H12 D64 "
                    f"{dt}", TRAIN_B, TRAIN_T, 12, 64, getattr(torch, dt),
                    True)
            for dt in ("float32", "bfloat16")}
    lang = {tag: run(tag, *shape) for tag, shape, _dt in
            language_shapes(torch) + parallel_shapes(torch)}
    return main, lang


def cross_case(torch, dev, timer, card):
    """One cross-attention call through the flash route: q from one
    tensor, k and v projections of another (the encoder's output), at
    Transformer-big's B16 T256 H16 D64 float32.  Output, dQ and the
    memory's gradient (through B3's dK and dV) against the reference
    path; forward and backward timed against it and SDPA."""
    from mxnet_tpu_torch.ops import attention
    from mxnet_tpu_torch.ops import flash as F
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    b, t, h, d = NMT_B, NMT_T, 16, 64
    q = torch.randn((b, t, h, d), generator=g, device=dev)
    mem = torch.randn((b, t, h * d), generator=g, device=dev)
    wk, wv = (torch.randn((h * d, h * d), generator=g, device=dev) /
              (h * d) ** 0.5 for _ in range(2))
    cot = torch.randn((b, t, h, d), generator=g, device=dev)

    def run(fn):
        qq, mm = q.clone().requires_grad_(), mem.clone().requires_grad_()
        k = (mm @ wk).reshape(b, t, h, d)
        v = (mm @ wv).reshape(b, t, h, d)
        out = fn(qq, k, v)
        return (out.detach(),) + torch.autograd.grad((out * cot).sum(),
                                                     (qq, mm))

    reset_launches()
    got = run(lambda qq, k, v: F.flash_attention(qq, k, v))
    n = read_launches()
    want = run(lambda qq, k, v: attention._attention_ref(qq, k, v))
    if [n[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")] != [1, 1, 1]:
        raise AssertionError(f"cross-attention launches {n}")
    print("cross-attention (q and k/v from different tensors), B16 T256 "
          "H16 D64 f32, flash route vs reference path:", flush=True)
    check("cross output", maxabs(got[0], want[0]), TOL_F32)
    check("cross dQ (over its max-abs)", relerr(got[1], want[1]),
          TOL_BWD["float32"])
    check("cross d memory through dK, dV (over its max-abs)",
          relerr(got[2], want[2]), TOL_BWD["float32"])

    def sdpa(qq, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            qq.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) \
            .transpose(1, 2)
    ms = {name: timer(lambda fn=fn: run(fn), iters=10)
          for name, fn in (("flash", F.flash_attention),
                           ("plain", attention._attention_ref),
                           ("sdpa", sdpa))}
    print(f"    forward + backward with the projections: flash route "
          f"{ms['flash']:.4f} ms, reference path {ms['plain']:.4f} ms, "
          f"sdpa {ms['sdpa']:.4f} ms [{card}]", flush=True)
    return ms


def engine_table(lens, max_new, ps, npt):
    """The page table ``InferenceEngine`` builds for requests of prompt
    lengths ``lens``: its own ``PagePool`` of ``len(lens) * npt`` pages
    gives each slot the distinct pages of prompt + ``max_new`` positions,
    and unassigned entries and the parked last row point at the zero
    page (id = pool size).  Returns the (slots + 1, npt) int32 table and
    the pool size."""
    from mxnet_tpu_torch.serving.kv_pages import PagePool
    pool = PagePool(len(lens) * npt, ps)
    table = np.full((len(lens) + 1, npt), pool.scratch, np.int32)
    for i, n in enumerate(lens):
        pages = pool.alloc(pool.pages_for(min(n + max_new, npt * ps)))
        table[i, :len(pages)] = pages
    return table, pool.num_pages


def shared_prefix_table(b, npt, shared, rs):
    """A chunk batch's page table: ``b`` rows whose first ``shared``
    logical pages are the same physical pages (a prefix hit's whole
    pages), the rest distinct, in random order.  Returns the (b, npt)
    int32 table and the pool size."""
    n_pool = shared + b * (npt - shared)
    perm = rs.permutation(n_pool).astype(np.int32)
    table = np.empty((b, npt), np.int32)
    table[:, :shared] = perm[:shared]
    table[:, shared:] = perm[shared:].reshape(b, npt - shared)
    return table, n_pool


def paged_cases(torch, dev, timer, card, lens):
    """B4 against its plain version; returns the main-path case's
    numbers and those at phase 9's chunk and verify shapes (float32).
    ``lens`` are the main path's prompt lengths."""
    from mxnet_tpu_torch.ops import paged as P
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    rs = np.random.RandomState(SEED + 1)

    def case(tag, b, tq, h, d, ps, npt, dtype, quant=False, layout=None,
             qpos=None, tol=TOL_F32, time_rows=None, park=True,
             device_time=False):
        """``layout`` is ``engine_table``'s (table, pool size), or
        ``shared_prefix_table``'s; by default distinct pages in random
        order, the last row parked on the zero page unless not ``park``.
        ``time_rows``: also time the kernel on the first rows only;
        ``device_time``: also read the profiler's device time."""
        if layout is None:
            n_pool = b * npt
            table = rs.permutation(n_pool).astype(np.int32).reshape(b, npt)
            if park:
                table[-1] = n_pool
        else:
            table, n_pool = layout
        table = torch.from_numpy(table).to(dev)
        # the model's pool layout: pages, the zero page, a trash page
        n_pages, zero = n_pool + 2, n_pool
        kf = torch.randn((n_pages, ps, h, d), generator=g, device=dev) * 2
        vf = torch.randn((n_pages, ps, h, d), generator=g, device=dev) * 2
        kf[zero] = 0
        vf[zero] = 0
        q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
        if qpos is None:
            base = torch.randint(0, npt * ps - tq, (b, 1), generator=g,
                                 device=dev)
            qpos = base + torch.arange(tq, device=dev)[None]
        qpos = qpos.to(torch.int32).contiguous()
        ks = vs = None
        if quant:
            kp, ks = P.kv_quantize(kf)
            vp, vs = P.kv_quantize(vf)
        else:
            kp, vp = kf.to(dtype), vf.to(dtype)
        out = P.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                v_scale=vs)
        torch.cuda.synchronize()
        ref = P._paged_plain(q, kp, vp, table, qpos, ks, vs, d ** -0.5)
        err = maxabs(out, ref)
        check(f"paged_attention {tag}", err, tol)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"paged_attention {tag}: output not finite")
        if not torch.equal(out, P.paged_attention(q, kp, vp, table, qpos,
                                                  k_scale=ks, v_scale=vs)):
            raise AssertionError(f"paged_attention {tag}: a second launch "
                                 "gave other bits")
        def call():
            return P.paged_attention(q, kp, vp, table, qpos, k_scale=ks,
                                     v_scale=vs)

        ms = timer(call)
        dev_ms = None
        if time_rows is not None:
            tr, qr = table[:time_rows].contiguous(), qpos[:time_rows]
            q_r = q[:time_rows].contiguous()

            def call_r():
                return P.paged_attention(q_r, kp, vp, tr, qr, k_scale=ks,
                                         v_scale=vs)

            ms_r = timer(call_r)
            # the events read the wrapper's host work here (two launches
            # of a few microseconds each): the profiler reads the kernels
            dev_ms = timer.device(call, "paged_")
            dev_r = timer.device(call_r, "paged_")
            print(f"    without the last row: kernel {ms_r:.4f} ms (with "
                  f"it {ms:.4f} ms); device time of both passes (profiler) "
                  f"{fmt_ms(dev_ms)}, without the last row {fmt_ms(dev_r)} "
                  f"[{card}]", flush=True)
        elif device_time:
            dev_ms = timer.device(call, "paged_")
            print(f"    device time of both passes (profiler) "
                  f"{fmt_ms(dev_ms)} [{card}]", flush=True)
        plain_ms = timer(lambda: P._paged_plain(q, kp, vp, table, qpos, ks,
                                                vs, d ** -0.5))
        # bytes: every distinct physical page holding a key <= some
        # row's last query read once (k and v, plus their scales when
        # int8; the zero page once however many rows walk it), q read,
        # out written, table and positions; operations: two multiply-adds
        # per (query, attended key, lane)
        qp = qpos.long().clamp(max=npt * ps - 1)
        walked = (qp.max(dim=1).values // ps + 1).tolist()
        pages = torch.cat([table[r, :n] for r, n in enumerate(walked)]) \
            .unique().numel()
        per_pos = h * d * kp.element_size() + (h * 4 if quant else 0)
        io_bytes = (2 * pages * ps * per_pos + 2 * q.numel() *
                    q.element_size() + table.numel() * 4 + qpos.numel() * 4)
        flops = 4 * d * h * int((qp + 1).sum())
        b_ms, b_by = bound(io_bytes, flops, "float32")
        print(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by} at {rate(b_by, 'float32')}) [{card}]",
              flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    device_ms=dev_ms)

    print("B4 paged_attention vs plain:", flush=True)
    case("decode B8 H12 D64 ps16 P64 f32", 8, 1, 12, 64, 16, 64,
         torch.float32)
    case("decode B8 H12 D64 ps16 P64 int8", 8, 1, 12, 64, 16, 64,
         torch.float32, quant=True, tol=TOL_INT8)
    case("decode B8 H12 D64 ps16 P64 bf16", 8, 1, 12, 64, 16, 64,
         torch.bfloat16, tol=TOL_BF16)
    case("chunk Tq16 B4 H12 D64 ps16 P64 f32", 4, 16, 12, 64, 16, 64,
         torch.float32)
    case("chunk Tq16 B4 H12 D64 ps16 P64 int8", 4, 16, 12, 64, 16, 64,
         torch.float32, quant=True, tol=TOL_INT8)
    # the smallest head dim the kernel is built for
    case("decode B8 H12 D32 ps16 P64 f32", 8, 1, 12, 32, 16, 64,
         torch.float32)
    case("decode B8 H12 D32 ps16 P64 int8", 8, 1, 12, 32, 16, 64,
         torch.float32, quant=True, tol=TOL_INT8)
    # one slot walking all 64 pages (the split walk's longest row alone)
    case("decode B1 all 64 pages H12 D64 ps16 f32", 1, 1, 12, 64, 16, 64,
         torch.float32, qpos=torch.tensor([[64 * 16 - 1]], device=dev),
         park=False)
    # walks of 1, 4 and 33 pages in one batch (a split of 4 pages ends
    # inside the first, on its boundary and one page past the eighth)
    walks = torch.tensor([[10], [3 * 16 + 5], [32 * 16 + 7]], device=dev)
    for dtype, quant, tol in ((torch.float32, False, TOL_F32),
                              (torch.float32, True, TOL_INT8),
                              (torch.bfloat16, False, TOL_BF16)):
        kind = "int8" if quant else str(dtype).split(".")[1]
        case(f"decode B3 walks of 1/4/33 pages H12 D64 ps16 {kind}", 3, 1,
             12, 64, 16, 64, dtype, quant=quant, qpos=walks, tol=tol,
             park=False)
    # phase 9's multi-query shapes: a chunk batch of 8 rows x 256
    # queries (the chunk bucket) whose tables share a 512-token prefix,
    # half of them right behind it; and a verify window of k + 1 = 5
    # queries over 8 slots and the parked scratch row
    chunk_layout = shared_prefix_table(8, 64, 32, rs)
    start = np.array([512, 100, 512, 300, 512, 740, 512, 0])
    chunk_qpos = torch.from_numpy(start[:, None] + np.arange(256)).to(dev)
    multi = {}
    for quant, tol in ((False, TOL_F32), (True, TOL_INT8)):
        kind = "int8" if quant else "f32"
        multi[("chunk", kind)] = case(
            f"chunk B8 Tq256 shared prefix H12 D64 ps16 P64 {kind}", 8, 256,
            12, 64, 16, 64, torch.float32, quant=quant, layout=chunk_layout,
            qpos=chunk_qpos, tol=tol, device_time=not quant)
        verify_qpos = torch.tensor([[n + 16] for n in lens] + [[64 * 16]],
                                   device=dev) + torch.arange(5, device=dev)
        multi[("verify", kind)] = case(
            f"verify B9 Tq5 H12 D64 ps16 P64 {kind}", 9, 5, 12, 64, 16, 64,
            torch.float32, quant=quant,
            layout=engine_table(lens, 64, 16, 64), qpos=verify_qpos,
            tol=tol, device_time=not quant)
    # the main path's decode step halfway through its 32 new tokens: 8
    # slots on the engine's page layout + the parked scratch row (pos =
    # Tmax walks all 64 zero-page entries), 512 pages, f32; timed also
    # without the parked row
    npt = 64
    qpos = torch.tensor([[n + 16] for n in lens] + [[npt * 16]], device=dev)
    main = case("main-path decode B9 H12 D64 ps16 P64 f32", 9, 1, 12, 64,
                16, npt, torch.float32, layout=engine_table(lens, 32, 16, npt),
                qpos=qpos, time_rows=len(lens))
    return main, {"chunk": multi[("chunk", "f32")],
                  "verify": multi[("verify", "f32")]}


# ------------------------------------------------------------ main path

def make_prompts():
    rs = np.random.RandomState(SEED)
    return [rs.randint(0, VOCAB, (int(n),)).astype(np.int32)
            for n in rs.randint(300, 501, size=8)]


def _launches():
    """The port's registry of kernel launch counters."""
    from mxnet_tpu_torch.ops import launches
    return launches


def reset_launches():
    """Set every kernel wrapper's launch counts to 0."""
    _launches().reset()


def read_launches() -> dict:
    """{kernel wrapper: launches}."""
    return _launches().totals()


def read_launches_by_dtype() -> dict:
    """{flash wrapper: {dtype name: launches}}."""
    return _launches().by_dtype()


def serve(torch, net, prompts, card, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    eng = InferenceEngine(net, kv_layout="paged", num_slots=8, max_batch=8,
                          page_size=16, seq_buckets=(64, 128, 256, 512),
                          **kw)
    n_warm = eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.start()
    outs = [f.result(600) for f in futs]
    wall = time.monotonic() - t0
    launches = read_launches()
    eng.stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    s = eng.stats()
    for p, o in zip(prompts, outs):
        if o.shape != (len(p) + 32,) or not np.array_equal(o[:len(p)], p) \
                or o.min() < 0 or o.max() >= VOCAB:
            raise AssertionError("served sequence has the wrong shape or "
                                 "out-of-vocab tokens")
    gen = s["counters"]["tokens_generated"]
    arm = kw.get("paged_attention"), kw.get("kv_quant")
    print(f"  serve arm={arm}: warmup programs {n_warm}, {gen} tokens in "
          f"{wall:.3f} s = {gen / wall:.1f} tokens/s, TTFT p50 "
          f"{s['latency']['ttft']['p50'] * 1e3:.1f} ms, peak memory "
          f"{peak:.0f} MiB, launches {launches} [{card}]", flush=True)
    return outs, launches


class PagedBatch:
    """One engine-shaped paged batch of the 8 prompts at the model level:
    the engine's page table (``engine_table``), the prompts padded to the
    512 bucket with their lengths and slot ids, and the decode positions
    (the parked row at ``max_length``)."""

    PS = 16

    def __init__(self, torch, net, prompts):
        self.torch, self.net, dev = torch, net, net.device
        s, npt = len(prompts), net.max_length // self.PS
        lens = np.array([len(p) for p in prompts], np.int32)
        table, self.n_pool = engine_table(lens, 32, self.PS, npt)
        toks = np.zeros((s, 512), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        self.table, self.toks, self.lens = (torch.from_numpy(a).to(dev)
                                            for a in (table, toks, lens))
        self.sidx = torch.arange(s, dtype=torch.int32, device=dev)
        self.pos = np.full((s + 1,), net.max_length, np.int32)
        self.pos[:s] = lens

    def caches(self, kv_quant=None):
        return self.net.init_page_cache(self.n_pool + 1, self.PS,
                                        kv_quant=kv_quant)

    def prefill(self, caches, kernel):
        logits, _ = self.net.prefill_slots(
            self.toks, self.lens, caches, self.sidx, page_table=self.table,
            paged_kernel=kernel)
        return logits

    def decode(self, tok, caches, kernel):
        """One decode step of ``tok`` (slots + 1,) at the current
        positions; the caller advances ``pos``."""
        dev = self.net.device
        logits, _ = self.net.decode_step(
            self.torch.from_numpy(tok).to(dev), caches,
            self.torch.from_numpy(self.pos).to(dev), page_table=self.table,
            paged_kernel=kernel)
        return logits


def logits_parity(torch, net, prompts, kv_quant):
    """Per-step logits of the kernel and gather read arms over the same
    page tables and tokens: one prefill of all 8 prompts in the 512
    bucket, then 8 decode steps."""
    pb = PagedBatch(torch, net, prompts)
    s = len(prompts)
    caches = {arm: pb.caches(kv_quant) for arm in ("kernel", "gather")}
    logits = {arm: pb.prefill(caches[arm], arm == "kernel")
              for arm in caches}
    worst = maxabs(logits["kernel"], logits["gather"])
    tok = np.zeros((s + 1,), np.int32)
    for _step in range(8):
        tok[:s] = logits["kernel"][:s].argmax(-1).cpu().numpy()
        for arm in caches:
            logits[arm] = pb.decode(tok, caches[arm], arm == "kernel")
        worst = max(worst, maxabs(logits["kernel"][:s],
                                  logits["gather"][:s]))
        pb.pos[:s] += 1
    check(f"logits kernel vs gather arm (kv_quant={kv_quant})", worst,
          TOL_LOGITS)
    return worst


# annotations the card's timeline also shows: a profiler schedule's
# steps, and the ranges of ``profiler.Marker`` (the serving metrics'
# spans around each program call) and of the tracer's span bridge; each
# covers kernels rather than running any
_ANNOTATIONS = ("ProfilerStep", "marker:", "span:")


def _device_events(torch, prof):
    """The kernels and copies a profile recorded on the card: its
    device events but for the annotations (``_ANNOTATIONS``) on the
    card's timeline."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(_ANNOTATIONS)]


def _device_rows(torch, prof):
    """(name, device ms) of the kernels and copies a profile recorded."""
    rows = []
    for e in _device_events(torch, prof):
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            rows.append((e.key, us / 1e3))
    return sorted(rows, key=lambda r: -r[1])


def _device_counts(torch, prof, marks):
    """How many kernels whose names hold each of ``marks`` the profile
    recorded on the card (a graph's replay is traced kernel by
    kernel)."""
    counts = dict.fromkeys(marks, 0)
    for e in _device_events(torch, prof):
        for mark in marks:
            if mark in e.key:
                counts[mark] += e.count
    return counts


def report_profile(torch, name, wall, prof, card, marks=(), classes=(),
                   want=None):
    """Print wall time, device-busy time and share, each kernel of
    ``marks`` (substrings of kernel names) with its share and the count
    of its launches the profiler saw, the share of each of ``classes``
    ((label, marks): a kernel counts in the first class one of whose
    marks its lower-cased name holds), and the kernels that took the
    most device time.  With ``want`` ({mark: launches}), fail unless the
    profiler saw that many of each."""
    rows = _device_rows(torch, prof)
    counts = _device_counts(torch, prof, marks)
    busy = sum(ms for _k, ms in rows)
    if not rows:
        print(f"  {name}: wall {wall:.3f} ms; the profiler recorded no "
              f"device time [{card}]", flush=True)
        if want:
            raise AssertionError(f"{name}: the profiler saw no kernel")
        return None
    print(f"  {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}) [{card}]",
          flush=True)
    gemm = sum(t for k, t in rows
               if any(g in k.lower() for g in GEMM_MARKS))
    print(f"    GEMMs: {gemm:.3f} ms, {gemm / busy:.1%} of busy", flush=True)
    for mark in marks:
        ms = sum(t for k, t in rows if mark in k)
        names = sorted({k[:k.find(">(") + 1] if ">(" in k else k[:80]
                        for k, _t in rows if mark in k})
        print(f"    {mark}: {ms:.3f} ms, {ms / busy:.1%} of busy, "
              f"{counts[mark]} launches seen ({', '.join(names)})",
              flush=True)
    if classes:
        by_class = dict.fromkeys([label for label, _m in classes]
                                 + ["other"], 0.0)
        for key, ms in rows:
            low = key.lower()
            label = next((lb for lb, ms_ in classes
                          if any(m in low for m in ms_)), "other")
            by_class[label] += ms
        print("    by class: " + ", ".join(
            f"{label} {ms:.3f} ms ({ms / busy:.1%})"
            for label, ms in by_class.items()), flush=True)
    for key, ms in rows[:8]:
        print(f"    {ms:9.3f} ms {ms / busy:6.1%}  {key[:100]}", flush=True)
    if want is not None and any(counts[m] != n for m, n in want.items()):
        raise AssertionError(f"{name}: the profiler saw {counts} kernel "
                             f"launches, the counters credit {want}")
    return 1 - busy / wall


def profile_steps(torch, net, prompts, card):
    """Where the serving path's time goes: torch.profiler over one
    prefill of the 8 prompts in the 512 bucket, then 8 decode steps of
    the kernel arm, each ending in a host read of its tokens as the
    engine's steps do."""
    from torch.profiler import ProfilerActivity, profile
    pb = PagedBatch(torch, net, prompts)
    s = len(prompts)
    caches = pb.caches()
    last = np.zeros((s + 1,), np.int32)

    def prefill():
        last[:s] = pb.prefill(caches, True).argmax(-1).cpu().numpy()

    def decode():
        for _ in range(8):
            last[:] = pb.decode(last, caches, True).argmax(-1).cpu().numpy()
            pb.pos[:s] += 1

    print("where the time goes (kernel arm, f32):", flush=True)
    for name, fn in (("prefill B8 T512", prefill), ("8 decode steps", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        report_profile(torch, name, wall, prof, card,
                       marks=("flash_fwd", "paged_"))


def main_path(torch, card, prompts):
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"GPT-2 124M: {n_params} parameters on {net.device}", flush=True)
    print(f"  prompt lengths {[len(p) for p in prompts]}", flush=True)
    outs, launches = serve(torch, net, prompts, card,
                           paged_attention="kernel")
    for name in ("flash_fwd", "paged_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"serving path never launched {name}")
    outs_g, _ = serve(torch, net, prompts, card, paged_attention="gather")
    same = np.mean([np.mean(a[len(p):] == b[len(p):])
                    for a, b, p in zip(outs, outs_g, prompts)])
    print(f"  greedy tokens identical kernel vs gather arm: {same:.4f}",
          flush=True)
    logits_parity(torch, net, prompts, None)
    outs_q, _ = serve(torch, net, prompts, card, paged_attention="kernel",
                      kv_quant="int8")
    same_q = np.mean([np.mean(a[len(p):] == b[len(p):])
                      for a, b, p in zip(outs, outs_q, prompts)])
    print(f"  greedy tokens identical int8 vs f32 pages: {same_q:.4f}",
          flush=True)
    int8_logits = logits_parity(torch, net, prompts, "int8")
    profile_steps(torch, net, prompts, card)
    return launches, int8_logits


# ------------------------------------------------- the serving features

# phase 9's engines: phase 3's, with prompts chunked at the 256 bucket
FEATURES = dict(num_slots=8, max_batch=8, page_size=16,
                seq_buckets=(64, 128, 256, 512), prefill_chunk=256,
                batch_buckets=GRAPH_BATCH_BUCKETS)


def drive(torch, eng, waves, max_new):
    """Warm ``eng`` up, set the launch counts to 0, serve ``waves`` (each
    submitted once the one before it has completed) and read the counts.
    Returns a dict: the outputs, the stats, the launch counts, B4's
    multi-query launches in each wave, the wall time, each wave's TTFT
    p50 (ms) and the peak memory (MiB)."""
    from mxnet_tpu_torch.ops.paged import paged_attention
    eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, ttft, multi = [], [], []
    t0 = time.monotonic()
    with eng:
        for wave in waves:
            n0 = len(eng._ttft)
            m0 = paged_attention.multi_query_launches
            futs = [eng.submit(p, max_new_tokens=max_new) for p in wave]
            outs += [f.result(600) for f in futs]
            ttft.append(float(np.median(eng._ttft[n0:])) * 1e3)
            multi.append(paged_attention.multi_query_launches - m0)
    wall = time.monotonic() - t0
    prompts = [p for wave in waves for p in wave]
    for p, o in zip(prompts, outs):
        if o.shape != (len(p) + max_new,) or \
                not np.array_equal(o[:len(p)], p) or o.min() < 0 or \
                o.max() >= VOCAB:
            raise AssertionError("a served sequence is short or has the "
                                 "wrong prompt or out-of-vocab tokens")
    return dict(outs=outs, stats=eng.stats(), launches=read_launches(),
                multi=multi, wall=wall, ttft=ttft,
                peak=torch.cuda.max_memory_allocated() / 2 ** 20)


def same_share(a, b, prompts):
    """The share of generated tokens two runs agree on."""
    return float(np.mean([np.mean(x[len(p):] == y[len(p):])
                          for x, y, p in zip(a, b, prompts)]))


def report(name, r, card):
    gen = r["stats"]["counters"]["tokens_generated"]
    print(f"  {name}: {gen} tokens in {r['wall']:.3f} s = "
          f"{gen / r['wall']:.1f} tokens/s, TTFT p50 "
          f"{' / '.join(f'{t:.1f}' for t in r['ttft'])} ms, peak memory "
          f"{r['peak']:.0f} MiB, B4 launches "
          f"{r['launches']['paged_attention']} ({sum(r['multi'])} with "
          f"Tq > 1), flash {r['launches']['flash_fwd']} [{card}]",
          flush=True)


def chunk_logits(torch, net):
    """A 1000-token prompt prefilled as 4 chunks of the 256 bucket
    through B4, against one ``prefill_slots`` call at T = 1024 (B1):
    the last position's logits."""
    dev, ps = net.device, 16
    npt = net.max_length // ps
    table = torch.full((2, npt), npt, dtype=torch.int32, device=dev)
    table[0] = torch.arange(npt, dtype=torch.int32, device=dev)
    prompt = np.random.RandomState(SEED + 9).randint(0, VOCAB, 1000)
    toks = torch.zeros((1, 1024), dtype=torch.int32, device=dev)
    toks[0, :1000] = torch.from_numpy(prompt)
    sidx = torch.zeros((1,), dtype=torch.int32, device=dev)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)
    caches = net.init_page_cache(npt + 1, ps)
    reset_launches()
    for off in range(0, 1000, 256):
        n = min(256, 1000 - off)
        chunk = torch.zeros((1, 256), dtype=torch.int32, device=dev)
        chunk[0, :n] = toks[0, off:off + n]
        lg, _ = net.prefill_slots(chunk, i32(n), caches, sidx,
                                  offset=i32(off), page_table=table,
                                  paged_kernel=True)
    from mxnet_tpu_torch.ops.paged import paged_attention
    if paged_attention.multi_query_launches != 4 * len(net.blocks):
        raise AssertionError("the chunks did not all run B4 with Tq > 1")
    full, _ = net.prefill_slots(toks, i32(1000), net.init_page_cache(
        npt + 1, ps), sidx, page_table=table, paged_kernel=True)
    check("last-position logits, 4 chunks through B4 vs one T=1024 "
          "prefill (B1)", maxabs(lg, full), TOL_LOGITS)


def verify_logits(torch, net, prompts):
    """``verify_slots`` over a 5-token window (B4 at Tq 5) against 5
    sequential ``decode_step`` calls from the same cache state."""
    pb = PagedBatch(torch, net, prompts)
    s, dev = len(prompts), net.device
    caches = [pb.caches(), pb.caches()]
    first = [pb.prefill(c, True) for c in caches][0]
    win = np.random.RandomState(SEED + 5).randint(0, VOCAB, (s + 1, 5))
    win[:s, 0] = first[:s].argmax(-1).cpu().numpy()
    win = win.astype(np.int32)
    pos = torch.from_numpy(pb.pos).to(dev)
    lg_win, _ = net.verify_slots(torch.from_numpy(win).to(dev), caches[0],
                                 pos, page_table=pb.table, paged_kernel=True)
    worst = 0.0
    for i in range(5):
        lg = pb.decode(np.ascontiguousarray(win[:, i]), caches[1], True)
        worst = max(worst, maxabs(lg[:s], lg_win[:s, i]))
        pb.pos[:s] += 1
    check("verify window (Tq 5) vs 5 sequential decode steps", worst,
          TOL_LOGITS)


def full_depth_draft(torch, net, prompts):
    """A control for the drafter's quality: ``draft_slots`` over all
    the model's layers is the model itself, so its 4 proposals must be
    the tokens of 4 greedy decode steps from the same state (read from
    the pages it gathers, against decode steps through B4).  Returns
    the share that agree; under 0.9 the drafter is at fault."""
    pb = PagedBatch(torch, net, prompts)
    s, dev = len(prompts), net.device
    caches = pb.caches()
    tok = np.zeros((s + 1,), np.int32)
    tok[:s] = pb.prefill(caches, True)[:s].argmax(-1).cpu().numpy()
    greedy = (torch.zeros(s + 1, device=dev),
              torch.zeros(s + 1, dtype=torch.int32, device=dev),
              torch.ones(s + 1, device=dev))
    drafts = net.draft_slots(
        torch.from_numpy(tok).to(dev), caches,
        torch.from_numpy(pb.pos).to(dev), 4, len(net.blocks), *greedy,
        np.zeros(s + 1, np.int64), page_table=pb.table).cpu().numpy()
    agree = []
    for i in range(4):
        tok = pb.decode(tok, caches, True).argmax(-1).to(torch.int32) \
            .cpu().numpy()
        agree.append(drafts[:s, i] == tok[:s])
        pb.pos[:s] += 1
    share = float(np.mean(agree))
    print(f"  drafter over all {len(net.blocks)} layers vs 4 greedy decode "
          f"steps: {share:.4f} of proposals agree", flush=True)
    if share < 0.9:
        raise AssertionError("the full-depth drafter does not propose the "
                             "model's tokens")
    return share


def feature_prompts(rs, lo, hi, n=8):
    return [rs.randint(0, VOCAB, (int(k),)).astype(np.int32)
            for k in rs.randint(lo, hi + 1, size=n)]


def features_path(torch, card, prompts):
    """Phase 9: chunked prefill, prefix reuse, page pressure and
    speculative decode at full width.  Returns each path's launch counts
    and B4's multi-query launches."""
    from mxnet_tpu_torch.models import get_gpt2
    from mxnet_tpu_torch.serving import InferenceEngine
    t_phase = time.monotonic()
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    rs = np.random.RandomState(SEED + 3)
    by_path, multi_by_path = {}, {}

    def engine(**kw):
        cfg = dict(FEATURES, kv_layout="paged")
        cfg.update(kw)
        return InferenceEngine(net, **cfg)

    def keep(path, r):
        by_path[path] = r["launches"]
        multi_by_path[path] = sum(r["multi"])
        if multi_by_path[path] <= 0:
            raise AssertionError(f"the {path} path never launched B4 with "
                                 "Tq > 1")

    print("9a chunked prefill: 8 prompts of 600-1000 tokens, chunks of 256, "
          "16 new tokens", flush=True)
    long = feature_prompts(rs, 600, 1000)
    print(f"  prompt lengths {[len(p) for p in long]}", flush=True)
    r = drive(torch, engine(), [long], 16)
    report("kernel arm f32", r, card)
    print(f"  prefill chunk batches {r['stats']['counters']['prefill_chunks']}"
          , flush=True)
    keep("chunk", r)
    chunk_logits(torch, net)
    g = drive(torch, engine(paged_attention="gather"), [long], 16)
    report("gather arm f32", g, card)
    print(f"  greedy tokens identical kernel vs gather arm: "
          f"{same_share(r['outs'], g['outs'], long):.4f}", flush=True)
    q = drive(torch, engine(kv_quant="int8"), [long], 16)
    report("kernel arm int8", q, card)
    print(f"  greedy tokens identical int8 vs f32 pages: "
          f"{same_share(r['outs'], q['outs'], long):.4f}", flush=True)

    print("9b prefix reuse: a 512-token prefix, suffixes of 32-64 tokens, "
          "two waves of 8", flush=True)
    prefix = rs.randint(0, VOCAB, 512)
    waves = [[np.concatenate([prefix, rs.randint(0, VOCAB, int(n))])
              .astype(np.int32) for n in rs.randint(32, 65, size=8)]
             for _ in range(2)]
    r = drive(torch, engine(), waves, 16)
    report("kernel arm f32, wave 1 / wave 2", r, card)
    c = r["stats"]["counters"]
    print(f"  prefix hits {c['prefix_hits']}, tokens reused "
          f"{c['prefix_tokens_saved']}, misses {c['prefix_misses']}; B4 "
          f"launches with Tq > 1 by wave {r['multi']}", flush=True)
    if c["prefix_hits"] < 8 or c["prefix_tokens_saved"] < 8 * 496:
        raise AssertionError("wave 2 did not reuse the cached prefix")
    if r["multi"][1] <= 0:
        raise AssertionError("the suffixes behind the hits never launched "
                             "B4 with Tq > 1")
    keep("prefix", r)
    d = drive(torch, engine(kv_layout="dense", prefix_pool_rows=0), waves,
              16)
    report("dense, no prefix cache", d, card)
    print(f"  greedy tokens identical paged with hits vs dense without: "
          f"{same_share(r['outs'], d['outs'], waves[0] + waves[1]):.4f}",
          flush=True)

    print("9c page pressure: 8 prompts of 400-500 tokens, 128 new, 160 "
          "pages", flush=True)
    press = feature_prompts(rs, 400, 500)
    need = sum(-(-(len(p) + 128) // 16) for p in press)
    print(f"  prompt lengths {[len(p) for p in press]}; lifetimes need "
          f"{need} pages", flush=True)
    r = drive(torch, engine(num_pages=160), [press], 128)
    report("kernel arm f32, 160 pages", r, card)
    c = r["stats"]["counters"]
    print(f"  preemptions {c['preemptions']}, resumes "
          f"{c['preempt_resumes']}, page faults {c['page_faults']}, prefix "
          f"hits {c['prefix_hits']}", flush=True)
    if c["preemptions"] <= 0 or c["completed"] != len(press):
        raise AssertionError("page pressure preempted nothing, or a "
                             "request did not complete")
    keep("pressure", r)
    roomy = drive(torch, engine(), [press], 128)
    report("kernel arm f32, 512 pages", roomy, card)
    print(f"  greedy tokens identical pressured vs unpressured: "
          f"{same_share(r['outs'], roomy['outs'], press):.4f}", flush=True)

    print("9d speculative decode: phase 3's prompts, 64 new, k = 4, 2 draft "
          "layers", flush=True)
    verify_logits(torch, net, prompts)
    full_depth_draft(torch, net, prompts)
    # prompts of at most 512 take phase 3's full path (B1), so every B4
    # launch with Tq > 1 below is a verify window
    off = drive(torch, engine(prefill_chunk=512), [prompts], 64)
    report("spec off", off, card)
    on = drive(torch, engine(prefill_chunk=512, spec_tokens=4,
                             draft_layers=2), [prompts], 64)
    report("spec on", on, card)
    sp = on["stats"]["counters"]
    print(f"  acceptance {on['stats']['rates']['spec_acceptance_rate']} "
          f"({sp['spec_tokens_accepted']} of {sp['spec_tokens_proposed']} "
          f"drafts, {sp['spec_cycles']} cycles, {sp['spec_pages_rewound']} "
          f"pages rewound); greedy tokens identical spec on vs off: "
          f"{same_share(on['outs'], off['outs'], prompts):.4f}", flush=True)
    keep("spec", on)
    print(f"phase 9: {time.monotonic() - t_phase:.1f} s", flush=True)
    return by_path, multi_by_path


# -------------------------------------------------------- training path

def grad_parity(torch, net, toks, labels):
    """One step's loss and every parameter's gradient with the flash
    kernels, against the same step with ``impl='ref'`` attention (the
    dispatch patched for this check only)."""
    import functools

    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.models import gpt2_lm_loss, transformer
    params = list(net.parameters())
    t, lab = (torch.from_numpy(x).to(net.device) for x in (toks, labels))

    def step():
        reset_launches()
        with training_mode(True):
            loss = gpt2_lm_loss(net(t), lab)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return loss.detach(), grads, read_launches()

    loss_k, g_k, n_k = step()
    orig = transformer.dot_product_attention
    transformer.dot_product_attention = functools.partial(orig, impl="ref")
    try:
        loss_r, g_r, n_r = step()
    finally:
        transformer.dot_product_attention = orig
    n_layers = len(net.blocks)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if n_k[name] != n_layers or n_r[name] != 0:
            raise AssertionError(f"grad parity: {name} launched "
                                 f"{n_k[name]} / {n_r[name]} times")
    check(f"loss B{t.shape[0]} T{t.shape[1]} kernels vs impl='ref' "
          "(relative)", abs(float(loss_k) - float(loss_r)) /
          abs(float(loss_r)), TOL_LOSS)
    # k_proj.bias adds the same q.b to every score of a row, which the
    # softmax cancels: its gradient is zero in exact arithmetic and both
    # runs return rounding noise, so it is held against the largest
    # gradient of the model instead of its own
    names = [n for n, _ in net.named_parameters()]
    errs = grad_errors(names, g_k, g_r)
    worst = int(np.argmax(errs))
    check(f"{len(errs)} gradients kernels vs impl='ref' (worst "
          f"{names[worst]}, over its max-abs)", errs[worst], TOL_GRAD)


def train_batch():
    rs = np.random.RandomState(SEED)
    return tuple(rs.randint(0, VOCAB, (TRAIN_B, TRAIN_T)).astype(np.int32)
                 for _ in range(2))


def train_path(torch, card):
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    toks, labels = train_batch()
    print(f"training GPT-2 124M, batch {TRAIN_B} x {TRAIN_T} tokens, Adam "
          f"lr {TRAIN_LR}, float32:", flush=True)
    grad_parity(torch, net, toks[:4], labels[:4])
    trainer = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                             optimizer_params={"learning_rate": TRAIN_LR})
    losses = [trainer.step(toks, labels)]        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.step(toks, labels))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [float(x) for x in losses]
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    print(f"  losses {losses}", flush=True)
    print(f"  {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step, "
          f"{TRAIN_STEPS * TRAIN_B * TRAIN_T / wall:.1f} tokens/s, peak "
          f"memory {peak:.0f} MiB (reserved {reserved_mib(torch):.0f}), "
          f"launches per step {per_step} [{card}]", flush=True)
    n_layers = len(net.blocks)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if per_step[name] != n_layers:
            raise AssertionError(f"training path launched {name} "
                                 f"{per_step[name]} times per step, not "
                                 f"{n_layers}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    print("where the time goes (one training step):", flush=True)
    prof, wall_ms = profiled(torch, lambda: trainer.step(toks, labels))
    # the step replays its graph: the profiler's count of each kernel
    # holds the counters, which replays credit from the capture
    report_profile(torch, f"train step B{TRAIN_B} T{TRAIN_T}", wall_ms, prof,
                   card, marks=("flash_fwd", "flash_dq", "flash_dkv"),
                   want=dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"),
                                      n_layers))
    return launches, losses


def grad_errors(names, grads, ref):
    """Each gradient's max-abs error over its reference's max-abs;
    ``k_proj.bias`` (zero in exact arithmetic: the softmax cancels it)
    over the largest reference gradient's instead."""
    top = max(float(g.abs().max()) for g in ref)
    return [maxabs(a, b) / (top if n.endswith("k_proj.bias") else
                            max(float(b.abs().max()), 1e-30))
            for n, a, b in zip(names, grads, ref)]


def gluon_step(mx, net, trainer, loss_fn, x, y):
    """One step of the canonical MXNet loop; returns the per-sample
    losses."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss.detach()


def gluon_path(torch, card, toks, labels, want_losses):
    """The MXNet imperative loop on a fresh GPT-2 124M (same seed, same
    batch) held to the ShardedTrainer's losses ``want_losses`` step by
    step, and its first gradients to ``torch.autograd.grad`` of
    ``gpt2_lm_loss``.  Returns the launches, the losses and step 1's
    gradients over the batch size."""
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    x = mx.nd.array(toks, dtype="int32")
    y = mx.nd.array(labels, dtype="int32")
    print(f"gluon loop on {x.context}: GPT-2 124M, batch {TRAIN_B} x "
          f"{TRAIN_T}, SoftmaxCrossEntropyLoss, gluon.Trainer adam lr "
          f"{TRAIN_LR}, float32:", flush=True)
    with training_mode(True):
        ref_loss = gpt2_lm_loss(net(x.tensor), y.tensor)
    ref = torch.autograd.grad(ref_loss, list(net.parameters()))
    del ref_loss
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": TRAIN_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = [gluon_step(mx, net, trainer, loss_fn, x, y)]     # warm-up
    params = net.collect_params()
    names = list(params.keys())
    # p.grad() holds the summed per-sample gradients; step() scales
    # them by 1 / batch (a power of two: exact)
    grads1 = [p.grad().tensor / TRAIN_B for p in params.values()]
    errs = grad_errors(names, grads1, ref)
    worst = int(np.argmax(errs))
    check(f"{len(errs)} step-1 p.grad() / {TRAIN_B} vs autograd.grad of "
          f"gpt2_lm_loss (worst {names[worst]}, over its max-abs)",
          errs[worst], TOL_GRAD)
    del ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        losses.append(gluon_step(mx, net, trainer, loss_fn, x, y))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [float(v.mean().asscalar()) for v in losses]
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    print(f"  losses {losses}", flush=True)
    print(f"  {TRAIN_STEPS} steps in {wall:.3f} s: "
          f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step, "
          f"{TRAIN_STEPS * TRAIN_B * TRAIN_T / wall:.1f} tokens/s, peak "
          f"memory {peak:.0f} MiB (reserved {reserved_mib(torch):.0f}), "
          f"launches per step {per_step} [{card}]", flush=True)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if per_step[name] != len(net.blocks):
            raise AssertionError(f"gluon loop launched {name} "
                                 f"{per_step[name]} times per step, not "
                                 f"{len(net.blocks)}")
    for i, (got, want) in enumerate(zip(losses, want_losses)):
        check(f"gluon loss step {i} vs ShardedTrainer (relative)",
              abs(got - want) / abs(want), TOL_LOSS)
    if len(losses) != len(want_losses):
        raise AssertionError("the two loops took different step counts")
    print("where the time goes (one gluon step):", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gluon_step(mx, net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(torch, f"gluon step B{TRAIN_B} T{TRAIN_T}", wall_ms, prof,
                   card, marks=("flash_fwd", "flash_dq", "flash_dkv"))
    return launches, losses, grads1


# ------------------------------------------------ the canonical program

def mnist_batches():
    """``MLP_STEPS`` MNIST-shaped batches: pixels in [0, 1), labels of a
    fixed random linear teacher over the pixels."""
    rs = np.random.RandomState(SEED)
    teacher = rs.randn(784, 10).astype(np.float32)
    out = []
    for _ in range(MLP_STEPS):
        x = rs.rand(MLP_B, 1, 28, 28).astype(np.float32)
        out.append((x, (x.reshape(MLP_B, -1) @ teacher).argmax(1)
                    .astype(np.float32)))
    return out


def mlp_program(mx, params=None):
    """The canonical program's net and loop pieces, as a user writes
    them; ``params`` (structural name → numpy) replace the draws."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Flatten(), nn.Dense(128, activation="relu"), nn.Dense(10))
    net.initialize(mx.init.Xavier())
    if params is not None:
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(params[k]))
    net.hybridize(static_alloc=True)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": MLP_LR})
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss()


def mlp_steps(mx, net, trainer, loss_fn, batches):
    """One SGD step per batch; the per-sample losses of each step."""
    losses = []
    for x, y in batches:
        xb, yb = mx.nd.array(x), mx.nd.array(y)
        with mx.autograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.detach())
    return losses


def mlp_path(torch, card):
    """Phase 6: the canonical program on the card, held to itself on
    the CPU from the same weights."""
    import mxnet_tpu_torch as mx
    batches = mnist_batches()
    net, trainer, loss_fn = mlp_program(mx)
    x0 = mx.nd.array(batches[0][0])
    print(f"canonical MLP on {x0.context}: batch {MLP_B} x 1 x 28 x 28, "
          f"{MLP_STEPS} SGD steps at {MLP_LR}, float32:", flush=True)
    net.hybridize(False)
    imp = net(x0)
    net.hybridize(static_alloc=True)
    hyb = net(x0)
    w = net.collect_params()["1.weight"]
    if w.shape != (128, 784) or w.data().context != x0.context:
        raise AssertionError(f"deferred weight is {w.shape} on "
                             f"{w.data().context}, not (128, 784) on "
                             f"{x0.context}")
    shapes = {k: p.shape for k, p in net.collect_params().items()}
    print(f"  deferred shapes {shapes} on {w.data().context}", flush=True)
    check("hybridized vs imperative output", maxabs(hyb.tensor, imp.tensor),
          0.0)
    params = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    card_losses = mlp_steps(mx, net, trainer, loss_fn, batches)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    card_losses = [float(v.mean().asscalar()) for v in card_losses]
    with mx.cpu():
        cnet, ctrainer, closs = mlp_program(mx, params)
        cpu_losses = [float(v.mean().asscalar()) for v in
                      mlp_steps(mx, cnet, ctrainer, closs, batches)]
    print(f"  losses {card_losses[0]:.6f} -> {card_losses[-1]:.6f}; "
          f"{MLP_STEPS} steps in {wall:.3f} s = "
          f"{MLP_STEPS * MLP_B / wall:.1f} samples/s [{card}]", flush=True)
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    check(f"{MLP_STEPS} step losses card vs CPU (relative)", worst,
          TOL_MLP_LOSS)
    if not all(np.isfinite(card_losses)) or \
            not card_losses[-1] < card_losses[0]:
        raise AssertionError(f"MLP losses not finite and falling: "
                             f"{card_losses}")


# ------------------------------------------------------- the amp arm

def watch_dtypes(net):
    """Forward hooks recording, for each named point of ``AMP_DTYPES``
    but the loss, the set of dtypes it shows over every layer; returns
    (the record, the hooks' handles)."""
    seen = {}

    def note(key, x):
        seen.setdefault(key, set()).add(str(x.dtype).rsplit(".", 1)[-1])

    def out(key):
        return lambda blk, args, y: note(key, y)

    hooks = []
    for blk in net.blocks:
        hooks += [blk.ln1.register_forward_hook(out("ln1 out")),
                  blk.ln2.register_forward_hook(out("ln2 out")),
                  blk.attn.out_proj.register_forward_pre_hook(
                      lambda b, args: note("attention out", args[0])),
                  blk.ffn.fc1.register_forward_hook(out("ffn hidden")),
                  blk.ffn.act.register_forward_hook(out("gelu out")),
                  blk.register_forward_hook(out("residual stream"))]
        hooks += [getattr(blk.attn, n).register_forward_hook(out(n))
                  for n in ("q_proj", "k_proj", "v_proj")]
    hooks.append(net.ln_f.register_forward_hook(out("ln_f out")))
    return seen, hooks


def amp_step1(mx, net, loss_fn, x, y, want_loss, want_grads):
    """One forward and backward under this thread's policy from the
    weights phase 5 started at: (the loss, its gap to phase 5's float32
    step 1 (relative), the worst gradient error against phase 5's step 1
    (``grad_errors``) and its parameter, the dtypes seen at the named
    points)."""
    seen, hooks = watch_dtypes(net)
    with mx.autograd.record():
        logits = net(x)
        loss = loss_fn(logits, y)
    for h in hooks:
        h.remove()
    seen["logits"] = {str(logits.dtype)}
    seen["loss"] = {str(loss.dtype)}
    loss.backward()
    params = net.collect_params()
    names = list(params.keys())
    errs = grad_errors(names, [p.grad().tensor / TRAIN_B
                               for p in params.values()], want_grads)
    worst = int(np.argmax(errs))
    got = float(loss.mean().asscalar())
    return (got, abs(got - want_loss) / abs(want_loss), errs[worst],
            names[worst], seen)


def amp_path(torch, card, toks, labels, want_step1, want_grads):
    """Phase 7: phase 5's loop under ``mx.amp.init('bfloat16')``, step 1
    held to phase 5's loss ``want_step1`` and gradients ``want_grads``
    (over the batch size)."""
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import get_gpt2
    try:
        net = get_gpt2("gpt2_124m", dropout=0.0)
        net.initialize(seed=SEED)
        x = mx.nd.array(toks, dtype="int32")
        y = mx.nd.array(labels, dtype="int32")
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        print(f"amp arm on {x.context}: GPT-2 124M, batch {TRAIN_B} x "
              f"{TRAIN_T}, gluon loop under amp.init('bfloat16'), adam lr "
              f"{TRAIN_LR}:", flush=True)
        # the controls take no step, so every run starts from the
        # weights phase 5 started at
        want = {k: {v} for k, v in AMP_DTYPES.items()}
        for what, ops in AMP_CONTROLS.items():
            mx.amp.init("bfloat16", target_precision_ops=ops)
            _, gap, err, leaf, seen = amp_step1(mx, net, loss_fn, x, y,
                                                want_step1, want_grads)
            off = sorted(k for k in want if seen.get(k) != want[k])
            print(f"  control, {what}: dtypes off at {off}, step-1 loss "
                  f"gap {gap:.3e}, worst gradient {err:.3e} ({leaf})",
                  flush=True)
            if not off and gap <= TOL_AMP_STEP1 and err <= TOL_AMP_GRAD:
                raise AssertionError(f"phase 7's checks do not see {what}")
        mx.amp.init("bfloat16")
        step1, gap, err, leaf, seen = amp_step1(mx, net, loss_fn, x, y,
                                                want_step1, want_grads)
        print(f"  step 1 loss {step1:.6f} vs phase 5's float32 "
              f"{want_step1:.6f}", flush=True)
        if seen != want:
            raise AssertionError(f"amp dtypes at the named points {seen}, "
                                 f"not {want}")
        print(f"  dtypes at the named points of all {len(net.blocks)} "
              f"layers as the reference's: {AMP_DTYPES}", flush=True)
        check("amp step-1 loss vs float32 (relative)", gap, TOL_AMP_STEP1)
        check(f"amp step-1 gradients vs float32 (worst {leaf}, over its "
              "max-abs)", err, TOL_AMP_GRAD)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": TRAIN_LR})
        trainer.step(TRAIN_B)                      # the warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.monotonic()
        timed = [gluon_step(mx, net, trainer, loss_fn, x, y)
                 for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_launches()
        by_dtype = read_launches_by_dtype()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = [step1] + [float(v.mean().asscalar()) for v in timed]
        print(f"  losses {losses}", flush=True)
        print(f"  {TRAIN_STEPS} steps in {wall:.3f} s: "
              f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step, "
              f"{TRAIN_STEPS * TRAIN_B * TRAIN_T / wall:.1f} tokens/s, peak "
              f"memory {peak:.0f} MiB, launches by dtype {by_dtype} "
              f"[{card}]", flush=True)
        n_layers = len(net.blocks)
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            got = by_dtype[name]
            if got["bfloat16"] != n_layers * TRAIN_STEPS or got["float32"]:
                raise AssertionError(f"amp arm launched {name} {got} over "
                                     f"{TRAIN_STEPS} steps, not "
                                     f"{n_layers} bf16 a step")
        for k, p in net.collect_params().items():
            if p.data().tensor.dtype != torch.float32 or \
                    p.grad().tensor.dtype != torch.float32:
                raise AssertionError(f"{k}: parameter {p.dtype} / gradient "
                                     f"{p.grad().dtype}, not float32")
        print(f"  all {len(net.collect_params())} parameters and gradients "
              "float32", flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"amp losses not finite and falling: "
                                 f"{losses}")
        print("where the time goes (one amp step):", flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gluon_step(mx, net, trainer, loss_fn, x, y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report_profile(torch, f"amp step B{TRAIN_B} T{TRAIN_T}", wall_ms,
                       prof, card, marks=("flash_fwd", "flash_dq",
                                          "flash_dkv"))
    finally:
        mx.amp.reset()
    return launches


# --------------------------------------------------- the routed family

def moe_step(torch, mx, net, toks, labels, remat, seed, impl=None):
    """One training forward and backward of ``net`` under ``remat``,
    dropout drawn from ``seed``: (loss, gradients, launches by dtype);
    the aux collector must be empty after it."""
    import functools

    from mxnet_tpu_torch import base
    from mxnet_tpu_torch.models import aux_loss_scope, gpt2_lm_loss
    from mxnet_tpu_torch.models import transformer
    net._remat = remat
    mx.random.seed(seed)
    orig = transformer.dot_product_attention
    if impl is not None:
        transformer.dot_product_attention = functools.partial(orig,
                                                              impl=impl)
    reset_launches()
    try:
        with base.training_mode(True), aux_loss_scope():
            loss = gpt2_lm_loss(net(toks), labels)
        grads = torch.autograd.grad(loss, list(net.parameters()))
    finally:
        transformer.dot_product_attention = orig
    torch.cuda.synchronize()
    if base.pop_aux_losses():
        raise AssertionError("the aux collector is not empty after a step")
    return loss.detach(), grads, read_launches_by_dtype()


def expect_launches(by_dtype, want, what, dtype="float32"):
    """``by_dtype`` ({wrapper: {dtype: n}}) must show launches in
    ``dtype`` only, ``want`` ({wrapper: n}) of each."""
    for name, n in want.items():
        got = by_dtype[name]
        if got.get(dtype, 0) != n or sum(got.values()) != n:
            raise AssertionError(f"{what}: {name} launched {got}, not {n} "
                                 f"{dtype}")


def moe_parity(torch, mx, card, toks, labels):
    """Phase 8's gates at batch ``MOE_PARITY_B``: one step with remat
    against the same step without it and against ``impl='ref'``
    attention, dropout ``MOE_DROPOUT`` from one seed.  Returns the
    gradients of the remat step."""
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", dropout=MOE_DROPOUT, **MOE_CFG)
    net.initialize(seed=SEED)
    n_layers = len(net.blocks)
    t, lab = (torch.from_numpy(x[:MOE_PARITY_B]).to(net.device)
              for x in (toks, labels))
    loss_r, g_r, n_r = moe_step(torch, mx, net, t, lab, True, SEED + 1)
    expect_launches(n_r, {"flash_fwd": 2 * n_layers, "flash_dq": n_layers,
                          "flash_dkv": n_layers}, "remat step")
    loss_p, g_p, n_p = moe_step(torch, mx, net, t, lab, False, SEED + 1)
    expect_launches(n_p, dict.fromkeys(("flash_fwd", "flash_dq",
                                        "flash_dkv"), n_layers),
                    "step without remat")
    names = [n for n, _ in net.named_parameters()]
    check(f"loss B{MOE_PARITY_B} T{TRAIN_T} dropout {MOE_DROPOUT} remat vs "
          "none (relative)", abs(float(loss_r) - float(loss_p)) /
          abs(float(loss_p)), TOL_REMAT_LOSS)
    errs = [relerr(a, b) for a, b in zip(g_r, g_p)]
    worst = int(np.argmax(errs))
    check(f"{len(errs)} gradients remat vs none (worst {names[worst]}, "
          "over its max-abs)", errs[worst], TOL_REMAT_GRAD)
    del g_p
    loss_f, g_f, n_f = moe_step(torch, mx, net, t, lab, True, SEED + 1,
                                impl="ref")
    if any(n for d in n_f.values() for n in d.values()):
        raise AssertionError(f"impl='ref' launched kernels: {n_f}")
    check("loss remat, kernels vs impl='ref' (relative)",
          abs(float(loss_r) - float(loss_f)) / abs(float(loss_f)), TOL_LOSS)
    errs = grad_errors(names, g_r, g_f)
    worst = int(np.argmax(errs))
    check(f"{len(errs)} gradients remat, kernels vs impl='ref' (worst "
          f"{names[worst]}, over its max-abs)", errs[worst], TOL_GRAD)
    return net, g_r


def lamb_multi_vs_loop(torch, card, net, grads):
    """One LAMB step over every parameter of ``net`` through the list-wise
    update against the per-parameter loop, from one state (a first
    list-wise step from zeros); each parameter within ``TOL_MULTI`` of
    its max-abs.  Then both forms' times, the median of 5 calls each, in
    turns."""
    from mxnet_tpu_torch import optimizer as topt
    kw = {"learning_rate": MOE_LR, "wd": MOE_WD}
    a = [p.detach().clone() for p in net.parameters()]
    opt_a, opt_b = topt.create("lamb", **kw), topt.create("lamb", **kw)
    idx = list(range(len(a)))
    st_a = [opt_a.create_state(i, w) for i, w in zip(idx, a)]
    b = [w.clone() for w in a]
    st_b = [tuple(s.clone() for s in st) for st in st_a]

    def list_wise(t):
        with opt_a.traced(MOE_LR, t):
            opt_a.update_multi(idx, a, grads, st_a)

    def per_parameter(t):
        with opt_b.traced(MOE_LR, t):
            for i in idx:
                opt_b.update(i, b[i], grads[i], st_b[i])

    list_wise(1)
    for w, v in zip(b, a):
        w.copy_(v)
    for s, v in zip(st_b, st_a):
        for x, y in zip(s, v):
            x.copy_(y)
    list_wise(2)
    per_parameter(2)
    errs = [relerr(x, y) for x, y in zip(a, b)]
    names = [n for n, _ in net.named_parameters()]
    worst = int(np.argmax(errs))
    check(f"LAMB list-wise vs per-parameter, {len(errs)} parameters (worst "
          f"{names[worst]}, over its max-abs)", errs[worst], TOL_MULTI)
    ms = {"list-wise": [], "per-parameter": []}
    for t in range(3, 8):
        for what, fn in (("list-wise", list_wise),
                         ("per-parameter", per_parameter)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(t)
            torch.cuda.synchronize()
            ms[what].append((time.perf_counter() - t0) * 1e3)
    print(f"  LAMB step over {len(a)} tensors, "
          f"{sum(w.numel() for w in a)} parameters, median of 5 calls in "
          f"turns: list-wise {np.median(ms['list-wise']):.3f} ms "
          f"({min(ms['list-wise']):.3f}-{max(ms['list-wise']):.3f}), "
          f"per-parameter {np.median(ms['per-parameter']):.3f} ms "
          f"({min(ms['per-parameter']):.3f}-"
          f"{max(ms['per-parameter']):.3f}) [{card}]", flush=True)


def optimizers_card_vs_cpu(torch, dev):
    """Every registered optimizer, 3 list-wise updates of a few tensors
    on the card and the same on the CPU: within ``TOL_MULTI`` of each
    CPU tensor's max-abs."""
    from mxnet_tpu_torch import optimizer as topt
    rs = np.random.RandomState(SEED)
    shapes = [(768,), (3072, 768), (8, 768), (64,)]
    w0 = [rs.randn(*s).astype(np.float32) * 0.02 for s in shapes]
    w0[-1][:] = 0                       # LAMB's and LARS's norm guards
    gs = [[rs.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(3)]
    names = sorted(topt._registry._entries)
    worst = (0.0, "")
    for name in names:
        out = {}
        for where in ("cpu", dev):
            opt = topt.create(name, learning_rate=1e-2, wd=0.01)
            w = [torch.tensor(x, device=where) for x in w0]   # copies
            st = [opt.create_state(i, x) for i, x in enumerate(w)]
            for g in gs:
                opt.update_multi(list(range(len(w))), w,
                                 [torch.tensor(x, device=where) for x in g],
                                 st)
            out[str(where)] = [x.cpu() for x in w]
        cpu, card_w = out["cpu"], out[str(dev)]
        err = max(relerr(a, b) for a, b in zip(card_w, cpu))
        worst = max(worst, (err, name))
    check(f"{len(names)} optimizers x 3 list-wise updates, card vs CPU "
          f"(worst {worst[1]}, over each tensor's max-abs)", worst[0],
          TOL_MULTI)


def moe_path(torch, card, toks, labels):
    """Phase 8: the routed GPT-2 at full width trained by
    ``ShardedTrainer`` with LAMB under remat."""
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import base
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    print(f"routed GPT-2 124M ({MOE_CFG}), LAMB lr {MOE_LR} wd {MOE_WD}, "
          f"remat, float32:", flush=True)
    parity_net, grads = moe_parity(torch, mx, card, toks, labels)
    lamb_multi_vs_loop(torch, card, parity_net, grads)
    del parity_net, grads
    gc.collect()
    torch.cuda.empty_cache()
    optimizers_card_vs_cpu(torch, torch.device("cuda", 0))
    net = get_gpt2("gpt2_124m", dropout=0.0, remat=True, **MOE_CFG)
    net.initialize(seed=SEED)
    moes = [(f"h{i}", b.moe) for i, b in enumerate(net.blocks)
            if hasattr(b, "moe")]
    n_params = sum(p.numel() for p in net.parameters())
    cap = moes[0][1].capacity(TRAIN_B * TRAIN_T)
    print(f"  {n_params} parameters on {net.device}, MoE in "
          f"{[n for n, _ in moes]}, capacity {cap} per expert at batch "
          f"{TRAIN_B} x {TRAIN_T}", flush=True)
    trainer = ShardedTrainer(net, "lamb", loss=gpt2_lm_loss,
                             optimizer_params={"learning_rate": MOE_LR,
                                               "wd": MOE_WD})

    def steps(n):
        out = []
        for _ in range(n):
            out.append(trainer.step(toks, labels))
            if base.pop_aux_losses():
                raise AssertionError("the aux collector is not empty "
                                     "after a step")
        return out

    n_layers = len(net.blocks)
    readings = {}
    losses = []
    for remat, n in ((True, TRAIN_STEPS), (False, 2)):
        # the step's program holds the remat form it was captured with:
        # each form compiles its own in its warm-up step, which the peak
        # takes in (a graph's pool is not allocated memory after it)
        net._remat = remat
        trainer._programs.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses += steps(1)
        reset_launches()
        t0 = time.monotonic()
        losses += steps(n)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        by_dtype = read_launches_by_dtype()
        if remat:
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        expect_launches(by_dtype, {
            "flash_fwd": (2 if remat else 1) * n_layers * n,
            "flash_dq": n_layers * n, "flash_dkv": n_layers * n},
            f"remat={remat} steps")
        readings[remat] = (wall / n * 1e3, n * TRAIN_B * TRAIN_T / wall,
                           peak)
        print(f"  remat={remat}: {n} steps in {wall:.3f} s: "
              f"{wall / n * 1e3:.1f} ms/step, "
              f"{n * TRAIN_B * TRAIN_T / wall:.1f} tokens/s, peak memory "
              f"{peak:.0f} MiB, launches by dtype {by_dtype} [{card}]",
              flush=True)
    losses = [float(x) for x in losses]
    print(f"  losses {losses}", flush=True)
    for name, layer in moes:
        print(f"  {name}.moe: aux {float(layer.last_aux):.6f}, dropped "
              f"{float(layer.last_dropped):.4%} of (token, choice) "
              "assignments", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"routed losses not finite and falling: "
                             f"{losses}")
    print(f"  remat saves {readings[False][2] - readings[True][2]:.0f} MiB "
          f"of peak for {readings[True][0] / readings[False][0]:.3f}x the "
          "step time", flush=True)
    net._remat = True
    trainer._programs.clear()
    trainer.step(toks, labels)          # compiles the remat form again
    print("where the time goes (one routed step, remat):", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(toks, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(torch, f"routed step B{TRAIN_B} T{TRAIN_T}", wall_ms,
                   prof, card, marks=("flash_fwd", "flash_dq", "flash_dkv"))
    return launches


# --------------------------------------------------- the vision family

def vision_batch():
    """``bench.py``'s ResNet-50 batch: images uniform in [-1, 1) (NHWC),
    labels in [0, 100)."""
    rs = np.random.RandomState(SEED)
    x = rs.uniform(-1, 1, (VISION_B, VISION_SIZE, VISION_SIZE, 3))
    return x.astype(np.float32), rs.randint(0, 100, (VISION_B,)) \
        .astype(np.int32)


def vision_ce(logits, labels):
    """``bench.py:101-104``'s loss: logsumexp - pick, per sample."""
    return logits.logsumexp(-1) - logits.gather(
        -1, labels.long()[:, None])[:, 0]


def resnet50(layout="NHWC"):
    from mxnet_tpu_torch.models.vision import get_resnet
    return get_resnet(1, 50, classes=1000, layout=layout)


def step_errors(names, got, ref):
    """(global L2 error of ``got`` against ``ref`` over ``ref``'s L2
    norm, every leaf's max-abs error over its max-abs, the worst leaf).
    A convolution bias that BatchNorm follows (v1's bottleneck body.0
    and body.6) has a zero gradient in exact arithmetic, since BatchNorm
    subtracts the batch mean: it is held against the largest leaf."""
    top = max(float(r.abs().max()) for r in ref)
    errs = [maxabs(a, r) / (top if n.endswith(".bias") and ".body." in n
                            else max(float(r.abs().max()), 1e-30))
            for n, a, r in zip(names, got, ref)]
    l2 = float(sum(((a.double() - r.double()) ** 2).sum()
                   for a, r in zip(got, ref)) ** 0.5 /
               sum((r.double() ** 2).sum() for r in ref) ** 0.5)
    worst = int(np.argmax(errs))
    return l2, errs[worst], names[worst]


def vision_parity(torch, card, params, x, y):
    """Phase 10's gates at batch 8 from ``params``: one SGD step on the
    card against the CPU, with the CPU's float64 step as the arbiter of
    the gradients; a predict-mode forward after it; NCHW against NHWC
    logits on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import training_mode
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.utils.convert import load_numpy_params
    cud = torch.backends.cudnn
    print(f"  gates at batch {len(x)}: cudnn.benchmark={cud.benchmark}, "
          f"cudnn.deterministic={cud.deterministic}, "
          f"cudnn.allow_tf32={cud.allow_tf32}", flush=True)
    runs = {}
    for run, ctx, dt in (("card", mx.gpu(0), torch.float32),
                         ("cpu", mx.cpu(), torch.float32),
                         ("cpu64", mx.cpu(), torch.float64)):
        with ctx:
            net = load_numpy_params(resnet50(), params).to(dt)
            tr = ShardedTrainer(net, "sgd", loss=vision_ce,
                                optimizer_params=VISION_OPT)
            xt = torch.from_numpy(x).to(net.device, dt)
            loss = float(tr.step(xt, (y,)))
            state = {k: v.detach().cpu().double()
                     for k, v in tr.state_dict().items()}
        runs[run] = (loss, state, net)
    (lc, sc, card_net), (lh, sh, cpu_net) = runs["card"], runs["cpu"]
    check(f"step-1 loss B{len(x)} card vs CPU (relative)",
          abs(lc - lh) / abs(lh), TOL_VISION_LOSS)
    names = {"state": [n for n, p in card_net.named_parameters()
                       if p.requires_grad],
             "aux": [n for n, p in card_net.named_parameters()
                     if not p.requires_grad]}
    keys = {kind: [k for k in sh if k.startswith(kind + ":")]
            for kind in names}
    # step 1's momentum is -lr x its gradient.  ResNet-50's training
    # gradients at initialization are ill-conditioned in float32: the
    # CPU's own float32 step parts from its float64 step by a few per
    # cent of each leaf (ResNet-18's, or ResNet-50's in predict mode,
    # by ~1e-6), so the card is held to float64 no worse than the CPU
    # float32 is
    grads = {run: [runs[run][1][k] for k in keys["state"]]
             for run in runs}
    vs = {"card vs CPU": step_errors(names["state"], grads["card"],
                                     grads["cpu"]),
          "card vs float64": step_errors(names["state"], grads["card"],
                                         grads["cpu64"]),
          "CPU vs float64": step_errors(names["state"], grads["cpu"],
                                        grads["cpu64"])}
    for what, (l2, worst, leaf) in vs.items():
        print(f"  step-1 gradients {what}: global L2 {l2:.3e}, worst leaf "
              f"{worst:.3e} ({leaf})", flush=True)
    check("step-1 gradients: card's L2 error to float64 over the CPU "
          "float32's", vs["card vs float64"][0] / vs["CPU vs float64"][0],
          TOL_VISION_GRAD_RATIO)
    _l2, worst, leaf = step_errors(names["aux"],
                                   [sc[k] for k in keys["aux"]],
                                   [sh[k] for k in keys["aux"]])
    check(f"{len(keys['aux'])} moving statistics after the step card vs "
          f"CPU (worst {leaf}, over its max-abs)", worst, TOL_VISION_STATE)
    # predict mode from one state, the card's after its step (the
    # parameters inherit the gradients' float32 spread; the moving
    # statistics agree as checked above)
    moved = {k: p.detach().cpu().numpy() for k, p in
             card_net.named_parameters()}
    load_numpy_params(cpu_net, moved)
    nchw = load_numpy_params(resnet50("NCHW"), moved)
    with torch.no_grad():
        with training_mode(False):
            pc, ph = (n(torch.from_numpy(x).to(n.device)).cpu()
                      for n in (card_net, cpu_net))
            pn = nchw(torch.from_numpy(x).to(nchw.device)
                      .permute(0, 3, 1, 2)).cpu()
        with training_mode(True):                  # batch statistics
            bc = card_net(torch.from_numpy(x).to(card_net.device)).cpu()
    check("predict-mode logits after the step card vs CPU (over max-abs)",
          relerr(pc, ph), TOL_VISION_LOGITS)
    gap = relerr(bc, pc)
    print(f"  batch-statistics logits differ from predict-mode ones by "
          f"{gap:.3e} of their max-abs", flush=True)
    if gap <= TOL_VISION_LOGITS:
        raise AssertionError("predict mode gives the batch-statistics "
                             "logits: the moving statistics are not used")
    check("NCHW vs NHWC predict-mode logits on the card (over max-abs)",
          relerr(pn, pc), TOL_VISION_LOGITS)


def vision_train(torch, card, trainer, x, y):
    """Phase 10a: a warm-up step and the timed ones; returns the losses
    and the profiler's step."""
    losses = [trainer.step(x, (y,))]                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(VISION_STEPS):
        losses.append(trainer.step(x, (y,)))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    while len(losses) < VISION_TRAIN_STEPS:
        losses.append(trainer.step(x, (y,)))
    losses = [float(v) for v in losses]
    ips = VISION_STEPS * VISION_B / wall
    print(f"  (a) ShardedTrainer sgd: losses {losses}", flush=True)
    print(f"  {VISION_STEPS} steps in {wall:.3f} s: "
          f"{wall / VISION_STEPS * 1e3:.1f} ms/step, {ips:.1f} images/s, "
          f"peak memory {peak:.0f} MiB, "
          f"{ips * VISION_FLOP_PER_IMAGE / F32_SIMT_PEAK:.1%} of float32's "
          f"{F32_SIMT_PEAK / 1e12:g} TFLOP/s outside the tensor cores at "
          f"{VISION_FLOP_PER_IMAGE:.3g} FLOP an image [{card}]", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet-50 losses not finite and falling: "
                             f"{losses}")
    return losses


def vision_amp(torch, card, x_np, y_np, want_step1):
    """Phase 10b: a fresh net from the same seed through the Gluon loop
    under ``amp.init('bfloat16')``; returns (losses, a step closure for
    the profiler)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    mx.amp.init("bfloat16")
    net = resnet50()
    net.initialize(seed=SEED)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", VISION_OPT)
    x, y = mx.nd.array(x_np), mx.nd.array(y_np, dtype="int32")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(VISION_B)
        return loss

    seen = {"Conv2D": set(), "BatchNorm": set()}

    def note(kind):
        return lambda _m, _i, out: seen[kind].add(str(out.dtype))
    hooks = [m.register_forward_hook(note(type(m).__name__))
             for m in net.modules()
             if isinstance(m, (nn.Conv2D, nn.BatchNorm))]
    first = step()                # step 1, the shapes settle in it
    for h in hooks:
        h.remove()
    want = {"Conv2D": {"torch.bfloat16"}, "BatchNorm": {"torch.float32"}}
    if seen != want:
        raise AssertionError(f"amp dtypes {seen}, not {want}")
    n_conv = sum(isinstance(m, nn.Conv2D) for m in net.modules())
    n_bn = sum(isinstance(m, nn.BatchNorm) for m in net.modules())
    print(f"  (b) gluon loop under amp.init('bfloat16'): all {n_conv} "
          f"convolutions bf16, all {n_bn} BatchNorms float32", flush=True)
    for k, p in net.collect_params().items():
        dts = {p.data().tensor.dtype} | (
            set() if p.grad_req == "null" else {p.grad().tensor.dtype})
        if dts != {torch.float32}:
            raise AssertionError(f"{k}: parameter or gradient {dts}")
    step1 = float(first.mean().asscalar())
    check("amp step-1 loss vs (a)'s float32 step 1 (relative)",
          abs(step1 - want_step1) / abs(want_step1), TOL_VISION_AMP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    timed = [step() for _ in range(VISION_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    timed += [step() for _ in range(VISION_TRAIN_STEPS - 1 - VISION_STEPS)]
    losses = [step1] + [float(v.mean().asscalar()) for v in timed]
    print(f"  losses {losses}; all parameters and gradients float32",
          flush=True)
    print(f"  {VISION_STEPS} steps in {wall:.3f} s: "
          f"{wall / VISION_STEPS * 1e3:.1f} ms/step, "
          f"{VISION_STEPS * VISION_B / wall:.1f} images/s, peak memory "
          f"{peak:.0f} MiB [{card}]", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"amp ResNet-50 losses not finite and "
                             f"falling: {losses}")
    return losses, step


def profile_one(torch, name, fn, card):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(torch, name, wall_ms, prof, card, classes=VISION_CLASSES)


def vision_path(torch, card):
    """Phase 10: full-width ResNet-50 v1 training, float32 through
    ``ShardedTrainer`` and under amp through the Gluon loop, after the
    card-vs-CPU and layout gates at batch 8."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import ShardedTrainer
    t_phase = time.monotonic()
    x_np, y_np = vision_batch()
    net = resnet50()
    net.initialize(seed=SEED)
    x = torch.from_numpy(x_np).to(net.device)
    y = torch.from_numpy(y_np).to(net.device)
    trainer = ShardedTrainer(net, "sgd", loss=vision_ce,
                             optimizer_params=VISION_OPT).build(x)
    n_params = sum(p.numel() for p in net.parameters() if p.requires_grad)
    print(f"ResNet-50 v1 NHWC: {n_params} trainable parameters on "
          f"{net.device}, batch {VISION_B} x {VISION_SIZE} x {VISION_SIZE} "
          f"x 3, SGD lr {VISION_OPT['learning_rate']} momentum "
          f"{VISION_OPT['momentum']}, float32:", flush=True)
    params = {k: p.detach().cpu().numpy() for k, p in
              net.named_parameters()}
    b = VISION_PARITY_B
    vision_parity(torch, card, params, x_np[:b], y_np[:b])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    losses = vision_train(torch, card, trainer, x, y)
    print("where the time goes (one ShardedTrainer step):", flush=True)
    profile_one(torch, f"ResNet-50 step B{VISION_B}",
                lambda: trainer.step(x, (y,)), card)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    try:
        _amp_losses, amp_step = vision_amp(torch, card, x_np, y_np,
                                           losses[0])
        print("where the time goes (one amp gluon step):", flush=True)
        profile_one(torch, f"ResNet-50 amp step B{VISION_B}", amp_step,
                    card)
    finally:
        mx.amp.reset()
    print(f"phase 10: {time.monotonic() - t_phase:.1f} s", flush=True)


# --------------------------------------------------- the language family

@contextlib.contextmanager
def attention_impl(impl):
    """Every ``MultiHeadAttention`` call takes ``dot_product_attention``
    with ``impl`` (the dispatch patched for a check only)."""
    from mxnet_tpu_torch.models import transformer
    orig = transformer.dot_product_attention
    transformer.dot_product_attention = functools.partial(orig, impl=impl)
    try:
        yield
    finally:
        transformer.dot_product_attention = orig


def kernels_vs_ref(torch, net, loss_fn, args, want, what):
    """One training forward and backward of ``loss_fn(net(*args))`` with
    the flash kernels, against the same with ``impl='ref'`` attention:
    ``want`` is the flash launches {wrapper: n} of the kernel run (none
    in the other); the loss relative ``TOL_LOSS``, every gradient
    ``TOL_GRAD`` of its own max-abs (``grad_errors``)."""
    from mxnet_tpu_torch.base import training_mode
    params = list(net.parameters())
    runs = {}
    for impl in ("auto", "ref"):
        reset_launches()
        with attention_impl(impl), training_mode(True):
            loss = loss_fn(net(*args)).mean()
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        runs[impl] = (float(loss.detach()), grads, read_launches())
        del loss
    (lk, gk, nk), (lr_, gr, nr) = runs["auto"], runs["ref"]
    for name, n in want.items():
        if nk[name] != n or nr[name]:
            raise AssertionError(f"{what}: {name} launched {nk[name]} / "
                                 f"{nr[name]} times, not {n} / 0")
    check(f"{what} loss kernels vs impl='ref' (relative)",
          abs(lk - lr_) / abs(lr_), TOL_LOSS)
    names = [n for n, _ in net.named_parameters()]
    errs = grad_errors(names, gk, gr)
    worst = int(np.argmax(errs))
    check(f"{what} {len(errs)} gradients kernels vs impl='ref' (worst "
          f"{names[worst]}, over its max-abs)", errs[worst], TOL_GRAD)


def timed_steps(torch, step, n, tokens, card, what, flop=None, peak=None):
    """``n`` timed calls of ``step`` after the caller's warm-up: returns
    (losses, ms/step, peak MiB, launches per step) and prints them with
    the rate of ``tokens`` units a step and, with ``flop`` (per step)
    and ``peak`` (FLOP/s), the share of that peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    losses = [step() for _ in range(n)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: v / n for k, v in read_launches().items()}
    mib = torch.cuda.max_memory_allocated() / 2 ** 20
    unit, count = tokens
    share = "" if flop is None else (
        f", {flop * n / wall / peak:.1%} of {peak / 1e12:g} TFLOP/s at "
        f"{flop:.4g} FLOP a step")
    # a captured step's activations live in its graph's pool, which the
    # allocated peak after the capture leaves out and reserved holds
    print(f"  {what}: {n} steps in {wall:.3f} s: {wall / n * 1e3:.1f} "
          f"ms/step, {count * n / wall:.1f} {unit}/s, peak memory "
          f"{mib:.0f} MiB (reserved {reserved_mib(torch):.0f}){share}, "
          f"launches per step {launches} [{card}]", flush=True)
    return [float(x) for x in losses], wall / n * 1e3, mib, launches


def finite_and_falling(losses, what):
    print(f"  {what} losses {losses}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what} losses not finite and falling: "
                             f"{losses}")


def profiled(torch, fn):
    """``fn()`` twice under the profiler, the first call untraced: the
    profiler can lose the records of the first kernels that run while
    its tracing starts (one B1 launch and ~2.4 ms of kernels at the head
    of a GPT-2 step on an H100), so the traced call runs with tracing
    already on.  The traced window's start is also set after
    ``prof.step()`` returns: a replayed step launched at once lost its
    first ~5 ms of kernel records, one B1 among them, on an H100, so the
    traced call waits 0.1 s on the host first.  Returns the profile and
    the traced call's wall ms."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.1)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def profile_step(torch, name, fn, card, want=None):
    """Profile one call of ``fn`` after one more (see :func:`profiled`
    and :func:`report_profile`; ``want`` holds the flash kernels'
    launches to the profiler's count)."""
    prof, wall_ms = profiled(torch, fn)
    return report_profile(torch, name, wall_ms, prof, card,
                          marks=("flash_fwd", "flash_dq", "flash_dkv"),
                          want=want)


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def bert_batch(b=BERT_B):
    """``bench.py:761-776``'s batch: random ids, token types 0, every row
    full (``valid_length`` = T), ``BERT_MASKED`` sorted masked positions
    a row, MLM and NSP labels."""
    rs = np.random.RandomState(SEED)
    toks = rs.randint(0, BERT_VOCAB, (b, BERT_T)).astype(np.int32)
    types = np.zeros((b, BERT_T), np.int32)
    vlen = np.full((b,), BERT_T, np.int32)
    pos = np.stack([np.sort(rs.choice(BERT_T, BERT_MASKED, replace=False))
                    for _ in range(b)]).astype(np.int32)
    mlm = rs.randint(0, BERT_VOCAB, (b, BERT_MASKED)).astype(np.int32)
    nsp = rs.randint(0, 2, (b,)).astype(np.int32)
    return toks, types, vlen, pos, mlm, nsp


def bert_loss(outs, mlm_labels, nsp_labels):
    """``bench.py:752-759``'s MLM + NSP cross entropy per sample (B,):
    its mean over the batch is bench.py's loss.  Tensors or NDArrays."""
    from mxnet_tpu_torch.ndarray.ops import apply_op

    def f(m, n, ym, yn):
        m, n = m.float(), n.float()
        lm = m.logsumexp(-1) - m.gather(-1, ym.long()[..., None])[..., 0]
        ln = n.logsumexp(-1) - n.gather(-1, yn.long()[:, None])[:, 0]
        return lm.mean(-1) + ln
    return apply_op("bert_loss", f, [outs[0], outs[1], mlm_labels,
                                     nsp_labels])


def bert_net(dropout):
    from mxnet_tpu_torch.models import BERTForPretrain, get_bert
    net = BERTForPretrain(get_bert("bert_large", vocab_size=BERT_VOCAB,
                                   max_length=BERT_T, remat="dots",
                                   dropout=dropout))
    return net.initialize(seed=SEED)


def bert_path(torch, card):
    """Phase 11: BERT-large pretraining at full width, (a) float32
    through ``ShardedTrainer`` with ``valid_length`` (the reference
    path), (b) the Gluon loop under amp without it (B1-B3 in bf16),
    after the kernels-vs-reference gate."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import ShardedTrainer
    t_phase = time.monotonic()
    n_layers = 24
    # B1 runs again when remat='dots' recomputes each layer (it is no
    # product, so its output is not kept)
    want = {"flash_fwd": 2 * n_layers, "flash_dq": n_layers,
            "flash_dkv": n_layers}
    print(f"BERT-large pretraining: 24 x 1024, 16 heads, vocab "
          f"{BERT_VOCAB}, batch {BERT_B} x {BERT_T}, {BERT_MASKED} masked "
          f"positions a row, Adam lr {BERT_LR}, remat='dots':", flush=True)
    net = bert_net(0.0)
    dev = net.device
    toks, types, _v, pos, mlm, nsp = (torch.from_numpy(a).to(dev) for a in
                                      bert_batch(BERT_PARITY_B))
    kernels_vs_ref(torch, net, lambda o: bert_loss(o, mlm, nsp),
                   (toks, types, None, pos), want,
                   f"BERT-large B{BERT_PARITY_B} T{BERT_T} dropout 0")
    del net
    free(torch)
    batch = [torch.from_numpy(a).to(dev) for a in bert_batch()]
    toks, types, vlen, pos, mlm, nsp = batch
    net = bert_net(BERT_DROPOUT)
    print(f"  {sum(p.numel() for p in net.parameters())} parameters on "
          f"{net.device}, dropout {BERT_DROPOUT}", flush=True)
    trainer = ShardedTrainer(net, "adam", loss=bert_loss,
                             optimizer_params={"learning_rate": BERT_LR})

    def step_a():
        return trainer.step((toks, types, vlen, pos), (mlm, nsp))
    first = [float(step_a())]                          # warm-up
    losses, ms_a, mib_a, per_a = timed_steps(
        torch, step_a, BERT_STEPS, ("samples", BERT_B), card,
        "(a) ShardedTrainer float32, valid_length (reference path)",
        BERT_FLOP_PER_SAMPLE * BERT_B, F32_SIMT_PEAK)
    finite_and_falling(first + losses, "(a)")
    if any(per_a.values()):
        raise AssertionError(f"(a) launched a kernel: {per_a}")
    print("where the time goes (one (a) step):", flush=True)
    profile_step(torch, f"BERT-large step B{BERT_B} f32", step_a, card)
    del trainer, net
    free(torch)
    try:
        mx.amp.init("bfloat16")
        net = bert_net(BERT_DROPOUT)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": BERT_LR})
        x = [mx.nd.array(a) for a in (toks, types, pos, mlm, nsp)]

        def step_b():
            with mx.autograd.record():
                loss = bert_loss(net(x[0], x[1], None, x[2]), x[3], x[4])
            loss.backward()
            trainer.step(BERT_B)
            return loss.mean().asscalar()
        first = [float(step_b())]                      # warm-up
        cpu0 = time.process_time()
        losses, ms_b, mib_b, _per = timed_steps(
            torch, step_b, BERT_STEPS, ("samples", BERT_B), card,
            "(b) gluon loop under amp.init('bfloat16'), no valid_length",
            BERT_FLOP_PER_SAMPLE * BERT_B, PEAK_FLOPS["bfloat16"])
        # every thread of the process (autograd's device thread runs
        # backward), the step's own sync wait included
        print(f"  (b) remat='dots' host CPU time "
              f"{(time.process_time() - cpu0) / BERT_STEPS * 1e3:.1f} ms a "
              f"step over {ms_b:.1f} ms of wall [{card}]", flush=True)
        launches = read_launches()
        by_dtype = read_launches_by_dtype()
        expect_launches(by_dtype, {k: n * BERT_STEPS for k, n in
                                   want.items()}, "(b)", dtype="bfloat16")
        finite_and_falling(first + losses, "(b)")
        print("where the time goes (one (b) step):", flush=True)
        profile_step(torch, f"BERT-large amp step B{BERT_B}", step_b, card)
    finally:
        mx.amp.reset()
    print(f"  remat='dots' launches a step: B1 {want['flash_fwd']}, B2 and "
          f"B3 {n_layers} each", flush=True)
    print(f"phase 11: {time.monotonic() - t_phase:.1f} s", flush=True)
    del trainer, net
    free(torch)
    return {k: int(v * BERT_STEPS) for k, v in per_a.items()}, launches


def nmt_batch(b=NMT_B):
    """``bench.py:702-707``'s batch: random source, shifted target and
    label ids."""
    rs = np.random.RandomState(SEED)
    return tuple(rs.randint(0, NMT_VOCAB, (b, NMT_T)).astype(np.int32)
                 for _ in range(3))


def nmt_attribution(torch, net):
    """Hooks on every attention module that credit the flash launches
    made inside its forward and inside its backward to its kind
    (encoder, decoder, cross).  Returns (counts, handles).  The hooks
    run again while ``ShardedTrainer`` captures its step, which launches
    nothing: they count only outside a capture."""
    counts = {kind: dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"),
                                  0)
              for kind in ("encoder", "decoder", "cross")}
    mods = [("encoder", b.attn) for b in net.enc_layers]
    for b in net.dec_layers:
        mods += [("decoder", b.self_attn), ("cross", b.cross_attn)]
    handles, mark = [], {}

    def before(key):
        def hook(*_a):
            if not torch.cuda.is_current_stream_capturing():
                mark[key] = read_launches()
        return hook

    def after(key, kind):
        def hook(*_a):
            if torch.cuda.is_current_stream_capturing():
                return
            now = read_launches()
            for name in counts[kind]:
                counts[kind][name] += now[name] - mark[key][name]
        return hook
    for i, (kind, m) in enumerate(mods):
        handles += [m.register_forward_pre_hook(before(("f", i))),
                    m.register_forward_hook(after(("f", i), kind)),
                    m.register_full_backward_pre_hook(before(("b", i))),
                    m.register_full_backward_hook(after(("b", i), kind))]
    return counts, handles


def nmt_path(torch, card):
    """Phase 12: Transformer-big training through ``ShardedTrainer``
    (float32), then greedy and beam ``translate``."""
    from mxnet_tpu_torch.models import get_nmt, nmt_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    t_phase = time.monotonic()
    n_layers = 6
    print(f"Transformer-big: 6 + 6 layers, 1024, 4096, 16 heads, vocab "
          f"{NMT_VOCAB}, batch {NMT_B}, source and target {NMT_T}, "
          f"dropout 0, Adam lr {NMT_LR}, float32:", flush=True)
    net = get_nmt("transformer_big", src_vocab_size=NMT_VOCAB, dropout=0.0)
    net.initialize(seed=SEED)
    dev = net.device
    src, tgt, labels = (torch.from_numpy(a).to(dev) for a in nmt_batch())
    b = NMT_PARITY_B
    want = {k: 3 * n_layers for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    kernels_vs_ref(torch, net, lambda o: nmt_loss(o, labels[:b]),
                   (src[:b], tgt[:b]), want,
                   f"Transformer-big B{b} T{NMT_T}")
    print(f"  {sum(p.numel() for p in net.parameters())} parameters on "
          f"{net.device}", flush=True)
    trainer = ShardedTrainer(net, "adam", loss=nmt_loss,
                             optimizer_params={"learning_rate": NMT_LR})

    def step():
        return trainer.step((src, tgt), labels)
    counts, handles = nmt_attribution(torch, net)
    reset_launches()
    first = [float(step())]                            # warm-up
    total = read_launches()
    for h in handles:
        h.remove()
    print(f"  launches a step by attention: {counts} (total {total})",
          flush=True)
    for kind, c in counts.items():
        if any(n != n_layers for n in c.values()):
            raise AssertionError(f"{kind} attention launched {c}, not "
                                 f"{n_layers} of each")
    losses, _ms, _mib, per = timed_steps(
        torch, step, NMT_STEPS, ("tokens", NMT_B * NMT_T), card,
        "ShardedTrainer float32", NMT_FLOP_PER_TOKEN * NMT_B * NMT_T,
        F32_SIMT_PEAK)
    if per != {**want, "paged_attention": 0}:
        raise AssertionError(f"launches per step {per}, not {want}")
    finite_and_falling(first + losses, "Transformer-big")
    launches = read_launches()
    print("where the time goes (one step):", flush=True)
    profile_step(torch, f"Transformer-big step B{NMT_B}", step, card)
    del trainer
    free(torch)
    translate_checks(torch, net)
    print(f"phase 12: {time.monotonic() - t_phase:.1f} s", flush=True)
    del net
    free(torch)
    return launches, counts


def forced_logits(torch, net, src, toks, bos):
    """Teacher-forced logits (B, L, V) of ``toks`` after BOS."""
    tgt = np.concatenate([np.full((len(toks), 1), bos, np.int32),
                          toks[:, :-1]], axis=1)
    with torch.no_grad():
        return net(src, torch.from_numpy(tgt).to(src.device)).double()


def translate_checks(torch, net):
    """Greedy and beam-4 ``translate`` of 8 random 64-token sources,
    ``max_length`` 32: greedy's tokens each within ``TOL_GREEDY``
    (relative) of their position's largest teacher-forced logit; beam's
    tokens well formed; both teacher-forced length-normalized scores
    printed."""
    rs = np.random.RandomState(SEED + 1)
    src = torch.from_numpy(rs.randint(0, NMT_VOCAB, (8, 64))
                           .astype(np.int32)).to(net.device)
    bos, eos, alpha = 1, 2, 1.0
    scores = {}
    for beam in (1, 4):
        t0 = time.monotonic()
        toks = net.translate(src, max_length=32, beam_size=beam,
                             alpha=alpha, bos_id=bos, eos_id=eos)
        wall = time.monotonic() - t0
        if toks.min() < 0 or toks.max() >= NMT_VOCAB:
            raise AssertionError(f"beam {beam}: ids out of range")
        lens = []
        for row in toks:
            ends = np.nonzero(row == eos)[0]
            n = int(ends[0]) + 1 if len(ends) else len(row)
            if (row[n:] != eos).any():
                raise AssertionError(f"beam {beam}: a token after EOS")
            lens.append(n)
        logits = forced_logits(torch, net, src, toks, bos)
        logp = torch.log_softmax(logits, -1).cpu().numpy()
        picked = np.take_along_axis(logp, toks[..., None].astype(np.int64),
                                    -1)[..., 0]
        scores[beam] = float(np.mean([picked[i, :n].sum() / n ** alpha
                                      for i, n in enumerate(lens)]))
        print(f"  translate beam {beam}: {toks.shape} tokens in "
              f"{wall:.3f} s, lengths {lens}, teacher-forced "
              f"length-normalized log-prob {scores[beam]:.6f}", flush=True)
        if beam == 1:
            lg = logits.cpu().numpy()
            worst = 0.0
            for i, n in enumerate(lens):
                top = lg[i, :n].max(-1)
                got = np.take_along_axis(lg[i, :n], toks[i, :n, None]
                                         .astype(np.int64), -1)[:, 0]
                worst = max(worst, float(((top - got) /
                                          np.abs(top)).max()))
            check("greedy tokens vs teacher-forced argmax (largest "
                  "logit - emitted, relative)", worst, TOL_GREEDY)
    print(f"  beam 4 minus greedy score: {scores[4] - scores[1]:.6f} "
          "(a finding on random weights, not a gate)", flush=True)


def word_lm():
    """The PTB word model of Zaremba, Sutskever and Vinyals (2014),
    "medium": embedding, dropout, a 2-layer LSTM with dropout between
    its layers, dropout, an untied Dense decoder over the vocabulary."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn, rnn

    class WordLM(mx.gluon.Block):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(LSTM_VOCAB, LSTM_UNITS)
            self.drop = nn.Dropout(LSTM_DROPOUT)
            self.lstm = rnn.LSTM(LSTM_UNITS, num_layers=2,
                                 dropout=LSTM_DROPOUT, input_size=LSTM_UNITS)
            self.decoder = nn.Dense(LSTM_VOCAB, flatten=False,
                                    in_units=LSTM_UNITS)

        def forward(self, x, states):
            out, states = self.lstm(self.drop(self.embed(x)), states)
            return self.decoder(self.drop(out)), states
    return WordLM()


def lstm_path(torch, card):
    """Phase 13: the LSTM language model through the Gluon loop (SGD lr
    1, gradients clipped at a global norm of 5 through
    ``gluon.utils.clip_global_norm``), after the fused-vs-step gate."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import training_mode
    t_phase = time.monotonic()
    net = word_lm().initialize(mx.init.Uniform(0.05), seed=SEED)
    dev = net.device
    rs = np.random.RandomState(SEED)
    x_np, y_np = (rs.randint(0, LSTM_VOCAB, (LSTM_T, LSTM_B))
                  .astype(np.int32) for _ in range(2))
    x, y = (torch.from_numpy(a).to(dev) for a in (x_np, y_np))
    n_params = sum(p.numel() for p in net.parameters())
    print(f"LSTM LM (Zaremba et al. 2014, medium): embedding "
          f"{LSTM_UNITS}, LSTM {LSTM_UNITS} x 2, dropout {LSTM_DROPOUT}, "
          f"vocab {LSTM_VOCAB}, {LSTM_T} steps x batch {LSTM_B}, SGD lr "
          f"{LSTM_LR}, clip {LSTM_CLIP}; {n_params} parameters on {dev}:",
          flush=True)
    params = list(net.parameters())
    names = [n for n, _ in net.named_parameters()]
    zeros = [torch.zeros((2, LSTM_B, LSTM_UNITS), device=dev)
             for _ in range(2)]
    runs = {}
    for impl in ("fused", "step"):
        net.lstm._impl = impl
        mx.random.seed(SEED)
        with training_mode(True):
            logits, _st = net(x, zeros)
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, LSTM_VOCAB), y.reshape(-1).long())
        runs[impl] = (logits.detach(), torch.autograd.grad(loss, params))
        torch.cuda.synchronize()
    net.lstm._impl = "auto"
    check("fused RNN (cuDNN) vs step-by-step: logits (over max-abs)",
          relerr(runs["fused"][0], runs["step"][0]), TOL_RNN)
    errs = [relerr(a, b) for a, b in zip(runs["fused"][1],
                                         runs["step"][1])]
    worst = int(np.argmax(errs))
    check(f"fused RNN vs step-by-step: {len(errs)} gradients (worst "
          f"{names[worst]}, over its max-abs)", errs[worst], TOL_RNN)
    del runs
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LSTM_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xn, yn = mx.nd.array(x_np, dtype="int32"), mx.nd.array(
        y_np, dtype="int32")
    states = net.lstm.begin_state(LSTM_B)
    grads = [p.grad() for p in net.collect_params().values()]
    n_tok = LSTM_T * LSTM_B

    def step():
        nonlocal states
        states = [s.detach() for s in states]
        with mx.autograd.record():
            out, states = net(xn, states)
            loss = loss_fn(out.reshape((n_tok, LSTM_VOCAB)),
                           yn.reshape((n_tok,)))
        loss.backward()
        # MXNet's word LM example: the summed gradient clipped at
        # clip x tokens, then the step divides by the tokens
        mx.gluon.utils.clip_global_norm(grads, LSTM_CLIP * n_tok,
                                        check_isfinite=False)
        trainer.step(n_tok)
        return loss.mean().asscalar()
    first = [float(step())]                            # warm-up
    losses, _ms, _mib, per = timed_steps(
        torch, step, LSTM_STEPS, ("tokens", n_tok), card,
        "gluon loop float32 (fused RNN)")
    finite_and_falling(first + losses, "LSTM LM")
    if any(per.values()):
        raise AssertionError(f"the LSTM LM launched a kernel: {per}")
    print("where the time goes (one step):", flush=True)
    profile_step(torch, f"LSTM LM step T{LSTM_T} B{LSTM_B}", step, card)
    print(f"phase 13: {time.monotonic() - t_phase:.1f} s", flush=True)
    del trainer, net
    free(torch)
    return {k: int(v * LSTM_STEPS) for k, v in per.items()}


# ------------------------------------------------- phase 14: the op surface

def on_card(*arrays):
    for a in arrays:
        if not a.tensor.is_cuda:
            raise AssertionError(f"an output left the card: {a.tensor.device}")


def cpu_copy(mx, a):
    """An NDArray on the CPU holding ``a``'s values (tensors and numpy
    arrays too)."""
    t = a.tensor if hasattr(a, "tensor") else a
    return mx.nd.array(t.detach().cpu() if hasattr(t, "detach") else t,
                       ctx=mx.cpu())


def op_time(torch, timer, fn, iters=5):
    """(ms a call by CUDA events, L2 flushed before each; peak MiB above
    what was allocated before the call)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return timer(fn, iters=iters, warm=1), peak


def fwd_bwd(mx, op, xs, head):
    """One recorded call of ``op(*xs)`` and its backward from ``head``;
    returns the output and the inputs' gradients."""
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        out = op(*xs)
    out.backward(head)
    return out, [x.grad for x in xs]


def timed_op(torch, mx, timer, card, what, op, xs, head=None, iters=5):
    """Time ``op(*xs)``, and with ``head`` forward plus backward; print
    both with the peak above the inputs.  Returns the numbers."""
    ms, peak = op_time(torch, timer, lambda: op(*xs), iters)
    line = f"  {what}: forward {ms:.4f} ms"
    rec = {"ms": ms, "peak_mib": peak}
    if head is not None:
        ms2, peak2 = op_time(torch, timer,
                             lambda: fwd_bwd(mx, op, xs, head), iters)
        rec.update(fwd_bwd_ms=ms2, backward_ms=ms2 - ms,
                   peak_mib=max(peak, peak2))
        line += f", forward+backward {ms2:.4f} ms (backward {ms2 - ms:.4f})"
    print(f"{line}, peak {rec['peak_mib']:.1f} MiB above the inputs "
          f"[{card}]", flush=True)
    return rec


def held(name, got, want, tol):
    """``got`` (card) against ``want`` (CPU), max-abs over max-abs."""
    import torch
    g, w = got.tensor.detach().cpu(), want.tensor.detach()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
    check(name, float((g.double() - w.double()).abs().max()) /
          max(float(w.double().abs().max()), 1e-30), tol)
    return torch.equal(g, w)


def ssd_priors(mx, ctx=None):
    """SSD-300's anchors (1, 8732, 4) over its six maps."""
    s = [v / 300.0 for v in SSD_SIZES]
    parts = []
    for k, m in enumerate(SSD_MAPS):
        ratios = (1, 2, 0.5, 3, 1 / 3) if k in SSD_WIDE else (1, 2, 0.5)
        step = SSD_STEPS[k] / 300.0
        parts.append(mx.nd.MultiBoxPrior(
            mx.nd.zeros((1, 1, m, m), ctx=ctx),
            sizes=(s[k], (s[k] * s[k + 1]) ** 0.5), ratios=ratios,
            steps=(step, step)))
    return mx.nd.concat(*parts, dim=1)


def ssd_inputs(rs):
    """Seeded labels (B, 56, 5), 1-40 valid rows of boxes inside the
    image; class scores (B, 21, 8732) as softmax probabilities; offsets
    (B, 34928)."""
    lab = -np.ones((SSD_B, SSD_GT, 5), np.float32)
    for b in range(SSD_B):
        k = rs.randint(1, 41)
        c = rs.uniform(0.05, 0.95, (k, 2))
        wh = rs.uniform(0.05, 0.6, (k, 2))
        lab[b, :k, 0] = rs.randint(0, SSD_CLASSES - 1, k)
        lab[b, :k, 1:3] = np.clip(c - wh / 2, 0, 1)
        lab[b, :k, 3:5] = np.clip(c + wh / 2, 0, 1)
    logits = rs.randn(SSD_B, SSD_CLASSES, SSD_ANCHORS).astype(np.float32)
    prob = np.exp(2 * logits)
    prob /= prob.sum(1, keepdims=True)
    loc = (0.5 * rs.randn(SSD_B, SSD_ANCHORS * 4)).astype(np.float32)
    return lab, prob.astype(np.float32), loc


def nms_differences(torch, got, want, thresh):
    """Rows kept on one device and not the other: each must lie within
    ``TOL_NMS_EDGE`` of the threshold in IoU with a kept row of its
    class that scores at least as high.  Returns (rows, worst margin)."""
    from mxnet_tpu_torch.ndarray.detection import pairwise_iou
    g, w = got.tensor.detach().cpu(), want.tensor.detach()
    g, w = g.reshape(-1, g.shape[-2], 6), w.reshape(-1, w.shape[-2], 6)
    n, worst = 0, 0.0
    for b in range(g.shape[0]):
        kg, kw = g[b, :, 0] >= 0, w[b, :, 0] >= 0
        for i in torch.nonzero(kg != kw).flatten().tolist():
            n += 1
            row = w[b, i] if kw[i] else g[b, i]
            kept = w[b][kw] if not kw[i] else g[b][kg]
            rival = kept[(kept[:, 0] == row[0]) & (kept[:, 1] >= row[1])]
            if not len(rival):
                raise AssertionError(f"NMS image {b} row {i} differs with "
                                     f"no kept rival")
            iou = pairwise_iou(row[None, 2:6].double(), rival[:, 2:6].double())
            margin = float((iou - thresh).abs().min())
            worst = max(worst, margin)
    if worst > TOL_NMS_EDGE:
        raise AssertionError(f"NMS kept sets differ away from the "
                             f"threshold: margin {worst:.3e}")
    return n, worst


def ssd_part(torch, mx, timer, card, rs, dev):
    """(a): MultiBoxPrior, MultiBoxTarget, MultiBoxDetection, box_nms."""
    out = {}
    anchors = ssd_priors(mx)
    if anchors.shape != (1, SSD_ANCHORS, 4):
        raise AssertionError(f"SSD-300 anchors {anchors.shape}, not 8732")
    on_card(anchors)
    held("(a) MultiBoxPrior, 8732 anchors, card vs CPU", anchors,
         ssd_priors(mx, mx.cpu()), TOL_OPS)
    out["MultiBoxPrior"] = timed_op(
        torch, mx, timer, card, "(a) MultiBoxPrior x 6 maps",
        lambda: ssd_priors(mx), [], iters=10)
    lab, prob, loc = ssd_inputs(rs)
    lab_d, prob_d, loc_d = (mx.nd.array(a) for a in (lab, prob, loc))
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=3.0,
              negative_mining_thresh=0.5)
    tgt = mx.nd.MultiBoxTarget(anchors, lab_d, prob_d, **kw)
    on_card(*tgt)
    want = mx.nd.MultiBoxTarget(cpu_copy(mx, anchors), cpu_copy(mx, lab),
                                cpu_copy(mx, prob), **kw)
    held("(a) MultiBoxTarget B32 loc targets", tgt[0], want[0], TOL_OPS)
    for name, g, w in (("loc masks", tgt[1], want[1]),
                       ("class targets", tgt[2], want[2])):
        if not torch.equal(g.tensor.cpu(), w.tensor):
            raise AssertionError(f"(a) MultiBoxTarget {name} differ")
    ct = want[2].tensor
    print(f"  (a) MultiBoxTarget class targets and masks identical: "
          f"{int((ct > 0).sum())} matched, {int((ct == 0).sum())} mined "
          f"negatives, {int((ct < 0).sum())} ignored", flush=True)
    out["MultiBoxTarget"] = timed_op(
        torch, mx, timer, card, "(a) MultiBoxTarget B32, 21 classes",
        lambda: mx.nd.MultiBoxTarget(anchors, lab_d, prob_d, **kw), [])
    dkw = dict(threshold=0.01, nms_threshold=0.45, nms_topk=400)
    det = mx.nd.MultiBoxDetection(prob_d, loc_d, anchors, **dkw)
    on_card(det)
    want = mx.nd.MultiBoxDetection(cpu_copy(mx, prob), cpu_copy(mx, loc),
                                   cpu_copy(mx, anchors), **dkw)
    n, margin = nms_differences(torch, det, want, 0.45)
    kept = det.tensor[..., 0] >= 0
    print(f"  (a) MultiBoxDetection B32: {int(kept.sum())} rows kept, "
          f"{n} differ from the CPU's (worst IoU margin {margin:.3e}, "
          f"limit {TOL_NMS_EDGE:g})", flush=True)
    both = kept.cpu() & (want.tensor[..., 0] >= 0)
    check("(a) MultiBoxDetection kept rows card vs CPU",
          float((det.tensor.cpu()[both] - want.tensor[both]).abs().max()),
          TOL_OPS)
    out["MultiBoxDetection"] = timed_op(
        torch, mx, timer, card,
        "(a) MultiBoxDetection B32, nms_topk 400",
        lambda: mx.nd.MultiBoxDetection(prob_d, loc_d, anchors, **dkw), [])
    # box_nms alone over all 8732 decoded rows of one image, topk=-1
    from mxnet_tpu_torch.ndarray import detection
    rows = mx.nd.array(detection._decode(
        prob_d.tensor[:1], loc_d.tensor[:1], anchors.tensor, True, 0.01,
        (0.1, 0.1, 0.2, 0.2)))
    nkw = dict(overlap_thresh=0.45, valid_thresh=0.01, topk=-1, id_index=0)
    nms = mx.nd.box_nms(rows, **nkw)
    on_card(nms)
    n, margin = nms_differences(torch, nms, mx.nd.box_nms(
        cpu_copy(mx, rows), **nkw), 0.45)
    print(f"  (a) box_nms 8732 rows, topk=-1: "
          f"{int((nms.tensor[..., 0] >= 0).sum())} kept, {n} differ "
          f"(worst margin {margin:.3e})", flush=True)
    head = mx.nd.array(np.ones(rows.shape, np.float32))
    out["box_nms"] = timed_op(torch, mx, timer, card,
                              "(a) box_nms 8732 rows",
                              lambda r: mx.nd.box_nms(r, **nkw), [rows],
                              head=head)
    return out


def rois(rs, n, images, height, width):
    """(n, 5) ROIs [image, x1, y1, x2, y2] in image pixels, ``n //
    images`` an image, 16-400 pixels a side."""
    img = np.repeat(np.arange(images), n // images)[:, None]
    wh = rs.uniform(16, 400, (n, 2))
    x1 = rs.uniform(0, width - 16, n)
    y1 = rs.uniform(0, height - 16, n)
    box = np.stack([x1, y1, np.minimum(x1 + wh[:, 0], width - 1),
                    np.minimum(y1 + wh[:, 1], height - 1)], 1)
    return np.concatenate([img, box], 1).astype(np.float32)


def roi_part(torch, mx, timer, card, rs, dev):
    """(b) ROIPooling at Faster R-CNN's size, (c) ROIAlign at Mask
    R-CNN's: values and data gradients card vs CPU, timed."""
    out = {}
    x = rs.randn(*RCNN_MAP).astype(np.float32)
    np.maximum(x, 0, out=x)                      # a ReLU's map: ties
    r = rois(rs, RCNN_ROIS, 2, 600, 1000)
    head = rs.uniform(0.5, 1.5, (RCNN_ROIS, RCNN_MAP[1]) + RCNN_POOL).astype(
        np.float32)

    def pool(x_, r_):
        return mx.nd.ROIPooling(x_, r_, RCNN_POOL, 1 / 16)
    xd, rd, hd = (mx.nd.array(a) for a in (x, r, head))
    got, (gx, _gr) = fwd_bwd(mx, pool, [xd, rd], hd)
    on_card(got, gx)
    want, (wx, _wr) = fwd_bwd(mx, pool, [cpu_copy(mx, x), cpu_copy(mx, r)],
                              cpu_copy(mx, head))
    held("(b) ROIPooling (2, 512, 38, 63) 256 ROIs 7x7 card vs CPU", got,
         want, TOL_OPS)
    held("(b) ROIPooling data gradient card vs CPU", gx, wx, TOL_OPS_GRAD)
    out["ROIPooling"] = timed_op(
        torch, mx, timer, card, "(b) ROIPooling (2, 512, 38, 63), 256 "
        "ROIs, 7x7, 1/16", pool, [xd, rd], head=hd)
    del got, gx, want, wx, xd, rd, hd
    free(torch)

    x = rs.randn(*MASK_MAP).astype(np.float32)
    r = rois(rs, MASK_ROIS, 2, 600, 1000)
    out_shape = (MASK_ROIS, MASK_MAP[1]) + MASK_POOL
    head = mx.nd.array(torch.rand(out_shape, generator=torch.Generator(
        dev).manual_seed(SEED), device=dev) + 0.5)

    def align(x_, r_):
        return mx.nd.ROIAlign(x_, r_, MASK_POOL, 1 / 16, 2)
    xd, rd = mx.nd.array(x), mx.nd.array(r)
    got, (gx, gr) = fwd_bwd(mx, align, [xd, rd], head)
    on_card(got, gx, gr)
    # the CPU holds the first ROIs of each image, the card recomputes
    # them alone: the same op on the same inputs
    k = MASK_HELD_ROIS // 2
    sub = np.concatenate([r[:k], r[MASK_ROIS // 2:MASK_ROIS // 2 + k]])
    hsub = torch.cat([head.tensor[:k], head.tensor[MASK_ROIS // 2:
                                                   MASK_ROIS // 2 + k]])
    g_sub, (gx_sub, _g) = fwd_bwd(mx, align, [mx.nd.array(x),
                                              mx.nd.array(sub)],
                                  mx.nd.array(hsub))
    w_sub, (wx_sub, _w) = fwd_bwd(mx, align, [cpu_copy(mx, x),
                                              cpu_copy(mx, sub)],
                                  cpu_copy(mx, hsub))
    held(f"(c) ROIAlign (2, 1024, 38, 63) 14x14 sr 2, {MASK_HELD_ROIS} "
         f"ROIs card vs CPU", g_sub, w_sub, TOL_OPS)
    held("(c) ROIAlign data gradient card vs CPU", gx_sub, wx_sub,
         TOL_OPS_GRAD)
    if not torch.equal(g_sub.tensor, torch.cat(
            [got.tensor[:k], got.tensor[MASK_ROIS // 2:MASK_ROIS // 2 + k]])):
        raise AssertionError("(c) ROIAlign: a ROI's output depends on the "
                             "other ROIs of the call")
    out["ROIAlign"] = timed_op(
        torch, mx, timer, card, "(c) ROIAlign (2, 1024, 38, 63), 1024 "
        "ROIs, 14x14, sample_ratio 2, 1/16", align, [xd, rd], head=head,
        iters=3)
    return out


def stn_part(torch, mx, timer, card, rs, dev):
    """(d) SpatialTransformer at the CUB setting: gradients to the data
    and to the affine parameters."""
    x = rs.rand(*STN_IN).astype(np.float32)
    theta = np.tile(np.array([0.5, 0, 0, 0, 0.5, 0], np.float32),
                    (STN_IN[0], 1)) + 0.1 * rs.randn(STN_IN[0], 6).astype(
        np.float32)
    head = rs.uniform(0.5, 1.5, (STN_IN[0], 3) + STN_OUT).astype(np.float32)

    def stn(x_, t_):
        return mx.nd.SpatialTransformer(x_, t_, target_shape=STN_OUT)
    xd, td, hd = (mx.nd.array(a) for a in (x, theta, head))
    got, (gx, gt) = fwd_bwd(mx, stn, [xd, td], hd)
    on_card(got, gx, gt)
    want, (wx, wt) = fwd_bwd(mx, stn, [cpu_copy(mx, x), cpu_copy(mx, theta)],
                             cpu_copy(mx, head))
    held("(d) SpatialTransformer (64, 3, 448, 448) -> 224 card vs CPU", got,
         want, TOL_OPS)
    held("(d) SpatialTransformer data gradient", gx, wx, TOL_OPS_GRAD)
    held("(d) SpatialTransformer loc gradient", gt, wt, TOL_OPS_GRAD)
    return {"SpatialTransformer": timed_op(
        torch, mx, timer, card, "(d) SpatialTransformer (64, 3, 448, 448) "
        "-> 224 x 224, affine", stn, [xd, td], head=hd)}


def linalg_part(torch, mx, timer, card, rs, dev):
    """(e): potrf, trsm (four flag combinations), slogdet and inverse of
    64 SPD 1024-matrices, det of 64 x 64 ones; residuals in float64 on
    the CPU."""
    out = {}
    xs = torch.from_numpy(rs.randn(GP_B, GP_N, GP_N)).to(dev)
    ad = mx.nd.array((xs @ xs.transpose(-1, -2) / GP_N + torch.eye(
        GP_N, dtype=torch.double, device=dev)).float())
    del xs
    h = GP_HELD                      # the matrices held in float64
    a64 = ad.tensor[:h].cpu().double()      # the float32 matrices, exactly
    norm = a64.norm(dim=(-2, -1))

    def resid(name, err):
        check(f"(e) {name} residual vs float64 on the CPU (relative, "
              f"{h} of {GP_B} matrices)", float(err),
              TOL_LINALG[name.split()[0]])
    lo = mx.nd.linalg_potrf(ad)
    on_card(lo)
    l64 = lo.tensor[:h].cpu().double()
    resid("potrf", ((l64 @ l64.transpose(-1, -2) - a64).norm(dim=(-2, -1))
                    / norm).max())
    out["linalg_potrf"] = timed_op(torch, mx, timer, card,
                                   "(e) linalg_potrf 64 x 1024^2",
                                   mx.nd.linalg_potrf, [ad])
    b = rs.randn(GP_B, GP_N, GP_RHS).astype(np.float32)
    for transpose in (False, True):
        for right in (False, True):
            bd = mx.nd.array(b.transpose(0, 2, 1).copy() if right else b)
            kw = dict(transpose=transpose, rightside=right, lower=True,
                      alpha=0.5)
            xsol = mx.nd.linalg_trsm(lo, bd, **kw)
            on_card(xsol)
            x64 = xsol.tensor[:h].cpu().double()
            b64 = bd.tensor[:h].cpu().double()
            op = l64.transpose(-1, -2) if transpose else l64
            lhs = x64 @ op if right else op @ x64
            resid(f"trsm transpose={transpose} rightside={right}",
                  ((lhs - 0.5 * b64).norm(dim=(-2, -1)) /
                   (op.norm(dim=(-2, -1)) * x64.norm(dim=(-2, -1)))).max())
            out[f"linalg_trsm t{int(transpose)} r{int(right)}"] = timed_op(
                torch, mx, timer, card,
                f"(e) linalg_trsm 64 x 1024^2, {GP_RHS} right-hand sides, "
                f"transpose={transpose} rightside={right}",
                lambda a_, b_, kw=kw: mx.nd.linalg_trsm(a_, b_, **kw),
                [lo, bd])
    sign, logdet = mx.nd.linalg_slogdet(ad)
    on_card(sign, logdet)
    s64, ld64 = torch.linalg.slogdet(a64)
    if not torch.equal(sign.tensor[:h].cpu().double(), s64):
        raise AssertionError("(e) slogdet signs differ from float64's")
    resid("slogdet", ((logdet.tensor[:h].cpu().double() - ld64).abs() /
                      ld64.abs()).max())
    out["linalg_slogdet"] = timed_op(torch, mx, timer, card,
                                     "(e) linalg_slogdet 64 x 1024^2",
                                     mx.nd.linalg_slogdet, [ad])
    inv = mx.nd.linalg_inverse(ad)
    on_card(inv)
    eye = torch.eye(GP_N, dtype=torch.double)
    resid("inverse", ((a64 @ inv.tensor[:h].cpu().double() - eye).norm(
        dim=(-2, -1)) / GP_N ** 0.5).max())
    out["linalg_inverse"] = timed_op(torch, mx, timer, card,
                                     "(e) linalg_inverse 64 x 1024^2",
                                     mx.nd.linalg_inverse, [ad])
    m = (np.eye(DET_N) + rs.randn(GP_B, DET_N, DET_N) / DET_N ** 0.5 *
         0.5).astype(np.float32)
    md = mx.nd.array(m)
    det = mx.nd.linalg_det(md)
    on_card(det)
    d64 = torch.linalg.det(torch.from_numpy(m).double())
    resid("det", ((det.tensor.cpu().double() - d64).abs() /
                  d64.abs()).max())
    out["linalg_det"] = timed_op(torch, mx, timer, card,
                                 "(e) linalg_det 64 x 64^2",
                                 mx.nd.linalg_det, [md], iters=10)
    return out


def sampler_laws(st):
    """name: (call on nd, scipy law) for the 18 samplers at
    ``SAMPLE_N`` draws; the sample_* ops draw 2**14 each of 2**10
    parameter rows of one value."""
    n, rows = SAMPLE_N, 1 << 10
    each = SAMPLE_N // rows

    def par(nd, *vals):
        return [nd.array(np.full((rows,), v, np.float32)) for v in vals]
    return {
        "random_uniform": (lambda nd: nd.random_uniform(
            shape=n, low=-1.0, high=3.0), st.uniform(-1, 4)),
        "uniform": (lambda nd: nd.uniform(shape=n), st.uniform(0, 1)),
        "random_normal": (lambda nd: nd.random_normal(
            shape=n, loc=1.0, scale=2.0), st.norm(1, 2)),
        "normal": (lambda nd: nd.normal(shape=n), st.norm(0, 1)),
        "random_gamma": (lambda nd: nd.random_gamma(
            shape=n, alpha=2.5, beta=1.5), st.gamma(2.5, scale=1.5)),
        "random_exponential": (lambda nd: nd.random_exponential(
            shape=n, lam=2.0), st.expon(scale=0.5)),
        "random_poisson": (lambda nd: nd.random_poisson(
            shape=n, lam=3.5), st.poisson(3.5)),
        "random_randint": (lambda nd: nd.random_randint(
            shape=n, low=-3, high=5), st.randint(-3, 5)),
        "random_bernoulli": (lambda nd: nd.random_bernoulli(
            0.3, shape=n), st.bernoulli(0.3)),
        "random_negative_binomial": (lambda nd: nd.random_negative_binomial(
            shape=n, k=3, p=0.4), st.nbinom(3, 0.4)),
        "random_generalized_negative_binomial": (
            lambda nd: nd.random_generalized_negative_binomial(
                shape=n, mu=2.0, alpha=0.5), st.nbinom(2.0, 0.5)),
        "sample_uniform": (lambda nd: nd.sample_uniform(
            *par(nd, 0.0, 2.0), shape=each), st.uniform(0, 2)),
        "sample_normal": (lambda nd: nd.sample_normal(
            *par(nd, 1.0, 3.0), shape=each), st.norm(1, 3)),
        "sample_gamma": (lambda nd: nd.sample_gamma(
            *par(nd, 0.7, 2.0), shape=each), st.gamma(0.7, scale=2.0)),
        "sample_exponential": (lambda nd: nd.sample_exponential(
            *par(nd, 0.5), shape=each), st.expon(scale=2.0)),
        "sample_poisson": (lambda nd: nd.sample_poisson(
            *par(nd, 6.0), shape=each), st.poisson(6.0)),
    }


def seeds_repeat(torch, mx, name, first, draw):
    """``draw()`` after reseeding with ``SEED`` repeats ``first`` (drawn
    just after seeding with it) bit for bit; after ``SEED + 1`` it
    differs."""
    mx.random.seed(SEED)
    again = draw().tensor
    mx.random.seed(SEED + 1)
    other = draw().tensor
    if not torch.equal(again, first.tensor) or torch.equal(other,
                                                           first.tensor):
        raise AssertionError(f"(f) {name}: a seed does not repeat, or "
                             f"another seed repeats it")


def sampling_part(torch, mx, timer, card, rs, dev):
    """(f): moments of 2**24 draws of each sampler, seeding, the
    multinomial at GPT-2's vocabulary, shuffle."""
    import scipy.stats as st
    out = {}
    for name, (call, law) in sampler_laws(st).items():
        mx.random.seed(SEED)
        x = call(mx.nd)
        on_card(x)
        t = x.tensor.double().reshape(-1)
        if t.numel() != SAMPLE_N:
            raise AssertionError(f"(f) {name}: {t.numel()} draws")
        mean, var, _s, kurt = (float(v) for v in law.stats(moments="mvsk"))
        m, v = float(t.mean()), float(t.var(unbiased=False))
        se_m = (var / SAMPLE_N) ** 0.5
        se_v = var * ((kurt + 2) / SAMPLE_N) ** 0.5
        if abs(m - mean) > SIGMAS * se_m or abs(v - var) > SIGMAS * se_v:
            raise AssertionError(
                f"(f) {name}: mean {m} (want {mean} +- {SIGMAS * se_m:.2e}) "
                f"variance {v} (want {var} +- {SIGMAS * se_v:.2e})")
        seeds_repeat(torch, mx, name, x, lambda: call(mx.nd))
        ms, peak = op_time(torch, timer, lambda: call(mx.nd))
        out[name] = {"ms": ms, "peak_mib": peak}
        print(f"  (f) {name} 2^24 draws: mean {m:.5f} (law {mean:.5f}, "
              f"{abs(m - mean) / se_m:.2f} se), variance {v:.5f} (law "
              f"{var:.5f}, {abs(v - var) / se_v:.2f} se), seeds repeat, "
              f"{ms:.4f} ms, peak {peak:.1f} MiB [{card}]", flush=True)
    logits = torch.randn(MULTI_ROWS, VOCAB, device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED))
    p = mx.nd.array(torch.softmax(2 * logits, -1))
    mx.random.seed(SEED)
    s, logp = mx.nd.sample_multinomial(p, get_prob=True)
    on_card(s, logp)
    seeds_repeat(torch, mx, "sample_multinomial", s,
                 lambda: mx.nd.sample_multinomial(p))
    pt, st_ = p.tensor.double(), s.tensor.long()
    picked = pt.gather(1, st_[:, None])[:, 0]
    want = (pt ** 2).sum(1)
    se = float(((pt ** 3).sum(1) - want ** 2).sum() ** 0.5) / MULTI_ROWS
    if abs(float(picked.mean() - want.mean())) > SIGMAS * se:
        raise AssertionError("(f) sample_multinomial draws do not follow p")
    check("(f) sample_multinomial get_prob vs log p at the draws",
          float((logp.tensor.double() - picked.log()).abs().max()), 1e-5)
    ms, peak = op_time(torch, timer, lambda: mx.nd.sample_multinomial(p))
    out["sample_multinomial"] = {"ms": ms, "peak_mib": peak}
    print(f"  (f) sample_multinomial (1024, 50257): E p[draw] "
          f"{float(picked.mean()):.6f} vs sum p^2 {float(want.mean()):.6f} "
          f"(se {se:.2e}), seeds repeat, {ms:.4f} ms, peak {peak:.1f} MiB "
          f"[{card}]",
          flush=True)
    rows = torch.arange(SHUFFLE_ROWS * 16, device=dev,
                        dtype=torch.int32).reshape(SHUFFLE_ROWS, 16)
    mx.random.seed(SEED)
    sh = mx.nd.shuffle(mx.nd.array(rows))
    on_card(sh)
    seeds_repeat(torch, mx, "shuffle", sh,
                 lambda: mx.nd.shuffle(mx.nd.array(rows)))
    back = sh.tensor[torch.argsort(sh.tensor[:, 0])]
    if not torch.equal(back, rows) or torch.equal(sh.tensor, rows):
        raise AssertionError("(f) shuffle is not a permutation of the rows")
    ms, peak = op_time(torch, timer, lambda: mx.nd.shuffle(sh))
    out["shuffle"] = {"ms": ms, "peak_mib": peak}
    print(f"  (f) shuffle (2^20, 16): a permutation of the rows, seeds "
          f"repeat, {ms:.4f} ms, peak {peak:.1f} MiB [{card}]", flush=True)
    return out


def index_part(torch, mx, timer, card, rs, dev):
    """(g): scatter_nd of 2**20 updates, duplicates adding, card vs
    CPU."""
    idx = rs.randint(0, SCATTER_SHAPE[0], (2, SCATTER_N)).astype(np.int32)
    idx[:, 1::64] = idx[:, ::64]                      # duplicates for sure
    data = rs.randn(SCATTER_N).astype(np.float32)
    dd, ii = mx.nd.array(data), mx.nd.array(idx)
    got = mx.nd.scatter_nd(dd, ii, SCATTER_SHAPE)
    on_card(got)
    held("(g) scatter_nd 2^20 updates into 4096^2 card vs CPU", got,
         mx.nd.scatter_nd(cpu_copy(mx, data), cpu_copy(mx, idx),
                          SCATTER_SHAPE), TOL_OPS)
    return {"scatter_nd": timed_op(
        torch, mx, timer, card, "(g) scatter_nd 2^20 updates, 4096 x 4096",
        lambda d, i: mx.nd.scatter_nd(d, i, SCATTER_SHAPE), [dd, ii],
        iters=10)}


def ops_path(torch, card, timer, dev):
    """Phase 14: the nd ops at published sizes, each held against the
    same port op on the CPU (or float64, or its law) and timed."""
    import mxnet_tpu_torch as mx
    t_phase = time.monotonic()
    print("the op surface at published sizes (SSD-300, Faster/Mask R-CNN "
          "heads, STN on CUB, GP linalg, samplers, scatter):", flush=True)
    rs = np.random.RandomState(SEED)
    out = {}
    for part in (ssd_part, roi_part, stn_part, linalg_part, sampling_part,
                 index_part):
        out.update(part(torch, mx, timer, card, rs, dev))
        free(torch)
    print(json.dumps({"ops": out}), flush=True)
    print(f"phase 14: {time.monotonic() - t_phase:.1f} s", flush=True)


# ------------------------------------------- phase 15: compiled programs

def serving_engine(torch, net, graphs, **kw):
    """Phase 3's engine (paged, 16-position pages, 8 slots, buckets
    64-512, the kernel arm), its programs CUDA graphs or eager."""
    from mxnet_tpu_torch.serving import InferenceEngine
    cfg = dict(kv_layout="paged", num_slots=8, max_batch=8, page_size=16,
               seq_buckets=(64, 128, 256, 512), paged_attention="kernel")
    cfg.update(kw)
    eng = InferenceEngine(net, **cfg)
    eng._graphs = graphs
    return eng


def arm_name(graphs):
    return "graphed" if graphs else "eager"


def graph_arm(torch, net, prompts, graphs, card, rnd):
    """One arm of (a): a fresh engine, warmed up, serving the prompts
    with each of ``GRAPH_NEW`` new tokens in turn.  Returns its outputs,
    launches, rates and memory."""
    free(torch)
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    eng = serving_engine(torch, net, graphs,
                         batch_buckets=GRAPH_BATCH_BUCKETS)
    t0 = time.monotonic()
    n_warm = eng.warmup()
    warm_s = time.monotonic() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    paged = _launches().wrappers()["paged_attention"]
    multi0 = paged.multi_query_launches
    outs, ttft = [], []
    t0 = time.monotonic()
    with eng:
        for new in GRAPH_NEW:
            n0 = len(eng._ttft)
            futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
            outs += [f.result(600) for f in futs]
            ttft.append(float(np.median(eng._ttft[n0:])) * 1e3)
    wall = time.monotonic() - t0
    launches = {k: n - before[k] for k, n in read_launches().items()}
    launches["multi_query"] = paged.multi_query_launches - multi0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    reserved = (torch.cuda.memory_reserved() - base_reserved) / 2 ** 20
    c = eng.stats()["counters"]
    for p, o, new in zip(prompts * len(GRAPH_NEW), outs,
                         [n for n in GRAPH_NEW for _ in prompts]):
        if o.shape != (len(p) + new,) or not np.array_equal(o[:len(p)], p) \
                or o.min() < 0 or o.max() >= VOCAB:
            raise AssertionError("served sequence has the wrong shape or "
                                 "out-of-vocab tokens")
    if graphs and c["compiles"] != n_warm:
        raise AssertionError(f"the graphed engine compiled on traffic: "
                             f"{c['compiles']} programs, warmup {n_warm}")
    gen = c["tokens_generated"]
    r = dict(outs=outs, launches=launches, tps=gen / wall, ttft=ttft,
             peak=peak, reserved=reserved, warm_s=warm_s, n_warm=n_warm,
             hits=c["bucket_hits"], wall=wall)
    print(f"  round {rnd} {arm_name(graphs)}: warmup {warm_s:.3f} s for "
          f"{n_warm} programs; {gen} tokens in {wall:.3f} s = "
          f"{r['tps']:.1f} tokens/s, TTFT p50 by wave "
          f"{' / '.join(f'{t:.1f}' for t in ttft)} ms, peak "
          f"{peak:.0f} MiB (reserved {reserved:.0f}) above the model, "
          f"{c['compiles']} compiles, {c['bucket_hits']} bucket hits, "
          f"launches {launches} [{card}]", flush=True)
    del eng
    return r


def eager_vs_graphed(torch, net, prompts, card):
    """(a): ``GRAPH_ROUNDS`` rounds of the eager and the graphed arm in
    turns (eager first in odd rounds): greedy streams identical across
    every arm, the same kernel launches, the graphed arm frozen."""
    print(f"15a eager vs graphed engine, {GRAPH_ROUNDS} rounds in turns: "
          f"phase 3's prompts with {GRAPH_NEW} new tokens", flush=True)
    runs = {True: [], False: []}
    for rnd in range(1, GRAPH_ROUNDS + 1):
        for graphs in ((False, True) if rnd % 2 else (True, False)):
            runs[graphs].append(graph_arm(torch, net, prompts, graphs,
                                          card, rnd))
    first = runs[False][0]
    for graphs, rs in runs.items():
        for r in rs:
            for a, b in zip(r["outs"], first["outs"]):
                if not np.array_equal(a, b):
                    raise AssertionError("greedy streams differ between "
                                         "the eager and the graphed arm")
            if r["launches"] != first["launches"]:
                raise AssertionError(f"launches under replay "
                                     f"{r['launches']} differ from the "
                                     f"eager arm's {first['launches']}")
    for graphs, rs in runs.items():
        tps = [r["tps"] for r in rs]
        print(f"  {arm_name(graphs)}: tokens/s by round "
              f"{' / '.join(f'{t:.1f}' for t in tps)}; greedy streams "
              f"identical across arms; launches {first['launches']} in "
              f"every arm [{card}]", flush=True)
    return {arm_name(g): [{k: r[k] for k in ("tps", "ttft", "peak",
                                              "reserved", "warm_s",
                                              "n_warm", "wall")}
                          for r in rs] for g, rs in runs.items()}


def program_calls(eng, rs, lens):
    """One call of each program kind of a phase-3 engine with
    speculation and a prefix cache, from seeded inputs: (name, thunk).
    Slot i owns pages [60 i, 60 i + 60); its prompt (``lens``)
    prefills at the 512 bucket (B1), then a chunk of the 256 bucket
    behind it (B4, Tq 256), a decode step, a draft and a verify window
    (B4, Tq k + 1), and a tail-page copy.  Rows 0, 2, 4, 6 sample."""
    s = eng.num_slots
    s1 = s + 1
    eng._page_table[:s, :60] = np.arange(60 * s).reshape(s, 60)
    eng._table_stale = True
    eng._sync_table()
    lens = np.asarray(lens, np.int32)
    toks = rs.randint(0, VOCAB, (s, 512)).astype(np.int32)
    chunk = rs.randint(0, VOCAB, (s, 256)).astype(np.int32)
    clen = rs.randint(100, 257, s).astype(np.int32)
    sidx = np.arange(s, dtype=np.int32)
    samp = eng._samp_rows([], s)
    temp = np.zeros(s1, np.float32)
    temp[0:s:2] = 0.8
    samp1 = (temp, np.zeros(s1, np.int32), np.ones(s1, np.float32),
             np.arange(s1, dtype=np.int64) + 5)
    pos = np.append(lens + clen, eng.max_length).astype(np.int32)
    tok = rs.randint(0, VOCAB, (s1,)).astype(np.int32)
    return [
        ("prefill B8 T512", lambda: eng._run_prefill(toks, lens, sidx,
                                                     samp)),
        ("chunk B8 T256", lambda: eng._run_prefill(chunk, clen, sidx, samp,
                                                   off=lens.copy())),
        ("decode", lambda: eng._run_decode(tok, pos, samp1)),
        ("draft + verify", lambda: eng._run_spec(tok, pos + 1, samp1)),
        ("prefix copy", lambda: eng._copy_rows(3, 60 * s + 5, 9)),
    ]


def cache_maxabs(a, b):
    """Max-abs between two paged engines' caches, the trash page (where
    duplicate writes land in any order) left out."""
    return max(maxabs(x[:-1], y[:-1]) for ca, cb in zip(a._caches,
                                                       b._caches)
               for x, y in zip(ca.values(), cb.values()))


def program_parity(torch, net, prompts, card):
    """(b): each program kind's replay against the eager call from the
    same inputs, then again after new inputs: tokens identical, the
    caches the programs wrote within ``TOL_REPLAY``."""
    print("15b replay vs eager call, each program kind, two sets of "
          "inputs (spec k = 4 over 2 draft layers)", flush=True)
    engs = {}
    for graphs in (True, False):
        eng = serving_engine(torch, net, graphs, batch_buckets=(8,),
                             seq_buckets=(256, 512), spec_tokens=4,
                             draft_layers=2)
        n = eng.warmup()
        if n != len(eng._programs):
            raise AssertionError("warmup's count is not its programs'")
        engs[graphs] = eng
    lens = [len(p) for p in prompts]
    worst = {}
    for rnd in range(2):
        calls = {g: program_calls(e, np.random.RandomState(SEED + 20 + rnd),
                                  lens) for g, e in engs.items()}
        for (name, fg), (_n, fe) in zip(calls[True], calls[False]):
            got, want = fg(), fe()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                if a is not None and not np.array_equal(a, b):
                    raise AssertionError(f"{name}: replayed tokens differ "
                                         "from the eager call's")
            torch.cuda.synchronize()
            err = cache_maxabs(engs[True], engs[False])
            worst[name] = max(worst.get(name, 0.0), err)
    for name, err in worst.items():
        check(f"{name}: replay vs eager, tokens identical, caches max-abs",
              err, TOL_REPLAY)
    c = engs[True].stats()["compile"]
    if c["compiles"] != len(engs[True]._programs):
        raise AssertionError("a parity call compiled a program")
    return engs


def profile_cycles(torch, net, prompts, card):
    """(c): torch.profiler over engine cycles driven by hand (no
    scheduler thread): the first cycle (admission, the B8 T512 prefill
    and one decode step), then 8 decode cycles, graphed and eager."""
    from torch.profiler import ProfilerActivity, profile
    print("15c where the time goes: the engine's own cycles, graphed vs "
          "eager (T5: 8 eager model-level decode steps idled 89.1 %)",
          flush=True)
    for graphs in (True, False):
        eng = serving_engine(torch, net, graphs, batch_buckets=(8,),
                             seq_buckets=(512,))
        eng.warmup()
        for p in prompts:
            eng.submit(p, max_new_tokens=64)
        for name, n in (("first cycle (prefill B8 T512 + 1 decode)", 1),
                        ("8 decode cycles", 8)):
            if n > 1:
                for _ in range(2):
                    eng._cycle()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    eng._cycle()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            report_profile(torch, f"{arm_name(graphs)} {name}", wall, prof,
                           card, marks=("flash_fwd", "paged_"))
        eng.stop()
        del eng
        free(torch)


def forward_engine(torch, net, graphs, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    eng = InferenceEngine(net, max_batch=FWD_BATCH, **kw)
    # each wave's requests form one batch
    eng.MAX_WAIT_US = 200_000.0
    eng._graphs = graphs
    return eng


def forward_serving(torch, card):
    """(d): ResNet-50 v1 served in forward mode, eager and graphed arms
    in turns, each output held to the block's direct forward on the
    card; the forward program's replay against its eager call."""
    from mxnet_tpu_torch.base import training_mode
    print(f"15d forward mode: ResNet-50 v1 NHWC at max_batch {FWD_BATCH}, "
          f"{FWD_REQUESTS} requests of {VISION_SIZE} x {VISION_SIZE} x 3 "
          f"in {FWD_WAVES} waves, float32 (TF32 off)", flush=True)
    net = resnet50()
    net.initialize(seed=SEED)
    rs = np.random.RandomState(SEED + 30)
    shape = (VISION_SIZE, VISION_SIZE, 3)
    images = rs.uniform(-1, 1, (FWD_REQUESTS,) + shape).astype(np.float32)
    waves = np.split(images, FWD_WAVES)
    with torch.no_grad(), training_mode(False):
        direct = [net(torch.from_numpy(w).to(net.device)).cpu().numpy()
                  for w in waves]
    # the forward program's replay vs its eager call, two inputs
    engs = {g: forward_engine(torch, net, g, batch_buckets=(FWD_BATCH,))
            for g in (True, False)}
    worst = 0.0
    for g, eng in engs.items():
        eng.warmup(example_shape=shape)
    key = (shape, "float32")
    for w in waves[:2]:
        got, want = (engs[g]._forward_program(w, key).float().cpu()
                     for g in (True, False))
        worst = max(worst, maxabs(got, want))
    check(f"forward B{FWD_BATCH}: replay vs eager call, two inputs", worst,
          TOL_REPLAY)
    for g, eng in engs.items():
        profile_one(torch, f"forward B{FWD_BATCH} program call "
                    f"({arm_name(g)}, staging copy included)",
                    lambda: eng._forward_program(waves[0], key), card)
    del engs, eng
    free(torch)
    out = {}
    for rnd, order in enumerate(((False, True), (True, False))
                                [:GRAPH_ROUNDS], 1):
        for graphs in order:
            free(torch)
            eng = forward_engine(torch, net, graphs)
            t0 = time.monotonic()
            n_warm = eng.warmup(example_shape=shape)
            warm_s = time.monotonic() - t0
            worst = 0.0
            t0 = time.monotonic()
            with eng:
                for w, ref in zip(waves, direct):
                    futs = [eng.submit(x) for x in w]
                    got = np.stack([f.result(600) for f in futs])
                    worst = max(worst, float(np.abs(got - ref).max())
                                / float(np.abs(ref).max()))
            wall = time.monotonic() - t0
            s = eng.stats()
            c = s["counters"]
            if c["compiles"] != n_warm or c["completed"] != FWD_REQUESTS:
                raise AssertionError(f"forward serving compiled on traffic "
                                     f"or lost a request: {c}")
            p50 = s["latency"]["request"]["p50"] * 1e3
            print(f"  round {rnd} {arm_name(graphs)}: warmup {warm_s:.3f} s "
                  f"for {n_warm} programs; {FWD_REQUESTS} images in "
                  f"{wall:.3f} s = {FWD_REQUESTS / wall:.1f} images/s, "
                  f"latency p50 {p50:.1f} ms, {c['forward_batches']} "
                  f"batches, compiles {c['compiles']} (frozen), bucket "
                  f"hits {c['bucket_hits']} [{card}]", flush=True)
            check(f"  {arm_name(graphs)} outputs vs the direct forward "
                  f"(max-abs over max-abs)", worst, TOL_FORWARD)
            out.setdefault(arm_name(graphs), []).append(
                dict(images_per_s=FWD_REQUESTS / wall, p50_ms=p50,
                     warm_s=warm_s, n_warm=n_warm))
            del eng
    del net
    free(torch)
    return out


def programs_path(torch, card, prompts):
    """Phase 15: the serving engine's compiled programs.  Returns the
    launches of (a)-(c), and (d)'s (which must be none)."""
    from mxnet_tpu_torch.models import get_gpt2
    t_phase = time.monotonic()
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    reset_launches()
    summary = {"a": eager_vs_graphed(torch, net, prompts, card)}
    engs = program_parity(torch, net, prompts, card)
    del engs
    free(torch)
    profile_cycles(torch, net, prompts, card)
    launches = read_launches()
    del net
    free(torch)
    reset_launches()
    summary["d"] = forward_serving(torch, card)
    fwd_launches = read_launches()
    if any(fwd_launches.values()):
        raise AssertionError(f"forward serving launched a kernel of the "
                             f"port: {fwd_launches}")
    print(json.dumps({"programs": summary}), flush=True)
    print(f"phase 15: {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches, fwd_launches


def in_turns(torch, run, what, rounds=GRAPH_ROUNDS):
    """``run(graphed, rnd)`` for both arms, ``rounds`` rounds, the eager
    arm first in odd rounds: {True: [results], False: [...]}."""
    print(f"{what}, {rounds} round(s) in turns:", flush=True)
    runs = {True: [], False: []}
    for rnd in range(1, rounds + 1):
        for graphed in ((False, True) if rnd % 2 else (True, False)):
            runs[graphed].append(run(graphed, rnd))
            free(torch)
    return runs


def arm_summary(runs, keys):
    return {arm_name(g): [{k: r[k] for k in keys} for r in rs]
            for g, rs in runs.items()}


def reserved_mib(torch):
    """MiB the allocator holds: a graph's pool, which the peak of
    ``max_memory_allocated`` after the capture leaves out, is in it (the
    arms free the allocator's cache after their warm-up step)."""
    return torch.cuda.memory_reserved() / 2 ** 20


def worst_relerr(got, want):
    """The largest max-abs error over max-abs of paired tensors."""
    return max((relerr(a, b) for a, b in zip(got, want)), default=0.0)


def replayed(graphed, per_step):
    """The flash kernels' launches a step that a graphed arm's profiled
    step must show the profiler (replays credit their counts from the
    capture, so the profiler's count is what measures them); None for
    the eager arm, whose wrappers count each launch as it happens."""
    if not graphed:
        return None
    return {k: v for k, v in per_step.items() if k.startswith("flash")}


def bert_graph_gate(torch, mx, card):
    """16a's gate: one recorded step of BERT-large at batch
    ``BERT_PARITY_B`` and dropout 0 under amp, hybridized (the second
    call, a replay) against not: the loss and every gradient."""
    batch = bert_batch(BERT_PARITY_B)
    runs = {}
    for graphed in (False, True):
        net = bert_net(0.0)
        if graphed:
            net.hybridize()
        x = [mx.nd.array(a) for a in batch]
        for _ in range(2):
            with mx.autograd.record():
                loss = bert_loss(net(x[0], x[1], None, x[3]), x[4],
                                 x[5]).mean()
            loss.backward()
        torch.cuda.synchronize()
        runs[graphed] = (loss.tensor.detach().clone(),
                         [p.grad.clone() for p in net.parameters()
                          if p.requires_grad])
        del net, loss
        free(torch)
    (lg, gg), (le, ge) = runs[True], runs[False]
    check(f"16a gate: BERT-large B4 dropout 0 amp, hybridized loss vs not "
          f"(relative) [{card}]", relerr(lg, le), TOL_GRAPHED)
    check(f"16a gate: {len(gg)} gradients hybridized vs not (worst, over "
          f"its max-abs) [{card}]", worst_relerr(gg, ge), TOL_GRAPHED)


def bert_graph_arm(torch, mx, card, graphed, rnd):
    """One arm of 16a: phase 11 (b)'s loop (amp, remat='dots', dropout
    0.1, B8 x T512), the net hybridized in the graphed arm."""
    batch = bert_batch()
    net = bert_net(BERT_DROPOUT)
    if graphed:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": BERT_LR})
    x = [mx.nd.array(a) for a in batch]

    def step():
        with mx.autograd.record():
            loss = bert_loss(net(x[0], x[1], None, x[3]), x[4], x[5])
        loss.backward()
        trainer.step(BERT_B)
        return loss.mean().asscalar()
    first = [float(step())]                  # warm-up (graphed: capture)
    free(torch)
    what = f"16a round {rnd} {arm_name(graphed)} BERT-large amp"
    cpu0 = time.process_time()
    losses, ms, mib, per = timed_steps(
        torch, step, BERT_STEPS, ("samples", BERT_B), card, what,
        BERT_FLOP_PER_SAMPLE * BERT_B, PEAK_FLOPS["bfloat16"])
    cpu = (time.process_time() - cpu0) / BERT_STEPS * 1e3
    by_dtype = read_launches_by_dtype()
    expect_launches(by_dtype, {"flash_fwd": 48 * BERT_STEPS,
                               "flash_dq": 24 * BERT_STEPS,
                               "flash_dkv": 24 * BERT_STEPS}, what,
                    dtype="bfloat16")
    finite_and_falling(first + losses, what)
    idle = profile_step(torch, f"{what} step", step, card,
                        want=replayed(graphed, per))
    reserved = reserved_mib(torch)
    print(f"  {what}: host CPU {cpu:.1f} ms a step over {ms:.1f} ms of "
          f"wall, idle {idle:.1%}, reserved {reserved:.0f} MiB [{card}]",
          flush=True)
    if graphed and len(net._cached_op._jit_cache) != 1:
        raise AssertionError("the hybridized BERT compiled more than one "
                             "signature")
    return dict(ms=ms, rate=BERT_B * 1e3 / ms, cpu=cpu, idle=idle,
                peak=mib, reserved=reserved, launches={k: int(v * BERT_STEPS)
                                    for k, v in per.items()})


def gpt2_graph_arm(torch, mx, card, graphed, rnd, amp):
    """One arm of 16b: phase 4's GPT-2 124M ``ShardedTrainer`` step
    (16 x 1024, Adam), float32 or under amp, its private ``_graphs``
    set by arm."""
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    toks, labels = train_batch()
    dtype = "bfloat16" if amp else "float32"
    if amp:
        mx.amp.init("bfloat16")
    try:
        net = get_gpt2("gpt2_124m", dropout=0.0).initialize(seed=SEED)
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": TRAIN_LR})
        tr._graphs = graphed
        first = [float(tr.step(toks, labels))]      # warm-up (capture)
        free(torch)
        what = f"16b round {rnd} {arm_name(graphed)} GPT-2 {dtype}"
        losses, ms, mib, per = timed_steps(
            torch, lambda: tr.step(toks, labels), TRAIN_STEPS,
            ("tokens", TRAIN_B * TRAIN_T), card, what)
        expect_launches(read_launches_by_dtype(),
                        {k: 12 * TRAIN_STEPS for k in
                         ("flash_fwd", "flash_dq", "flash_dkv")}, what,
                        dtype=dtype)
        params = [p.detach().clone() for p in net.parameters()]
        idle = profile_step(torch, f"{what} step",
                            lambda: tr.step(toks, labels), card,
                            want=replayed(graphed, per))
        reserved = reserved_mib(torch)
        print(f"  {what}: idle {idle:.1%}, reserved {reserved:.0f} MiB "
              f"[{card}]", flush=True)
        if graphed and len(tr._programs) != 1:
            raise AssertionError(f"{what}: {len(tr._programs)} programs")
    finally:
        mx.amp.reset()
    return dict(ms=ms, rate=TRAIN_B * TRAIN_T * 1e3 / ms, idle=idle,
                peak=mib, reserved=reserved, losses=first + losses, params=params,
                launches={k: int(v * TRAIN_STEPS) for k, v in per.items()})


def vision_graph_steps(torch, graphed, n=3):
    """Phase 10's ResNet-50 v1 NHWC ``ShardedTrainer`` (batch 128 x 224²,
    SGD momentum) from the seed, ``n`` steps: the trainer, and each
    step's loss and moving statistics."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    x, y = vision_batch()
    net = resnet50()
    net.initialize(seed=SEED)
    tr = ShardedTrainer(net, "sgd", loss=vision_ce,
                        optimizer_params=VISION_OPT)
    tr._graphs = graphed
    losses, stats = [], []
    for _ in range(n):
        losses.append(float(tr.step(x, (y,))))
        stats.append([p.detach().clone() for _n, p in tr._aux])
    return tr, losses, stats


def vision_graph_gate(torch, card):
    """16c's gate: 3 steps graphed and eager under deterministic cuDNN
    algorithms.  Its default backward-filter algorithms are not
    deterministic, so two eager runs part after one step too (the timed
    arms print that control)."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for graphed in (False, True):
            _tr, losses, stats = vision_graph_steps(torch, graphed)
            runs[graphed] = (losses, stats)
            del _tr
            free(torch)
    finally:
        torch.backends.cudnn.deterministic = det
    (lg, sg), (le, se) = runs[True], runs[False]
    print(f"  16c gate losses graphed {lg}, eager {le} [{card}]", flush=True)
    check(f"16c gate: moving statistics after 3 steps graphed vs eager, "
          f"deterministic cuDNN (worst, over its max-abs) [{card}]",
          worst_relerr(sg[2], se[2]), TOL_GRAPHED)


def vision_graph_arm(torch, card, graphed, rnd):
    """One timed arm of 16c: 3 steps, then ``VISION_STEPS`` timed
    ones."""
    x, y = vision_batch()
    tr, losses, stats = vision_graph_steps(torch, graphed)
    free(torch)
    what = f"16c round {rnd} {arm_name(graphed)} ResNet-50"
    _l, ms, mib, per = timed_steps(torch, lambda: tr.step(x, (y,)),
                                   VISION_STEPS, ("images", VISION_B),
                                   card, what)
    reserved = reserved_mib(torch)
    print(f"  {what}: reserved {reserved:.0f} MiB [{card}]", flush=True)
    if any(per.values()):
        raise AssertionError(f"{what} launched a kernel of the port: {per}")
    return dict(ms=ms, rate=VISION_B * 1e3 / ms, peak=mib,
                reserved=reserved, stats=stats[2],
                losses=losses, launches={k: int(v * VISION_STEPS)
                                         for k, v in per.items()})


def guarded_replay(torch, mx, card):
    """16d: GPT-2 124M under the loss scaler, graphed: a finite step
    (captured, then replayed), a finite replay, a replay whose loss is NaN
    (a poisoned label), then a finite replay."""
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    toks, labels = (a[:GUARD_B] for a in train_batch())
    ok = np.zeros(GUARD_B, np.float32)
    nan = np.full(GUARD_B, np.nan, np.float32)

    def loss(out, y, poison):
        return gpt2_lm_loss(out, y) + poison.sum()
    net = get_gpt2("gpt2_124m", dropout=0.0).initialize(seed=SEED)
    tr = ShardedTrainer(net, "adam", loss=loss,
                        optimizer_params={"learning_rate": TRAIN_LR},
                        loss_scaler=mx.amp.LossScaler(2.0 ** 16, 2.0, 2000))
    for poison in (ok, ok):
        _l, finite = tr.step(toks, (labels, poison))
        if not bool(finite):
            raise AssertionError("16d: a finite step reported non-finite")
    before = {k: v.clone() for k, v in tr.state_dict().items()
              if not k.startswith("meta:")}
    scale = tr.loss_scale
    reset_launches()
    _l, finite = tr.step(toks, (labels, nan))
    after = tr.state_dict()
    same = all(torch.equal(after[k], v) for k, v in before.items())
    print(f"  16d NaN replay: all_finite {bool(finite)}, {len(before)} "
          f"parameter, aux and state tensors bit-identical: {same}, scale "
          f"{scale} -> {tr.loss_scale}, finite steps "
          f"{int(after['meta:good_steps'][0])}, launches "
          f"{read_launches()} [{card}]", flush=True)
    if bool(finite) or not same or tr.loss_scale != scale / 2:
        raise AssertionError("16d: the NaN replay changed the state or "
                             "did not halve the scale")
    _l, finite = tr.step(toks, (labels, ok))
    moved = not torch.equal(tr.state_dict()["param:0"], before["param:0"])
    print(f"  16d finite replay after it: all_finite {bool(finite)}, "
          f"parameters updated: {moved} [{card}]", flush=True)
    if not bool(finite) or not moved:
        raise AssertionError("16d: the step after the NaN replay did not "
                             "update")
    if len(tr._programs) != 1:
        raise AssertionError(f"16d: {len(tr._programs)} programs")


def dropout_replays(torch, mx, card):
    """16e: GPT-2 124M at dropout 0.1 under remat, graphed, learning
    rate 0: each replay draws new masks (the loss moves with nothing
    else), the recomputation draws its forward's (B1 2 a layer), and a
    reseeded run repeats the first loss for loss."""
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    toks, labels = (a[:DROP_B] for a in train_batch())

    def run():
        mx.random.seed(SEED)
        net = get_gpt2("gpt2_124m", dropout=0.1, remat=True)
        net.initialize(seed=SEED)
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": 0.0})
        reset_launches()
        losses = [float(tr.step(toks, labels)) for _ in range(4)]
        return losses, read_launches()
    first, n = run()
    again, _n = run()
    print(f"  16e losses by step {first}, reseeded {again}, launches "
          f"{n} [{card}]", flush=True)
    if len(set(first[1:])) != 3:
        raise AssertionError("16e: two replays drew the same masks")
    if again != first:
        raise AssertionError("16e: a reseeded run did not repeat")
    # four replays, and the first step's warm-up before its capture
    if n["flash_fwd"] != 5 * 24 or n["flash_dq"] != 5 * 12:
        raise AssertionError(f"16e: launches {n}, not 24 / 12 / 12 a step "
                             "and a warm-up")


def training_programs_path(torch, card):
    """Phase 16: the compiled training programs.  Returns the graphed
    arms' launches by path."""
    import mxnet_tpu_torch as mx
    t_phase = time.monotonic()
    summary, launches = {}, {}
    print("16a BERT-large, phase 11 (b)'s loop, hybridized vs not:",
          flush=True)
    try:
        mx.amp.init("bfloat16")
        bert_graph_gate(torch, mx, card)
        runs = in_turns(
            torch, lambda g, r: bert_graph_arm(torch, mx, card, g, r),
            "16a BERT-large B8 T512 amp, remat='dots'")
    finally:
        mx.amp.reset()
    summary["a"] = arm_summary(runs, ("ms", "rate", "cpu", "idle", "peak",
                                      "reserved"))
    launches["hybrid_bert_amp"] = runs[True][0]["launches"]
    for amp in (False, True):
        dtype = "bfloat16" if amp else "float32"
        runs = in_turns(
            torch, lambda g, r: gpt2_graph_arm(torch, mx, card, g, r, amp),
            f"16b GPT-2 124M ShardedTrainer {dtype}")
        ge, gg = runs[False][0], runs[True][0]
        check(f"16b {dtype} {len(gg['losses'])} graphed losses vs eager "
              f"(worst, relative) [{card}]",
              max(abs(a - b) / abs(b) for a, b in zip(gg["losses"],
                                                      ge["losses"])),
              TOL_GRAPHED)
        check(f"16b {dtype} final parameters graphed vs eager (worst, over "
              f"its max-abs) [{card}]",
              worst_relerr(gg["params"], ge["params"]), TOL_GRAPHED)
        summary[f"b_{dtype}"] = arm_summary(runs, ("ms", "rate", "idle",
                                                   "peak", "reserved"))
        launches["graph_amp" if amp else "graph_train"] = gg["launches"]
        del runs, ge, gg
        free(torch)
    print("16c ResNet-50 v1 NHWC ShardedTrainer float32:", flush=True)
    vision_graph_gate(torch, card)
    runs = in_turns(torch,
                    lambda g, r: vision_graph_arm(torch, card, g, r),
                    "16c ResNet-50 v1 NHWC, cuDNN's default algorithms",
                    rounds=VISION_GRAPH_ROUNDS)
    e1, e2, g1 = runs[False][0], runs[False][1], runs[True][0]
    print(f"  16c control: moving statistics after 3 steps, eager round 1 "
          f"vs round 2 {worst_relerr(e1['stats'], e2['stats']):.3e}, "
          f"graphed vs eager round 1 "
          f"{worst_relerr(g1['stats'], e1['stats']):.3e} (worst, over its "
          f"max-abs) [{card}]", flush=True)
    del e1, e2, g1
    summary["c"] = arm_summary(runs, ("ms", "rate", "peak", "reserved"))
    launches["graph_vision"] = runs[True][0]["launches"]
    del runs
    free(torch)
    print("16d guarded replay, GPT-2 124M under the loss scaler:",
          flush=True)
    guarded_replay(torch, mx, card)
    free(torch)
    print("16e dropout under replay, GPT-2 124M, remat:", flush=True)
    dropout_replays(torch, mx, card)
    free(torch)
    print(json.dumps({"training_programs": summary}), flush=True)
    print(f"phase 16: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches


RES_FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def res_batches():
    """Phase 17's data: a fresh iterator over one seeded (tokens, labels)
    batch a global step."""
    for i in range(max(RES_STEPS, RES_TIMED)):
        rs = np.random.RandomState(SEED + 1000 + i)
        yield tuple(rs.randint(0, VOCAB, (TRAIN_B, TRAIN_T))
                    .astype(np.int32) for _ in range(2))


def res_trainer(mx):
    """A fresh phase 17 trainer, the same weights every time (amp is on:
    the caller's ``amp.init``)."""
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net = get_gpt2("gpt2_124m", dropout=RES_DROPOUT,
                   num_layers=RES_LAYERS).initialize(seed=SEED)
    return ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                          optimizer_params={"learning_rate": TRAIN_LR},
                          guard_nonfinite=True,
                          loss_scaler=mx.amp.LossScaler(RES_SCALE, 2.0,
                                                        2000))


def res_loop(tr, directory, commits=None, save_every=RES_SAVE, write=True,
             **kw):
    """A ResilientLoop over ``tr``; with ``commits`` (a list), each
    commit's bytes and seconds by phase (the checkpointer's
    ``last_save``) and the whole save's seconds are appended to it.
    ``write=False`` (17a's timed arms) saves nothing: their ms/step
    leaves the commits out, and nothing reads their directories."""
    from mxnet_tpu_torch.resilience import ResilientLoop
    loop = ResilientLoop(tr, directory, save_every=save_every,
                         seed=RES_SEED, max_to_keep=2, backoff=0.0, **kw)
    if not write:
        loop.checkpointer.save = lambda step, tree, meta=None: None
    elif commits is not None:
        ck = loop.checkpointer
        save = ck.save

        def timed(step, tree, meta=None):
            t0 = time.monotonic()
            out = save(step, tree, meta)
            commits.append(dict(ck.last_save,
                                total_s=time.monotonic() - t0))
            return out
        ck.save = timed
    return loop


def res_state(tr):
    """Every tensor of the trainer's state (parameters, optimizer state,
    step count, loss scale, finite-step count), cloned."""
    return {k: v.clone() for k, v in tr.state_dict().items()}


def res_differ(torch, got, want):
    """The keys of ``want`` whose tensors ``got`` does not hold bit for
    bit."""
    return sorted(k for k, v in want.items()
                  if k not in got or not torch.equal(got[k], v))


def res_gate(what, ok, detail=""):
    print(f"  {what}: {'ok' if ok else 'FAIL'}{detail}", flush=True)
    if not ok:
        raise AssertionError(f"{what}{detail}")


def commit_line(rows):
    """Per commit: MB, ms for the snapshot (device to host), the write
    with its digest, the rename, and the whole save."""
    return ", ".join(
        f"step {r['step']}: {r['bytes'] / 1e6:.1f} MB, snapshot "
        f"{r['snapshot_s'] * 1e3:.1f} + write {r['write_s'] * 1e3:.1f} + "
        f"rename {r['rename_s'] * 1e3:.2f} = {r['total_s'] * 1e3:.1f} ms"
        for r in rows)


def res_reference(torch, mx, card, root):
    """17a: the fault-free run under a tracer, then the bare trainer
    against the loop, tracing off and on, in turns.  Returns the
    trainer, its final state and loss, the launches and the commits."""
    from mxnet_tpu_torch import observability as obs
    tr, commits = res_trainer(mx), []
    loop = res_loop(tr, f"{root}/a", commits)
    tracer = obs.enable_tracing()
    try:
        reset_launches()
        t0 = time.monotonic()
        report = loop.run(res_batches, RES_STEPS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        spans = [s.name for s in tracer.spans()]
    finally:
        obs.disable_tracing()
    by_dtype = read_launches_by_dtype()
    launches = read_launches()
    want, loss = res_state(tr), report["final_loss"]
    print(f"  17a fault-free: {RES_STEPS} steps in {wall:.3f} s (a capture "
          f"and {len(commits)} commits in), final loss {loss!r}, scale "
          f"{tr.loss_scale}, reserved {reserved_mib(torch):.0f} MiB "
          f"[{card}]", flush=True)
    print(f"  17a commits: {commit_line(commits)} [{card}]", flush=True)
    # a fresh trainer warms its step up once before the capture
    expect_launches(by_dtype,
                    dict.fromkeys(RES_FLASH, RES_LAYERS * (RES_STEPS + 1)),
                    "17a", dtype="bfloat16")
    counts = {n: spans.count(n) for n in ("loop.step", "trainer.step",
                                          "checkpoint.save",
                                          "checkpoint.commit")}
    res_gate(f"17a spans {counts}",
             counts == {"loop.step": RES_STEPS, "trainer.step": RES_STEPS,
                        "checkpoint.save": RES_STEPS // RES_SAVE,
                        "checkpoint.commit": RES_STEPS // RES_SAVE})
    res_gate("17a report", report["completed_steps"] == RES_STEPS
             and report["bad_steps"] == 0 and len(tr._programs) == 1,
             f" {report}")
    arms = res_timing(torch, card, tr, root)
    return tr, want, loss, launches, commits, arms


def res_timing(torch, card, tr, root):
    """17a's timing: ms/step of the captured trainer bare (``step`` in a
    loop, one sync at the end) against ``ResilientLoop`` with tracing
    off and on (which reads each step's finite flag), RES_TIMED steps an
    arm, in turns; a loop arm does not commit (17a's run times the
    commits).  Each arm launches B1-B3 RES_LAYERS times a step from
    replays."""
    from mxnet_tpu_torch import observability as obs
    arms = {"bare": [], "loop": [], "loop+trace": []}
    order = list(arms)
    for rnd in range(RES_ROUNDS):
        for arm in (order if rnd % 2 == 0 else order[::-1]):
            commits = []
            tracer = obs.enable_tracing() if arm == "loop+trace" else None
            try:
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.monotonic()
                if arm == "bare":
                    for x, y in list(res_batches())[:RES_TIMED]:
                        tr.step(x, y)
                else:
                    res_loop(tr, f"{root}/t{rnd}{arm}", commits,
                             save_every=RES_TIMED + 1,
                             write=False).run(res_batches, RES_TIMED)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            finally:
                obs.disable_tracing()
            expect_launches(read_launches_by_dtype(),
                            dict.fromkeys(RES_FLASH, RES_LAYERS * RES_TIMED),
                            f"17a {arm}", dtype="bfloat16")
            spent = wall - sum(r["total_s"] for r in commits)
            ms = spent / RES_TIMED * 1e3
            arms[arm].append(ms)
            extra = "" if tracer is None else \
                f", {len(tracer.spans())} spans"
            print(f"  17a round {rnd + 1} {arm}: {ms:.2f} ms/step over "
                  f"{RES_TIMED} steps{extra}"
                  + (f"; commit {commit_line(commits)}" if commits else "")
                  + f" [{card}]", flush=True)
    print(f"  17a ms/step in turns: {arms} [{card}]", flush=True)
    return arms


def res_observability(torch, card, tr, root):
    """17f: the registry's Prometheus text, a flight-recorder bundle, and
    a torch.profiler trace of one replayed step with the spans as
    ranges: the ``trainer.step`` range and RES_LAYERS of each of B1-B3's
    records."""
    from mxnet_tpu_torch import observability as obs
    text = obs.to_prometheus(obs.default_registry().collect())
    parsed = obs.parse_prometheus(text)
    steps = parsed.get(("mxtpu_trainer_steps_total", ()), 0)
    commits = parsed.get(("mxtpu_checkpoint_commits_total", ()), 0)
    res_gate(f"17f Prometheus text ({len(text)} bytes, {len(parsed)} "
             f"series): mxtpu_trainer_steps_total {steps}, "
             f"mxtpu_checkpoint_commits_total {commits}",
             steps >= RES_STEPS and commits >= RES_STEPS // RES_SAVE)
    fr = obs.enable_flight_recorder(bundle_dir=f"{root}/flight")
    try:
        bundle = json.load(open(fr.dump("phase17.dump")))
    finally:
        obs.disable_flight_recorder()
    v = bundle["versions"]
    res_gate(f"17f flight bundle versions {v}",
             v["devices"] == [torch.cuda.get_device_name(0)]
             and v["device_count"] == torch.cuda.device_count()
             and v["torch"] == torch.__version__
             and v["cuda"] == torch.version.cuda)
    x, y = next(res_batches())
    obs.enable_tracing(profiler_markers=True)
    try:
        prof, wall_ms = profiled(torch, lambda: tr.step(x, y))
    finally:
        obs.disable_tracing()
    # the range is a host event, and its annotation on the card's
    # timeline around the replay's kernels a device one
    ranges = {str(e.device_type).split(".")[-1]: e.count
              for e in prof.key_averages() if e.key == "span:trainer.step"}
    seen = _device_counts(torch, prof, RES_FLASH)
    res_gate(f"17f profiled replay ({wall_ms:.1f} ms): span:trainer.step "
             f"ranges {ranges}, B1-B3 records {seen}",
             ranges.get("CPU") == 1
             and seen == dict.fromkeys(RES_FLASH, RES_LAYERS))


def res_chaos(torch, mx, card, root, want, want_loss):
    """17b: kills at three distinct ``trainer.step`` hits and one at the
    commit, and a retried fault; a fresh trainer and loop resume after
    each kill, and the run ends bit-identical to 17a.  For RES_STEPS = 8,
    RES_SAVE = 4 (hits count over every run): the first run commits step
    4 and dies at step 6 (hit 6); the next two resume from 4 and die at
    step 6 again (hits 8, 10); the fourth runs steps 5-8 and dies in the
    step-8 commit (the commit's hit 2); the fifth retries step 6 once
    (hit 16) and commits step 8."""
    from mxnet_tpu_torch.resilience import FaultPlan, SimulatedPreemption
    plan = (FaultPlan(seed=0)
            .kill_at("trainer.step", at=RES_SAVE + 2)
            .kill_at("trainer.step", at=RES_SAVE + 4)
            .kill_at("trainer.step", at=RES_SAVE + 6)
            .kill_at("checkpoint.commit", at=2)
            .raise_at("trainer.step", at=3 * RES_SAVE + 4, retryable=True))
    kills, report, loop, commits = 0, None, None, []
    with plan:
        for _ in range(8):
            loop = None
            free(torch)
            loop = res_loop(res_trainer(mx), f"{root}/b", commits)
            try:
                report = loop.run(res_batches, RES_STEPS)
                break
            except SimulatedPreemption:
                kills += 1
                print(f"  17b killed ({plan.log[-1]}), latest commit "
                      f"{loop.checkpointer.latest_step()}, reserved "
                      f"{reserved_mib(torch):.0f} MiB", flush=True)
    got = res_state(loop.trainer)
    differ = res_differ(torch, got, want)
    print(f"  17b report {report}, counters resumes "
          f"{loop.metrics.counters['resumes']} retries "
          f"{loop.metrics.counters['retries']}", flush=True)
    res_gate(f"17b {kills} kills, {plan.fired()} faults fired, "
             f"{len(want)} tensors vs 17a, bit-identical",
             kills == 4 and plan.fired() == 5 and not differ
             and report["final_loss"] == want_loss
             and report["retries"] == 1
             and loop.metrics.counters["resumes"] >= 1,
             f" (differ: {differ[:6]}, loss {report['final_loss']!r} vs "
             f"{want_loss!r})")
    return commits


class ResRecorder:
    """Each step's finite flag (wrapping ``tr.step``) and, at chosen
    ``trainer.step`` hits, the state before that step (a ``call_at``
    fires before the step moves anything)."""

    def __init__(self, tr):
        self.tr, self.flags, self.states, self.scales = tr, [], {}, {}
        step = tr.step

        def rec(data, labels):
            out = step(data, labels)
            self.flags.append(bool(out[1]))
            return out
        tr.step = rec

    def at(self, hit):
        def snap():
            self.states[hit] = res_state(self.tr)
            self.scales[hit] = self.tr.loss_scale
        return snap


def res_poison(torch, mx, card, root):
    """17c: a loss poison at step 3 and a gradient poison (Inf) at step 6
    of the replayed graph: each step non-finite, every tensor but the
    count and the guard state bit-identical across it, the scale halved;
    then two poisoned steps in a row under ``on_bad_step='rewind'``
    restore the step-4 commit."""
    from mxnet_tpu_torch.resilience import AtomicCheckpointer, FaultPlan
    n = 2 * RES_SAVE
    tr = res_trainer(mx)
    rec = ResRecorder(tr)
    plan = (FaultPlan()
            .nonfinite_at("trainer.loss_nonfinite", at=3)
            .nonfinite_at("trainer.grad_nonfinite", at=6,
                          value=float("inf")))
    for hit in (3, 4, 6, 7, 8):
        plan.call_at("trainer.step", at=hit, fn=rec.at(hit))
    with plan:                   # one commit, at the end
        report = res_loop(tr, f"{root}/c", save_every=n).run(res_batches,
                                                              n)
    guard = {"meta:num_update", "meta:loss_scale", "meta:good_steps"}
    for hit in (3, 6):
        before, after = rec.states[hit], rec.states[hit + 1]
        moved = set(res_differ(torch, after, before))
        res_gate(f"17c poisoned step {hit}: flag {rec.flags[hit - 1]}, "
                 f"{len(before) - len(moved)} of {len(before)} tensors "
                 f"bit-identical, scale {rec.scales[hit]} -> "
                 f"{rec.scales[hit + 1]}",
                 rec.flags[hit - 1] is False and moved == guard
                 and rec.scales[hit + 1] == rec.scales[hit] / 2)
    moved = res_differ(torch, rec.states[8], rec.states[7])
    res_gate(f"17c flags {rec.flags}, bad_steps {report['bad_steps']}, "
             f"the step after updates ({len(moved)} tensors moved)",
             rec.flags == [True, True, False, True, True, False, True, True]
             and report["bad_steps"] == 2 and "param:0" in moved)
    del rec, tr
    free(torch)
    tr = res_trainer(mx)
    rec = ResRecorder(tr)
    plan = (FaultPlan()
            .nonfinite_at("trainer.loss_nonfinite", at=6)
            .nonfinite_at("trainer.loss_nonfinite", at=7)
            .call_at("trainer.step", at=8, fn=rec.at(8)))
    with plan:
        report = res_loop(tr, f"{root}/c-rewind", on_bad_step="rewind",
                          rewind_after=2).run(res_batches, n)
    committed, meta = AtomicCheckpointer(f"{root}/c-rewind").restore(
        RES_SAVE)
    differ = sorted(k for k, v in committed.items()
                    if not k.startswith("meta:")
                    and not torch.equal(rec.states[8][k].cpu(), v))
    res_gate(f"17c rewind: rewinds {report['rewinds']}, bad_steps "
             f"{report['bad_steps']}, step 8 starts from the step-"
             f"{meta['step']} commit ({len(committed)} tensors)",
             report["rewinds"] == 1 and report["bad_steps"] == 2
             and meta["step"] == RES_SAVE and not differ,
             f" (differ: {differ[:6]})")


def res_rot(torch, mx, card, root, want, want_loss):
    """17d: a commit every ``every = RES_SAVE - 1`` steps (3 and 6 of 8),
    bit rot in the second, then a kill at step 7: the resume quarantines
    step 6, falls back to step 3, and the run ends bit-identical to
    17a."""
    from mxnet_tpu_torch.resilience import FaultPlan, SimulatedPreemption
    every = RES_SAVE - 1
    plan = (FaultPlan().corrupt_at("checkpoint.corrupt", at=2)
            .kill_at("trainer.step", at=2 * every + 1))
    with plan:
        loop = res_loop(res_trainer(mx), f"{root}/d", save_every=every)
        try:
            loop.run(res_batches, RES_STEPS)
            killed = False
        except SimulatedPreemption:
            killed = True
        loop = None
        free(torch)
        loop = res_loop(res_trainer(mx), f"{root}/d", save_every=every)
        report = loop.run(res_batches, RES_STEPS)
    c = loop.metrics.counters
    differ = res_differ(torch, res_state(loop.trainer), want)
    res_gate(f"17d rot at the step-{2 * every} commit: resumed from "
             f"{report['resumed_from']}, quarantines "
             f"{c['checkpoint_quarantines']}, fallbacks "
             f"{c['checkpoint_fallbacks']} ({loop.checkpointer.quarantined()}"
             f"), bit-identical to 17a",
             killed and report["resumed_from"] == every
             and c["checkpoint_quarantines"] == 1
             and c["checkpoint_fallbacks"] == 1 and not differ
             and report["final_loss"] == want_loss,
             f" (differ: {differ[:6]})")


def res_sigterm(torch, mx, card, root, want, want_loss):
    """17e: SIGTERM to the process at step 6: the loop finishes the step,
    commits and returns preempted; a fresh loop completes bit-identical
    to 17a (commits every 8 steps, so the resume is from the SIGTERM's
    commit alone)."""
    import os
    import signal
    from mxnet_tpu_torch.resilience import FaultPlan
    at = RES_SAVE + 2
    with FaultPlan().call_at("trainer.step", at=at,
                             fn=lambda: os.kill(os.getpid(),
                                                signal.SIGTERM)):
        loop = res_loop(res_trainer(mx), f"{root}/e",
                        save_every=2 * RES_SAVE)
        first = loop.run(res_batches, RES_STEPS)
        latest = loop.checkpointer.latest_step()
    loop = None
    free(torch)
    loop = res_loop(res_trainer(mx), f"{root}/e", save_every=2 * RES_SAVE)
    report = loop.run(res_batches, RES_STEPS)
    differ = res_differ(torch, res_state(loop.trainer), want)
    res_gate(f"17e SIGTERM at step {at}: preempted {first['preempted']} "
             f"after {first['completed_steps']} steps, latest commit "
             f"{latest}; resumed from {report['resumed_from']}, "
             f"bit-identical to 17a",
             first["preempted"] is True and first["completed_steps"] == at
             and latest == at and report["resumed_from"] == at
             and not differ and report["final_loss"] == want_loss,
             f" (differ: {differ[:6]})")


def resilient_path(torch, card):
    """Phase 17: resilient training at full width.  Returns the fault-free
    run's launches."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="mxtpu-phase17-")
    print(f"17 GPT-2 124M's widths at {RES_LAYERS} layers, amp, guarded, "
          f"dropout {RES_DROPOUT}, under "
          f"ResilientLoop: {RES_STEPS} steps of {TRAIN_B} x {TRAIN_T}, a "
          f"commit every {RES_SAVE}, seed {RES_SEED}:", flush=True)
    mx.amp.init("bfloat16")
    try:
        tr, want, want_loss, launches, commits, arms = res_reference(
            torch, mx, card, root)
        res_observability(torch, card, tr, root)
        del tr
        free(torch)
        parts = {}
        for name, fn in (
                ("b", lambda: res_chaos(torch, mx, card, root, want,
                                        want_loss)),
                ("c", lambda: res_poison(torch, mx, card, root)),
                ("d", lambda: res_rot(torch, mx, card, root, want,
                                      want_loss)),
                ("e", lambda: res_sigterm(torch, mx, card, root, want,
                                          want_loss))):
            t0 = time.monotonic()
            fn()
            parts[name] = round(time.monotonic() - t0, 1)
            free(torch)
    finally:
        mx.amp.reset()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"resilient_training": {
        "commits": commits, "ms_per_step": arms, "seconds": parts}}),
        flush=True)
    print(f"phase 17: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches


# ------------------------------------------------ the hardened engine

# phase 18: phase 3's engine (its prompts, 32 new tokens, paged, the
# kernel arm, graphs captured by warmup()) with its lattice cut to the
# one point phase 3's prompts use, B8 x T512, so that its many engines
# warm up in seconds
HARD_LATTICE = dict(batch_buckets=(8,), seq_buckets=(512,))
HARD_NEW = 32
# (a) the position-embedding row poisoned: only the 495-token prompt's
# decode reaches it (its steps consume positions 495-525; the next
# longest, 492 tokens, ends at 522), and no prefill pads to it
HARD_NAN_POS = 524
# the next tenant's prompt length (phase 3's shortest)
HARD_TENANT = 309
# (b) the kill's watchdog: dead-thread detection polls every interval
HARD_HANG, HARD_INTERVAL = 1.0, 0.1
# (e) the cost of the guard: arms in turns, this many rounds, each
# serving the prompts with this many new tokens
HARD_ROUNDS, HARD_COST_NEW = 3, 64


def hard_engine(torch, net, **kw):
    """Phase 3's engine, the lattice cut to ``HARD_LATTICE``, warmed up:
    (engine, programs compiled)."""
    eng = serving_engine(torch, net, True, **HARD_LATTICE, **kw)
    return eng, eng.warmup()


def outcome(fut):
    """A served sequence, or the class name of the request's error."""
    try:
        return fut.result(600)
    except Exception as e:
        return type(e).__name__


def same_stream(a, b):
    return not isinstance(a, str) and not isinstance(b, str) and \
        np.array_equal(a, b)


def pool_finite(torch, eng):
    """Every real page of every leaf finite (int8 pages through their
    scales), the zero page all zeros."""
    n = eng.num_pages
    for layer in eng._caches:
        for a in layer.values():
            if not bool(torch.isfinite(a[:n].float()).all()) or \
                    bool(a[n].any()):
                return False
    return True


def wait_for(cond, what, limit=60.0):
    """Poll ``cond()`` while the scheduler thread runs."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > limit:
            raise AssertionError(f"phase 18: waited {limit} s for {what}")
        time.sleep(0.001)


def drive_until(eng, done, limit=2000):
    """The engine's cycles on this thread (no scheduler thread) until
    ``done()``."""
    for _ in range(limit):
        if done():
            return
        with eng._step_lock:
            eng._cycle()
    raise AssertionError("phase 18: the engine's cycles did not get there")


def nan_guard_part(torch, net, prompts, tenant, card, kv_quant):
    """(a) on one page type: a clean engine's streams, then a poisoned
    one's (row ``HARD_NAN_POS`` of the position embedding NaN before its
    warmup()): one typed failure, the other 7 streams unchanged, the
    next tenant (admitted into the victim's slot and scrubbed pages, the
    cycles driven by hand so that it is) equal to the clean engine's,
    ``nonfinite_outputs`` 1, the pool finite.  int8 also: a
    ``serving.kv_scale`` poison fails its reader typed, one dequant
    fault, the others unchanged.  Returns the clean streams."""
    from mxnet_tpu_torch.resilience import FaultPlan
    tag = f"kv_quant={kv_quant}"
    eng, _n = hard_engine(torch, net, kv_quant=kv_quant)
    with eng:
        clean = [f.result(600) for f in
                 [eng.submit(p, max_new_tokens=HARD_NEW) for p in prompts]]
        clean_tenant = eng.infer(tenant, max_new_tokens=HARD_NEW)
    del eng
    wpe = dict(net.named_parameters())["wpe.weight"]
    keep = wpe[HARD_NAN_POS].clone()
    with torch.no_grad():
        wpe[HARD_NAN_POS] = float("nan")
    try:
        eng, _n = hard_engine(torch, net, kv_quant=kv_quant)
        freed = []
        scrub = eng._scrub_pages

        def record(pages, count=True):
            if count:
                freed.extend(pages)
            scrub(pages, count)
        eng._scrub_pages = record
        futs = [eng.submit(p, max_new_tokens=HARD_NEW) for p in prompts]
        victim = int(np.argmax([len(p) for p in prompts]))
        drive_until(eng, futs[victim].done)
        fut_t = eng.submit(tenant, max_new_tokens=HARD_NEW)

        def tenant_pages():
            return [pid for _s, st in eng._alloc.items()
                    if st.request.future is fut_t for pid in st.pages]
        drive_until(eng, lambda: tenant_pages() or fut_t.done())
        tenant_pages = tenant_pages()
        drive_until(eng, lambda: all(f.done() for f in futs + [fut_t]))
        outs = [outcome(f) for f in futs]
        got_t = outcome(fut_t)
        c = eng.metrics.counters
        finite = pool_finite(torch, eng)
        eng.stop()
    finally:
        with torch.no_grad():
            wpe[HARD_NAN_POS] = keep
    others = [i for i in range(len(prompts)) if i != victim]
    print(f"18a NaN guard ({tag}): wpe row {HARD_NAN_POS} NaN; victim "
          f"(prompt {len(prompts[victim])}) -> {outs[victim]}; "
          f"nonfinite_outputs {c['nonfinite_outputs']}, pages_scrubbed "
          f"{c['pages_scrubbed']}, tenant pages {tenant_pages} of the "
          f"scrubbed {sorted(freed)} [{card}]", flush=True)
    res_gate(f"({tag}) the victim fails typed",
              outs[victim] == "NonFiniteOutputError")
    res_gate(f"({tag}) the other 7 streams equal the clean engine's",
              all(same_stream(outs[i], clean[i]) for i in others))
    res_gate(f"({tag}) the next tenant, on the victim's scrubbed pages, "
              "equals the clean engine's stream",
              same_stream(got_t, clean_tenant)
              and bool(set(tenant_pages) & set(freed)))
    res_gate(f"({tag}) nonfinite_outputs 1 and the pool finite",
              c["nonfinite_outputs"] == 1 and finite)
    if kv_quant:
        eng, _n = hard_engine(torch, net, kv_quant=kv_quant)
        futs = [eng.submit(p, max_new_tokens=HARD_NEW) for p in prompts]
        with FaultPlan().nonfinite_at("serving.kv_scale", at=1) as plan:
            with eng:
                outs = [outcome(f) for f in futs]
        c = eng.metrics.counters
        failed = [i for i, o in enumerate(outs) if isinstance(o, str)]
        print(f"18a serving.kv_scale poison ({tag}): fired "
              f"{plan.fired('serving.kv_scale')}, failed {failed} "
              f"{[outs[i] for i in failed]}, kv_dequant_faults "
              f"{c['kv_dequant_faults']} [{card}]", flush=True)
        res_gate(f"({tag}) the scale poison fails one reader typed, one "
                  "dequant fault, the rest unchanged",
                  len(failed) == 1
                  and outs[failed[0]] == "NonFiniteOutputError"
                  and c["kv_dequant_faults"] == 1
                  and all(same_stream(outs[i], clean[i])
                          for i in range(len(prompts)) if i not in failed)
                  and pool_finite(torch, eng))
        eng.stop()
    return clean, clean_tenant


def faults_part(torch, net, prompts, clean, card):
    """(b) a retryable raise at the third ``serving.decode_step``: the
    fault-free streams bit for bit, one retry, ``compiles`` at
    warmup()'s; a kill at ``serving.scheduler``: the watchdog trips
    within ``hang_timeout`` plus two intervals of the kill, every rider
    fails with ``EngineCrashedError``, and a fresh engine serves."""
    from mxnet_tpu_torch.resilience import FaultPlan
    eng, n_warm = hard_engine(torch, net, retry_backoff=0.001)
    futs = [eng.submit(p, max_new_tokens=HARD_NEW) for p in prompts]
    t0 = time.monotonic()
    with FaultPlan().raise_at("serving.decode_step", at=3,
                              retryable=True) as plan:
        with eng:
            outs = [outcome(f) for f in futs]
    wall = time.monotonic() - t0
    c = eng.metrics.counters
    print(f"18b retryable fault at decode step 3: fired {plan.fired()}, "
          f"retries {c['retries']}, compiles {c['compiles']} (warmup "
          f"{n_warm}), {c['tokens_generated']} tokens in {wall:.3f} s "
          f"[{card}]", flush=True)
    res_gate("the retried run is bit-identical to the fault-free one, "
              "one retry, nothing compiled",
              all(same_stream(o, r) for o, r in zip(outs, clean))
              and c["retries"] == 1 and c["compiles"] == n_warm)
    del eng
    eng, _n = hard_engine(torch, net, hang_timeout=HARD_HANG,
                          watchdog_interval=HARD_INTERVAL)
    futs = [eng.submit(p, max_new_tokens=HARD_NEW) for p in prompts]
    killed = []
    plan = (FaultPlan()
            .call_at("serving.scheduler", lambda: killed.append(
                time.monotonic()), at=5)
            .kill_at("serving.scheduler", at=5))
    with plan:
        eng.start()
        outs = [outcome(f) for f in futs]
        h = eng.health()
        eng.stop(timeout=30)
    trip = min(f.t_done for f in futs) - killed[0]
    limit = HARD_HANG + 2 * HARD_INTERVAL
    print(f"18b kill at serving.scheduler: watchdog tripped {trip:.3f} s "
          f"after the kill (limit {limit:.1f}), riders {sorted(set(outs))}, "
          f"health live={h['live']} crashed={bool(h['crashed'])}, "
          f"watchdog_trips {eng.metrics.counters['watchdog_trips']} "
          f"[{card}]", flush=True)
    res_gate("the watchdog trips in time and every rider fails typed",
              trip <= limit and outs == ["EngineCrashedError"] * len(futs)
              and not h["live"] and h["crashed"])
    del eng
    eng, _n = hard_engine(torch, net)
    futs = [eng.submit(p, max_new_tokens=HARD_NEW) for p in prompts]
    t0 = time.monotonic()
    with eng:
        outs = [f.result(600) for f in futs]
    print(f"18b a fresh engine, fault-free: {HARD_NEW * len(prompts)} "
          f"tokens in {time.monotonic() - t0:.3f} s (the retried run "
          f"{wall:.3f} s) [{card}]", flush=True)
    res_gate("a fresh engine then serves the clean streams",
              all(np.array_equal(o, r) for o, r in zip(outs, clean)))


def overload_part(torch, net, prompts, tenant, clean, clean_tenant, card):
    """(c) 24 arrivals in one burst, 8 of each class in turn, at
    ``queue_depth`` 8: no interactive request shed; an interactive
    arrival with every slot busy preempts a best_effort decode, whose
    resumed stream equals its solo stream; a cancel mid-decode returns
    its pages to the pool."""
    classes = ("interactive", "batch", "best_effort")
    eng, _n = hard_engine(torch, net, queue_depth=8)
    burst = []
    for i in range(24):
        cls = classes[i % 3]
        try:
            burst.append((cls, eng.submit(prompts[i % 8],
                                          max_new_tokens=HARD_NEW,
                                          priority=cls)))
        except Exception as e:
            burst.append((cls, type(e).__name__))
    with eng:
        res = [(cls, f if isinstance(f, str) else outcome(f))
               for cls, f in burst]
        sheds = eng.stats()["overload"]["sheds"]
        served = eng.stats()["overload"]["served"]
    del eng
    # a fresh engine (no prefix cached): every stream but the resumed
    # one's prefills whole, as (a)'s clean engine did
    eng, _n = hard_engine(torch, net)
    with eng:
        base = eng.metrics.counters["decode_steps"]
        be = [eng.submit(p, max_new_tokens=HARD_NEW, priority="best_effort")
              for p in prompts]
        wait_for(lambda: eng.metrics.counters["decode_steps"] >= base + 3,
                 "the best_effort wave decodes")
        ia = eng.submit(tenant, max_new_tokens=HARD_NEW,
                        priority="interactive")
        be_outs = [outcome(f) for f in be]
        ia_out = outcome(ia)
        c = dict(eng.metrics.counters)
        victim = eng.submit(prompts[0], max_new_tokens=HARD_NEW)
        wait_for(lambda: eng.metrics.counters["decode_steps"]
                 >= c["decode_steps"] + 3, "the request decodes")
        cancelled = eng.cancel(victim)
        got = outcome(victim)
        wait_for(lambda: not eng._alloc.active_count, "the slot frees")
        pages_back = eng._pool.free_count + eng._prefix.evictable_pages()
    shed_ia = [r for cls, r in res if cls == "interactive"
               and isinstance(r, str)]
    print(f"18c burst of 24 (8 a class) at queue_depth 8: sheds "
          f"{json.dumps(sheds)}, served {json.dumps(served)} [{card}]",
          flush=True)
    res_gate("no interactive request shed", not shed_ia)
    print(f"18c preemption: {c['preemptions']} preemptions, "
          f"{c['preempt_resumes']} resumes, {c['prefix_hits']} prefix hits "
          f"[{card}]", flush=True)
    res_gate("an interactive arrival preempts a best_effort decode that "
              "resumes token-identically",
              c["preemptions"] >= 1 and c["preempt_resumes"] >= 1
              and all(same_stream(o, r) for o, r in zip(be_outs, clean))
              and same_stream(ia_out, clean_tenant))
    print(f"18c cancel mid-decode: cancel() {cancelled}, the request "
          f"{got}, pages back {pages_back} of {eng.num_pages} [{card}]",
          flush=True)
    res_gate("a cancel mid-decode returns its pages",
              cancelled and got == "RequestCancelledError"
              and pages_back == eng.num_pages)


def parity_part(torch, net, prompts, int8_logits, card):
    """(d) ``debug_parity``: the kernel arm against its float32 gather
    twin over phase 3's requests: the int8 arm's histogram printed
    beside phase 3's int8 logits reading; the float32 arm's max held to
    ``TOL_LOGITS``."""
    worst = {}
    for quant in ("int8", None):
        eng, n_warm = hard_engine(torch, net, kv_quant=quant,
                                  debug_parity=True)
        with eng:
            for f in [eng.submit(p, max_new_tokens=HARD_NEW)
                      for p in prompts]:
                f.result(600)
        s = eng.stats()
        err = s["quantized_kv"]["error"]
        p50 = eng.metrics.kv_quant_error.percentile(50)
        worst[quant] = err["max"]
        print(f"18d debug_parity kv_quant={quant}: {err['count']} steps, "
              f"max-abs logit delta p50 {p50:.3e} max {err['max']:.3e}; "
              f"compiles {s['compile']['compiles']} (warmup {n_warm}) "
              f"[{card}]", flush=True)
        res_gate(f"(kv_quant={quant}) the twin ran every step and "
                  "compiled nothing after warmup()",
                  err["count"] > 0 and s["quantized_kv"]["debug_parity"]
                  and s["compile"]["compiles"] == n_warm)
        del eng
    print(f"18d int8: the twin's max {worst['int8']:.3e} beside phase 3's "
          f"int8 kernel-vs-gather logits {int8_logits:.3e} [{card}]",
          flush=True)
    check("debug_parity float32 kernel arm vs its gather twin", worst[None],
          TOL_LOGITS)


def cost_arm(torch, net, prompts, guard, card, rnd):
    """One arm of (e): tokens/s serving the prompts with
    ``HARD_COST_NEW`` new tokens, and the idle share of 8 decode cycles
    driven by hand under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    kw = dict(hang_timeout=HARD_HANG) if guard else \
        dict(guard_nonfinite=False)
    eng, _n = hard_engine(torch, net, **kw)
    futs = [eng.submit(p, max_new_tokens=HARD_COST_NEW) for p in prompts]
    drive_until(eng, lambda: eng.metrics.counters["decode_steps"]
                >= 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            with eng._step_lock:
                eng._cycle()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    name = "guard, metrics, watchdog" if guard else "guard off"
    idle = report_profile(torch, f"round {rnd} {name}: 8 decode cycles",
                          wall, prof, card)
    drive_until(eng, lambda: all(f.done() for f in futs))
    gen0 = eng.metrics.counters["tokens_generated"]
    t0 = time.monotonic()
    with eng:
        for f in [eng.submit(p, max_new_tokens=HARD_COST_NEW)
                  for p in prompts]:
            f.result(600)
    tps = (eng.metrics.counters["tokens_generated"] - gen0) / \
        (time.monotonic() - t0)
    print(f"  round {rnd} {name}: {tps:.1f} tokens/s [{card}]", flush=True)
    del eng
    return tps, idle


def observability_part(torch, net, prompts, card):
    """(f) the registry's Prometheus text carries the engine's
    ``mxtpu_serving_*`` series under the reference's names, and a flight
    bundle's live-engine section names the running engine."""
    import shutil
    import tempfile
    import mxnet_tpu_torch.observability as obs
    from mxnet_tpu_torch.serving.metrics import ServingMetrics
    root = tempfile.mkdtemp(prefix="mxtpu-phase18-")
    fr = obs.enable_flight_recorder(bundle_dir=root)
    try:
        eng, _n = hard_engine(torch, net, name="phase18")
        with eng:
            eng.infer(prompts[0], max_new_tokens=4)
            text = obs.to_prometheus(obs.default_registry().collect())
            with open(fr.dump("phase18.dump")) as f:
                engines = json.load(f)["engines"]
    finally:
        obs.disable_flight_recorder()
        shutil.rmtree(root, ignore_errors=True)
    series = {n for n, labels in obs.parse_prometheus(text)
              if dict(labels).get("engine") == eng.name}
    want = {f"mxtpu_serving_{c}_total" for c in ServingMetrics._COUNTERS}
    want |= {"mxtpu_serving_queue_depth", "mxtpu_serving_kv_pages_free",
             "mxtpu_serving_kv_bytes_per_token", "mxtpu_serving_compiles",
             "mxtpu_serving_brownout", "mxtpu_serving_overload_factor",
             "mxtpu_serving_latency_seconds_bucket",
             "mxtpu_serving_ttft_seconds_count",
             "mxtpu_serving_kv_quant_error_sum"}
    print(f"18f Prometheus: {len(series)} series names under "
          f"engine={eng.name}, {len(want - series)} of the reference's "
          f"{len(want)} missing; the flight bundle's engines: "
          f"{sorted(engines)} [{card}]", flush=True)
    res_gate("the reference's series and the live engine in the bundle",
              not (want - series) and eng.name in engines)


def hardened_path(torch, card, prompts, int8_logits):
    """Phase 18: the hardened engine at full width.  Returns its
    launches (every engine of the phase, warm-ups in)."""
    from mxnet_tpu_torch.models import get_gpt2
    t_phase = time.monotonic()
    print(f"18 the hardened engine: GPT-2 124M, phase 3's prompts, "
          f"{HARD_NEW} new tokens, lattice {HARD_LATTICE}:", flush=True)
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    rs = np.random.RandomState(SEED + 18)
    tenant = rs.randint(0, VOCAB, (HARD_TENANT,)).astype(np.int32)
    reset_launches()
    parts = {}
    t0 = time.monotonic()
    clean, clean_tenant = nan_guard_part(torch, net, prompts, tenant, card,
                                         None)
    nan_guard_part(torch, net, prompts, tenant, card, "int8")
    parts["a"] = round(time.monotonic() - t0, 1)
    for name, fn in (
            ("b", lambda: faults_part(torch, net, prompts, clean, card)),
            ("c", lambda: overload_part(torch, net, prompts, tenant, clean,
                                        clean_tenant, card)),
            ("d", lambda: parity_part(torch, net, prompts, int8_logits,
                                      card)),
            ("f", lambda: observability_part(torch, net, prompts, card))):
        t0 = time.monotonic()
        fn()
        parts[name] = round(time.monotonic() - t0, 1)
        free(torch)
    launches = read_launches()
    res_gate("B1 and B4 launched on the hardened path",
              launches["flash_fwd"] > 0 and launches["paged_attention"] > 0,
              f" {launches}")
    t0 = time.monotonic()
    print(f"18e cost of the guard, the metrics and the watchdog: "
          f"{HARD_ROUNDS} rounds in turns, {HARD_COST_NEW} new tokens",
          flush=True)
    cost = {True: [], False: []}
    for rnd in range(1, HARD_ROUNDS + 1):
        order = (True, False) if rnd % 2 else (False, True)
        for guard in order:
            cost[guard].append(cost_arm(torch, net, prompts, guard, card,
                                        rnd))
            free(torch)
    parts["e"] = round(time.monotonic() - t0, 1)
    summary = {("on" if g else "off"): {
        "tokens_per_s": [round(t, 1) for t, _i in runs],
        "idle": [None if i is None else round(i, 4) for _t, i in runs]}
        for g, runs in cost.items()}
    print(json.dumps({"hardened_engine": {"cost": summary,
                                          "seconds": parts}}), flush=True)
    print(f"phase 18: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches


def data_token_records(root):
    """(a)'s records: one ``MXIndexedRecordIO`` file of DATA_BATCHES x
    TRAIN_B records, each TRAIN_T + 1 seeded int32 tokens packed with an
    ``IRHeader``.  Returns the file's path."""
    from mxnet_tpu_torch import recordio
    path = f"{root}/tokens.rec"
    rec = recordio.MXIndexedRecordIO(f"{root}/tokens.idx", path, "w")
    rs = np.random.RandomState(SEED)
    n = (DATA_WARM + DATA_ROUNDS * DATA_STEPS) * TRAIN_B
    for i in range(n):
        toks = rs.randint(0, VOCAB, TRAIN_T + 1).astype(np.int32)
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, 0.0, i, 0),
                                       toks.tobytes()))
    rec.close()
    return path


def data_token_loader(mx, path):
    """Records → ``RecordFileDataset`` → ``transform`` (unpack to
    (inputs, labels)) → ``DataLoader(pin_memory=True)``."""
    def split(raw):
        toks = np.frombuffer(mx.recordio.unpack(raw)[1], np.int32)
        return toks[:-1], toks[1:]
    ds = mx.gluon.data.RecordFileDataset(path).transform(split)
    return mx.gluon.data.DataLoader(ds, batch_size=TRAIN_B, pin_memory=True)


def quantiles(waits):
    w = sorted(waits)
    return w[len(w) // 2] * 1e3, w[-1] * 1e3


def data_arm_steps(torch, tokens, feed, tr, what, card):
    """DATA_STEPS timed steps of ``tr`` fed by ``feed()`` (a batch and
    the wait it cost): (losses, ms/step, waits, launches a step)."""
    waits = []

    def step():
        (d, l), wait = feed()
        waits.append(wait)
        return tr.step(d, l)
    losses, ms, _mib, per = timed_steps(torch, step, DATA_STEPS, tokens,
                                        card, what)
    return losses, ms, waits, per


def first_step(tr, feed):
    """A signature's first step (its capture): the loss."""
    (d, l), _w = feed()
    return float(tr.step(d, l))


def data_gpt2(torch, mx, card, root):
    """19 (a): GPT-2 124M amp, graphed, fed from token records through
    the DataLoader and DevicePrefetcher, against the same batches
    resident on the card.  Returns the pipeline arm's launches."""
    from mxnet_tpu_torch.data import DevicePrefetcher
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    path = data_token_records(root)
    resident = [(d.tensor.cuda(), l.tensor.cuda())
                for d, l in data_token_loader(mx, path)]
    torch.cuda.synchronize()
    mx.amp.init("bfloat16")
    try:
        arms = {}
        for arm in ("pipeline", "resident"):
            net = get_gpt2("gpt2_124m", dropout=0.0).initialize(seed=SEED)
            tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                                optimizer_params={"learning_rate": TRAIN_LR})
            if arm == "pipeline":
                pf = tr.attach_data_source(DevicePrefetcher(
                    data_token_loader(mx, path), depth=DATA_DEPTH))

                def feed(pf=pf):
                    b = pf.next()
                    return b, pf.last_wait_seconds
            else:
                it = iter(resident)

                def feed(it=it):
                    return next(it), 0.0
            reset_launches()
            losses = [first_step(tr, feed)]
            arms[arm] = dict(tr=tr, feed=feed, losses=losses, ms=[],
                             waits=[], launches=read_launches())
        for rnd in range(1, DATA_ROUNDS + 1):
            for arm in (("pipeline", "resident") if rnd % 2 else
                        ("resident", "pipeline")):
                a = arms[arm]
                what = f"19a round {rnd} {arm} GPT-2 124M amp"
                losses, ms, waits, per = data_arm_steps(
                    torch, ("tokens", TRAIN_B * TRAIN_T), a["feed"],
                    a["tr"], what, card)
                expect_launches(read_launches_by_dtype(),
                                {k: 12 * DATA_STEPS for k in RES_FLASH},
                                what, dtype="bfloat16")
                a["losses"] += losses
                a["ms"].append(ms)
                a["waits"] += waits
                for k, v in per.items():
                    a["launches"][k] += int(v * DATA_STEPS)
    finally:
        mx.amp.reset()
    p, r = arms["pipeline"], arms["resident"]
    st = p["tr"].stats()["data"]
    p["tr"]._data_source.close()
    if p["losses"] != r["losses"]:
        raise AssertionError(f"19a losses through the pipeline "
                             f"{p['losses']} differ from the resident "
                             f"batches' {r['losses']}")
    finite_and_falling(p["losses"], "19a pipeline")
    p50, mx_ = quantiles(p["waits"])
    print(f"  19a {len(p['losses'])} losses bit-identical, pipeline vs "
          f"resident; ms/step by round pipeline {p['ms']}, resident "
          f"{r['ms']}; input_wait p50 {p50:.3f} ms, max {mx_:.3f} ms; "
          f"{st['bytes_shipped'] / st['batches_shipped']:.0f} bytes "
          f"shipped a step; B1/B2/B3 launches (pipeline arm) "
          f"{p['launches']} [{card}]", flush=True)
    # the first step's eager warm-up launches each kernel 12 times, then
    # every step's replay 12
    if any(p["launches"][k] != 12 * (len(p["losses"]) + 1)
           for k in RES_FLASH):
        raise AssertionError(f"19a: B1-B3 did not launch 12 times a step: "
                             f"{p['launches']}")
    summary = dict(ms_pipeline=p["ms"], ms_resident=r["ms"],
                   input_wait_ms_p50=p50, input_wait_ms_max=mx_,
                   bytes_a_step=st["bytes_shipped"] / st["batches_shipped"],
                   losses=p["losses"])
    launches = p["launches"]
    del arms, p, r, resident
    free(torch)
    return launches, summary


def data_images():
    """(b)'s source: seeded uint8 DATA_IMG² RGB images (NHWC) and labels
    in [0, 100), enough for every batch an arm takes."""
    n = (DATA_WARM + DATA_ROUNDS * DATA_STEPS + DATA_PROFILE
         + DATA_DEPTH) * VISION_B
    rs = np.random.RandomState(SEED)
    x = rs.randint(0, 256, (n, DATA_IMG, DATA_IMG, 3), dtype=np.uint8)
    return x, rs.randint(0, 100, (n,)).astype(np.int32)


def data_transform():
    from mxnet_tpu_torch.data import DeviceTransform
    return DeviceTransform(mean=DATA_MEAN, std=DATA_STD, crop=VISION_SIZE,
                           mirror=True, layout="NHWC", seed=SEED)


def copy_overlap(torch, fn, root):
    """One profiled call of ``fn`` (after one untraced, as
    :func:`profiled`): the host-to-device copies the trace holds, their
    µs, and the µs of them that ran while a kernel of another stream
    did.  From the chrome trace (``ts``/``dur`` in µs, ``stream`` in
    ``args``)."""
    prof, wall_ms = profiled(torch, fn)
    trace = f"{root}/copy_trace.json"
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    copies, kernels = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                e.get("args", {}).get("stream"))
        if cat == "gpu_memcpy" and "HtoD" in name:
            copies.append(span)
        elif cat == "kernel":
            kernels.append(span)
    copy_us = sum(b - a for a, b, _s in copies)
    overlap = 0.0
    for a, b, s in copies:
        cuts = sorted((max(a, ka), min(b, kb)) for ka, kb, ks in kernels
                      if ks != s and ka < b and kb > a)
        end = a
        for lo, hi in cuts:
            lo = max(lo, end)
            if hi > lo:
                overlap += hi - lo
                end = hi
    return dict(copies=len(copies), copy_us=copy_us, overlap_us=overlap,
                wall_ms=wall_ms)


def data_vision_arm(torch, mx, arm, x, y):
    """One (b) arm: a fresh ResNet-50 ``ShardedTrainer`` and its feed:
    the pipeline (DataLoader → DevicePrefetcher → DeviceTransform on
    the feeder's stream) or the same uint8 batches resident on the card
    through the same transform on the step's stream."""
    from mxnet_tpu_torch.data import DevicePrefetcher
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net = resnet50()
    net.initialize(seed=SEED)
    tr = ShardedTrainer(net, "sgd", loss=vision_ce,
                        optimizer_params=VISION_OPT)
    tf = data_transform()
    # the transform's one lattice point, met once and frozen: a batch of
    # another shape on the loop raises
    tf.apply(torch.from_numpy(x[:VISION_B]).cuda(), 0)
    tf.freeze()
    if arm == "pipeline":
        ds = mx.gluon.data.ArrayDataset(x, y)
        dl = mx.gluon.data.DataLoader(ds, batch_size=VISION_B,
                                      pin_memory=True, num_workers=2)
        pf = tr.attach_data_source(DevicePrefetcher(dl, depth=DATA_DEPTH,
                                                    transform=tf))

        def feed():
            d, l = pf.next()
            return (d, (l,)), pf.last_wait_seconds
    else:
        batches = [(torch.from_numpy(x[i:i + VISION_B]).cuda(),
                    torch.from_numpy(y[i:i + VISION_B]).cuda())
                   for i in range(0, len(x), VISION_B)]
        step_no = iter(range(len(batches)))

        def feed():
            i = next(step_no)
            d, l = batches[i]
            return (tf.apply(d, i), (l,)), 0.0
    return dict(tr=tr, feed=feed, tf=tf, losses=[], ms=[], waits=[])


def data_vision(torch, mx, card, root):
    """19 (b): ResNet-50 v1 NHWC at 128 x 224², graphed, fed uint8
    images through the pipeline, against the same batches resident on
    the card through the same transform; float32 and amp."""
    x, y = data_images()
    per_img = DATA_IMG * DATA_IMG * 3
    print(f"  19b source: {len(x)} seeded uint8 {DATA_IMG}x{DATA_IMG}x3 "
          f"images in memory ({per_img} bytes an image; no libjpeg on the "
          f"card host: gluon.data.ArrayDataset, not JPEG records)",
          flush=True)
    ds = mx.gluon.data.ArrayDataset(x, y)
    dl = mx.gluon.data.DataLoader(ds, batch_size=VISION_B, pin_memory=True,
                                  num_workers=2)
    t0 = time.perf_counter()
    n = 0
    for i, (d, _l) in enumerate(dl):
        n += d.shape[0]
        if i == 4:
            break
    host_rate = n / (time.perf_counter() - t0)
    print(f"  19b the source alone (DataLoader, 2 workers, pinned): "
          f"{host_rate:.1f} images/s on the host [{card}]", flush=True)
    # the transformed batches, pipeline against resident: bit for bit
    arms = {a: data_vision_arm(torch, mx, a, x, y)
            for a in ("pipeline", "resident")}
    got = [arms["pipeline"]["feed"]()[0][0].tensor for _ in range(3)]
    want = [arms["resident"]["feed"]()[0][0] for _ in range(3)]
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"  19b transformed batches 0-2, pipeline vs resident: "
          f"{'bit-identical' if same else 'DIFFER'}; "
          f"{tuple(got[0].shape)} {got[0].dtype}, channels-last "
          f"{got[0].is_contiguous()} [{card}]", flush=True)
    if not same:
        raise AssertionError("19b: the pipeline's transformed batches "
                             "differ from the resident ones")
    arms["pipeline"]["tr"]._data_source.close()
    del arms, got, want
    free(torch)
    # the losses, as phase 16 holds them: deterministic cuDNN algorithms
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gate = {}
        for a in ("pipeline", "resident"):
            arm = data_vision_arm(torch, mx, a, x, y)
            gate[a] = [first_step(arm["tr"], arm["feed"])] + [
                float(arm["tr"].step(*arm["feed"]()[0]))
                for _ in range(DATA_GATE_STEPS - 1)]
            if a == "pipeline":
                arm["tr"]._data_source.close()
            del arm
            free(torch)
    finally:
        torch.backends.cudnn.deterministic = det
    check(f"19b gate: {DATA_GATE_STEPS} losses, pipeline vs resident, "
          f"deterministic cuDNN (worst, relative) [{card}]",
          max(abs(a - b) / abs(b) for a, b in zip(gate["pipeline"],
                                                  gate["resident"])),
          TOL_GRAPHED)
    out, launches = {}, {}
    for amp in (False, True):
        dtype = "bfloat16" if amp else "float32"
        if amp:
            mx.amp.init("bfloat16")
        try:
            arms = {a: data_vision_arm(torch, mx, a, x, y)
                    for a in ("pipeline", "resident")}
            launches[dtype] = {}
            for a in arms.values():
                a["losses"].append(first_step(a["tr"], a["feed"]))
            free(torch)
            for rnd in range(1, DATA_ROUNDS + 1):
                for name in (("pipeline", "resident") if rnd % 2 else
                             ("resident", "pipeline")):
                    a = arms[name]
                    what = f"19b round {rnd} {name} ResNet-50 {dtype}"
                    losses, ms, waits, per = data_arm_steps(
                        torch, ("images", VISION_B), a["feed"], a["tr"],
                        what, card)
                    if any(per.values()):
                        raise AssertionError(f"{what} launched a kernel of "
                                             f"the port: {per}")
                    if name == "pipeline":
                        for k, v in per.items():
                            launches[dtype][k] = launches[dtype].get(
                                k, 0) + int(v * DATA_STEPS)
                    a["losses"] += losses
                    a["ms"].append(ms)
                    a["waits"] += waits
            p = arms["pipeline"]

            def one(p=p):
                (d, l), _w = p["feed"]()
                return p["tr"].step(d, l)
            ov = copy_overlap(torch, one, root)
            st = p["tr"].stats()["data"]
            p["tr"]._data_source.close()
        finally:
            mx.amp.reset()
        r = arms["resident"]
        p50, mx_ = quantiles(p["waits"])
        rates = {k: [VISION_B * 1e3 / ms for ms in arms[k]["ms"]]
                 for k in arms}
        print(f"  19b {dtype}: images/s by round pipeline "
              f"{[round(v, 1) for v in rates['pipeline']]}, resident "
              f"{[round(v, 1) for v in rates['resident']]}; input_wait "
              f"p50 {p50:.3f} ms, max {mx_:.3f} ms; "
              f"{st['bytes_shipped'] / st['batches_shipped']:.0f} bytes "
              f"shipped a step; profiled step: {ov['copies']} host-to-"
              f"device copies, {ov['copy_us']:.1f} µs, of which "
              f"{ov['overlap_us']:.1f} µs overlap the step's kernels "
              f"(wall {ov['wall_ms']:.1f} ms) [{card}]", flush=True)
        finite = all(np.isfinite(p["losses"] + r["losses"]))
        if not finite:
            raise AssertionError(f"19b {dtype} losses not finite: "
                                 f"{p['losses']}, {r['losses']}")
        out[dtype] = dict(rate_pipeline=rates["pipeline"],
                          rate_resident=rates["resident"],
                          input_wait_ms_p50=p50, input_wait_ms_max=mx_,
                          bytes_a_step=st["bytes_shipped"]
                          / st["batches_shipped"], **ov)
        del arms, p, r
        free(torch)
    out["host_images_per_s"] = host_rate
    return launches, out


def data_path(torch, card):
    """Phase 19: the data pipeline.  Returns (a)'s launches and (b)'s
    (no kernel of the port)."""
    import tempfile
    import mxnet_tpu_torch as mx
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as root:
        print("19a GPT-2 124M amp, graphed, fed from token records:",
              flush=True)
        launches, summary_a = data_gpt2(torch, mx, card, root)
        print("19b ResNet-50 v1 NHWC, graphed, fed uint8 images:",
              flush=True)
        vision, summary_b = data_vision(torch, mx, card, root)
    print(json.dumps({"data_pipeline": {"a": summary_a, "b": summary_b}}),
          flush=True)
    print(f"phase 19: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, vision


# ------------------------------------------------ phase 20: dp x sp


def ring_mode_cases(torch, dev, timer, card):
    """B2's ring modes against their plain versions at the ring's block
    shapes (a zigzag half-chunk against itself, causal, and against
    another chunk, full), float32 and bf16, and D = 256; the main
    shape's numbers for the kernels line: each mode's time, its plain
    version's, its bound, and SDPA's whole backward at the same shape as
    the library's yardstick."""
    from mxnet_tpu_torch.ops import flash as F
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)

    def run(tag, shape, dtype, causal):
        b, t, h, d = shape
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
        scale = d ** -0.5
        _o, lse = F.flash_fwd(q, k, v, causal=causal, scale=scale)
        # another chunk's keys: the global lse lies above this one's, so
        # the partial sums fall below 1, as on a ring
        lse = (lse + 0.5).contiguous()
        args = (q, k, v, do, lse)
        kw = dict(causal=causal, scale=scale)
        pdp, psum = F.flash_dq(*args, mode="partial", **kw)
        delta = (pdp / psum).contiguous()
        dq = F.flash_dq(*args, mode="given", delta=delta, **kw)
        torch.cuda.synchronize()
        rp, rs = F._dq_partial_plain(*args, None, None, causal, scale)
        rdq, _d = F._dq_plain(*args, None, None, causal, scale, delta)
        err = {"partial": max(relerr(pdp, rp), relerr(psum, rs)),
               "given": relerr(dq, rdq)}
        for mode, e in err.items():
            check(f"flash_dq[{mode}] {tag} (over plain max-abs)", e,
                  TOL_BWD[dname])
        again = F.flash_dq(*args, mode="given", delta=delta, **kw)
        if not torch.equal(dq, again):
            raise AssertionError(f"flash_dq[given] {tag}: a second launch "
                                 "gave other bits")
        ms = {"partial": timer(lambda: F.flash_dq(*args, mode="partial",
                                                  **kw)),
              "given": timer(lambda: F.flash_dq(*args, mode="given",
                                                delta=delta, **kw))}
        plain = {"partial": timer(lambda: F._dq_partial_plain(
                     *args, None, None, causal, scale)),
                 "given": timer(lambda: F._dq_plain(
                     *args, None, None, causal, scale, delta))}
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        lib_ms = timer(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        # per attended pair: partial computes S and dP (4*D operations),
        # given S, dP and dQ (6*D); bytes: q, k, v, dO and lse read once,
        # partial writes its two row sums, given reads delta and writes dQ
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        n = b * t * h * d * q.element_size()
        rows = b * h * t * 4
        work = {"partial": (4 * n + 3 * rows, 4 * d * pairs),
                "given": (5 * n + 2 * rows, 6 * d * pairs)}
        res = {}
        for mode, (nbytes, flops) in work.items():
            b_ms, b_by = bound(nbytes, flops, dname)
            res[mode] = dict(max_abs_err=maxabs(pdp, rp) if mode ==
                             "partial" else maxabs(dq, rdq),
                             rel_err=err[mode], ms=ms[mode],
                             plain_ms=plain[mode], bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)
            print(f"    flash_dq[{mode}]: kernel {ms[mode]:.4f} ms, plain "
                  f"{plain[mode]:.4f} ms, bound {b_ms:.4f} ms ({b_by} at "
                  f"{rate(b_by, dname)}), sdpa backward {lib_ms:.4f} ms "
                  f"[{card}]", flush=True)
        return res

    print("B2's ring modes vs plain at the ring's blocks:", flush=True)
    b, t, h, d = RING_BLOCK
    run(f"causal B{b} T{t} H{h} D{d} float32", RING_BLOCK, torch.float32,
        True)
    run(f"full B{b} T{t} H{h} D{d} bfloat16", RING_BLOCK, torch.bfloat16,
        False)
    run("causal B2 T300 H3 D256 float32", (2, 300, 3, 256), torch.float32,
        True)
    # the main shape: a block against another chunk's keys, full
    return run(f"main: full B{b} T{t} H{h} D{d} float32", RING_BLOCK,
               torch.float32, False)


def launch_ranks(part, d, n=2, timeout=900, flag="--phase20-rank"):
    """Run ``part`` of phase 20 (or 21, ``flag``) on ``n`` gloo ranks of
    this card through ``tools/launch.py``, in a session of their own
    that is killed whole if it outlives ``timeout``; returns the ranks'
    npz outputs."""
    import os
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXNET_TPU_DIST_TIMEOUT="600")
    cmd = [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
           str(n), sys.executable, os.path.abspath(__file__), flag, part,
           d]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{flag} {part}: ranks outlived {timeout} s")
    for line in out.splitlines():
        if line.startswith("  "):
            print(line, flush=True)
    if proc.returncode:
        raise AssertionError(f"{flag} {part}: ranks failed:\n"
                             f"{out[-6000:]}")
    return [dict(np.load(os.path.join(d, f"{part}_r{r}.npz")))
            for r in range(n)]


def phase20_rank(part, d) -> int:
    """One gloo rank of phase 20 (b) (``dp2``) or (c) (``sp2``)."""
    import os
    import torch
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import collectives as coll
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    par.init_distributed(backend="gloo")
    r = par.rank()
    torch.cuda.set_device(par.distributed.local_device())
    out = {}
    toks, labels = train_batch()
    if part == "dp2":
        # rank 1 seeded apart: the trainer's broadcast starts it from
        # rank 0's weights
        net = get_gpt2("gpt2_124m", dropout=0.0,
                       num_layers=PAR_LAYERS).initialize(
            seed=SEED if r == 0 else SEED + 1)
        tr = par.ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                                optimizer_params={"learning_rate":
                                                  TRAIN_LR},
                                mesh=par.make_mesh(dp=2))
        losses, ms, share, staged = [], [], [], []
        for i in range(DP_STEPS):
            coll.reset_stats()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses.append(float(tr.step(toks, labels)))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            st = coll.stats()
            ms.append(wall * 1e3)
            share.append(st["all_reduce_seconds"] / wall)
            staged.append(st.get("staged_bytes_d2h", 0)
                          + st.get("staged_bytes_h2d", 0))
            if i == 1:
                t1 = time.monotonic()
                tr.save_checkpoint(os.path.join(d, "ckpt"),
                                   2).wait_until_finished()
                out["ckpt_s"] = np.array(time.monotonic() - t1)
        stats = tr.stats()
        out.update(losses=np.array(losses), ms=np.array(ms),
                   share=np.array(share), staged=np.array(staged),
                   graphed=np.array(stats["graphed"]),
                   checksum=np.array([float(p.detach().double().abs().sum())
                                      for p in net.parameters()]))
        if r == 0:
            torch.save({n: p.detach().cpu() for n, p in
                        net.named_parameters()},
                       os.path.join(d, "dp2_params.pt"))
        print(f"  20b rank {r}: losses {losses}, ms/step "
              f"{[round(x, 1) for x in ms]}, all-reduce share "
              f"{[round(x, 3) for x in share]}, bytes staged a step "
              f"{staged}, graphed {stats['graphed']} backend "
              f"{stats['backend']}", flush=True)
    else:
        mesh = par.make_mesh(dp=1, sp=2)
        t = TRAIN_T // 2
        x = torch.as_tensor(toks[:SP_B, r * t:(r + 1) * t]).cuda()
        y = torch.as_tensor(labels[:SP_B, r * t:(r + 1) * t]).cuda()
        for mode in ("ring", "ulysses"):
            os.environ["MXNET_TPU_SEQ_PARALLEL"] = mode
            net = get_gpt2("gpt2_124m", dropout=0.0,
                           num_layers=PAR_LAYERS).initialize(seed=SEED)
            params = list(net.parameters())
            reset_launches()
            coll.reset_stats()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with par.use_mesh(mesh):
                loss = gpt2_lm_loss(net(x), y).mean()
            grads = list(torch.autograd.grad(loss, params))
            # each rank's share of the global mean: 1/2
            flat = [loss.detach().reshape(1)] + grads
            coll.all_reduce_(flat, mesh.group("sp"))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            st = coll.stats()
            from mxnet_tpu_torch.ops import flash as F
            launches = {n: sum(getattr(F, n).launches_by_dtype.values())
                        for n in ("flash_fwd", "flash_dq", "flash_dkv")}
            by_mode = dict(F.flash_dq.launches_by_mode)
            out[f"{mode}:loss"] = np.array(float(flat[0]) / 2)
            out[f"{mode}:launches"] = np.array(
                [launches[n] for n in ("flash_fwd", "flash_dq",
                                       "flash_dkv")])
            out[f"{mode}:by_mode"] = np.array(
                [by_mode[m] for m in ("own", "partial", "given")])
            out[f"{mode}:ms"] = np.array(wall * 1e3)
            out[f"{mode}:staged"] = np.array(
                st.get("staged_bytes_d2h", 0) + st.get("staged_bytes_h2d",
                                                       0))
            if r == 0:
                torch.save([g.detach().div(2).cpu() for g in flat[1:]],
                           os.path.join(d, f"sp2_{mode}_grads.pt"))
            print(f"  20c {mode} rank {r}: loss {float(flat[0]) / 2:.6f}, "
                  f"{wall * 1e3:.1f} ms (forward, backward, all-reduce), "
                  f"launches {launches}, B2 by mode {by_mode}, bytes "
                  f"staged {int(out[f'{mode}:staged'])}", flush=True)
            del net, params, grads, flat, loss
            free(torch)
    np.savez(os.path.join(d, f"{part}_r{r}.npz"), **out)
    par.barrier()
    return 0


def one_rank_mesh(torch, card):
    """20a: the amp step under a one-rank NCCL mesh, graphed, against
    ``mesh=None``: losses bit for bit."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    toks, labels = train_batch()
    par.init_distributed(None, 1, 0, backend="nccl")
    losses = {}
    try:
        mx.amp.init("bfloat16")
        for arm in ("none", "mesh"):
            net = get_gpt2("gpt2_124m", dropout=0.0).initialize(seed=SEED)
            mesh = par.make_mesh(dp=1) if arm == "mesh" else None
            tr = par.ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                                    optimizer_params={"learning_rate":
                                                      TRAIN_LR},
                                    mesh=mesh)
            got = [float(tr.step(toks, labels)) for _ in range(DP_STEPS)]
            # without a mesh stats() keeps the reference's keys
            graphed = tr.stats().get("graphed", tr._graphs)
            losses[arm] = got
            print(f"  20a mesh={arm}: losses {got}, graphed {graphed}, "
                  f"backend {tr.stats().get('backend')}, programs "
                  f"{len(tr._programs)} [{card}]", flush=True)
            if not graphed:
                raise AssertionError(f"20a mesh={arm}: the step is not "
                                     "graphed")
            del net, tr
            free(torch)
    finally:
        mx.amp.reset()
        dist.destroy_process_group()
    if losses["mesh"] != losses["none"]:
        raise AssertionError(f"20a: one-rank NCCL mesh {losses['mesh']} "
                             f"against mesh=None {losses['none']}")
    print("  20a one-rank NCCL mesh: losses bit-identical to mesh=None",
          flush=True)


def parallel_path(torch, card):
    """Phase 20.  Returns rank 0's launches on the ring and on Ulysses,
    and B2's launches by mode on the ring."""
    import os
    import tempfile
    from mxnet_tpu_torch.models import get_gpt2, gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    t_phase = time.monotonic()
    print("phase 20: data and sequence parallel GPT-2 124M "
          f"(two gloo ranks on this card) [{card}]", flush=True)
    one_rank_mesh(torch, card)
    free(torch)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as d:
        # (b) dp = 2 against one process
        ranks = launch_ranks("dp2", d)
        toks, labels = train_batch()
        net = get_gpt2("gpt2_124m", dropout=0.0,
                       num_layers=PAR_LAYERS).initialize(seed=SEED)
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": TRAIN_LR})
        one, one_ms = [], []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            one.append(float(tr.step(toks, labels)))
            torch.cuda.synchronize()
            one_ms.append((time.monotonic() - t0) * 1e3)
        print(f"  20b one process: losses {one}, ms/step "
              f"{[round(x, 1) for x in one_ms]} (graphed) [{card}]",
              flush=True)
        for r, out in enumerate(ranks):
            check(f"20b rank {r} losses vs one process (relative)",
                  max(abs(a - b) / abs(b) for a, b in
                      zip(out["losses"], one)), TOL_LOSS)
        if not np.array_equal(ranks[0]["checksum"], ranks[1]["checksum"]):
            raise AssertionError("20b: the two ranks' parameters differ")
        dp2 = torch.load(os.path.join(d, "dp2_params.pt"))
        check("20b final parameters vs one process (max-abs)",
              max(maxabs(p.detach().cpu(), dp2[n])
                  for n, p in net.named_parameters()), TOL_DP_PARAM)
        del net, tr, dp2
        free(torch)
        # the step-2 checkpoint, loaded by one process, continues the run
        net = get_gpt2("gpt2_124m", dropout=0.0,
                       num_layers=PAR_LAYERS).initialize(seed=SEED + 2)
        tr = ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                            optimizer_params={"learning_rate": TRAIN_LR})
        tr.build(toks, labels)
        tr.load_checkpoint(os.path.join(d, "ckpt"))
        resumed = float(tr.step(toks, labels))
        check("20b step 3 from the dp = 2 checkpoint vs the ranks' "
              "(relative)", abs(resumed - ranks[0]["losses"][2])
              / abs(ranks[0]["losses"][2]), TOL_LOSS)
        del net, tr
        free(torch)
        ms = float(np.mean(ranks[0]["ms"][1:]))
        share = float(np.mean(ranks[0]["share"][1:]))
        print(f"  20b dp = 2 over gloo: {ms:.1f} ms/step (steps 2-"
              f"{DP_STEPS}, rank 0), the all-reduce {share * 100:.1f} % of "
              f"it, {int(ranks[0]['staged'][-1])} bytes staged a step, "
              f"checkpoint {float(ranks[0]['ckpt_s']):.2f} s, eager "
              f"(graphed {bool(ranks[0]['graphed'])}) [{card}]",
              flush=True)
        # (c) sp = 2: ring, then Ulysses, against one process
        ranks = launch_ranks("sp2", d)
        net = get_gpt2("gpt2_124m", dropout=0.0,
                       num_layers=PAR_LAYERS).initialize(seed=SEED)
        x = torch.as_tensor(toks[:SP_B]).cuda()
        y = torch.as_tensor(labels[:SP_B]).cuda()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = gpt2_lm_loss(net(x), y).mean()
        names = [n for n, _ in net.named_parameters()]
        ref = torch.autograd.grad(loss, list(net.parameters()))
        torch.cuda.synchronize()
        one_ms = (time.monotonic() - t0) * 1e3
        loss = float(loss.detach())
        base = read_launches()
        for mode in ("ring", "ulysses"):
            got = [g.cuda() for g in torch.load(
                os.path.join(d, f"sp2_{mode}_grads.pt"))]
            check(f"20c {mode} loss vs one process (relative)",
                  abs(float(ranks[0][f"{mode}:loss"]) - loss) / abs(loss),
                  TOL_LOSS)
            errs = grad_errors(names, got, ref)
            worst = int(np.argmax(errs))
            check(f"20c {mode}: {len(errs)} gradients vs one process "
                  f"(worst {names[worst]}, over its max-abs)", errs[worst],
                  TOL_GRAD)
            for r, out in enumerate(ranks):
                n = out[f"{mode}:launches"]
                if not all(n > 0):
                    raise AssertionError(f"20c {mode} rank {r}: B1-B3 "
                                         f"launches {n}")
            by_mode = ranks[0]["ring:by_mode"]
            if mode == "ring" and not (by_mode[1] > 0 and by_mode[2] > 0):
                raise AssertionError(f"20c ring: B2 by mode {by_mode}")
        print(f"  20c one process: {one_ms:.1f} ms (forward, backward; "
              f"its first call), launches {base} [{card}]", flush=True)
        del net, ref, loss
        free(torch)
    launches = {mode: dict(zip(("flash_fwd", "flash_dq", "flash_dkv"),
                               (int(c) for c in
                                ranks[0][f"{mode}:launches"])))
                for mode in ("ring", "ulysses")}
    for counts in launches.values():
        counts["paged_attention"] = 0
    by_mode = dict(zip(("own", "partial", "given"),
                       (int(c) for c in ranks[0]["ring:by_mode"])))
    print(f"phase 20: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, by_mode


# ------------------------------- phase 21: tensor, expert and pipeline

def par_batch():
    """Phase 21's batch: the first PAR_B rows of the training batch."""
    toks, labels = train_batch()
    return toks[:PAR_B], labels[:PAR_B]


def par_net(part):
    """Phase 21's model of ``part``, not initialized: (a) GPT-2 124M with
    nanoGPT's vocabulary, (b) phase 8's routed GPT-2 124M, (c) the
    stacked GPT-2 124M in PAR_MICRO microbatches."""
    from mxnet_tpu_torch.models import get_gpt2, get_stacked_gpt2
    if part == "tp2":
        return get_gpt2("gpt2_124m", vocab_size=PAR_VOCAB, dropout=0.0)
    if part == "ep2":
        return get_gpt2("gpt2_124m", dropout=0.0, **MOE_CFG)
    return get_stacked_gpt2("gpt2_124m", num_microbatches=PAR_MICRO)


def par_trainer(net, mesh=None):
    from mxnet_tpu_torch.models import gpt2_lm_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    return ShardedTrainer(net, "adam", loss=gpt2_lm_loss,
                          optimizer_params={"learning_rate": TRAIN_LR},
                          mesh=mesh)


def dropped_shares(net):
    """Each MoE layer's dropped share at the last forward."""
    return [float(b.moe.last_dropped) for b in net.blocks
            if hasattr(b, "moe")]


def phase21_rank(d) -> int:
    """One of phase 21's two gloo ranks: (a) tp = 2, (b) ep = 2, (c) pp =
    2, one after another; each part's losses, ms, collectives and
    launches a step, and this rank's blocks of the final parameters."""
    import os
    import torch
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.parallel import collectives as coll
    from mxnet_tpu_torch.parallel.sharding import global_shape, is_block
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    par.init_distributed(backend="gloo")
    r = par.rank()
    torch.cuda.set_device(par.distributed.local_device())
    toks, labels = par_batch()
    out = {}
    for part, axis in PAR_PARTS:
        mesh = par.make_mesh(**{axis: 2})
        # rank 1 seeded apart: the trainer starts it from rank 0's weights
        net = par_net(part).initialize(seed=SEED if r == 0 else SEED + 1)
        if part == "pp2":
            par.shard_params(net, mesh)
            reset_launches()
            with par.use_mesh(mesh), torch.no_grad():
                logits = net(torch.as_tensor(toks).cuda())
            out["pp2:forward_launches"] = np.array(
                [read_launches()[n] for n in RES_FLASH])
            if r == 0:
                torch.save(logits.cpu(), os.path.join(d, "pp2_logits.pt"))
            del logits
        tr = par_trainer(net, mesh)
        rows = {k: [] for k in ("losses", "ms", "coll_s", "staged",
                                "launches", "dropped")}
        for _ in range(DP_STEPS):
            reset_launches()
            coll.reset_stats()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            rows["losses"].append(float(tr.step(toks, labels)))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            st = coll.stats()
            rows["ms"].append(wall * 1e3)
            rows["coll_s"].append(st.get(f"seconds:{axis}", 0.0))
            rows["staged"].append(st.get("staged_bytes_d2h", 0)
                                  + st.get("staged_bytes_h2d", 0))
            by_dtype = read_launches_by_dtype()
            rows["launches"].append([by_dtype[n].get("float32", 0)
                                     for n in RES_FLASH])
            if sum(sum(by_dtype[n].values()) for n in RES_FLASH) != \
                    sum(rows["launches"][-1]):
                raise AssertionError(f"21 {part}: launches {by_dtype}")
            if part == "ep2":
                rows["dropped"].append(dropped_shares(net))
        for k, v in rows.items():
            out[f"{part}:{k}"] = np.array(v)
        out[f"{part}:graphed"] = np.array(tr.stats()["graphed"])
        torch.save({n: (p.detach().cpu(),
                        [(x.start, x.stop) for x in
                         p._sharding.local_slices(global_shape(p))]
                        if is_block(p) else None)
                    for n, p in net.named_parameters()},
                   os.path.join(d, f"{part}_params_r{r}.pt"))
        share = np.array(rows["coll_s"]) / (np.array(rows["ms"]) / 1e3)
        print(f"  21 {part} rank {r}: losses {rows['losses']}, ms/step "
              f"{[round(x, 1) for x in rows['ms']]}, {axis} collectives "
              f"{[round(x, 3) for x in rows['coll_s']]} s "
              f"({[round(float(x), 3) for x in share]} of the step), "
              f"bytes staged a step {rows['staged']}, B1-B3 a step "
              f"{rows['launches']}", flush=True)
        del net, tr
        free(torch)
    np.savez(os.path.join(d, f"models_r{r}.npz"), **out)
    par.barrier()
    return 0


def par_one_process(torch, part, toks, labels):
    """The one-process run of phase 21's ``part`` from rank 0's weights:
    (losses, ms a step, parameters, dropped shares a step, logits of the
    unpiped forward for (c))."""
    net = par_net(part).initialize(seed=SEED)
    logits = None
    if part == "pp2":
        with torch.no_grad():
            logits = net(torch.as_tensor(toks).cuda())
    tr = par_trainer(net)
    losses, ms, dropped = [], [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(float(tr.step(toks, labels)))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        if part == "ep2":
            dropped.append(dropped_shares(net))
    params = {n: p.detach() for n, p in net.named_parameters()}
    return losses, ms, params, dropped, logits


def parallel_models_path(torch, card):
    """Phase 21.  Returns rank 0's B1-B3 launches over the steps of each
    part, by path."""
    import os
    import tempfile
    t_phase = time.monotonic()
    print(f"phase 21: tensor, expert and pipeline parallel training, two "
          f"gloo ranks on this card, {PAR_B} x {TRAIN_T}, float32, "
          f"{DP_STEPS} Adam steps a part [{card}]", flush=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build")
    os.makedirs(root, exist_ok=True)
    toks, labels = par_batch()
    by_path = {}
    with tempfile.TemporaryDirectory(dir=root) as d:
        ranks = launch_ranks("models", d, flag="--phase21-rank")
        for letter, (part, axis) in zip("abc", PAR_PARTS):
            one, one_ms, params, dropped, logits = par_one_process(
                torch, part, toks, labels)
            if part == "pp2":
                piped = torch.load(os.path.join(d, "pp2_logits.pt"))
                check("21c piped forward logits vs the unpiped model "
                      "(over its max-abs)", relerr(piped.cuda(), logits),
                      TOL_PAR_LOGITS)
                del piped, logits
            for r, out in enumerate(ranks):
                check(f"21{letter} {part} rank {r} losses vs one process "
                      "(relative)", max(abs(a - b) / abs(b) for a, b in
                                        zip(out[f"{part}:losses"], one)),
                      TOL_LOSS)
                blocks = torch.load(os.path.join(
                    d, f"{part}_params_r{r}.pt"))
                worst = max(maxabs(b.cuda(), params[n] if sl is None else
                                   params[n][tuple(slice(*x) for x in sl)])
                            for n, (b, sl) in blocks.items())
                check(f"21{letter} {part} rank {r}: {len(blocks)} "
                      "parameters (its blocks) vs one process (max-abs)",
                      worst, TOL_DP_PARAM)
                got = out[f"{part}:launches"]
                want = PAR_LAUNCHES[part]
                if not (got == np.array(want)[None]).all():
                    raise AssertionError(f"21{letter} {part} rank {r}: "
                                         f"B1-B3 a step {got.tolist()}, "
                                         f"not {want}")
                if part == "ep2" and \
                        out["ep2:dropped"].tolist() != dropped:
                    raise AssertionError(
                        f"21b rank {r}: dropped shares "
                        f"{out['ep2:dropped'].tolist()} vs one process "
                        f"{dropped}")
            r0 = ranks[0]
            ms = float(np.mean(r0[f"{part}:ms"][1:]))
            share = float(np.mean(r0[f"{part}:coll_s"][1:])) / ms * 1e3
            print(f"  21{letter} {part}: {ms:.1f} ms/step (steps 2-"
                  f"{DP_STEPS}, rank 0; eager, graphed "
                  f"{bool(r0[f'{part}:graphed'])}) against one process's "
                  f"{float(np.mean(one_ms[1:])):.1f} (graphed); {axis} "
                  f"collectives {share * 100:.1f} % of the step, "
                  f"{int(r0[f'{part}:staged'][-1])} bytes staged a step, "
                  f"B1-B3 {r0[f'{part}:launches'][-1].tolist()} a step a "
                  f"rank [{card}]", flush=True)
            if part == "ep2":
                print(f"  21b dropped shares a step by MoE layer (both "
                      f"ranks and one process): {dropped}", flush=True)
            if part == "pp2":
                print(f"  21c piped forward: B1-B3 "
                      f"{r0['pp2:forward_launches'].tolist()} a rank",
                      flush=True)
            counts = dict(zip(RES_FLASH, (int(c) for c in
                                          r0[f"{part}:launches"].sum(0))))
            counts["paged_attention"] = 0
            by_path[f"parallel_{axis}"] = counts
            del params
            free(torch)
    print(f"phase 21: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return by_path


# -------------------- phase 22: sharded serving, BERT and NMT under tp

def shard_gpt2():
    """(a)'s GPT-2 124M with nanoGPT's vocabulary, seeded alike on every
    rank (the engine's ranks must hold the same weights)."""
    from mxnet_tpu_torch.models import get_gpt2
    return get_gpt2("gpt2_124m", vocab_size=PAR_VOCAB,
                    dropout=0.0).initialize(seed=SEED)


def shard_engine(net, layout, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    paged = dict(kv_layout="paged", page_size=16,
                 paged_attention="gather") if layout == "paged" else {}
    return InferenceEngine(net, num_slots=8, max_batch=8, **HARD_LATTICE,
                           **paged, **kw)


def shard_requests(eng, prompts):
    """Phase 3's prompts through ``eng`` (started): the streams."""
    futs = [eng.submit(p, max_new_tokens=SHARD_NEW,
                       **(SHARD_SAMPLED if i == SHARD_SAMPLED_ROW else {}))
            for i, p in enumerate(prompts)]
    return [f.result(600) for f in futs]


def shard_lang_net(kind):
    """(b)'s BERT-large with the pretraining heads, taking no
    ``valid_length`` (every row full: the flash path), or (c)'s
    Transformer-big with one shared vocabulary; not initialized."""
    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.models import BERTForPretrain, get_bert, get_nmt
    if kind == "nmt":
        return get_nmt("transformer_big", src_vocab_size=NMT_VOCAB,
                       shared_embed=True, dropout=0.0)

    class FullRows(HybridBlock):
        def __init__(self):
            super().__init__()
            self.bert = BERTForPretrain(get_bert(
                "bert_large", vocab_size=BERT_VOCAB, max_length=BERT_T,
                dropout=0.0))

        def forward(self, tokens, types, positions):
            return self.bert(tokens, types, None, positions)
    return FullRows()


def shard_lang_step(kind):
    """(data, labels, loss, learning rate) of (b) or (c)."""
    from mxnet_tpu_torch.models import nmt_loss
    if kind == "nmt":
        src, tgt, labels = nmt_batch()
        return (src, tgt), (labels,), nmt_loss, NMT_LR
    toks, types, _vlen, pos, mlm, nsp = bert_batch()
    return (toks, types, pos), (mlm, nsp), bert_loss, SHARD_BERT_LR


def shard_sources():
    rs = np.random.RandomState(SEED + 1)
    return rs.randint(0, NMT_VOCAB, (SHARD_SOURCES, SHARD_SRC_T)) \
        .astype(np.int32)


def staged_bytes(st) -> int:
    return st.get("staged_bytes_d2h", 0) + st.get("staged_bytes_h2d", 0)


def per_program(torch, eng, rows):
    """Wrap ``eng._call``: each program call's wall (synchronized), the
    bytes its collectives staged, and the host seconds of those
    collectives and of the plan exchange, summed by program into
    ``rows[kind] = [calls, wall s, bytes, collective s]``."""
    from mxnet_tpu_torch.parallel import collectives as coll
    call = eng._call

    def timed(key, fn, *args, count=True):
        st0, p0 = coll.stats(), eng._mesh.plans["seconds"]
        t0 = time.monotonic()
        res = call(key, fn, *args, count=count)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        st1 = coll.stats()
        secs = sum(st1.get(k, 0) - st0.get(k, 0) for k in st1
                   if k.startswith("seconds:"))
        row = rows.setdefault(key[0], [0, 0.0, 0, 0.0])
        row[0] += 1
        row[1] += wall
        row[2] += staged_bytes(st1) - staged_bytes(st0)
        row[3] += secs + eng._mesh.plans["seconds"] - p0
        return res
    eng._call = timed


def shard_serve_rank(torch, r, out):
    """(a) on one rank: each layout's engine over tp = 2."""
    from mxnet_tpu_torch.parallel import collectives as coll
    net = shard_gpt2()
    prompts = make_prompts()
    for layout in SHARD_LAYOUTS:
        eng = shard_engine(net, layout, mesh=2, name=f"shard_{layout}")
        n_warm = eng.warmup()
        torch.cuda.synchronize()
        reset_launches()
        rows = {}
        with eng:
            if not eng._follower:
                # the engine as it runs: tokens/s and TTFT
                t0 = time.monotonic()
                outs = shard_requests(eng, prompts)
                wall = time.monotonic() - t0
                s = eng.stats()
                # its own window, each program call synchronized: the
                # breakdown by program (other prompts: no prefix hits)
                coll.reset_stats()
                per_program(torch, eng, rows)
                t0 = time.monotonic()
                shard_requests(eng, [(p + 1) % VOCAB for p in prompts])
                wall2 = time.monotonic() - t0
                s2 = eng.stats()
        torch.cuda.synchronize()
        launches = read_launches()
        out[f"{layout}:launches"] = np.array([launches[n]
                                              for n in KERNELS])
        if r == 0:
            c = s["counters"]
            dec = rows.get("decode", [0, 0.0, 0, 0.0])
            for i, o in enumerate(outs):
                out[f"{layout}:out{i}"] = o
            out[f"{layout}:numbers"] = np.array([
                c["tokens_generated"] / wall,
                s["latency"]["ttft"]["p50"] * 1e3, *dec,
                s2["plans"]["sent"] - s["plans"]["sent"],
                s2["plans"]["bytes"] - s["plans"]["bytes"],
                (s2["counters"]["tokens_generated"]
                 - c["tokens_generated"]) / wall2])
            out[f"{layout}:programs"] = np.array(json.dumps(rows))
            out[f"{layout}:compile"] = np.array(json.dumps(
                [n_warm, s["compile"], s["mesh"]]))
        print(f"  22a {layout} rank {r}: warm-up programs {n_warm}, "
              f"launches {launches}", flush=True)
        del eng
        free(torch)
    del net
    free(torch)


def shard_train_rank(torch, kind, r, d, out):
    """(b) or (c) on one rank: DP_STEPS steps at tp = 2 (rank 1 seeded
    apart), then (c)'s translate."""
    import os
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.parallel import collectives as coll
    from mxnet_tpu_torch.parallel.sharding import global_shape, is_block
    data, labels, loss, lr = shard_lang_step(kind)
    mesh = par.make_mesh(tp=2)
    net = shard_lang_net(kind).initialize(seed=SEED if r == 0 else
                                          SEED + 1)
    tr = par.ShardedTrainer(net, "adam", loss=loss, mesh=mesh,
                            optimizer_params={"learning_rate": lr})
    rows = {k: [] for k in ("losses", "ms", "coll_s", "staged",
                            "launches")}
    for _ in range(DP_STEPS):
        reset_launches()
        coll.reset_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rows["losses"].append(float(tr.step(data, labels)))
        torch.cuda.synchronize()
        rows["ms"].append((time.monotonic() - t0) * 1e3)
        st = coll.stats()
        rows["coll_s"].append(st.get("seconds:tp", 0.0))
        rows["staged"].append(st.get("staged_bytes_d2h", 0)
                              + st.get("staged_bytes_h2d", 0))
        by_dtype = read_launches_by_dtype()
        rows["launches"].append([by_dtype[n].get("float32", 0)
                                 for n in RES_FLASH])
    for k, v in rows.items():
        out[f"{kind}:{k}"] = np.array(v)
    torch.save({n: (p.detach().cpu(),
                    [(x.start, x.stop) for x in
                     p._sharding.local_slices(global_shape(p))]
                    if is_block(p) else None)
                for n, p in net.named_parameters()},
               os.path.join(d, f"{kind}_params_r{r}.pt"))
    if kind == "nmt":
        out["nmt:translate"] = net.translate(shard_sources(),
                                             max_length=SHARD_MAX_LEN)
    print(f"  22{'b' if kind == 'bert' else 'c'} {kind} rank {r}: losses "
          f"{rows['losses']}, ms/step {[round(x, 1) for x in rows['ms']]}, "
          f"B1-B3 a step {rows['launches']}", flush=True)
    del net, tr
    free(torch)


def phase22_rank(d) -> int:
    """One of phase 22's two gloo ranks: (a), (b) and (c) in turn."""
    import os
    import torch
    from mxnet_tpu_torch import parallel as par
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    par.init_distributed(backend="gloo")
    r = par.rank()
    torch.cuda.set_device(par.distributed.local_device())
    out = {}
    shard_serve_rank(torch, r, out)
    for kind in ("bert", "nmt"):
        shard_train_rank(torch, kind, r, d, out)
    np.savez(os.path.join(d, f"shard_r{r}.npz"), **out)
    par.barrier()
    return 0


def graphed_programs(eng) -> bool:
    """Whether every program the engine compiled is a CUDA graph."""
    return all(p.graph for p in eng._programs.values())


def shard_one_rank(torch, net, prompts, card):
    """22a: a one-rank NCCL mesh engine, graphed, against ``mesh=None``:
    the streams bit-identical."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel as par
    par.init_distributed(None, 1, 0, backend="nccl")
    outs = {}
    try:
        for arm in ("none", "mesh"):
            eng = shard_engine(net, "paged", name=f"one_rank_{arm}",
                               mesh=1 if arm == "mesh" else None)
            n_warm = eng.warmup()
            graphed = graphed_programs(eng)
            with eng:
                outs[arm] = shard_requests(eng, prompts)
            print(f"  22a one-rank NCCL mesh={arm}: mesh point "
                  f"{eng.stats()['mesh']['mesh_point']}, programs "
                  f"{n_warm}, graphed {graphed} [{card}]", flush=True)
            if not graphed:
                raise AssertionError(f"22a mesh={arm}: a program is not "
                                     "graphed")
            del eng
            free(torch)
    finally:
        dist.destroy_process_group()
    if not all(np.array_equal(a, b) for a, b in zip(outs["mesh"],
                                                     outs["none"])):
        raise AssertionError("22a: the one-rank NCCL mesh engine's streams "
                             "differ from mesh=None's")
    print("  22a one-rank NCCL mesh: streams bit-identical to mesh=None",
          flush=True)


def shard_serving(torch, ranks, card):
    """(a)'s gates against one process, and its numbers."""
    net = shard_gpt2()
    prompts = make_prompts()
    r0 = ranks[0]
    for layout in SHARD_LAYOUTS:
        eng = shard_engine(net, layout, name=f"one_{layout}")
        eng.warmup()
        t0 = time.monotonic()
        with eng:
            one = shard_requests(eng, prompts)
        wall = time.monotonic() - t0
        got = [r0[f"{layout}:out{i}"] for i in range(len(prompts))]
        same = [bool(np.array_equal(a, b)) for a, b in zip(got, one)]
        n_warm, comp, mesh = json.loads(str(r0[f"{layout}:compile"]))
        tps, ttft, steps, dwall, staged, coll_s, plans, pbytes, tps2 = \
            r0[f"{layout}:numbers"].tolist()
        launches = [dict(zip(KERNELS, o[f"{layout}:launches"].tolist()))
                    for o in ranks]
        steps = max(steps, 1)
        one_tps = sum(len(o) - len(p) for o, p in zip(one, prompts)) / wall
        print(f"  22a {layout}: tp = 2 {tps:.1f} tokens/s, TTFT p50 "
              f"{ttft:.1f} ms; with each program call synchronized "
              f"(other prompts) {tps2:.1f} tokens/s, a decode step "
              f"(rank 0, {steps:.0f} of them) "
              f"{dwall / steps * 1e3:.2f} ms, {staged / steps:.0f} bytes "
              f"staged, collectives and plan exchange "
              f"{coll_s / steps * 1e3:.2f} ms "
              f"({coll_s / max(dwall, 1e-9) * 100:.1f} %); "
              f"by program {r0[f'{layout}:programs']} ({plans:.0f} plans, "
              f"{pbytes:.0f} bytes of inputs); one process (graphed) "
              f"{one_tps:.1f} tokens/s; mesh {mesh['mesh_point']}, "
              f"warm-up programs {n_warm}, compiles {comp['compiles']} "
              f"{comp['by_mesh_point']}; "
              f"launches by rank {launches} [{card}]", flush=True)
        if not all(same):
            raise AssertionError(f"22a {layout}: streams against one "
                                 f"process {same}")
        if comp["compiles"] != n_warm or \
                comp["by_mesh_point"] != {"2dev:tp=2": n_warm}:
            raise AssertionError(f"22a {layout}: compiles moved after "
                                 f"warmup(): {comp}")
        if any(c["flash_fwd"] == 0 or c["paged_attention"] for c in
               launches):
            raise AssertionError(f"22a {layout}: launches {launches}")
        print(f"  22a {layout}: {len(same)} streams (request "
              f"{SHARD_SAMPLED_ROW} sampled) token-identical to one "
              "process", flush=True)
        del eng
        free(torch)
    shard_one_rank(torch, net, prompts, card)
    del net
    free(torch)


def shard_translate(torch, net, got, card):
    """(c)'s translate against the one-process net: identical tokens, or
    a split where the one-process net's teacher-forced logits tie within
    TOL_GREEDY (relative)."""
    src = torch.from_numpy(shard_sources()).to(net.device)
    want = net.translate(src, max_length=SHARD_MAX_LEN)
    if got.shape == want.shape and np.array_equal(got, want):
        print(f"  22c translate: {want.shape} tokens identical to one "
              f"process [{card}]", flush=True)
        return
    for i in range(len(want)):
        j = next((k for k in range(min(len(got[i]), len(want[i])))
                  if got[i, k] != want[i, k]), None)
        if j is None:
            continue
        lg = forced_logits(torch, net, src[i:i + 1], want[i:i + 1], 1)
        row = lg[0, j].cpu().numpy()
        margin = float((row[want[i, j]] - row[got[i, j]]) /
                       abs(row[want[i, j]]))
        print(f"  22c translate: source {i} splits at position {j} "
              f"({got[i, j]} vs {want[i, j]}), one process's margin "
              f"{margin:.3e} (relative) [{card}]", flush=True)
        if margin > TOL_GREEDY:
            raise AssertionError(f"22c translate: source {i} splits at "
                                 f"{j} with margin {margin:.3e}")


def shard_lang(torch, ranks, d, card):
    """(b) and (c)'s gates against one process; their launches by path."""
    import os
    from mxnet_tpu_torch import parallel as par
    by_path = {}
    for letter, kind in (("b", "bert"), ("c", "nmt")):
        data, labels, loss, lr = shard_lang_step(kind)
        net = shard_lang_net(kind).initialize(seed=SEED)
        init = {n: p.detach().clone() for n, p in net.named_parameters()}
        tr = par.ShardedTrainer(net, "adam", loss=loss,
                                optimizer_params={"learning_rate": lr})
        one, one_ms = [], []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            one.append(float(tr.step(data, labels)))
            torch.cuda.synchronize()
            one_ms.append((time.monotonic() - t0) * 1e3)
        params = {n: p.detach() for n, p in net.named_parameters()}
        print(f"  22{letter} {kind} one process: losses {one}", flush=True)
        for r, out in enumerate(ranks):
            check(f"22{letter} {kind} rank {r} losses vs one process "
                  "(relative)", max(abs(a - b) / abs(b) for a, b in
                                    zip(out[f"{kind}:losses"], one)),
                  TOL_LOSS)
            blocks = torch.load(os.path.join(d, f"{kind}_params_r{r}.pt"))
            worst = max(maxabs(b.cuda(), cut(params[n], sl))
                        for n, (b, sl) in blocks.items())
            check(f"22{letter} {kind} rank {r}: {len(blocks)} parameters "
                  "(its blocks) vs one process (max-abs)", worst,
                  min(TOL_SHARD_PARAM, 2 * lr * DP_STEPS))
            name, moved = max(((n, travel_gap(b.cuda(), cut(params[n], sl),
                                              cut(init[n], sl)))
                               for n, (b, sl) in blocks.items()
                               if not n.endswith(NO_GRADIENT)),
                              key=lambda x: x[1])
            check(f"22{letter} {kind} rank {r}: the worst parameter's "
                  f"travel vs one process's ({name}; relative L2, 1 if "
                  "left unchanged)", moved, TOL_SHARD_TRAVEL)
            got = out[f"{kind}:launches"]
            if not (got == np.array(SHARD_LAUNCHES[kind])[None]).all():
                raise AssertionError(f"22{letter} {kind} rank {r}: B1-B3 "
                                     f"a step {got.tolist()}, not "
                                     f"{SHARD_LAUNCHES[kind]}")
        r0 = ranks[0]
        ms = float(np.mean(r0[f"{kind}:ms"][1:]))
        share = float(np.mean(r0[f"{kind}:coll_s"][1:])) / ms * 1e3
        print(f"  22{letter} {kind}: {ms:.1f} ms/step (steps 2-{DP_STEPS}, "
              f"rank 0, eager) against one process's "
              f"{float(np.mean(one_ms[1:])):.1f} (graphed); tp collectives "
              f"{share * 100:.1f} % of the step, "
              f"{int(r0[f'{kind}:staged'][-1])} bytes staged a step, "
              f"B1-B3 {r0[f'{kind}:launches'][-1].tolist()} a step a rank "
              f"[{card}]", flush=True)
        if kind == "nmt":
            shard_translate(torch, net, r0["nmt:translate"], card)
        by_path[f"parallel_{kind}"] = dict(
            zip(RES_FLASH, (int(c) for c in r0[f"{kind}:launches"].sum(0))),
            paged_attention=0)
        del net, tr, params, init
        free(torch)
    return by_path


def cut(t, sl):
    """The block of ``t`` at slices ``sl`` ((start, stop) a dimension),
    or all of it where ``sl`` is None."""
    return t if sl is None else t[tuple(slice(*x) for x in sl)]


def travel_gap(got, want, start) -> float:
    """How far a parameter's travel from ``start`` strays from the
    reference's: |(got - start) - (want - start)| / |want - start| (L2),
    1.0 for a parameter the run left unchanged."""
    ref = (want - start).double().norm().item()
    gap = (got - want).double().norm().item()
    return gap / ref if ref else (0.0 if gap == 0 else float("inf"))


def shard_path(torch, card):
    """Phase 22.  Returns rank 0's launches by path: the sharded serving
    (both layouts, after warm-up) and (b)'s and (c)'s steps."""
    import os
    import tempfile
    t_phase = time.monotonic()
    print(f"phase 22: sharded serving (GPT-2 124M, vocabulary "
          f"{PAR_VOCAB}), BERT-large and Transformer-big at tp = 2, two "
          f"gloo ranks on this card, float32 [{card}]", flush=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as d:
        ranks = launch_ranks("shard", d, flag="--phase22-rank")
        shard_serving(torch, ranks, card)
        by_path = shard_lang(torch, ranks, d, card)
    r0 = ranks[0]
    serve = sum(r0[f"{layout}:launches"] for layout in SHARD_LAYOUTS)
    by_path["sharded_serve"] = dict(zip(KERNELS, (int(c) for c in serve)))
    print(f"phase 22: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return by_path


# ------------------------------------------------- phase 23: queue A7

# (a)'s engines: phase 3's traffic on one (8, 512) lattice point
A7_ENG = dict(kv_layout="paged", num_slots=8, max_batch=8, page_size=16,
              batch_buckets=(8,), seq_buckets=(512,),
              paged_attention="kernel")
A7_NEW = 48
# (b): 4 system-prompt families of 256 tokens (16 pages of 16) with a
# 32-token question each, 3 rounds; a pool of 48 pages holds 2 of them
TIER_FAMILIES, TIER_SYSTEM, TIER_QUESTION, TIER_ROUNDS = 4, 256, 32, 3
TIER_ENG = dict(kv_layout="paged", num_slots=2, max_batch=2, page_size=16,
                batch_buckets=(2,), seq_buckets=(512,), max_length=512,
                num_pages=48, prefix_min_tokens=64,
                paged_attention="kernel")
# the host pool holds one family's bundle (18 pages x 16 positions x 12
# layers x K and V x 768 float32 = 21.2 MB); the others spill to disk
TIER_HOST_BYTES = 40 << 20
TIER_NEW = 16
# (c): 3 replicas, 6 families of a 128-token system prompt, 4 members
FLEET_ENG = dict(kv_layout="paged", num_slots=4, max_batch=4, page_size=16,
                 batch_buckets=(4,), seq_buckets=(256,), max_length=256,
                 prefix_min_tokens=32, paged_attention="kernel")
FLEET_FAMILIES, FLEET_MEMBERS, FLEET_SYSTEM, FLEET_TAIL = 6, 4, 128, 16
FLEET_NEW = 16


def a7_engine(net, **kw):
    from mxnet_tpu_torch.serving import InferenceEngine
    return InferenceEngine(net, **kw)


def a7_sampling(i):
    """Request i: odd ones sampled with seed i."""
    return dict(seed=i, temperature=0.8 if i % 2 else 0.0)


def same_streams(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what}: stream {i} differs")


def frozen(eng, warm, what):
    c = eng.stats()["compile_cache"]["compiles"]
    if c != warm:
        raise AssertionError(f"{what}: {c} compiles after a warm-up of "
                             f"{warm}")


def disagg_arm(torch, net, prompts, card, kv_quant):
    """(a) one storage arm: a unified engine, then a prefill-role engine
    handing off to a decode-role engine.  A first run starts the decode
    engine only once every request has migrated, so the prefill
    engine's launches and the decode engine's read apart; a second run
    with both running reads the handoff's costs.  TTFT is one definition
    in both arms: the request's submit to the engine's first token (the
    unified engine's ``_ttft``; on the prefill engine the first token's
    time as the handoff starts)."""
    from mxnet_tpu_torch.serving import engine as engine_mod
    from mxnet_tpu_torch.serving import migration as migration_mod
    kw = dict(A7_ENG, kv_quant=kv_quant)
    arm = kv_quant or "f32"
    uni = a7_engine(net, name=f"a7u_{arm}", **kw)
    warm_u = uni.warmup()
    with uni:
        futs = [uni.submit(p, max_new_tokens=A7_NEW, **a7_sampling(i))
                for i, p in enumerate(prompts)]
        want = [f.result(600) for f in futs]
        ttft_u = float(np.median(uni._ttft)) * 1e3
    frozen(uni, warm_u, f"23a {arm} unified")
    pre = a7_engine(net, role="prefill", name=f"a7p_{arm}", **kw)
    dec = a7_engine(net, role="decode", name=f"a7d_{arm}", **kw)
    t_sub, nbytes = {}, []
    ms = {k: [] for k in ("export", "copy", "digest", "adopt", "handoff",
                          "ttft")}

    def target(bundle, future):
        t0 = time.monotonic()
        dec.adopt(bundle, future)
        t1 = time.monotonic()
        ms["adopt"].append((t1 - t0) * 1e3)
        nbytes.append(bundle.nbytes())
        ms["handoff"].append((t1 - t_sub[bundle.prompt.tobytes()]) * 1e3)
    pre.migrate_to(target)
    warm = (pre.warmup(), dec.warmup())
    out = {}
    begin, seal = engine_mod.begin_export, migration_mod.PendingBundle.seal
    migrate_out = pre._migrate_out

    def timed_begin(*a):
        t0 = time.monotonic()
        p = begin(*a)
        ms["export"].append((time.monotonic() - t0) * 1e3)
        return p

    def timed_seal(self):
        t0 = time.monotonic()
        arrays = self.copy.result()
        t1 = time.monotonic()
        b = migration_mod.MigrationBundle(arrays=arrays, **self.fields)
        b.digest = migration_mod.bundle_digest(b)
        ms["copy"].append((t1 - t0) * 1e3)
        ms["digest"].append((time.monotonic() - t1) * 1e3)
        return b

    def timed_migrate_out(slot, st, token):
        ok = migrate_out(slot, st, token)
        r = st.request
        ms["ttft"].append((r.t_first - r.t_submit) * 1e3)
        return ok
    engine_mod.begin_export = timed_begin
    migration_mod.PendingBundle.seal = timed_seal
    pre._migrate_out = timed_migrate_out
    try:
        with pre:
            for run in ("attribution", "concurrent"):
                torch.cuda.synchronize()
                reset_launches()
                for v in (*ms.values(), nbytes):
                    del v[:]
                m0 = pre.metrics.counters["migrations_out"]
                for p in prompts:
                    t_sub[p.tobytes()] = time.monotonic()
                futs = [pre.submit(p, max_new_tokens=A7_NEW,
                                   **a7_sampling(i))
                        for i, p in enumerate(prompts)]
                if run == "attribution":
                    wait_for(lambda: pre.metrics.counters["migrations_out"]
                             - m0 == len(prompts),
                             "23a: every request migrates")
                    torch.cuda.synchronize()
                    out["prefill"] = read_launches()
                    reset_launches()
                    dec.start()
                got = [f.result(600) for f in futs]
                torch.cuda.synchronize()
                if run == "attribution":
                    out["decode"] = read_launches()
                same_streams(got, want, f"23a {arm} {run}: disaggregated "
                                        f"vs unified")
            sp = pre.stats()
    finally:
        engine_mod.begin_export = begin
        migration_mod.PendingBundle.seal = seal
    dec.stop()
    sd = dec.stats()
    if sp["migration"]["migrations_out"] != 2 * len(prompts) or \
            sd["migration"]["migrations_in"] != 2 * len(prompts):
        raise AssertionError(f"23a {arm}: {sp['migration']} / "
                             f"{sd['migration']}")
    for eng, w, role in ((pre, warm[0], "prefill"), (dec, warm[1], "decode")):
        frozen(eng, w, f"23a {arm} {role}")
    p50 = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"  23a {arm}: streams identical (greedy and sampled, "
          f"{len(prompts)} requests x {A7_NEW} tokens, twice); a "
          f"request's bundle {int(np.mean(nbytes))} bytes; p50 a "
          f"request, second run: on the prefill scheduler export "
          f"{p50['export']:.2f} ms (gather, host copy enqueued); on the "
          f"handoff worker host copy wait {p50['copy']:.2f} ms, digest "
          f"{p50['digest']:.2f} ms, adopt (its digest check included) "
          f"{p50['adopt']:.2f} ms; TTFT p50 (submit to the engine's first "
          f"token) {p50['ttft']:.1f} ms disaggregated vs {ttft_u:.1f} ms "
          f"unified; handoff complete (submit to adopt's return) p50 "
          f"{p50['handoff']:.1f} ms [{card}]", flush=True)
    b1, b4 = out["prefill"]["flash_fwd"], out["decode"]["paged_attention"]
    if b1 <= 0 or b4 <= 0 or out["decode"]["flash_fwd"]:
        raise AssertionError(f"23a {arm}: prefill engine launches "
                             f"{out['prefill']}, decode engine "
                             f"{out['decode']}")
    print(f"  23a {arm}: launches on the prefill engine {out['prefill']}, on "
          f"the decode engine {out['decode']}; compiles frozen after "
          f"warmup() on both roles [{card}]", flush=True)
    return out


def tier_traffic(rs, vocab=VOCAB):
    systems = [rs.randint(0, vocab, (TIER_SYSTEM,)).astype(np.int32)
               for _ in range(TIER_FAMILIES)]
    return [np.concatenate([systems[f], rs.randint(0, vocab, (
        TIER_QUESTION,)).astype(np.int32)])
        for _ in range(TIER_ROUNDS) for f in range(TIER_FAMILIES)]


def tier_arm(torch, net, prompts, host_bytes, disk, rot=False):
    """(b) the traffic one request at a time; returns the streams, the
    stats, the launches and the promotion's install and verify times."""
    from mxnet_tpu_torch.resilience import FaultPlan
    eng = a7_engine(net, name=f"a7t_{host_bytes}_{int(rot)}",
                    host_pool_bytes=host_bytes, disk_tier_dir=disk,
                    **TIER_ENG)
    warm = eng.warmup()
    times = {"install": [], "verify": []}
    if eng._tier is not None:
        install, promote = eng._tier_install, eng._tier._do_promote

        def timed_install(*a, install=install):
            t0 = time.monotonic()
            ok = install(*a)
            times["install"].append((time.monotonic() - t0) * 1e3)
            return ok

        def timed_promote(*a, promote=promote):
            t0 = time.monotonic()
            promote(*a)
            times["verify"].append((time.monotonic() - t0) * 1e3)
        eng._tier_install = timed_install
        eng._tier._do_promote = timed_promote
    plan = FaultPlan()
    if rot:
        plan.corrupt_at("serving.tier_rot", at=1)
    torch.cuda.synchronize()
    reset_launches()
    outs = []
    with plan, eng:
        for p in prompts:
            outs.append(eng.infer(p, max_new_tokens=TIER_NEW))
            if eng._tier is not None:
                eng._tier.drain()
        s = eng.stats()
    torch.cuda.synchronize()
    frozen(eng, warm, f"23b tier {host_bytes}")
    if rot and plan.fired("serving.tier_rot") != 1:
        raise AssertionError("23b: the tier_rot fault did not fire")
    return outs, s, read_launches(), times


def tier_path(torch, net, card):
    import tempfile
    prompts = tier_traffic(np.random.RandomState(SEED + 23))
    off, s_off, _l, _t = tier_arm(torch, net, prompts, 0, None)
    with tempfile.TemporaryDirectory() as d:
        on, s_on, launches, times = tier_arm(torch, net, prompts,
                                             TIER_HOST_BYTES, d)
    same_streams(on, off, "23b: tier on vs off")
    t = s_on["tier"]
    if t["tier_demotes"] < 1 or t["tier_promotes"] < 1 or \
            t["tier_disk_spills"] < 1:
        raise AssertionError(f"23b: the tier did not demote, spill and "
                             f"promote: {t}")
    saved = (s_on["prefix_cache"]["prefix_tokens_saved"],
             s_off["prefix_cache"]["prefix_tokens_saved"])
    with tempfile.TemporaryDirectory() as d:
        rot, s_rot, _l, _t = tier_arm(torch, net, prompts,
                                      TIER_HOST_BYTES, d, rot=True)
    same_streams(rot, off, "23b: a rotted bundle's recompute")
    r = s_rot["tier"]
    if r["tier_verify_failures"] != 1 or r["tier_quarantines"] != 1:
        raise AssertionError(f"23b: the rotted bundle was not refused: {r}")
    if launches["flash_fwd"] <= 0 or launches["paged_attention"] <= 0:
        raise AssertionError(f"23b launches {launches}")
    print(f"  23b: {len(prompts)} requests, streams identical tier on/off; "
          f"{t['tier_demotes']} demotions, {t['tier_promotes']} promotions,"
          f" {t['tier_disk_spills']} disk spills ({t['tier_disk_loads']} "
          f"loads); hits: {s_on['prefix_cache']['prefix_hits']} prefix "
          f"(tier 1 and promoted) vs {s_off['prefix_cache']['prefix_hits']}"
          f" without the tier, {t['tier_hits']} tier-2; promote: verify "
          f"p50 {np.median(times['verify']):.2f} ms on the worker, install "
          f"p50 {np.median(times['install']):.2f} ms; prefill tokens saved "
          f"{saved[0]} vs {saved[1]}; one tier_rot: "
          f"{r['tier_verify_failures']} verify failure, "
          f"{r['tier_quarantines']} quarantined, stream unchanged "
          f"[{card}]", flush=True)
    return launches


def fleet_traffic(rs, vocab=VOCAB):
    systems = [rs.randint(0, vocab, (FLEET_SYSTEM,)).astype(np.int32)
               for _ in range(FLEET_FAMILIES)]
    return [np.concatenate([systems[f], rs.randint(0, vocab, (
        FLEET_TAIL,)).astype(np.int32)])
        for m in range(FLEET_MEMBERS) for f in range(FLEET_FAMILIES)]


def fleet_round(torch, fleet, prompts, launches=None):
    """One round of the traffic.  Its kernel launches add to
    ``launches``: the path counts served rounds only, never the rebuilds,
    restarts and warm-ups between them."""
    torch.cuda.synchronize()
    reset_launches()
    futs = [fleet.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    got = [f.result(600) for f in futs]
    torch.cuda.synchronize()
    if launches is not None:
        for k, n in read_launches().items():
            launches[k] += n
    return got


def fleet_path(torch, net, card):
    """(c) a FleetRouter over 3 replicas: affinity, a replica killed
    mid-traffic, a rolling restart, scale_up and scale_down."""
    from mxnet_tpu_torch.fleet import FleetRouter
    from mxnet_tpu_torch.resilience import FaultPlan

    def factory(name):
        return a7_engine(net, name=name, **FLEET_ENG)
    prompts = fleet_traffic(np.random.RandomState(SEED + 24))
    fleet = FleetRouter(factory=factory, num_replicas=3, name="a7f",
                        probation=0.5)
    warm = fleet.warmup()
    launches = dict.fromkeys(KERNELS, 0)
    with fleet:
        want = fleet_round(torch, fleet, prompts, launches)
        s = fleet.stats()
        agg = s["aggregate"]
        hit_rate = agg["prefix_hits"] / max(1, agg["prefix_hits"]
                                            + agg["prefix_misses"])
        routed = s["router"]["affinity_routed"]
        for name, rep in s["replicas"].items():
            if rep["stats"]["compile_cache"]["compiles"] != warm[name]:
                raise AssertionError(f"23c: {name} compiled on traffic")
        victim = fleet._handles[1].name
        plan = FaultPlan().raise_at(f"serving.scheduler@{victim}", at=3)
        with plan:
            # not counted: the killed replica's rebuild warms up in it
            got = fleet_round(torch, fleet, prompts)
        same_streams(got, want, "23c: a replica killed mid-traffic")
        if plan.fired(f"serving.scheduler@{victim}") != 1:
            raise AssertionError("23c: the kill did not fire")
        deaths = fleet.stats()["router"].get("replica_deaths", 0)
        wait_for(lambda: len(fleet._healthy()) == 3,
                 "23c: the killed replica is re-admitted")
        fleet.rolling_restart(timeout=300)
        same_streams(fleet_round(torch, fleet, prompts, launches), want,
                     "23c: after a rolling restart")
        new = fleet.scale_up(signals={"reason": "phase 23"})
        h = fleet._by_name[new]
        c0 = h.engine.stats()["compile_cache"]["compiles"]
        same_streams(fleet_round(torch, fleet, prompts, launches), want,
                     "23c: after scale_up")
        if h.engine.stats()["compile_cache"]["compiles"] != c0:
            raise AssertionError(f"23c: the new replica served "
                                 f"{h.routed} requests, compiles "
                                 f"{c0} -> {h.engine.stats()}")
        # the families whose affinity target leaves: their next request
        # lands on the survivor that took the seeds, and hits
        first = prompts[FLEET_FAMILIES:2 * FLEET_FAMILIES]
        owner = {i: fleet._order_candidates(p)[0][0].name
                 for i, p in enumerate(first)}
        gone = max(set(owner.values()),
                   key=lambda n: list(owner.values()).count(n))
        moved = [first[i] for i, n in owner.items() if n == gone]
        fleet.scale_down(replica=gone)
        seeds = fleet.stats()["router"].get("seeds_migrated", 0)
        hits0 = hits1 = 0
        for p, w in zip(moved, [want[FLEET_FAMILIES + i] for i, n in
                                owner.items() if n == gone]):
            before = sum(x.engine.metrics.counters.get("prefix_hits", 0)
                         for x in fleet._handles)
            same_streams(fleet_round(torch, fleet, [p], launches), [w],
                         "23c: a moved family after scale_down")
            hits1 += sum(x.engine.metrics.counters.get("prefix_hits", 0)
                         for x in fleet._handles) - before
            hits0 += 1
        same_streams(fleet_round(torch, fleet, prompts, launches), want,
                     "23c: after scale_down")
        restarts = sum(r["restarts"] for r in
                       fleet.health()["replicas"].values())
    if not seeds or not moved or hits1 != hits0:
        raise AssertionError(f"23c: scale_down seeds {seeds}; of the "
                             f"{hits0} moved families' requests {hits1} hit")
    if launches["flash_fwd"] <= 0 or launches["paged_attention"] <= 0:
        raise AssertionError(f"23c launches {launches}")
    print(f"  23c: 3 replicas, {len(prompts)} requests a round; affinity "
          f"routed {routed}, prefix hit rate {hit_rate:.3f}; replica "
          f"{victim} killed mid-round: 0 lost, streams identical "
          f"({deaths} deaths counted); rolling restart ({restarts} "
          f"restarts counted), "
          f"scale_up {new} served {h.routed} with 0 compiles on traffic, "
          f"scale_down {gone}: {seeds} seeds planted, its {hits0} "
          f"families' next requests hit {hits1} times on the survivors; "
          f"launches in the served rounds (the kill's round not counted) "
          f"{launches} [{card}]", flush=True)
    return launches


def a7_path(torch, card, prompts):
    """Phase 23.  Returns the launches by path: the prefill and decode
    engines of (a) (each arm's together), the tiered engine and the
    fleet."""
    from mxnet_tpu_torch.models import get_gpt2
    t_phase = time.monotonic()
    print(f"phase 23: disaggregated prefill/decode, the tiered prefix cache"
          f" and the fleet (GPT-2 124M, float32 and int8 pages) [{card}]",
          flush=True)
    net = get_gpt2("gpt2_124m", dropout=0.0)
    net.initialize(seed=SEED)
    by_path = {"disagg_prefill": dict.fromkeys(KERNELS, 0),
               "disagg_decode": dict.fromkeys(KERNELS, 0)}
    for kv_quant in (None, "int8"):
        got = disagg_arm(torch, net, prompts, card, kv_quant)
        for role in ("prefill", "decode"):
            for k in KERNELS:
                by_path[f"disagg_{role}"][k] += got[role][k]
    free(torch)
    by_path["tiered"] = tier_path(torch, net, card)
    free(torch)
    by_path["fleet"] = fleet_path(torch, net, card)
    print(f"phase 23: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return by_path


CHAOS_ARGS = ("--device", "cuda", "--corroborate", "--kills", "2",
              "--steps", "6")
CHAOS_TIMEOUT = 600


def chaos_path(torch, card):
    """Phase 24.  Returns the sweep's launches: its serving scenarios'
    and its training scenarios'."""
    import os
    t_phase = time.monotonic()
    print(f"phase 24: the chaos sweep on the card "
          f"(tools/chaos_sweep_torch.py {' '.join(CHAOS_ARGS)}) [{card}]",
          flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "chaos_report.json")
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "chaos_sweep_torch.py"),
         *CHAOS_ARGS, "--out", out], cwd=root, capture_output=True,
        text=True, timeout=CHAOS_TIMEOUT)
    for line in proc.stdout.splitlines():
        if line.startswith(("[PASS]", "[FAIL]", "chaos_sweep_torch:")):
            print(f"  {line}", flush=True)
    if not os.path.exists(out):
        raise AssertionError(f"the chaos sweep wrote no report (exit "
                             f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out) as f:
        rep = json.load(f)
    print(f"  sweep config: {json.dumps(rep['config'])}", flush=True)
    failed = [s["name"] for s in rep["scenarios"] if not s["passed"]]
    if failed or proc.returncode:
        detail = {s["name"]: s["detail"] for s in rep["scenarios"]
                  if not s["passed"]}
        raise AssertionError(
            f"chaos sweep: {failed} failed (exit {proc.returncode}): "
            f"{json.dumps(detail, default=str)[:6000]}\n"
            f"{proc.stderr[-2000:]}")
    names = {s["name"] for s in rep["scenarios"]}
    for want in ("training/kill_resume_determinism", "lockwitness",
                 "raceguard_corroboration", "forensics"):
        if want not in names:
            raise AssertionError(f"chaos sweep: no {want} scenario")
    corr = [s for s in rep["scenarios"]
            if s["name"] == "raceguard_corroboration"][0]["detail"]
    if corr["unexercised"] or corr["unmapped"]:
        raise AssertionError(f"corroboration: {corr['unexercised']} "
                             f"unexercised, {corr['unmapped']} unmapped")
    kr = [s for s in rep["scenarios"]
          if s["name"] == "training/kill_resume_determinism"][0]["detail"]
    if not kr["params_bit_identical"]:
        raise AssertionError("kill/resume is not bit-identical on the card")
    serve, train = rep["launches"]["serve"], rep["launches"]["train"]
    for group, got, want in (("serving", serve, ("flash_fwd",
                                                  "paged_attention")),
                             ("training", train, ("flash_fwd", "flash_dq",
                                                  "flash_dkv"))):
        for k in want:
            if not got.get(k):
                raise AssertionError(f"the chaos sweep's {group} scenarios "
                                     f"never launched {k}: {got}")
    print(f"  launches: serving {json.dumps(serve)} (references and "
          f"warm-ups apart: {json.dumps(rep['launches']['serve_aside'])}),"
          f" training {json.dumps(train)}; corroboration: {corr['mapped_sites']} "
          f"sites mapped, {corr['witnessed_sites']} witnessed, exempt "
          f"{sorted(corr['exempt'])}", flush=True)
    print(f"phase 24: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return {"chaos_serve": {k: serve.get(k, 0) for k in KERNELS},
            "chaos_train": {k: train.get(k, 0) for k in KERNELS}}


def host_ms(torch, fn, n=5) -> float:
    """Mean wall milliseconds of ``fn`` over ``n`` calls after one
    warm-up, each run ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def symbol_block_arm(torch, mx, card, d):
    """25a.  Returns the imported block's launches over its two gated
    calls, and the exported GPT-2 (for 25d)."""
    from mxnet_tpu_torch.gluon.block import SymbolBlock
    from mxnet_tpu_torch.models import get_gpt2
    net = get_gpt2("gpt2_124m", dropout=0.0).initialize(seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    toks = {b: torch.randint(0, VOCAB, (b, SYMBOL_T), generator=g,
                             device="cuda") for b in SYMBOL_BATCHES}
    net.hybridize(static_alloc=True)
    with torch.no_grad():
        want = {b: net(toks[b]) for b in SYMBOL_BATCHES}
        net_ms = host_ms(torch, lambda: net(toks[SYMBOL_BATCHES[0]]))
    t0 = time.monotonic()
    sym_f, par_f = net.export(f"{d}/gpt2")
    export_s = time.monotonic() - t0
    with open(sym_f) as f:
        meta = json.load(f)
    if not meta["symbolic_batch"]:
        raise AssertionError("25a: GPT-2 exported with a static batch")
    t0 = time.monotonic()
    blk = SymbolBlock.imports(sym_f, ["data"], par_f)
    torch.cuda.synchronize()
    import_s = time.monotonic() - t0
    total = {k: 0 for k in KERNELS}
    for b in SYMBOL_BATCHES:
        reset_launches()
        with torch.no_grad():
            out = blk(toks[b])
        torch.cuda.synchronize()
        got = read_launches()
        if got != {k: 12 if k == "flash_fwd" else 0 for k in KERNELS}:
            raise AssertionError(f"25a: the imported block at B{b} "
                                 f"launched {got}, not B1 12 times")
        for k, n in got.items():
            total[k] += n
        check(f"25a imported GPT-2 logits at B{b} x T{SYMBOL_T} vs the "
              "hybridized net's", maxabs(out, want[b]), TOL_SYMBOL)
    del want, out
    with torch.no_grad():
        blk_ms = host_ms(torch, lambda: blk(toks[SYMBOL_BATCHES[0]]))
    sizes = {k: os.path.getsize(meta[k]) / 2 ** 20
             for k in ("graph_file", "params_file")}
    print(f"  25a GPT-2 124M: export {export_s:.2f} s (program "
          f"{sizes['graph_file']:.2f} MiB, params "
          f"{sizes['params_file']:.1f} MiB), import {import_s:.2f} s; "
          f"B{SYMBOL_BATCHES[0]} x T{SYMBOL_T}: imported block "
          f"{blk_ms:.2f} ms against the hybridized net's graphed "
          f"{net_ms:.2f} ms; B1 {total['flash_fwd']} launches over "
          f"{len(SYMBOL_BATCHES)} calls [{card}]", flush=True)
    del blk
    return total, net


def module_arm(torch, mx, card):
    """25b: Module.fit of the classic MLP symbol on the card."""
    data = mx.sym.Variable("data")
    flat = mx.sym.reshape(data, shape=(-1, 784), name="flatten")
    h = mx.sym.Activation(mx.sym.FullyConnected(flat, num_hidden=128,
                                                name="fc1"),
                          act_type="relu", name="relu1")
    h = mx.sym.Activation(mx.sym.FullyConnected(h, num_hidden=64,
                                                name="fc2"),
                          act_type="relu", name="relu2")
    sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=10,
                                                     name="fc3"),
                               name="softmax")
    train = mx.io.MNISTIter(batch_size=MODULE_B, shuffle=True, seed=SEED)
    val = mx.io.MNISTIter(batch_size=MODULE_B, shuffle=False, seed=SEED + 1)
    n = sum(b.data[0].shape[0] for b in train)
    mx.random.seed(SEED)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    ends = []               # each epoch's end, the card drained

    def stamp(*_):
        torch.cuda.synchronize()
        ends.append(time.monotonic())

    mod.fit(train, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), eval_metric="acc",
            num_epoch=MODULE_EPOCHS, epoch_end_callback=stamp,
            batch_end_callback=mx.callback.Speedometer(MODULE_B, 10))
    # the first epoch binds and warms up: the rate is the later ones'
    timed = MODULE_EPOCHS - 1
    wall = ends[-1] - ends[0]
    acc = dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]
    where = mod._exec.arg_dict["fc1_weight"].context
    print(f"  25b Module.fit on {where} (synthetic MNIST "
          f"{train.synthetic}): {MODULE_EPOCHS} epochs of {n} samples; "
          f"epochs 2-{MODULE_EPOCHS} in {wall:.3f} s = "
          f"{timed * n / wall:.1f} samples/s, validation accuracy "
          f"{acc:.4f} [{card}]", flush=True)
    if where.device_type != "gpu" or not acc > MODULE_ACC:
        raise AssertionError(f"25b: accuracy {acc} on {where}, not above "
                             f"{MODULE_ACC} on the card")


def fuse_bn_arm(torch, mx, card):
    """25c: FUSE_BN on ResNet-50 v1 inference."""
    from mxnet_tpu_torch.gluon import nn
    net = resnet50()
    net.initialize(seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand((FUSE_B, VISION_SIZE, VISION_SIZE, 3), generator=g,
                   device="cuda") * 2 - 1
    with torch.no_grad():
        net(x)
        bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm)]
        for m in bns:           # statistics a trained net would carry
            c = m.running_mean.shape[0]
            m.running_mean.copy_(torch.randn(c, generator=g,
                                             device="cuda") * 0.1)
            m.running_var.copy_(torch.rand(c, generator=g,
                                           device="cuda") + 0.5)
            m.gamma.copy_(torch.rand(c, generator=g, device="cuda") + 0.5)
            m.beta.copy_(torch.randn(c, generator=g, device="cuda") * 0.1)
        net.hybridize(static_alloc=True)
        ref = net(x)
        before = host_ms(torch, lambda: net(x))
        out = net.optimize_for(x, backend="FUSE_BN")
        after = host_ms(torch, lambda: net(x))
    left = sum(isinstance(m, nn.BatchNorm) for m in net.modules())
    print(f"  25c ResNet-50 v1 NHWC B{FUSE_B}: {len(bns)} BatchNorms, "
          f"{left} left after FUSE_BN; {before:.2f} ms unfused, "
          f"{after:.2f} ms fused (hybridized, graphed) [{card}]",
          flush=True)
    if left:
        raise AssertionError(f"25c: {left} BatchNorms not folded")
    check("25c FUSE_BN outputs vs the unfused net's (relative)",
          relerr(out, ref), TOL_FUSE)


def onnx_arm(torch, mx, card, d, gpt2):
    """25d: ResNet-18 v1 through ONNX on the card; the flash-route GPT-2
    refused by name."""
    from mxnet_tpu_torch.models.vision import get_model
    net = get_model("resnet18_v1", classes=1000)
    net.initialize(seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (ONNX_B, 3, VISION_SIZE, VISION_SIZE)
    x = torch.rand(shape, generator=g, device="cuda") * 2 - 1
    with torch.no_grad():
        want = net(x)
    t0 = time.monotonic()
    path = mx.onnx.export_model(net, f"{d}/r18.onnx", shape)
    export_s = time.monotonic() - t0
    blk, args, _aux = mx.onnx.import_model(path)
    out = blk(x)
    print(f"  25d ResNet-18 v1 B{ONNX_B}: ONNX export {export_s:.2f} s, "
          f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, {len(args)} "
          f"initializers on {out.context} [{card}]", flush=True)
    check("25d ONNX ResNet-18 outputs vs the net's (relative)",
          relerr(out.tensor, want), TOL_ONNX)
    t0 = time.monotonic()
    try:
        mx.onnx.export_model(gpt2, f"{d}/gpt2.onnx",
                             (SYMBOL_BATCHES[0], SYMBOL_T),
                             input_dtype="int64")
    except mx.MXNetError as e:
        if "mxnet_tpu_torch::flash_fwd" not in str(e):
            raise
        print(f"  25d GPT-2 on the flash route refused in "
              f"{time.monotonic() - t0:.2f} s: {e} [{card}]", flush=True)
    else:
        raise AssertionError("25d: the flash-route GPT-2 exported to ONNX")


def symbolic_path(torch, card):
    """Phase 25.  Returns its launches by path."""
    import tempfile
    import mxnet_tpu_torch as mx
    t_phase = time.monotonic()
    print(f"phase 25: the symbolic surface (export/SymbolBlock, Module, "
          f"FUSE_BN, ONNX) [{card}]", flush=True)
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="mxtpu-phase25-") as d:
        by_path["symbol_block"], gpt2 = symbol_block_arm(torch, mx, card, d)
        free(torch)
        for name, arm in (("module_fit", lambda: module_arm(torch, mx,
                                                            card)),
                          ("fuse_bn", lambda: fuse_bn_arm(torch, mx,
                                                          card))):
            reset_launches()
            arm()
            by_path[name] = read_launches()
            if any(by_path[name].values()):
                raise AssertionError(f"25 {name} launched a kernel of the "
                                     f"port: {by_path[name]}")
            free(torch)
        onnx_arm(torch, mx, card, d, gpt2)
        del gpt2
    free(torch)
    print(f"phase 25: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return by_path


# ------------------ phase 26: sparse storage, mx.np and mx.image (A9.2)

def bow_net(sparse_grad):
    """``example/train_sparse_embedding.py``'s BowClassifier on the port:
    a BOW_VOCAB x BOW_DIM embedding (``sparse_grad`` as given) averaged
    over the tokens, then a Dense(2)."""
    from mxnet_tpu_torch.gluon import nn

    class BowClassifier(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(BOW_VOCAB, BOW_DIM,
                                      sparse_grad=sparse_grad)
            self.out = nn.Dense(2)

        def forward(self, toks):
            return self.out(self.embed(toks).mean(axis=1))

    return BowClassifier()


def bow_batches():
    """The example's task from the seed: each class's tokens from its own
    1000-row region.  BOW_WARM + BOW_STEPS (tokens, labels) batches."""
    rs = np.random.RandomState(SEED)
    out = []
    for _ in range(BOW_WARM + BOW_STEPS):
        y = rs.randint(0, 2, (BOW_B,)).astype(np.int32)
        toks = (rs.randint(0, 1000, (BOW_B, BOW_T))
                + y[:, None] * 1000).astype(np.int32)
        out.append((toks, y))
    return out


def bow_arm(torch, mx, init, batches, sparse_grad, opt):
    """One Trainer arm from the weights ``init``: BOW_WARM steps, then
    BOW_STEPS timed.  Returns its ms/step, the peak MiB it allocated
    above what was allocated before it, the rows each sparse gradient
    held, its losses and its final weights (host)."""
    free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net = bow_net(sparse_grad)
    net.initialize()
    with mx.autograd.pause():
        net(mx.nd.array(batches[0][0], dtype="int32"))   # settle Dense
    params = net.collect_params()
    for k, p in params.items():
        p.set_data(init[k])
    lr = BOW_ADAM_LR if opt == "adam" else BOW_SGD_LR
    tr = mx.gluon.Trainer(params, opt, {"learning_rate": lr})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    emb = params["embed.weight"]
    rows, losses = [], []

    def step(i):
        toks, y = batches[i]
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(toks, dtype="int32")),
                           mx.nd.array(y, dtype="int32"))
        loss.backward()
        if sparse_grad:
            g = emb.grad()
            if g.stype != "row_sparse" or g._data is not None:
                raise AssertionError("26a the sparse gradient densified")
            rows.append(int(g._sp_indices.numel()))
        tr.step(BOW_B)
        losses.append(loss.mean().tensor)

    for i in range(BOW_WARM):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(BOW_WARM, BOW_WARM + BOW_STEPS):
        step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / BOW_STEPS
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    weights = {k: p.data().asnumpy() for k, p in params.items()}
    out = dict(ms=ms, peak=peak, rows=rows, weights=weights,
               losses=[float(x) for x in losses])
    del net, tr, params, emb
    free(torch)
    return out


def bow_plain_adam(init, batches):
    """A plain numpy (float64) forward, backward and lazy Adam of the
    BowClassifier over ``batches``: the gradient of the summed
    cross-entropy over the batch, rescaled by 1 / BOW_B as
    ``Trainer.step`` does; the embedding's rows updated only where a
    batch looks them up, with their own step counts' bias correction
    (every row shares the count, as the lazy update keeps one count a
    parameter).  Returns the final weights."""
    w = {k: v.astype(np.float64) for k, v in init.items()}
    m = {k: np.zeros_like(v) for k, v in w.items()}
    v2 = {k: np.zeros_like(v) for k, v in w.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t, (toks, y) in enumerate(batches, start=1):
        e = w["embed.weight"][toks]                        # (B, T, D)
        h = e.mean(axis=1)
        logits = h @ w["out.weight"].T + w["out.bias"]
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        p[np.arange(len(y)), y] -= 1.0
        d = p / BOW_B                                      # rescale_grad
        grads = {"out.weight": d.T @ h, "out.bias": d.sum(0)}
        dh = d @ w["out.weight"]
        uniq, inv = np.unique(toks.ravel(), return_inverse=True)
        rows = np.zeros((len(uniq), BOW_DIM))
        np.add.at(rows, inv, np.repeat(dh / BOW_T, BOW_T, axis=0))
        coef = BOW_ADAM_LR * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        for k, g in grads.items():
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            w[k] = w[k] - coef * m[k] / (np.sqrt(v2[k]) + eps)
        k = "embed.weight"
        m[k][uniq] = b1 * m[k][uniq] + (1 - b1) * rows
        v2[k][uniq] = b2 * v2[k][uniq] + (1 - b2) * rows * rows
        w[k][uniq] = w[k][uniq] - coef * m[k][uniq] / (
            np.sqrt(v2[k][uniq]) + eps)
    return w


def rel_maxabs(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def sparse_part(torch, mx, card):
    """26a: the sparse embedding trained at its width, in three Trainer
    arms one after another (lazy Adam on the sparse gradient, Adam with
    sparse_grad=False, plain SGD on the sparse and on the dense
    gradient), row_sparse_pull and sparse.dot at the batch's size."""
    from mxnet_tpu_torch.ndarray import sparse
    batches = bow_batches()
    mx.random.seed(SEED)
    net = bow_net(True)
    net.initialize(mx.init.Xavier())
    with mx.autograd.pause():
        net(mx.nd.array(batches[0][0], dtype="int32"))
    init = {k: p.data().tensor.detach().clone()
            for k, p in net.collect_params().items()}
    init_host = {k: t.cpu().numpy() for k, t in init.items()}
    del net
    print(f"26a BowClassifier: Embedding({BOW_VOCAB}, {BOW_DIM}) and "
          f"Dense(2), batch {BOW_B} x {BOW_T} tokens, {BOW_WARM} warm-up "
          f"and {BOW_STEPS} timed steps an arm [{card}]", flush=True)
    arms = {}
    for name, sg, opt in (("adam sparse", True, "adam"),
                          ("adam dense", False, "adam"),
                          ("sgd sparse", True, "sgd"),
                          ("sgd dense", False, "sgd")):
        arms[name] = a = bow_arm(torch, mx, init, batches, sg, opt)
        if not all(np.isfinite(a["losses"])):
            raise AssertionError(f"26a {name} losses not finite")
        print(f"  {name}: {a['ms']:.3f} ms/step, peak {a['peak']:.1f} MiB "
              f"above the arm's start, loss {a['losses'][0]:.4f} -> "
              f"{a['losses'][-1]:.4f}"
              + (f", rows touched a step {min(a['rows'])}-{max(a['rows'])}"
                 if a["rows"] else "") + f" [{card}]", flush=True)
    rows = arms["adam sparse"]["rows"] + arms["sgd sparse"]["rows"]
    if max(rows) > BOW_B * BOW_T:
        raise AssertionError(f"26a a sparse gradient held {max(rows)} rows")
    saved = arms["adam dense"]["peak"] - arms["adam sparse"]["peak"]
    print(f"  26a the sparse arm's peak is {saved:.1f} MiB below the dense "
          f"arm's; the dense gradient is "
          f"{BOW_DENSE_GRAD_BYTES / 2 ** 20:.1f} MiB [{card}]", flush=True)
    if saved * 2 ** 20 < BOW_DENSE_GRAD_BYTES:
        raise AssertionError("26a the sparse arm's peak is not a dense "
                             "gradient below the dense arm's")
    for k in init_host:
        n = BOW_STEPS + BOW_WARM
        check(f"26a SGD sparse vs dense gradient, {k} after {n} steps "
              f"(max-abs over max-abs) [{card}]",
              rel_maxabs(arms["sgd sparse"]["weights"][k],
                         arms["sgd dense"]["weights"][k]), TOL_BOW_SGD)
    plain = bow_plain_adam(init_host, batches)
    for k in init_host:
        check(f"26a lazy Adam on the card vs a plain numpy lazy Adam on the "
              f"CPU, {k} (max-abs over max-abs) [{card}]",
              rel_maxabs(arms["adam sparse"]["weights"][k], plain[k]),
              TOL_BOW_ADAM)
    untouched = np.setdiff1d(np.arange(BOW_VOCAB),
                             np.unique(np.concatenate(
                                 [t.ravel() for t, _ in batches])))
    if not np.array_equal(arms["adam sparse"]["weights"]["embed.weight"]
                          [untouched], init_host["embed.weight"][untouched]):
        raise AssertionError("26a lazy Adam moved a row no batch touched")
    del arms
    table = init["embed.weight"]
    kv = mx.kv.create("device")
    kv.init("embed", mx.nd.NDArray(table))
    ids = np.random.RandomState(SEED + 1).randint(0, BOW_VOCAB,
                                                  BOW_PULL_IDS)
    out = sparse.zeros("row_sparse", (BOW_VOCAB, BOW_DIM))
    t0 = time.perf_counter()
    kv.row_sparse_pull("embed", out=out, row_ids=mx.nd.array(
        ids, dtype="int64"))
    torch.cuda.synchronize()
    pull_ms = (time.perf_counter() - t0) * 1e3
    want = np.unique(ids)
    if out._data is not None or \
            out._sp_indices.cpu().numpy().tolist() != want.tolist() or \
            not torch.equal(out._sp_data, table[torch.from_numpy(
                want).to(table.device)]):
        raise AssertionError("26a row_sparse_pull did not return exactly "
                             "the rows asked for")
    print(f"  26a row_sparse_pull of {BOW_PULL_IDS} ids ({len(want)} "
          f"unique) from a {BOW_VOCAB}-row key: exact, {pull_ms:.3f} ms "
          f"[{card}]", flush=True)
    del kv
    toks = batches[0][0]
    indptr = np.arange(0, BOW_B * BOW_T + 1, BOW_T)
    csr = sparse.csr_matrix((np.ones(BOW_B * BOW_T, np.float32),
                             toks.ravel(), indptr),
                            shape=(BOW_B, BOW_VOCAB))
    got = sparse.dot(csr, mx.nd.NDArray(table)).tensor
    want_t = table[torch.from_numpy(toks).to(table.device).long()].sum(1)
    check(f"26a sparse.dot of the batch's bag of words ({BOW_B} x "
          f"{BOW_VOCAB}, {BOW_T} a row) vs the gather-and-sum (max-abs "
          f"over max-abs) [{card}]",
          float((got - want_t).abs().max() / want_t.abs().max()),
          TOL_BOW_DOT)
    return dict(rows=[min(rows), max(rows)], saved_mib=saved)


def np_card_part(torch, mx, card):
    """26b: every float op of the reference's mx.np table once on a CUDA
    array and once on the CPU (tools/np_cases.py), and the gradients of
    its sample of differentiable ops."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import np_cases as C
    np_mod = mx.np

    def on(ctx):
        return lambda a: np_mod.array(a, dtype=a.dtype, ctx=ctx)

    def unsign(r):
        return [unsign(x) for x in r] if isinstance(r, list) else (
            np.abs(r) if isinstance(r, np.ndarray) else r)

    cases = [c for c in C.cases() if c.floating()]
    checked, failed = 0, []
    for c in cases:
        with mx.gpu(0):
            got = C.run(c, np_mod, on(mx.gpu(0)))
        with mx.cpu():
            want = C.run(c, np_mod, on(mx.cpu()))
        if got[0] != "ok":
            failed.append(f"{c.id}: raised {got[1]} on the card")
            continue
        if c.id in NP_SIGN_FREE:
            got, want = ("ok", unsign(got[1])), ("ok", unsign(want[1]))
        diff = C.agree(c, want, got)
        if diff:
            failed.append(diff)
        checked += 1
    grads, worst = 0, 0.0
    for c in (c for c in C.cases() if c.grad):
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                xs = []

                def make(a):
                    x = on(ctx)(a)
                    if a.dtype.kind == "f":
                        x.attach_grad()
                        xs.append(x)
                    return x
                args = C._args(c.args, np_mod, make)
                kw = C._args(c.kwargs, np_mod, make)
                with mx.autograd.record():
                    out = C.resolve(c.name, np_mod)(*args, **kw)
                    out = out[0] if isinstance(out, list) else out
                    (out * out).sum().backward()
                res.append([x.grad.asnumpy() for x in xs])
        for g, w in zip(*res):
            err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            worst = max(worst, err)
            if err > TOL_NP_GRAD:
                failed.append(f"{c.id} gradient: {err:.3e}")
        grads += 1
    print(f"  26b mx.np on the card vs the CPU: {checked} float ops of "
          f"{len(cases)} checked at their tolerances, {grads} gradients "
          f"(worst {worst:.3e}, tol {TOL_NP_GRAD:g}); {len(failed)} "
          f"failed [{card}]", flush=True)
    if failed:
        raise AssertionError(f"26b mx.np disagrees on the card: {failed}")
    return dict(ops=checked, grads=grads, worst_grad=worst)


def image_rec(root):
    """IMG_N seeded IMG_SRC^2 RGB images (smooth: seeded 32^2 noise
    resized bilinear), JPEG-packed with their labels into one .rec."""
    from PIL import Image
    from mxnet_tpu_torch import recordio
    path = os.path.join(root, "images.rec")
    rs = np.random.RandomState(SEED)
    w = recordio.MXRecordIO(path, "w")
    for i in range(IMG_N):
        small = rs.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(small).resize(
            (IMG_SRC, IMG_SRC), Image.BILINEAR))
        w.write(recordio.pack_img(recordio.IRHeader(
            0, float(rs.randint(0, 100)), i, 0), img, quality=IMG_QUALITY))
    w.close()
    return path


def image_iter(mx, path):
    """An ImageIter over ``path`` with IMG_AUG's augmenters, shuffled,
    from the seeds (Python's ``random`` and numpy's, which it draws
    from)."""
    import random
    random.seed(SEED)
    np.random.seed(SEED)
    augs = mx.image.CreateAugmenter(
        data_shape=(3, VISION_SIZE, VISION_SIZE), **IMG_AUG)
    return mx.image.ImageIter(batch_size=VISION_B,
                              data_shape=(3, VISION_SIZE, VISION_SIZE),
                              path_imgrec=path, aug_list=augs, shuffle=True)


def image_part(torch, mx, card, root):
    """26c: mx.image feeding ResNet-50 v1 NHWC amp through
    DevicePrefetcher, against the same step on resident batches."""
    from mxnet_tpu_torch.data import DevicePrefetcher
    from mxnet_tpu_torch.parallel import ShardedTrainer
    t0 = time.perf_counter()
    path = image_rec(root)
    print(f"26c {IMG_N} seeded {IMG_SRC}x{IMG_SRC} JPEG records "
          f"({os.path.getsize(path) / 2 ** 20:.1f} MiB) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy())
            for b in image_iter(mx, path)]
    host_s = time.perf_counter() - t0
    n_steps = len(want)
    print(f"  26c ImageIter alone (PIL decode, {len(IMG_AUG)} augmenter "
          f"settings, one host thread): {n_steps * VISION_B / host_s:.1f} "
          f"images/s [{card}]", flush=True)
    resident = [(torch.from_numpy(d).cuda().permute(0, 2, 3, 1)
                 .contiguous(), torch.from_numpy(l).cuda())
                for d, l in want]
    mx.amp.init("bfloat16")
    try:
        net = resnet50()
        net.initialize(seed=SEED)
        tr = ShardedTrainer(net, "sgd", loss=vision_ce,
                            optimizer_params=VISION_OPT)
        first = float(tr.step(resident[0][0], (resident[0][1],)))
        torch.cuda.synchronize()
        pf = tr.attach_data_source(DevicePrefetcher(image_iter(mx, path),
                                                    depth=IMG_DEPTH))
        waits, losses, fed = [], [first], []
        t0 = time.perf_counter()
        for _ in range(n_steps):
            b = pf.next()
            waits.append(pf.last_wait_seconds)
            d, l = b.data[0].tensor, b.label[0].tensor
            fed.append((d, l))
            losses.append(tr.step(d.permute(0, 2, 3, 1).contiguous(),
                                  (l,)))
        torch.cuda.synchronize()
        fed_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        pf.close()
        same = len(fed) == n_steps and all(
            np.array_equal(d.cpu().numpy(), w[0])
            and np.array_equal(l.cpu().numpy(), w[1])
            for (d, l), w in zip(fed, want))
        del fed
        t0 = time.perf_counter()
        for d, l in resident:
            losses.append(tr.step(d, (l,)))
        torch.cuda.synchronize()
        res_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    finally:
        mx.amp.reset()
    losses = [float(x) for x in losses]
    p50, mx_ = quantiles(waits)
    print(f"  26c ResNet-50 v1 NHWC amp B{VISION_B}: fed by ImageIter -> "
          f"DevicePrefetcher {fed_ms:.1f} ms/step, input wait p50 "
          f"{p50:.1f} ms, max {mx_:.1f} ms; resident {res_ms:.1f} ms/step; "
          f"losses {[round(x, 4) for x in losses]} [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("26c losses not finite")
    if not same:
        raise AssertionError("26c the prefetched batches differ from a "
                             "second ImageIter's from the same seeds")
    print(f"  26c the {n_steps} fed batches equal a second ImageIter's from "
          f"the same seeds, bit for bit", flush=True)
    del tr, net, resident
    free(torch)
    return dict(host_images_per_s=n_steps * VISION_B / host_s,
                fed_ms=fed_ms, resident_ms=res_ms, wait_p50_ms=p50,
                wait_max_ms=mx_)


def a92_path(torch, card):
    """Phase 26: queue A9.2 on the card, float32 (TF32 off) but 26c's
    amp.  Launches none of the port's kernels (gated by the caller)."""
    import tempfile
    import mxnet_tpu_torch as mx
    t_phase = time.monotonic()
    out = {"a": sparse_part(torch, mx, card)}
    free(torch)
    print("26b mx.np on the card:", flush=True)
    out["b"] = np_card_part(torch, mx, card)
    free(torch)
    with tempfile.TemporaryDirectory() as d:
        out["c"] = image_part(torch, mx, card, d)
    print(json.dumps({"a92": out}), flush=True)
    print(f"phase 26: {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)


def write_phase_seconds(seconds):
    """Print the seconds of every phase and write them to
    ``chiprun_out/chip_smoke_phases.json`` beside this script."""
    import os
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "chiprun_out")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "chip_smoke_phases.json"), "w") as f:
        json.dump(seconds, f, indent=1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.utils import native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    seconds = {}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.monotonic()
        try:
            yield
        finally:
            seconds[name] = round(time.monotonic() - t0, 1)

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    with phase("1"):
        secs = native.build()
    print(f"kernel build: {secs:.1f} s", flush=True)
    for name in native.KERNELS:
        print(f"--- ptxas {name}:\n{native.build_log(name).strip()}")
    timer = Timer(torch, dev)
    prompts = make_prompts()
    with phase("2"):
        fwd_f32, fwd_bf16, fwd_lang = flash_cases(torch, dev, timer, card)
        bwd, bwd_lang = flash_bwd_cases(torch, dev, timer, card)
        ring_modes = ring_mode_cases(torch, dev, timer, card)
        cross_ms = cross_case(torch, dev, timer, card)
        paged_main, paged_multi = paged_cases(torch, dev, timer, card,
                                              [len(p) for p in prompts])
    record = {"flash_fwd": fwd_f32, **bwd["float32"],
              "paged_attention": paged_main}
    record_bf16 = {"flash_fwd": fwd_bf16, **bwd["bfloat16"]}
    with phase("3"):
        serve_launches, int8_logits = main_path(torch, card, prompts)
    by_path = {"serve": serve_launches}
    with phase("4"):
        by_path["train"], train_losses = train_path(torch, card)
    gc.collect()                 # the training phase's net and trainer
    torch.cuda.empty_cache()
    toks, labels = train_batch()
    with phase("5"):
        by_path["gluon"], gluon_losses, gluon_grads = gluon_path(
            torch, card, toks, labels, train_losses)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mlp"] = {name: 0 for name in KERNELS}
    reset_launches()
    with phase("6"):
        mlp_path(torch, card)
    if any(read_launches().values()):
        raise AssertionError("the MLP program launched a kernel of the port")
    gc.collect()
    torch.cuda.empty_cache()
    with phase("7"):
        by_path["amp"] = amp_path(torch, card, toks, labels,
                                  gluon_losses[0], gluon_grads)
    del gluon_grads
    gc.collect()
    torch.cuda.empty_cache()
    with phase("8"):
        by_path["moe"] = moe_path(torch, card, toks, labels)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("9"):
        features, multi_by_path = features_path(torch, card, prompts)
    by_path.update(features)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    with phase("10"):
        vision_path(torch, card)
    by_path["vision"] = read_launches()
    if any(by_path["vision"].values()):
        raise AssertionError(f"the vision phase launched a kernel of the "
                             f"port: {by_path['vision']}")
    free(torch)
    with phase("11"):
        by_path["bert"], by_path["bert_amp"] = bert_path(torch, card)
    with phase("12"):
        by_path["nmt"], nmt_split = nmt_path(torch, card)
    with phase("13"):
        by_path["lstm"] = lstm_path(torch, card)
    free(torch)
    reset_launches()
    with phase("14"):
        ops_path(torch, card, timer, dev)
    by_path["ops"] = read_launches()
    if any(by_path["ops"].values()):
        raise AssertionError(f"the ops phase launched a kernel of the "
                             f"port: {by_path['ops']}")
    free(torch)
    with phase("15"):
        by_path["programs"], by_path["forward"] = programs_path(
            torch, card, prompts)
    free(torch)
    with phase("16"):
        by_path.update(training_programs_path(torch, card))
    free(torch)
    with phase("17"):
        by_path["resilient"] = resilient_path(torch, card)
    free(torch)
    with phase("18"):
        by_path["hardened"] = hardened_path(torch, card, prompts,
                                            int8_logits)
    free(torch)
    reset_launches()
    with phase("19"):
        by_path["data"], vision_launches = data_path(torch, card)
    for dtype, counts in vision_launches.items():
        if any(counts.values()):
            raise AssertionError(f"19b {dtype} launched a kernel of the "
                                 f"port: {counts}")
        by_path[f"data_vision_{dtype}"] = counts
    free(torch)
    with phase("20"):
        ring_launches, ring_by_mode = parallel_path(torch, card)
    by_path["parallel_ring"] = ring_launches["ring"]
    by_path["parallel_ulysses"] = ring_launches["ulysses"]
    free(torch)
    with phase("21"):
        by_path.update(parallel_models_path(torch, card))
    free(torch)
    with phase("22"):
        by_path.update(shard_path(torch, card))
    free(torch)
    with phase("23"):
        by_path.update(a7_path(torch, card, prompts))
    free(torch)
    with phase("24"):
        by_path.update(chaos_path(torch, card))
    free(torch)
    with phase("25"):
        by_path.update(symbolic_path(torch, card))
    free(torch)
    reset_launches()
    with phase("26"):
        a92_path(torch, card)
    by_path["a92"] = read_launches()
    if any(by_path["a92"].values()):
        raise AssertionError(f"phase 26 launched a kernel of the port: "
                             f"{by_path['a92']}")
    write_phase_seconds(seconds)
    # each kernel's launches on the path that is its own: the training
    # path for the flash kernels, the serving path for paged attention;
    # the flash kernels' bf16 numbers (phase 2 at the training shape)
    # with the amp arm's launches
    own = {name: "serve" if name == "paged_attention" else "train"
           for name in KERNELS}
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name],
                    launches=by_path[own[name]][name],
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    **record[name]) for name in KERNELS]
    for k in kernels:
        if k["name"] == "paged_attention":
            # phase 9's paths: B4's launches with Tq > 1, and its numbers
            # at the chunk and verify shapes (phase 2)
            k["multi_query_launches_by_path"] = multi_by_path
            k.update(paged_multi)
        if k["name"] in record_bf16:
            k["bfloat16"] = dict(launches=by_path["amp"][k["name"]],
                                 **record_bf16[k["name"]])
            # phases 11-12's shapes (phase 2), the NMT step's launches
            # by attention, the cross-attention call's times
            k["shapes"] = (fwd_lang if k["name"] == "flash_fwd" else
                           {t: r[k["name"]] for t, r in bwd_lang.items()})
            k["nmt_launches_by_attention"] = {
                kind: c[k["name"]] for kind, c in nmt_split.items()}
            k["cross_fwd_bwd_ms"] = cross_ms
    for mode in ("partial", "given"):
        # B2's ring modes: phase 20 (c)'s ring on rank 0
        kernels.append(dict(name=f"flash_dq[{mode}]", route="cuda",
                            source="mxnet_tpu_torch/csrc/flash_dq_ring.cu",
                            replaces=REPLACES["flash_dq"],
                            launches=ring_by_mode[mode],
                            **ring_modes[mode]))
    print(f"chip_smoke: {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase20-rank"]:
        sys.exit(phase20_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--phase21-rank"]:
        sys.exit(phase21_rank(sys.argv[3]))
    if sys.argv[1:2] == ["--phase22-rank"]:
        sys.exit(phase22_rank(sys.argv[3]))
    sys.exit(main())
