#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (incubator_mxnet_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line; any failed check exits non-zero:

1. build       compile every csrc/*.cu of the port with nvcc (sm_90a);
               ptxas's registers and spills for each kernel (those of
               the fp32 backward at each head dim also on their own,
               ``tf32_bwd``); each kernel's HGMMA (wgmma) and HMMA
               (mma.sync) count in the SASS (cuobjdump): every flash
               kernel (flash_fwd, flash_dq, flash_dkv; bf16 and fp32 as
               split-TF32) at each head dim must have HGMMA; the fp32
               forward at every head dim, the fp32 flash_dq and
               flash_dkv and the bf16 forward at D=64 no spills; no
               wgmma serialized by ptxas; csrc/nms_sweep.cu's kernels
               (the pair test, the sweep at one and at four words a
               thread, and with the words in shared memory) present and
               without spills.
2. kernels     hold flash_fwd against its plain PyTorch version on the
               card at the main paths' shapes (fp32 forward and serve,
               bf16 train) and a sweep of others, and time kernel, plain
               version, library call and bound; each case names the
               kernel it ran (fp32: flash_fwd_tf32_kernel, bf16:
               flash_fwd_tc_kernel).
3. kernels_bwd the same for flash_dq and flash_dkv against the plain
               backward, at the train path's shape (bf16 and fp32) and
               the forward's sweep; each case names the kernels it ran
               (fp32: flash_dq_tf32_kernel and flash_dkv_tf32_kernel,
               bf16: flash_dq_tc_kernel and flash_dkv_tc_kernel) and
               checks that a second launch on the same inputs gives
               bit-identical dq, dk and dv (no atomics).
4. forward     TransformerLM at bench.py's transformer width (vocab
               32000, d 1024, 12 layers, 16 heads, max_len 1024; seeded
               Xavier weights) scores B=8 x L=1024 tokens; logits are
               finite, the flash kernel ran once per layer, and the
               logits match the same weights on the CPU's plain path.
5. serve       answers requests with ``generate`` (4 prompts of 128
               tokens, 2 of 512, greedy, 32 new tokens); each answer
               equals the teacher-forced argmax of ``forward``, and each
               prefill ran the kernel once per layer.
6. serve_engine  serving.ServingEngine (max_batch 8, block_size 16,
               512 blocks, prefix cache on) on the forward phase's
               model, with bench.py's serving traffic at that width: 16
               requests submitted at once, the even ones sharing a
               256-token system prompt, each with its own 64 to 448
               tokens (numpy seed 7), 32 new tokens each.  Every request
               finishes with no leaked block; the decode step is
               captured once (trace_counts["decode"] == 1); each
               request's tokens equal generate()'s but where generate's
               top-two logits are within 1e-5 relative (printed, and
               that request compared no further); one replay of the
               captured step equals the step called eagerly on clones
               of the pools and buffers, bit for bit; no flash kernel
               runs.  Prints decode ms per iteration, tokens/s, TTFT
               p50/p99, the busy share over profiled steps, the graph's
               device ms, the step's byte bound and the prefix-cache
               hits.
7. fleet       the serving fleet and the engine's operability hooks at
               serve_engine's width and traffic, every request held
               against an in-process engine over the replica CLI's
               _build_tiny of that width, but at printed top-two ties
               of the forward's logits within 1e-5; no flash kernel
               runs.  (i) with telemetry on: the counters equal the
               traffic's (requests, tokens, prefill tokens, prefix
               hits), one decode capture, and one synchronizing CUDA
               call a decode-only iteration (set_sync_debug_mode
               "warn"); decode ms per iteration with MXTPU_TELEMETRY=0
               and =1 in turns; (ii) serve:step:2:hang of 0.05 s
               against step_timeout=0.02: one serve_step_overrun of at
               least 0.05 s and a flight-recorder dump whose first line
               names it, the tokens unchanged; (iii) num_blocks="auto":
               the block count, the plan, the peak the engine allocated
               against it; under MXTPU_HBM_BYTES of half the weights a
               MemoryPlanError before any pool; (iv) perf_report's
               roofline ms for one decode step beside the measured
               decode ms, serving_mfu finite and in (0, 1); (v) three
               replica processes (python -m incubator_mxnet_tpu_torch.
               serving.replica, 512 blocks each, prefix cache on)
               behind a ServingRouter here, replica 0 under
               router:replica:3:kill, the router under router:net:9:
               hang: replica 0 exits 1, a re-dispatch counted, one
               router_terminal a request, every request finished, the
               survivors' pools holding only their prefix caches'
               blocks, the shared-prompt requests ending on fewer
               replicas than the others; tokens/s and TTFT through the
               router beside the engine's (and again through the two
               survivors, warm), the recovery seconds after the death,
               each survivor's peak memory; (vi) a second
               batch drained once tokens flow: both survivors exit 0,
               each snapshot restores into a fresh engine on the card,
               no request lost.
8. train       (i) one fp32 loss and every parameter's gradient at B=1 x
               L=256 on the card equal the same weights' on the CPU's
               plain path; (ii) bench.py's training step (B=8 x L=1024,
               Adam lr 1e-4, bf16 compute over fp32 masters, its LM
               loss and tokens), 2 warm-up and 8 timed steps, twice from
               the seeded weights: through ``_eager_call`` (op by op)
               and as users call it (the first call captures the step as
               one CUDA graph, every call replays it): losses finite and
               falling, the two ways' losses and parameters equal bit
               for bit, one capture; each eager step launched flash_fwd,
               flash_dq and flash_dkv once per layer, the captured step
               at its first call only (warm-up and capture), and a
               profiled replay ran each once per layer on the card;
               each way's step ms (the timed steps back to back, one
               synchronize at the end, over their count; the median of
               the steps' spans between CUDA events beside it),
               tokens/s, MFU, peak memory and profile (busy share); the
               kernel table counts the captured steps' launches, the
               eager ones stay in this record; (iii) the default fp32 step
               (compute_dtype=None) the same way, 2 warm-up and 3 timed
               steps; (iv) dropout in a captured step (a small model,
               rate 0.1): replays draw fresh masks, a reseeded generator
               repeats them, the eager step from the same seed gives the
               same losses, and the Dropout op captured alone keeps 1 -
               rate within 5 binomial standard deviations.
9. resnet      bench.py's headline workload on the port's Gluon path, no
               hand kernel on it: (i) resnet50_v1() from seed 0 on the
               card and on the CPU (load_gluon_params), fp32 with TF32
               off, one ShardedTrainStep SGD step at B=2 x 3x224x224:
               losses within 1e-4 rel, gradients within 1e-2 (median
               3e-3; the CPU's own floor printed), BatchNorm moving
               stats within 1e-4; (ii) bench.py's step: functionalize,
               ShardedTrainStep(sgd, lr 0.1, momentum 0.9, wd 1e-4,
               bf16 over fp32 masters) at B=32 on bench.py's batch, 3
               warm-up and 20 timed steps, eager and captured as in
               train (ii) with cuDNN's deterministic algorithms (its
               default fp32 ones differ from run to run even eagerly):
               losses finite and falling, losses, parameters and moving
               stats equal bit for bit, one capture; then captured with
               cuDNN's defaults, the step as users run it; each way's
               step ms (as in train (ii)), img/s, peak memory, MFU against
               989 TFLOP/s from the port's own count of train FLOPs per
               image (convolution and dense shapes, within 2% of
               bench.py's 3 x 7.826e9), one profiled step's device ms by
               class (conv, batchnorm, pool, matmul, optimizer, other),
               busy share and cProfile; (iii) the same in fp32; (iv) 23
               steps of the imperative loop (autograd.record, SoftmaxCross
               EntropyLoss, backward, gluon.Trainer.step(32)) with
               cuDNN's deterministic algorithms: losses finite and
               falling, equal bit for bit to (iii)'s eager step's,
               every parameter with a gradient.
               (The loss rises for steps 3 to 7 at lr 0.1 before it
               falls, so each run takes 23 steps.)  Each
               kernel's launches on this path are counted ("resnet").
10. rtc        the user-kernel path (rtc_examples.py): builds the four
               CUDA twins of the Pallas user kernels through
               rtc.compile_kernel (ptxas report), holds each against
               its plain version at the JAX test's shape and at fp32
               (8192, 4096), and times kernel, plain version, library
               call and bound; holds scale bit for bit at an odd offset,
               an n not a multiple of 4 and n < 4 (scale_edges), and
               times it against torch.mul in turns, beside the same
               source on a resident grid (scale_turns); drives each twin through nd and
               autograd (rtc_ops); runs the example's eager loop grown
               to an SGD step at full width, x (8192, 1024) . w (1024,
               4096) through scale_shift_relu against t (8192, 4096),
               5 steps (rtc_train): losses finite and falling, one
               fused_scale_shift_relu launch per step, and one step's
               loss and gradient equal the CPU's plain path; times the
               host cost of an eager call; and checks that
               nd._internal._flash_attention launches flash_fwd.  The
               eager-call timing (dispatch) also profiles the rtc
               kernel's calls, alone and through nd, with cProfile
               (host_profile).

11. module     the symbolic frontend: (i) the MNIST MLP through
               Module.fit to validation accuracy 0.95; (ii) ResNet-50 as
               a Symbol (_to_symbol under SoftmaxOutput) through Module
               at B=32, fp32: card vs CPU at B=2, the first loss vs the
               Gluon fp32 step's, 23 timed steps, a checkpoint reloaded
               bit for bit, and then the same with kvstore='tpu' (the
               fused SymbolTrainStep, one CUDA graph replay a step):
               under cuDNN's deterministic algorithms its first two
               losses, its parameters' moves and moving stats after
               them within 2e-4 of 'local''s; one capture,
               step ms, peak memory and profile beside 'local''s; (iii)
               sym.scale_shift_relu in a bound graph: bit-equal to the
               nd path, one launch a forward, 5 Module SGD steps, and
               the same steps with kvstore='tpu' (one run of the kernel
               a replay, the first loss equal to the nd path's).
12. hybridize  HybridBlock.hybridize() through graph.CachedOp: (i)
               bench.py's CachedOp bench (24 x Dense(64, relu) +
               Dense(10), B=32): eager ms per call beside replay ms per
               call, one trace (capture) after 201 same-shape calls and
               two after a second shape, replays equal to eager bit for
               bit; (ii) resnet50_v1() inference at B=32 on bench.py's
               batch, eager and hybridized, bit-equal under
               deterministic cuDNN; (iii) phase resnet (iv)'s Trainer
               loop hybridized for 23 steps: its first 3 losses,
               parameters and moving stats bit-equal to the loop not
               hybridized (deterministic cuDNN), one capture, step ms
               beside eager; (iv) examples/custom_pallas_kernel.py's
               hybridized block at the rtc width: output and gradient
               bit-equal to the nd path's, one fused_scale_shift_relu
               run per replay (profiler), recorded or not; (v)
               bench.py's three graph-bench graphs bound on the card at
               MXTPU_GRAPH_OPT 0, 1 and 2: outputs bit-equal, node
               counts printed; (vi) one hybridized Dense applied 3
               times in a chain under one record(), twice, in graph
               and in jit mode: gradients bit-equal to the chain not
               hybridized, one captured pair per call that waits for
               the backward (3 captures).
13. moe        TransformerLM at bench.py's width with moe_experts=8
               (capacity factor 1.25; 922.9M parameters): forward at
               B=8 x L=1024 (logits and aux finite, flash_fwd once per
               layer, the card within rel 1e-3 of the CPU at B=1 x
               L=256); generate for 4 prompts of 128 tokens, 32 new:
               the first new token equals the forward's argmax and
               every token the CPU's generate() (expert capacity is set
               by a call's tokens, so a teacher-forced forward routes
               with other capacities; its agreement is printed); the
               bf16 ShardedTrainStep (Adam lr 1e-4, CE + 0.01 aux) at
               the first of B=8, 4, 2 (x L=1024) whose peak stays under
               60 GB, eager and captured, bit-equal, one capture, each
               flash kernel once per layer per replay, peak memory.
14. ops        the samplers, ordering and linear algebra (no hand
               kernel on them): each of the 15 sampler ops (26 names
               with their aliases) draws 10^6 values on the card whose
               mean and variance lie within 5 standard errors of the
               analytic values (printed in standard errors), a seed
               repeats its draws and another does not, and torch's own
               CUDA generator is never drawn from; sort, argsort and
               topk (every ret_typ, both orders, several axes) on
               small integers (ties everywhere) bit-equal to the CPU;
               each _linalg_ op and khatri_rao in float64 within 1e-10
               (max error over max) of the CPU, eigenvector and Q rows
               sign-normalised.
15. rnn        the recurrent stack (cuDNN's RNN, no hand kernel): (i)
               the fused RNN op for each mode, one way and
               bidirectional, at the word LM's width (2 layers of 1500,
               T=35, N=20): outputs within 1e-4 and gradients within
               1e-3 (max error over max) of the CPU on the same
               weights; (ii) the Gluon word LM (examples/
               word_language_model.py's RNNModel, tied by params= as
               the example builds it, with dropout)
               at the "large" PTB LSTM's width (Zaremba et al. 2014:
               2 x 1500, embedding 1500, vocabulary 10000, bptt 35,
               batch 20): one step at dropout 0 whose loss (rel 1e-5)
               and gradients (1e-3) equal the CPU's, then 12 steps at
               dropout 0.65 of the example's loop (record, backward,
               clip_global_norm 0.25, Trainer SGD lr 5) on the
               example's corpus: losses finite, the last below the
               first; ms per step, tokens/s, peak memory over what
               the phase found allocated, one step's device ms by
               class (cudnn_rnn, matmul, other) and busy share;
               (iii) config 3, examples/lstm_bucketing.py's sym_gen
               through BucketingModule at its defaults (200 / 200, 2
               layers, batch 32, Adam lr 0.01, Mixed init) with
               PTB's vocabulary (10000) and the reference example's
               buckets (10 to 60) on the script's Markov corpus: epochs
               until the last one's perplexity is below 60% of the
               first's and below 10000 (at most 15), each bucket bound
               once; ms per batch by bucket, tokens/s, peak memory
               over what the phase found allocated;
               (iv) a HybridBlock holding rnn.LSTM hybridized: one
               capture with cuDNN's RNN inside, replays bit-equal to
               the eager call.
16. detect     config 4 (SSD) and the detection, CTC and contrib ops, each
               held against the port on the CPU with the same inputs:
               (i) MultiBoxTarget (hard negative mining, ratio 3) and
               MultiBoxDetection (NMS 0.45 at nms_topk 400 and at the
               default -1) at SSD300's 8732 anchors, B=32, 21 classes,
               1 to 16 boxes an image: loc_target within 1e-5,
               cls_target and loc_mask equal but where the mining key
               lies within 1e-6 of the cut-off (counted), detections
               equal in class and within 1e-5 but where an IoU lies
               within 1e-6 of the threshold (counted; the CPU takes the
               first 4 images at -1); ms per call, the -1 call's peak
               memory, below one (B, k, k) bool mask's bytes; (ii) the
               NMS kernels (csrc/nms_sweep.cu, the port's own kernels
               for the JAX ops' (k, k) masks and their lax.while_loop
               and lax.fori_loop) bit-equal to their plain versions:
               nms_boxes (the pair test, then the sweep) on the windows
               of (i) at k = 400 and 8732, of (v) at 6000, on
               adversarial windows (exact ties at 0.45, duplicates,
               zero areas, NaN boxes; 8 x 8732 with and without
               force_suppress, 1 x 6000 at +1 pixel) and on random
               boxes at 1 x 65536 (four alive words a sweep thread, the
               pair test past 512 words), and the pair test's packed
               words against the plain mask packed by _pack_plain; and
               above the sweep's register limit, 1 x 131072 boxes in
               1024 groups of 128 that no box of another group meets,
               the groups' rows interleaved in score order, bit-equal
               to the plain version run on each group alone (the sweep
               keeps its alive words in shared memory; the pair test's
               words take 2 GB, its peak printed), and 66000 images of
               256 rows (a batch above 65535: eight adversarial images
               repeated) bit-equal to the plain version; each one's
               device ms, the pair test's
               and the sweep's from the same trace, the plain version's
               ms and the bound (the IoU tests these inputs need, or
               their bytes); (iii)
               config 4, examples/ssd_train.py --quick (48 px, 64
               images, B=16, 160 iterations, SGD lr 0.1, momentum 0.9,
               wd 1e-4, blocks hybridized): final loss below 0.7 of the
               first and AP above 0.5, ms per iteration, one step's loss
               (rel 1e-4) and gradients (1e-3, max error over max)
               against the CPU from the same weights; (iv) the three
               MultiBox ops in one hybridized block: one capture,
               replays bit-equal to the eager call, and as a Symbol
               bound (shape inference on meta) equal to the nd path;
               (v) Proposal at its defaults (6000 / 300, 0.7, a 600x1000
               image under stride 16: a 38x63 map) and MultiProposal at
               B=2: batch indices equal, rois within 1e-4 of the largest
               coordinate; ROIPooling (512 channels, 300 rois, 7x7),
               PSROIPooling (R-FCN: 21 classes, 7x7 groups) and
               DeformableConvolution (512 to 512, 3x3) within 1e-4,
               gradients within 1e-3 (max error over max); (vi)
               examples/speech_ctc.py --quick (BiLSTM + CTCLoss, 200
               Adam steps): label error rate below 0.15 and the last
               loss below half the first; ctc_loss at T=100, B=32,
               C=29, labels up to 40 with lengths, both blank modes:
               costs within rel 1e-5, gradients within 1e-4, an
               impossible alignment 1e30, ms of forward and backward;
               (vii) phase module (i)'s MLP as two Modules chained by
               SequentialModule: its gate, one epoch from the same
               weights within 1e-5 of one Module's, and a chain ending
               in a PythonLossModule trains; (viii) the 18 contrib_misc
               names against the CPU (FFT at (32, 4096), FlowNetC's
               Correlation on (2, 256, 48, 64), quantize and dequantize
               bit for bit).  nms_boxes's launches are counted per path
               (detect_ssd300, detect_train, detect_capture,
               detect_rcnn), and the ops launch nothing else.
17. sparse     config 5, the sparse linear classifier
               (examples/linear_classification.py's loop through
               incubator_mxnet_tpu_torch/tools/linear_classification.py:
               LibSVMIter's CSR batches, the weight in a KVStore with
               the lazy sparse.sgd_update store-side, row_sparse_pull
               of the rows a batch touches, sparse.dot forward and
               csr.T backward): (i) the example's --quick size passes
               its gate (final NLL below 0.65 of the first, accuracy
               above 0.8, fewer rows pulled than 0.75 of a dense pull);
               (ii) its default size (dim 2000, 8192 rows, batch 64, 30
               epochs): final NLL and accuracy within 0.01 of the same
               loop on the CPU, seconds and steps/s of both (the NLL
               with float64 logits: the example's float32 one is nan
               at this size on either device); (iii) the
               reference example's width on Avazu-app (1,000,000
               features, batch 8192) on make_libsvm's rows synthesized
               in bulk at 20 nonzeros a row, 20 steps: wall ms a step,
               rows pulled a step, peak memory, each part's ms alone
               (row_sparse_pull, the logits' dot, the csr.T gradient,
               the lazy sgd_update), and the first two steps' pulled
               rows and updated weight rows within rel 1e-5 of the
               CPU's.  The path runs torch's own ops: it launches no
               kernel of the port.
18. vision     alexnet, vgg16, squeezenet1_1, densenet121, mobilenet1_0
               and inception_v3 (the model zoo's other families) at
               their published inputs (224; 299) from seeded Xavier
               weights: at B=1 the card's forward within 1e-3 (max error
               over max) of the CPU's on the same weights (a .params
               file); at B=32 the eager forward and the hybridized one
               (one capture, then replays) bit-equal under deterministic
               cuDNN, ms and img/s of each; inception_v3 then takes 5
               gluon.Trainer SGD steps on one fixed batch of 32 and its
               loss falls.  No kernel of the port runs.
19. data       the input pipeline (no hand kernel: decode, augmentation
               and batching run on the host, the copy is a DMA): which
               JPEG decoder the host has (native or PIL); (i) 10,000
               RecordIO records of 100 KB written and read back through
               the native backend (MB/s); (ii) 1,280 synthetic JPEGs
               stored as ImageNet's (shorter side 256 at 4:3, quality
               95) through ImageRecordIter as train_imagenet.py sets it
               up (B=32, random crop and mirror, its mean and std,
               min(cpu_count, 16) threads): img/s over two epochs, and
               the first epoch again from its state_dict, bit for bit;
               (iii) ResNet-50 v1 as a Symbol through
               Module.fit(kvstore='tpu') for 40 steps from
               DevicePrefetchIter(ImageRecordIter), under deterministic
               cuDNN with TF32 off: its losses bit-equal to the same
               Module fed (ii)'s batches built on the card beforehand,
               both from one copy of the weights; steps/s, img/s, the
               step without the pipeline and which sets the pace;
               (iv) DevicePrefetchIter at depth 1, 2 and 4 over 500 host
               batches filled from their index, the consumer sleeping on
               its stream past the copy before it checks: 0 mismatches,
               and the pinned copy's GB/s; (v) gluon.data.DataLoader
               (4 process workers) over a RecordFileDataset of (ii)'s
               .rec, decoding in the workers: its first 8 batches
               bit-equal to num_workers=0's, then 20 Gluon ResNet-50
               Trainer steps; (vi) Predictor over (iii)'s checkpoint
               within 1e-5 of Module.predict, and the profiler around 5
               steps: one framework event per dispatched op, cuDNN's
               convolution and batch-norm kernels in the device trace,
               the busy share; (vii) test_utils.check_consistency of
               Convolution, BatchNorm, FullyConnected, Pooling and
               softmax between cpu() and the card; (viii) ImageDetIter
               over 256 JPEGs at 300 x 300 feeds config 4's SSD loop
               for 10 steps and its loss falls; (ix) the multi-process
               data service over (ii)'s .rec: the host's CPUs, the
               size and free space of /dev/shm against the rings (W x
               depth 4 x 19.27 MB; a ring that does not fit fails
               typed), the decoder the workers use; its merged stream
               of 40 batches at W = 1, 2 and 4 (random crop and mirror
               off) bit-equal to ImageRecordIter's, and with
               train_imagenet.py's augmentation W=4 bit-equal to W=1
               from one seed; img/s at W = 1, 2, 4 and 6 over an epoch
               after a warm one, beside (ii)'s; config 2 at the best W:
               40 Module.fit steps from
               DevicePrefetchIter(DataServiceIter), its losses bit-equal
               to the same batches staged on the card, steps/s, img/s,
               the busy share, the telemetry spans (data wait,
               forward-backward, optimizer) and the peak card memory; a
               state_dict after 7 batches at W=4 restored at W=3 gives
               the next batch; a worker SIGKILLed mid-epoch is restarted
               (one restart counted, the flight recorder's dead and
               restart events) and the stream stays bit-identical; a
               RemoteShardServer in a subprocess takes the last of 2
               shards for 8 batches, bit-identical; every worker
               reports CUDA not initialized in it, the parent's CUDA
               initialized before the fork.
20. operability  the step guard, loss scaling, divergence rollback, the
               perf observatory and the memory preflight and OOM ladder
               (no new kernel; the flash kernels run in (iv) to (vi));
               first, no earlier phase took a degrade rung or failed to
               plan.  (i) phase resnet (iv)'s Trainer loop (B=32,
               deterministic cuDNN) under MXTPU_NONFINITE_POLICY=skip
               with MXTPU_GUARD_INTERVAL=4, 9 steps, grad:nonfinite at
               steps 3 and 6: each bad step leaves every parameter and
               momentum bit-equal, the step count ends 2 lower, 3 guard
               reads, the steps between reads run under
               torch.cuda.set_sync_debug_mode("error"), the other losses
               equal an unguarded run's without those batches bit for
               bit; guarded and unguarded ms per step; (ii) a static
               loss scale of 2^15: losses within rel 1e-6 of the
               unscaled loop (bit-equal printed); a dynamic one (window
               2) on the hybridized net: an injected overflow halves it,
               two good windows double it twice, one capture; (iii)
               phase module (i)'s MLP through Module.fit(checkpoint_
               prefix=) on 'local' and 'tpu' (the captured
               SymbolTrainStep with numeric_guard): a checkpoint after
               the first epoch, 3 consecutive bad steps raise
               DivergedError and roll back once to it, and the fit
               resumed from it passes the example's gate (0.95); a child
               that diverges under install_diverged_exithook exits 13;
               (iv) bench.py's transformer step (B=8 x L=1024, bf16,
               captured): cost_analysis (FlopCounterMode on meta copies)
               arms the clock, and over 19 replays its train_mfu is
               within 5% of the MFU timed here between CUDA events on
               the same replays against caps_for(card)'s bf16 peak (the
               MFU from the host's enqueue time beside it); a replay
               runs each flash kernel once per layer; ResNet-50's
               analytic train FLOPs (symbol_cost x 3) within 2% of phase
               resnet's own count and of FlopCounterMode's, and
               Module.perf_report()'s roofline table at B=32; (v) the
               planner against torch.cuda.max_memory_allocated over a
               step less what was live before the step's objects: the
               MLP Module (gate 20%), ResNet-50 through Module (printed)
               and the transformer step eager (gate 20%) and captured
               (printed), with the elementwise share that would fit;
               (vi) MXTPU_HBM_BYTES under the transformer's plan: the
               preflight takes remat (the first step's loss and
               parameters bit-equal to the plain step's), lower the
               grad_accum rungs to the first whose plan fits (at this
               width grad_accum=2 plans above remat: its accumulator
               costs more than half the activations; loss within rel
               1e-5), lower still MemoryPlanError after every rung;
               then the allocator
               capped (set_per_process_memory_fraction) between the
               remat and plain first calls' reserved peaks (3/4 up):
               with
               MXTPU_MEM_POLICY=off the OOM is raised as an OomError,
               with the default policy it takes the remat rung
               (oom_retries_total 1) and the retried step captures once
               and gives a finite loss; the cap is lifted after.

Then it prints the card's name and power limit (nvidia-smi), the kernel
table ({"kernels": [...]}; ``launches`` is the sum over the main paths'
runs, ``launches_by_path`` each run's own count, for the paths whose
phase counted that kernel) and, last,
{"ok": true, "device": {...}}.  fp32 matrix products run in full fp32
(TF32 off) so the plain versions are exact yardsticks.

Times: ``ms`` (a kernel's, its plain version's as ``plain_ms``, its
library call's as ``library_ms``) is device time per call, from
torch.profiler over back-to-back calls: the summed device time of the
call's kernels over the count, so host time and gaps between launches
drop out; a trace with no device event is taken again and counted
(``device_ms_traces``, printed with ``phase_seconds``).  Every trace
opens with throwaway launches that take the first device records a
trace loses (``device_trace``); at the start and the end of the run,
``trace_keeps`` counts how many of 10 launches after them a trace
records (all, or the run fails), how many of them it lost, and how many
of the 10 a trace without them records.  ``call_ms`` is
the time of one call between two CUDA events, which also counts the
host's work before the launch.
"""
import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time

SEED = 0
H100_FP32_FLOPS = 67e12      # non-tensor-core fp32, SXM, 700 W
H100_BF16_FLOPS = 989e12     # dense tensor-core bf16
H100_TF32_FLOPS = 495e12     # dense tensor-core tf32
# fp32-accurate products on the tensor cores: split-TF32, three tf32
# products per fp32 product
H100_SPLIT_TF32_FLOPS = H100_TF32_FLOPS / 3
H100_BYTES_PER_S = 3.35e12   # HBM3
TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# backward: sums over up to 1024 keys or queries in another order (fp32);
# the output's bf16 rounding (bf16)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bench.py's transformer width, and the requests the main paths send it
MODEL = dict(vocab_size=32000, d_model=1024, n_layers=12, n_heads=16,
             max_len=1024)
FORWARD = (8, 1024)              # B x L scored by forward
SERVE = ((4, 128), (2, 512))     # B prompts x P tokens per generate
NEW_TOKENS = 32
TRAIN = (8, 1024)                # B x L of bench.py's training step
TRAIN_CHECK = (1, 256)           # B x L of the card-vs-CPU gradient check
WARMUP_STEPS, TIMED_STEPS = 2, 8
FP32_WARMUP_STEPS, FP32_TIMED_STEPS = 2, 3   # step (iv), fp32
TRAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# the kernel flash_fwd launches for each dtype (csrc/flash_fwd.cu), and
# those flash_dq and flash_dkv launch (csrc/flash_bwd.cu)
FWD_KERNELS = {"float32": "flash_fwd_tf32_kernel",
               "bfloat16": "flash_fwd_tc_kernel"}
BWD_KERNELS = {"float32": ["flash_dq_tf32_kernel", "flash_dkv_tf32_kernel"],
               "bfloat16": ["flash_dq_tc_kernel", "flash_dkv_tc_kernel"]}


# the kernels of csrc/nms_sweep.cu, and how many instances each has (the
# sweep's: one and four alive words a thread in registers, and the words
# in shared memory above 65536 rows)
NMS_KERNELS = {"nms_pair_kernel": 1, "nms_sweep_kernel": 2,
               "nms_sweep_shared_kernel": 1}


class CheckFailed(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def call_ms(fn, torch, warmup=3, reps=20):
    """Median time of one call between two CUDA events.  The card is
    idle when the first is recorded, so this counts the host's work
    before the launch too: the cost a lone call pays."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# traces device_ms took, and those that held no device event at all
TRACES = {"taken": 0, "empty": 0}
TRACE_ATTEMPTS = 3


# the throwaway launches that open every device_trace: fills of int16,
# a kernel the port does not run, which device_events leaves out
TRACE_LEAD = 128
LEAD_KERNEL = "FillFunctor<short>"


@contextlib.contextmanager
def device_trace(torch):
    """torch.profiler over the host and the card.  Such a trace can
    drop its first few device records, more the longer the process has
    run and whether or not the card was idle before them (the count
    ``trace_keeps`` prints), which hid the first kernels of a short CUDA
    graph replay; so the trace opens with TRACE_LEAD throwaway
    launches, which take the loss."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    lead = torch.empty(64, dtype=torch.int16, device="cuda")
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_LEAD):
            lead.fill_(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def device_events(prof):
    """The card's rows of a ``device_trace`` (key_averages), its lead
    launches left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and LEAD_KERNEL not in e.key]


def trace_keeps(torch, n=10):
    """How many of ``n`` kernel launches a ``device_trace`` records (all,
    or the run fails), how many of its lead launches it lost, and how
    many of the ``n`` a trace without the lead records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    xs = [torch.empty(256 + i, device="cuda") for i in range(n)]

    def fills():
        for x in xs:
            x.fill_(1.0)
        torch.cuda.synchronize()

    def counted(rows, kernel):
        return sum(e.count for e in rows if kernel in e.key)

    with device_trace(torch) as led:
        fills()
    rows = [e for e in led.key_averages() if e.device_type == DeviceType.CUDA]
    kept, lead = counted(rows, "FillFunctor<float>"), counted(rows,
                                                              LEAD_KERNEL)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as bare:
        fills()
    check(lead > 0, f"no {LEAD_KERNEL} kernel in a trace's lead")
    check(kept == n, f"a trace recorded {kept} of {n} kernels after "
                     f"its lead")
    return {"launched": n, "recorded": kept,
            "lead_lost": TRACE_LEAD - lead,
            "recorded_without_lead": counted(
                [e for e in bare.key_averages()
                 if e.device_type == DeviceType.CUDA],
                "FillFunctor<float>")}


def device_ms(fn, torch, what, warmup=3, reps=20):
    """Device time of one call of ``what``: the summed device time of
    the kernels (and copies) of ``reps`` back-to-back calls under
    torch.profiler, over ``reps``.  Host time and the gaps between
    launches drop out.  A trace that holds no device event at all (seen
    on the card for calls that launched kernels) is taken again, up to
    TRACE_ATTEMPTS traces, and counted in TRACES["empty"], which the run
    prints; if none has device time the check fails."""
    return device_split_ms(fn, torch, what, (), warmup, reps)[0]


def device_split_ms(fn, torch, what, kernels, warmup=3, reps=20):
    """``device_ms`` of ``what`` and, from the same trace, the device ms
    of one call of each of ``kernels`` (the events whose name holds it):
    -> (ms, {kernel: ms}).  A trace in which a kernel of ``kernels`` ran
    other than once a call is taken again, as an empty one is."""
    for _ in range(warmup):
        fn()
    for _ in range(TRACE_ATTEMPTS):
        with device_trace(torch) as prof:
            for _ in range(reps):
                fn()
        TRACES["taken"] += 1
        rows = device_events(prof)
        us = sum(e.self_device_time_total for e in rows)
        parts = {k: [e for e in rows if k in e.key] for k in kernels}
        if us > 0 and all(sum(e.count for e in v) == reps
                          for v in parts.values()):
            return us / 1e3 / reps, {
                k: sum(e.self_device_time_total for e in v) / 1e3 / reps
                for k, v in parts.items()}
        TRACES["empty"] += 1
    raise CheckFailed(f"torch.profiler recorded no device time for "
                      f"{what}, or not each of {list(kernels)} once a "
                      f"call, in {TRACE_ATTEMPTS} traces")


def timed_ms(fn, torch, what, reps=20):
    """(device ms, call ms) of one call: ``device_ms``, ``call_ms``."""
    return (device_ms(fn, torch, what, reps=reps),
            call_ms(fn, torch, reps=reps))


def wall_ms(fn, torch, reps=3):
    """Median host time of calls that end in a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def profile(fn, torch):
    """Device time by kernel over one call, from torch.profiler: the
    busy share is the kernels' summed device time over the call's wall
    time (the profiler's own host cost makes it a lower bound); and the
    number of kernels each class ran."""
    try:
        with device_trace(torch) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): an operator's row
        # on the host repeats its kernels' time
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in device_events(prof)
                       if e.self_device_time_total > 0),
                      key=lambda r: -r[1])
    except RuntimeError as exc:   # a measurement, not a check
        return {"error": str(exc)}
    busy = sum(r[1] for r in rows)
    by_class, n_class = {}, {}
    for key, ms, n in rows:
        cls = kernel_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_class[cls] = n_class.get(cls, 0) + n
    return {"wall_ms": wall, "device_ms": busy,
            "device_busy_share": busy / wall if rows else None,
            "device_ms_by_class": by_class, "kernels_by_class": n_class,
            "top_ms": [[k[:60], ms] for k, ms, _ in rows[:6]]}


def kernel_class(name):
    """The layer a device kernel belongs to, from its name: the port's
    flash kernels, matrix products (cuBLAS), or the rest (elementwise,
    reductions, normalization, copies)."""
    for tag in ("flash_fwd", "flash_dq", "flash_dkv"):
        if tag in name:
            return tag
    if any(t in name.lower() for t in ("gemm", "nvjet", "xmma",
                                       "cutlass")):
        return "matmul"
    return "other"


def live_pairs(lq, lk, causal, window):
    """(query, key) pairs the mask keeps: the work the data needs."""
    if not causal:
        return lq * lk
    return sum(min(i + 1, lk, window if window else lk)
               for i in range(lq))


def _bound(nbytes, flops, peak):
    """Least time for the work on an H100: max of bytes / 3.35 TB/s and
    operations / ``peak`` FLOP/s; and which of the two it is."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops \
        else "operations"


def _matmul_bounds(nbytes, flops, dtype):
    """A flash kernel's bound: bf16 at the dense bf16 rate; fp32 at the
    split-TF32 rate (the least time for fp32-accurate products on the
    tensor cores), with the CUDA cores' bound beside it as
    ``cuda_core_bound_ms``."""
    if dtype != "float32":
        ms, by = _bound(nbytes, flops, H100_BF16_FLOPS)
        return {"bound_ms": ms, "bound_by": by}
    ms, by = _bound(nbytes, flops, H100_SPLIT_TF32_FLOPS)
    return {"bound_ms": ms, "bound_by": by, "cuda_core_bound_ms":
            _bound(nbytes, flops, H100_FP32_FLOPS)[0]}


def bound(case):
    """flash_fwd: reads q, k, v; writes o and lse; 4*D flops per kept
    pair."""
    bh, lq, lk, d = case["bh"], case["lq"], case["lk"], case["d"]
    size = 4 if case["dtype"] == "float32" else 2
    nbytes = size * bh * d * (2 * lq + 2 * lk) + 4 * bh * lq
    flops = 4 * d * bh * live_pairs(lq, lk, case["causal"], case["window"])
    return _matmul_bounds(nbytes, flops, case["dtype"])


def bwd_bound(case, kernel):
    """flash_dq reads q, k, v, g, lse, delta and writes dq, 6*D flops
    per kept pair (s, dp, dq); flash_dkv reads the same and writes dk
    and dv, 8*D flops per kept pair (s, dp, dv, dk)."""
    bh, lq, lk, d = case["bh"], case["lq"], case["lk"], case["d"]
    size = 4 if case["dtype"] == "float32" else 2
    pairs = live_pairs(lq, lk, case["causal"], case["window"])
    reads = size * bh * d * (2 * lq + 2 * lk) + 8 * bh * lq
    if kernel == "flash_dq":
        nbytes, flops = reads + size * bh * lq * d, 6 * d * bh * pairs
    else:
        nbytes, flops = reads + 2 * size * bh * lk * d, 8 * d * bh * pairs
    return _matmul_bounds(nbytes, flops, case["dtype"])


# flash_dq_tc_kernel<64> (the tensor cores, bf16) or
# flash_dq_tf32_kernel<64> (the tensor cores, fp32 as split-TF32),
# mangled.  The name follows its length (digits); the anonymous
# namespace before it also holds "_flash_fwd_cu_<hash>"
_KERNEL_NAME = re.compile(r"(?<=\d)(flash_[a-z0-9_]*?_kernel)ILi(\d+)E")


def _demangle(mangled):
    """The function name of a mangled C++ name (``_Z5scalePKfPffx`` ->
    ``scale``); anything else unchanged."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    return mangled[start:start + int(m.group(1))]


def kernel_name(mangled):
    """``flash_dq_tc_kernel<bf16,64>``, ``flash_dq_tf32_kernel<f32,64>``,
    or the demangled function name of any other kernel."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return _demangle(mangled)
    fp32 = "_tf32_" in m.group(1)
    return f"{m.group(1)}<{'f32' if fp32 else 'bf16'},{m.group(2)}>"


def ptxas_report(log):
    """{kernel<dtype, D>: {"registers", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas -v output, and ptxas's warnings about wgmma
    (serialized pipelines) under "wgmma_warnings"."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_name(ln.split("'")[1])
            out[name] = {}
        elif "wgmma" in ln:
            out.setdefault("wgmma_warnings", []).append(ln.strip())
        elif name is not None and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", ln)
            out[name].update({f"spill_{k}": int(v) for v, k in nums})
        elif name is not None and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


def sass_tensor_ops(path):
    """{kernel: {"hgmma", "hmma"}}: each kernel's count of wgmma
    (HGMMA) and mma.sync (HMMA) instructions in the SASS of a built
    library, from cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        fn = re.search(r"Function : (\S+)", ln)
        if fn:
            name = kernel_name(fn.group(1))
            out[name] = {"hgmma": 0, "hmma": 0}
        elif name is not None:
            op = re.search(r"\b(HGMMA|HMMA)\b", ln)
            if op:
                out[name][op.group(1).lower()] += 1
    return out


def phase_build(mt, card):
    build = mt.ops._build
    t0 = time.perf_counter()
    built = build.build()
    seconds = time.perf_counter() - t0
    ptxas, sass = {}, {}
    for name, src in build.sources().items():
        lib = build._target(src)
        ptxas.update(ptxas_report(lib.with_suffix(".log").read_text()))
        sass.update(sass_tensor_ops(lib))
    dims = mt.ops.flash.HEAD_DIMS
    tf32_bwd = {k: ptxas.get(k) for d in dims for k in (
        f"flash_dq_tf32_kernel<f32,{d}>", f"flash_dkv_tf32_kernel<f32,{d}>")}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "sources": sorted(built), "ptxas": ptxas, "tf32_bwd": tf32_bwd,
          "sass_tensor_ops": sass})
    # on the tensor cores, by wgmma: every flash kernel (flash_fwd,
    # flash_dq, flash_dkv; bf16 and fp32; one per head dim each)
    tc = {k: v for k, v in sass.items()
          if "<bf16," in k or "_tf32_kernel<" in k}
    check(len(tc) == 6 * len(dims)
          and all(v["hgmma"] > 0 for v in tc.values()),
          f"tensor-core flash kernels without HGMMA: {tc}")
    no_spill = ["flash_fwd_tc_kernel<bf16,64>",
                "flash_dq_tf32_kernel<f32,64>",
                "flash_dkv_tf32_kernel<f32,64>"] + [
        f"flash_fwd_tf32_kernel<f32,{d}>" for d in dims]
    spills = {k: ptxas.get(k) for k in no_spill
              if ptxas.get(k, {}).get("spill_stores") != 0
              or ptxas.get(k, {}).get("spill_loads") != 0}
    check(not spills, f"flash kernels spill: {spills}")
    check(not ptxas.get("wgmma_warnings"),
          f"ptxas serialized wgmma: {ptxas.get('wgmma_warnings')}")
    # csrc/nms_sweep.cu: the pair test and the sweep, whose alive words
    # and loads in flight sit in registers: none may spill
    for kernel, count in NMS_KERNELS.items():
        nms = {k: v for k, v in ptxas.items() if kernel in k}
        check(len(nms) == count and all(v.get("spill_stores") == 0
                                    and v.get("spill_loads") == 0
                                    for v in nms.values()),
              f"{kernel} spills or is missing: {nms}")


def flash_cases():
    """The shapes the main paths give the kernel (forward's, and each
    serve request's prefill, in fp32; the train step's, which is
    forward's, in bf16), then a sweep of the kernel's options."""
    h = MODEL["n_heads"]
    dh = MODEL["d_model"] // h
    b, l = FORWARD
    main = dict(bh=b * h, lq=l, lk=l, d=dh, causal=True, window=0)
    shapes = [dict(main, path="forward")]
    shapes += [dict(main, bh=b * h, lq=p, lk=p, path="serve")
               for b, p in SERVE]
    shapes += [dict(main, path="sweep", **kw) for kw in (
        dict(causal=False), dict(window=256), dict(lq=1000, lk=1000),
        dict(lq=256, causal=False), dict(d=32), dict(bh=64, d=128))]
    cases = [dict(s, dtype=dt) for dt in ("float32", "bfloat16")
             for s in shapes]
    for c in cases:
        if c["dtype"] == "bfloat16" and c["path"] == "forward":
            c["path"] = "train"
    return cases


def worst_by_dtype(rows):
    """{dtype: the largest worst_over_tol of its cases}."""
    out = {}
    for r in rows:
        out[r["dtype"]] = max(out.get(r["dtype"], 0.0), r["worst_over_tol"])
    return out


def phase_kernels(mt, torch):
    from incubator_mxnet_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []
    for case in flash_cases():
        dt = getattr(torch, case["dtype"])
        q = torch.randn(case["bh"], case["lq"], case["d"], generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn(case["bh"], case["lk"], case["d"],
                            generator=gen, device="cuda").to(dt)
                for _ in range(2))
        scale = 1.0 / math.sqrt(case["d"])
        args = (q, k, v, case["causal"], scale, case["window"])
        o, lse = flash.flash_attention_fwd(*args[:3], causal=args[3],
                                           scale=scale, window=args[5])
        ro, rlse = flash._reference_fwd(*args)
        torch.cuda.synchronize()
        tol = TOL[case["dtype"]]
        diff = (o.float() - ro.float()).abs()
        ratio = (diff / (tol + tol * ro.float().abs())).max().item()
        lse_ratio = ((lse - rlse).abs()
                     / (tol + tol * rlse.abs())).max().item()
        row = dict(case, kernel=FWD_KERNELS[case["dtype"]],
                   max_abs_err=diff.max().item(),
                   max_abs_err_lse=(lse - rlse).abs().max().item(),
                   tol=tol, worst_over_tol=max(ratio, lse_ratio))
        check(math.isfinite(row["worst_over_tol"])
              and row["worst_over_tol"] <= 1.0,
              f"flash_fwd disagrees with its plain version: {row}")
        row["ms"], row["call_ms"] = timed_ms(
            lambda: flash.flash_attention_fwd(
                q, k, v, causal=args[3], scale=scale, window=args[5]),
            torch, f"flash_fwd {case}")
        row["plain_ms"] = device_ms(lambda: flash._reference_fwd(*args),
                                    torch, f"plain flash_fwd {case}",
                                    reps=10)
        row.update(bound(case))
        row["library_ms"] = row["library_call_ms"] = None
        if case["causal"] and not case["window"] \
                and case["lq"] == case["lk"]:
            # yardstick only: the port never calls it
            # (1, BH, L, D): SDPA's fused backends take 4-D only
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"], row["library_call_ms"] = timed_ms(
                lambda: sdpa(q[None], k[None], v[None], is_causal=True),
                torch, f"SDPA {case}")
        rows.append(row)
        del q, k, v, o, lse, ro, rlse
    emit({"phase": "kernels", "cases": rows,
          "worst_over_tol": worst_by_dtype(rows)})
    m = next(r for r in rows if r["path"] == "forward")
    t = next(r for r in rows if r["path"] == "train")
    keys = ("kernel", "max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call_ms", "tol")
    return dict({k: m[k] for k in keys},
                name="flash_fwd", route="cuda",
                source="incubator_mxnet_tpu_torch/csrc/flash_fwd.cu",
                replaces="incubator_mxnet_tpu/ops/flash.py:121",
                launches=None, shape=[m["bh"], m["lq"], m["d"]],
                dtype=m["dtype"], causal=True,
                cuda_core_bound_ms=m["cuda_core_bound_ms"],
                over_library=m["ms"] / m["library_ms"],
                cases_within_tol=len(rows),
                bf16_train=dict({k: t[k] for k in keys},
                                shape=[t["bh"], t["lq"], t["d"]],
                                dtype=t["dtype"], causal=True,
                                over_library=t["ms"] / t["library_ms"]))


def bwd_cases():
    """The train path's shape (in bf16, the train dtype, and in fp32),
    then the forward sweep's other shapes."""
    h = MODEL["n_heads"]
    b, l = TRAIN
    main = dict(bh=b * h, lq=l, lk=l, d=MODEL["d_model"] // h,
                causal=True, window=0)
    shapes = [dict(main, path="train")]
    shapes += [dict(main, path="sweep", **kw) for kw in (
        dict(causal=False), dict(window=256), dict(lq=1000, lk=1000),
        dict(lq=256, causal=False), dict(lq=256), dict(d=32),
        dict(bh=64, d=128))]
    return [dict(s, dtype=dt) for dt in ("bfloat16", "float32")
            for s in shapes]


def phase_kernels_bwd(mt, torch):
    from incubator_mxnet_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for case in bwd_cases():
        dt = getattr(torch, case["dtype"])

        def rand(n):
            return torch.randn(case["bh"], n, case["d"], generator=gen,
                               device="cuda").to(dt)

        q, k, v, g = rand(case["lq"]), rand(case["lk"]), rand(case["lk"]), \
            rand(case["lq"])
        causal, window = case["causal"], case["window"]
        scale = 1.0 / math.sqrt(case["d"])
        o, lse = flash.flash_attention_fwd(q, k, v, causal, scale, window)
        delta = flash._delta(g, o)
        args = (q, k, v, g, lse, delta, causal, scale, window)
        got = (flash._launch_dq(*args),) + flash._launch_dkv(*args)
        ref = flash._reference_bwd(q, k, v, o, lse, g, causal, scale,
                                   window)
        torch.cuda.synchronize()
        tol = BWD_TOL[case["dtype"]]
        row = dict(case, kernels=BWD_KERNELS[case["dtype"]], tol=tol)
        worst = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            diff = (a.float() - b.float()).abs()
            row[f"max_abs_err_{name}"] = diff.max().item()
            worst = max(worst, (diff / (tol + tol * b.float().abs()))
                        .max().item())
        row["worst_over_tol"] = worst
        check(math.isfinite(worst) and worst <= 1.0,
              f"flash_dq/flash_dkv disagree with the plain backward: "
              f"{row}")
        # each block writes only its own rows, with no atomics: a second
        # launch on the same inputs gives the same bits
        again = (flash._launch_dq(*args),) + flash._launch_dkv(*args)
        row["bit_identical"] = all(bool(torch.equal(a, b))
                                   for a, b in zip(got, again))
        check(row["bit_identical"], f"flash_dq/flash_dkv differ between "
                                    f"two launches on the same inputs: "
                                    f"{row}")
        for kernel, fn, plain in (
                ("flash_dq", flash._launch_dq, flash._reference_dq),
                ("flash_dkv", flash._launch_dkv, flash._reference_dkv)):
            row[f"{kernel}_ms"], row[f"{kernel}_call_ms"] = timed_ms(
                lambda: fn(*args), torch, f"{kernel} {case}")
            row[f"{kernel}_plain_ms"] = device_ms(
                lambda: plain(*args), torch, f"plain {kernel} {case}",
                reps=10)
            row.update({f"{kernel}_{k}": v for k, v in
                        bwd_bound(case, kernel).items()})
        row["kernels_sum_ms"] = row["flash_dq_ms"] + row["flash_dkv_ms"]
        row["library_ms"] = row["library_call_ms"] = None
        if not window and (not causal or case["lq"] == case["lk"]):
            # yardstick only, SDPA's backward (dq, dk, dv together):
            # the port never calls it
            # (1, BH, L, D): SDPA's fused backends take 4-D only
            ql, kl, vl = (t[None].detach().clone().requires_grad_()
                          for t in (q, k, v))
            out = sdpa(ql, kl, vl, is_causal=causal)
            row["library_ms"], row["library_call_ms"] = timed_ms(
                lambda: torch.autograd.grad(
                    out, (ql, kl, vl), g[None], retain_graph=True), torch,
                f"SDPA backward {case}")
            del ql, kl, vl, out
        rows.append(row)
        del q, k, v, g, o, lse, delta, got, again, ref
    emit({"phase": "kernels_bwd", "cases": rows,
          "worst_over_tol": worst_by_dtype(rows),
          "cases_within_tol": {dt: sum(r["dtype"] == dt for r in rows)
                               for dt in BWD_KERNELS},
          "bit_identical": all(r["bit_identical"] for r in rows)})
    m = rows[0]
    f = next(r for r in rows
             if r["path"] == "train" and r["dtype"] == "float32")
    entries = []
    for kernel, line, errs in (("flash_dq", 220, ("dq",)),
                               ("flash_dkv", 262, ("dk", "dv"))):
        keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "cuda_core_bound_ms")
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "incubator_mxnet_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"incubator_mxnet_tpu/ops/flash.py:{line}",
            "launches": None,
            "max_abs_err": max(m[f"max_abs_err_{e}"] for e in errs),
            "ms": m[f"{kernel}_ms"], "call_ms": m[f"{kernel}_call_ms"],
            "plain_ms": m[f"{kernel}_plain_ms"],
            "bound_ms": m[f"{kernel}_bound_ms"],
            "bound_by": m[f"{kernel}_bound_by"],
            "library_ms": m["library_ms"],
            "library_call_ms": m["library_call_ms"],
            "library_is": "SDPA backward (dq, dk, dv together); compare "
                          "with the sum of flash_dq and flash_dkv",
            "shape": [m["bh"], m["lq"], m["d"]], "dtype": m["dtype"],
            "causal": True, "tol": m["tol"],
            "cases_within_tol": len(rows),
            "fp32_train": dict(
                {k: f[f"{kernel}_{k}"] for k in keys},
                kernel=f["kernels"][0 if kernel == "flash_dq" else 1],
                max_abs_err=max(f[f"max_abs_err_{e}"] for e in errs),
                library_ms=f["library_ms"],
                library_call_ms=f["library_call_ms"],
                shape=[f["bh"], f["lq"], f["d"]], dtype="float32",
                causal=True, tol=f["tol"])})
    return entries


def build_model(device):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
        TransformerLM
    return TransformerLM(**MODEL, device=device)


def phase_forward(mt, torch):
    launches = mt.ops.LAUNCHES
    net = build_model(None)        # None: the CUDA card
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(SEED))
    n_params = sum(p.numel() for p in net.parameters())
    gen = torch.Generator().manual_seed(SEED + 1)
    b, l = FORWARD
    vocab = MODEL["vocab_size"]
    toks = torch.randint(0, vocab, (b, l), generator=gen).cuda()
    with torch.inference_mode():
        mt.ops.reset_launches()
        logits = net(toks)                    # the main path
        torch.cuda.synchronize()
        n = launches["flash_fwd"]
        layers = MODEL["n_layers"]
        check(n == layers,
              f"forward launched flash_fwd {n} times, not {layers}")
        check(tuple(logits.shape) == (b, l, vocab), "logits shape")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        del logits
        ms = wall_ms(lambda: net(toks), torch)
        prof = profile(lambda: net(toks), torch)
        # the same weights on the CPU's plain path, B=1 x L=256
        cpu_net = build_model("cpu")
        cpu_net.load_state_dict({k: v.cpu() for k, v in
                                 net.state_dict().items()})
        short = toks[:1, :256]
        got = net(short).cpu()
        ref = cpu_net(short.cpu())
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
    check(rel <= 1e-3, f"card vs CPU logits rel err {rel} > 1e-3")
    emit({"phase": "forward", "params": n_params, "batch": b,
          "seq": l, "flash_launches": n, "ms_per_forward": ms,
          "tokens_per_s": b * l / ms * 1e3,
          "cpu_rel_err": rel, "cpu_tol": 1e-3, "profile": prof})
    return net, n


def phase_serve(mt, torch, net):
    launches = mt.ops.LAUNCHES
    gen = torch.Generator().manual_seed(SEED + 2)
    counts = []
    layers = MODEL["n_layers"]
    for b, p in SERVE:
        prompts = torch.randint(0, MODEL["vocab_size"], (b, p),
                                generator=gen).cuda()
        new = NEW_TOKENS
        mt.ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate(prompts, max_new_tokens=new)   # the main path
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        n = launches["flash_fwd"]
        counts.append(n)
        check(n == layers,
              f"prefill launched flash_fwd {n} times, not {layers}")
        check(tuple(out.shape) == (b, p + new), "generate shape")
        check(bool((out[:, :p] == prompts).all()), "prompt echoed")
        with torch.inference_mode():
            tf = net(out[:, :-1]).argmax(-1)[:, p - 1:]
        agree = (tf == out[:, p:]).float().mean().item()
        check(agree == 1.0, f"greedy tokens differ from teacher-forced "
                            f"argmax ({agree:.4f} agree) at B={b} P={p}")
        prefill_ms = wall_ms(lambda: net.generate(prompts, 1), torch)
        full_ms = wall_ms(lambda: net.generate(prompts, new), torch)
        prof = profile(lambda: net.generate(prompts, new), torch)
        emit({"phase": "serve", "requests": b, "prompt": p,
              "new_tokens": new, "flash_launches": n,
              "first_call_ms": gen_ms, "prefill_ms": prefill_ms,
              "ms_per_decoded_token": (full_ms - prefill_ms) / (new - 1),
              "generate_ms": full_ms,
              "tokens_per_s": b * new / full_ms * 1e3,
              "teacher_forced_agree": agree, "profile": prof})
    return counts


# ------------------------------------------------------------ serve_engine
# bench.py's serving traffic (bench.py:1013-1100) at the forward phase's
# width, through serving.ServingEngine: every request submitted at once.
ENGINE = dict(max_batch=8, block_size=16, num_blocks=512, prefix_cache=True)
ENGINE_REQUESTS = 16
ENGINE_SYSTEM = 256          # the even-numbered requests' shared prompt
ENGINE_OWN = (64, 448)       # each request's own part, tokens
ENGINE_SEED = 7              # numpy, as bench.py's
ENGINE_PROFILED_STEPS = 4
TIE_REL = 1e-5               # generate()'s top-two logits this close: a tie


def engine_prompts(vocab):
    """bench.py's prompt mix: a shared system prompt on the even
    requests, then each request's own part, drawn in bench.py's order."""
    import numpy as np
    rs = np.random.RandomState(ENGINE_SEED)
    system = [int(t) for t in rs.randint(0, vocab, ENGINE_SYSTEM)]
    prompts = []
    for i in range(ENGINE_REQUESTS):
        n = int(rs.randint(ENGINE_OWN[0], ENGINE_OWN[1] + 1))
        own = [int(t) for t in rs.randint(0, vocab, n)]
        prompts.append(system + own if i % 2 == 0 else own)
    return prompts


def generate_logits(net, prompt, upto, torch):
    """The logits greedy ``generate()`` picks its new tokens 0..upto
    from, by the same calls (``_prefill``, then ``_step`` per token)."""
    p = len(prompt)
    with torch.inference_mode():
        wts = net._decode_params()
        caches, logits = net._prefill(
            torch.tensor([prompt], device="cuda"), p + NEW_TOKENS)
        out = [logits[0]]
        for i in range(p, p + upto):
            logits = net._step(wts, caches, out[-1].argmax()[None], i)
            out.append(logits[0])
    return out


def tie_margin(logits):
    """(top1 - top2) / |top1| of one row of logits."""
    top = logits.topk(2).values.tolist()
    return (top[0] - top[1]) / abs(top[0])


def compare_with_generate(net, reqs, torch):
    """Each request's tokens against ``generate()`` on its prompt.  A
    difference passes only where generate's top-two logits are within
    TIE_REL of each other; that request is compared no further."""
    ties = []
    for r in reqs:
        with torch.inference_mode():
            ref = net.generate(torch.tensor([r.prompt], device="cuda"),
                               NEW_TOKENS)[0].tolist()
        p = len(r.prompt)
        diff = [j for j in range(NEW_TOKENS)
                if r.generated[j] != ref[p + j]]
        if not diff:
            continue
        j = diff[0]
        logits = generate_logits(net, r.prompt, j, torch)
        check(all(int(logits[k].argmax()) == ref[p + k]
                  for k in range(j + 1)),
              "generate_logits disagrees with generate()")
        margin = tie_margin(logits[j])
        ties.append({"request": r.id, "new_token": j,
                     "engine": r.generated[j], "generate": ref[p + j],
                     "top2_rel_margin": margin})
        check(margin <= TIE_REL,
              f"engine request {r.id} differs from generate() at new "
              f"token {j} ({r.generated[j]} vs {ref[p + j]}), top-two "
              f"margin {margin} > {TIE_REL}")
    return ties


def graph_matches_eager(eng, torch):
    """One replay of the captured decode step against the step function
    called eagerly on clones of the pools and of the static buffers: the
    same kernels on the same inputs, so live slots' logits and tokens
    must be equal bit for bit.  Inactive slots are not compared: they
    all write block 0, offset 0 and read it back, and which of those
    duplicate writes lands is not determined on the card.  The replay
    writes each live slot's K/V at its position, the values the next
    real step writes there again."""
    eng._grow()                 # the next step's blocks, as step() does
    eng._fill_decode_inputs()
    for dev, host in zip(eng._static_in, eng._host_in):
        dev.copy_(host)
    pools = ([p.clone() for p in eng._kpools],
             [p.clone() for p in eng._vpools])
    ins = [t.clone() for t in eng._static_in]
    with torch.no_grad():
        nxt_e, logits_e = eng._step_fn(eng._wts, *pools, *ins)
    eng._graph.replay()
    nxt_g, logits_g = eng._graph_out
    torch.cuda.synchronize()
    live = [i for i, r in enumerate(eng._sched.slots) if r is not None]
    ok = bool(torch.equal(logits_g[live], logits_e[live])
              and torch.equal(nxt_g[live], nxt_e[live]))
    return {"live_slots": len(live), "bitwise_equal": ok,
            "max_abs_diff": (logits_g[live] - logits_e[live])
            .abs().max().item()}


def replay_ms(eng, torch, reps=10):
    """Device time of one replay of the captured decode step on the
    current inputs (CUDA events; it rewrites the live slots' K/V at
    their positions with the same values)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng._graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def engine_bound(net, eng):
    """Bytes one decode step must move: the weights once, and every
    slot's gathered K and V rows (max_blocks x block_size positions per
    layer), at the card's memory rate."""
    weights = sum(p.numel() * p.element_size() for p in net.parameters())
    pool = eng._kpools[0]
    row = eng.max_blocks * eng.block_size * pool.shape[2] * pool.shape[3]
    gathered = 2 * len(eng._kpools) * eng.max_batch * row \
        * pool.element_size()
    return {"weights_bytes": weights, "gathered_pool_bytes": gathered,
            "bound_ms": (weights + gathered) / H100_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def phase_serve_engine(mt, torch, net):
    """The serving engine at full width: bench.py's traffic, every
    request finished with no leaked block, one decode capture, tokens
    equal to generate() but at ties, the captured step equal to the
    eager one, and its times against its byte bound."""
    import numpy as np
    from incubator_mxnet_tpu_torch.serving import FINISHED, ServingEngine

    launches = mt.ops.LAUNCHES
    prompts = engine_prompts(MODEL["vocab_size"])
    eng = ServingEngine(net, **ENGINE)
    mt.ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]   # the main path
    decode_ms, eager_check = [], None
    while eng.has_work():
        t_step = time.perf_counter()
        events = eng.step()
        dt = (time.perf_counter() - t_step) * 1e3
        if len(events) == len({r.id for r, _ in events}):
            decode_ms.append((dt, len(events)))       # no admission
        if eager_check is None and eng._graph is not None \
                and eng._sched.n_running() == eng.max_batch:
            t_check = time.perf_counter()
            eager_check = graph_matches_eager(eng, torch)
            t0 += time.perf_counter() - t_check       # not the traffic's
    wall_s = time.perf_counter() - t0
    path_launches = {k: v for k, v in launches.items() if v}
    flash_launches = {k: launches.get(k, 0) for k in TRAIN_KERNELS}
    check(all(r.state == FINISHED for r in reqs),
          f"engine states {[r.state for r in reqs]}")
    refs = eng.cache.block_refs()
    check(eng.pool.live() == refs
          and eng.pool.num_allocated == sum(refs.values()),
          f"leaked blocks: {eng.pool.live()} against the cache's {refs}")
    check(eng.trace_counts.get("decode") == 1,
          f"decode captured {eng.trace_counts.get('decode')} times")
    check(eager_check is not None and eager_check["bitwise_equal"],
          f"captured decode step differs from the eager one: "
          f"{eager_check}")
    check(not any(k.startswith("flash") for k in path_launches),
          f"the engine's path launched {path_launches}")
    check(all(len(r.generated) == NEW_TOKENS for r in reqs),
          "engine requests short of their tokens")
    ties = compare_with_generate(net, reqs, torch)
    ttft = [r.first_token_ts - r.submit_ts for r in reqs]
    full = [ms for ms, n in decode_ms if n == eng.max_batch]
    # a second wave, every prompt in the prefix cache: profile decode
    # steps of a full batch
    wave = [eng.submit(p, NEW_TOKENS) for p in prompts[:eng.max_batch]]
    eng.step()
    check(eng._sched.n_running() == eng.max_batch, "second wave admitted")
    prof = profile(lambda: [eng.step()
                            for _ in range(ENGINE_PROFILED_STEPS)], torch)
    graph_ms = replay_ms(eng, torch)
    eng.run()
    check(all(r.state == FINISHED for r in wave), "second wave finished")
    stats = eng.stats()
    out = {"phase": "serve_engine", "config": ENGINE,
           "requests": ENGINE_REQUESTS, "new_tokens": NEW_TOKENS,
           "prompt_tokens": [len(p) for p in prompts],
           "all_finished": True, "leaked_blocks": 0,
           "cached_blocks": len(refs),
           "trace_counts": dict(eng.trace_counts),
           "wall_s": wall_s,
           "generated_tokens_per_s": ENGINE_REQUESTS * NEW_TOKENS / wall_s,
           "decode_ms_per_iteration": (float(np.median(full)) if full
                                       else None),
           "decode_iterations_full_batch": len(full),
           "decode_ms_all": [round(ms, 3) for ms, _ in decode_ms],
           "graph_replay_ms": graph_ms,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "prefix_hit_tokens": stats["prefix_hit_tokens"],
           "captured_vs_eager": eager_check,
           "generate_ties": ties, "tie_rel": TIE_REL,
           "launches": path_launches,
           "profile": prof, **engine_bound(net, eng)}
    emit(out)
    del eng
    torch.cuda.empty_cache()
    return flash_launches


# ------------------------------------------------------------------- fleet
# A2's rest at the serve_engine phase's width: the engine's operability
# hooks, the step watchdog, the auto-sized pool and the perf report, then
# three replica processes behind a ServingRouter under the JAX package's
# chaos acceptance (tests/test_serving_fleet.py:474): one replica killed
# at its 3rd dispatch, the router's 9th frame delayed; then a drain whose
# snapshots restore on the card.
FLEET_SPEC = "vocab=32000,d_model=1024,n_layers=12,n_heads=16,max_len=1024"
FLEET_REPLICAS = 3
FLEET_KILL = "router:replica:3:kill"     # replica 0's 3rd dispatch
FLEET_NET = "router:net:9:hang"          # the router's 9th frame
FLEET_NET_HANG_S = 0.2
FLEET_STEP_HANG = "serve:step:2:hang"    # (ii): the 2nd decode step
FLEET_STEP_HANG_S = 0.05
FLEET_STEP_TIMEOUT = 0.02
FLEET_TURNS = 4                          # (i): telemetry off, on, off, on
FLEET_TIMED_STEPS = 16                   # decode-only steps timed a turn
FLEET_BOOT_S = 300                       # the replicas' start, deadline
FLEET_WAIT_S = 300                       # a batch's terminals, deadline
FLEET_COUNTERS = ("serving_requests_total", "serving_tokens_total",
                  "serving_prefill_tokens_total",
                  "serving_prefix_cache_hits_total",
                  "serving_prefix_cache_misses_total",
                  "serving_preemptions_total")


def fleet_counted(mt, path, fn, *args):
    """``fn(*args)`` with the kernel wrappers' counts set to 0 before and
    added into ``path`` after: the fleet path's launches."""
    mt.ops.reset_launches()
    try:
        return fn(*args)
    finally:
        for k, v in mt.ops.LAUNCHES.items():
            if v:
                path[k] = path.get(k, 0) + v


def fleet_traffic(eng, prompts):
    """Every prompt submitted at once, the engine driven to its end:
    (requests, wall seconds, [(step ms, decode only)])."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    steps = []
    while eng.has_work():
        t = time.perf_counter()
        events = eng.step()
        steps.append(((time.perf_counter() - t) * 1e3,
                      len(events) == len({r.id for r, _ in events})))
    return reqs, time.perf_counter() - t0, steps


def fleet_margin(net, torch, tokens):
    """(top1 - top2) / |top1| of the forward's logits after ``tokens``,
    and the two token ids."""
    with torch.inference_mode():
        logits = net(torch.tensor([tokens], device=DEV))[0, -1]
    top = logits.topk(2)
    v = top.values.tolist()
    return (v[0] - v[1]) / abs(v[0]), top.indices.tolist()


def fleet_compare(net, torch, got, ref, what):
    """``got`` and ``ref``: {key: (prompt, generated)}.  Each ``got``
    equals its ``ref`` but where the two part at a tie: the forward's
    top-two logits after the shared tokens within TIE_REL, and the two
    tokens the top two (printed; that request is compared no further)."""
    ties = []
    for key, (prompt, gen) in sorted(got.items()):
        ref_gen = ref[key][1]
        check(ref[key][0] == prompt, f"{what} {key}: another prompt")
        check(len(gen) == len(ref_gen),
              f"{what} {key}: {len(gen)} tokens, the reference "
              f"{len(ref_gen)}")
        diff = [j for j in range(len(gen)) if gen[j] != ref_gen[j]]
        if not diff:
            continue
        j = diff[0]
        margin, top2 = fleet_margin(net, torch, prompt + gen[:j])
        ties.append({"what": what, "request": key, "new_token": j,
                     "got": gen[j], "reference": ref_gen[j],
                     "top2_rel_margin": margin})
        check(margin <= TIE_REL and {gen[j], ref_gen[j]} == set(top2),
              f"{what} {key} differs from the reference at new token "
              f"{j} ({gen[j]} vs {ref_gen[j]}), top-two margin {margin} "
              f"> {TIE_REL} or not the top two {top2}")
    return ties


def fleet_reading(mt):
    reg = mt.telemetry.get_registry()
    return {n: reg.counter(n).value for n in FLEET_COUNTERS}


def fleet_sync_wave(torch, eng, prompts):
    """One wave under ``set_sync_debug_mode("warn")``: each step's count
    of synchronizing CUDA calls, for decode-only steps and for steps
    that admitted (prefill copies its inputs and reads its first
    token)."""
    import warnings
    for p in prompts:
        eng.submit(p, NEW_TOKENS)
    decode, admit = [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while eng.has_work():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                events = eng.step()
            n = sum("synchroniz" in str(w.message) for w in caught)
            only = len(events) == len({r.id for r, _ in events})
            (decode if only else admit).append(n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return decode, admit


def fleet_turns(mt, torch, net, prompts):
    """Decode ms per iteration with MXTPU_TELEMETRY=0 and =1, in turns
    (off, on, off, on): an engine built under each setting, a full
    batch admitted by one step, then FLEET_TIMED_STEPS decode-only steps
    timed on the host clock (each ends in its token read)."""
    from incubator_mxnet_tpu_torch.serving import ServingEngine
    engines = {}
    for flag in ("0", "1"):
        with env_set(mt, MXTPU_TELEMETRY=flag):
            engines[flag] = ServingEngine(net, **ENGINE)
    out = {"0": [], "1": []}
    for turn in range(FLEET_TURNS):
        flag = "01"[turn % 2]
        eng = engines[flag]
        with env_set(mt, MXTPU_TELEMETRY=flag):
            for p in prompts[:eng.max_batch]:
                eng.submit(p, NEW_TOKENS)
            eng.step()
            check(eng._sched.n_running() == eng.max_batch,
                  "a turn's batch admitted by one step")
            times = []
            for _ in range(FLEET_TIMED_STEPS):
                t = time.perf_counter()
                eng.step()
                times.append((time.perf_counter() - t) * 1e3)
            eng.run()
        out[flag].append(sorted(times)[len(times) // 2])
    check(all(e.trace_counts.get("decode") == 1 for e in engines.values()),
          "a turn's engine captured decode more than once")
    return {"telemetry_off_ms": out["0"], "telemetry_on_ms": out["1"]}


def fleet_engine(mt, torch, net, prompts, path):
    """(i) the hooked engine on the phase serve_engine's traffic with
    telemetry on: counters against the traffic, one decode capture, one
    synchronizing call a decode-only iteration; then the in-turns
    timing; (iv) the perf report and the serving_mfu gauge."""
    import numpy as np
    from incubator_mxnet_tpu_torch.serving import FINISHED, ServingEngine
    before = fleet_reading(mt)
    eng = ServingEngine(net, **ENGINE)
    reqs, wall, steps = fleet_counted(mt, path, fleet_traffic, eng,
                                      prompts)
    delta = {k: v - before[k] for k, v in fleet_reading(mt).items()}
    check(all(r.state == FINISHED for r in reqs),
          f"(i) states {[r.state for r in reqs]}")
    n_prompt = sum(len(p) for p in prompts)
    hits = eng.prefix_hit_tokens
    want = {"serving_requests_total": len(prompts),
            "serving_tokens_total": len(prompts) * NEW_TOKENS,
            "serving_prefill_tokens_total": n_prompt - hits,
            "serving_prefix_cache_hits_total": hits,
            "serving_prefix_cache_misses_total": n_prompt - hits,
            "serving_preemptions_total": 0}
    check(delta == want and hits > 0,
          f"(i) counters {delta} against the traffic's {want}")
    check(eng.trace_counts.get("decode") == 1,
          f"(i) decode captured {eng.trace_counts.get('decode')} times")
    reg = mt.telemetry.get_registry()
    mfu = reg.gauge("serving_mfu").value
    check(math.isfinite(mfu) and 0.0 < mfu < 1.0,
          f"(iv) serving_mfu {mfu} not in (0, 1)")
    full = [ms for ms, only in steps if only]
    decode_ms = float(np.median(full))
    ctx = int(np.mean([len(p) + NEW_TOKENS / 2 for p in prompts]))
    rep = eng.perf_report(context_len=ctx, batch=eng.max_batch)
    sync_decode, sync_admit = fleet_counted(
        mt, path, fleet_sync_wave, torch, eng, prompts[:eng.max_batch])
    check(sync_admit and min(sync_admit) >= 1,
          f"(i) the sync counter saw no prefill sync: {sync_admit}")
    check(sync_decode and set(sync_decode) == {1},
          f"(i) synchronizing calls a decode-only step: {sync_decode}")
    check(eng.trace_counts.get("decode") == 1, "(i) one capture after "
          "the sync wave")
    ref = {r.id: (r.prompt, list(r.generated)) for r in reqs}
    ttft = [r.first_token_ts - r.submit_ts for r in reqs]
    out = {"wall_s": wall,
           "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_p99_s": float(np.percentile(ttft, 99)),
           "decode_ms_per_iteration": decode_ms,
           "counters": delta, "trace_counts": dict(eng.trace_counts),
           "syncs_per_decode_step": sync_decode,
           "syncs_per_admit_step": sync_admit,
           "serving_mfu": mfu,
           "serving_flops_per_token":
               reg.gauge("serving_flops_per_token").value,
           "perf_report": {
               "context_len": rep["context_len"], "batch": rep["batch"],
               "dtype": rep["dtype"], "device": rep["device"],
               "flops_per_token": rep["flops_per_token"],
               "roofline_ms": rep["roofline"]["predicted_s"] * 1e3,
               "bound": rep["roofline"]["bound"],
               "per_family": rep["per_family"]},
           "span_serve_decode_p50_s": reg.histogram(
               "span_serve_decode_seconds").percentile(0.5)}
    del eng
    out["in_turns"] = fleet_counted(mt, path, fleet_turns, mt, torch, net,
                                    prompts)
    return ref, out


def fleet_watchdog(mt, torch, net, prompts, ref, tmp, path):
    """(ii) serve:step:2:hang of 0.05 s against a 0.02-s budget: one
    serve_step_overrun of at least 0.05 s, the flight recorder dumped
    for it, and every request with the unfaulted run's tokens."""
    import os
    from incubator_mxnet_tpu_torch.serving import FINISHED, ServingEngine
    eng = ServingEngine(net, **ENGINE, step_timeout=FLEET_STEP_TIMEOUT)
    eng._capture()          # the capture's time stays out of the watch
    dump = os.path.join(tmp, "flight.jsonl")
    with env_set(mt, MXTPU_FAULT_SPEC=FLEET_STEP_HANG,
                 MXTPU_FAULT_HANG_S=FLEET_STEP_HANG_S,
                 MXTPU_TRACE_DUMP=dump):
        reqs, _, _ = fleet_counted(mt, path, fleet_traffic, eng, prompts)
    evs = mt.tracing.events("serve_step_overrun", engine=eng.engine_id)
    hung = [e for e in evs if e["seconds"] >= FLEET_STEP_HANG_S]
    check(len(hung) == 1, f"(ii) overruns {evs}")
    with open(dump) as f:
        head = json.loads(f.readline())
    check(head.get("reason") == "serve_step_overrun",
          f"(ii) the dump's first line {head}")
    check(all(r.state == FINISHED for r in reqs), "(ii) states")
    check(eng.trace_counts.get("decode") == 1, "(ii) one capture")
    got = {r.id: (r.prompt, list(r.generated)) for r in reqs}
    ties = fleet_compare(net, torch, got, ref, "watchdog")
    return {"overruns": [{"seconds": e["seconds"], "budget": e["budget"]}
                         for e in evs],
            "dump_reason": head.get("reason"), "ties": ties}


def fleet_auto_pool(mt, torch, net, prompts, ref, path):
    """(iii) num_blocks="auto" on the card: the pool's block count and
    the plan, the traffic served, the peak the engine allocated against
    the plan; a budget below the weights refused before any pool."""
    from incubator_mxnet_tpu_torch.serving import FINISHED, ServingEngine
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(net, **dict(ENGINE, num_blocks="auto"))
    plan = eng.memory_plan
    reqs, _, _ = fleet_counted(mt, path, fleet_traffic, eng, prompts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(all(r.state == FINISHED for r in reqs), "(iii) states")
    got = {r.id: (r.prompt, list(r.generated)) for r in reqs}
    ties = fleet_compare(net, torch, got, ref, "auto_pool")
    out = {"num_blocks": eng.num_blocks,
           "cap": eng.max_batch * eng.max_blocks + 1,
           "plan": plan.as_dict(),
           "engine_peak_bytes": peak,
           "engine_peak_over_plan_kv_and_workspace":
               peak / (plan.kv_pool + plan.activations),
           "ties": ties}
    del eng, reqs
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    refused = None
    with env_set(mt, MXTPU_HBM_BYTES=plan.params / 2):
        try:
            ServingEngine(net, **dict(ENGINE, num_blocks="auto"))
        except mt.resilience.MemoryPlanError as exc:
            refused = str(exc)
    torch.cuda.synchronize()
    check(refused is not None, "(iii) no MemoryPlanError below the weights")
    check(torch.cuda.memory_allocated() == held,
          "(iii) the refused engine allocated device memory")
    out["refusal"] = refused[:200]
    return out


def fleet_spawn(tmp, i, fault):
    import os
    env = dict(os.environ)
    for k in ("MXTPU_FAULT_SPEC", "MXTPU_FAULT_HANG_S", "MXTPU_TRACE_DUMP",
              "MXTPU_HBM_BYTES", "MXTPU_TELEMETRY"):
        env.pop(k, None)
    if fault:
        env["MXTPU_FAULT_SPEC"] = fault
    if DEV == "cpu":
        env["MXTPU_FORCE_CPU"] = "1"
    port_file = os.path.join(tmp, f"port{i}")
    log = open(os.path.join(tmp, f"replica{i}.log"), "wb")
    cmd = [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving.replica",
           "--tiny", FLEET_SPEC, "--name", f"fleet{i}",
           "--max-batch", str(ENGINE["max_batch"]),
           "--block-size", str(ENGINE["block_size"]),
           "--num-blocks", str(ENGINE["num_blocks"]),
           "--prefix-cache", str(int(ENGINE["prefix_cache"])),
           "--port-file", port_file]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, port_file, log


def fleet_log_tail(tmp, i, n=2000):
    import os
    try:
        with open(os.path.join(tmp, f"replica{i}.log"), "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def fleet_ports(procs, tmp):
    import os
    deadline = time.monotonic() + FLEET_BOOT_S
    while time.monotonic() < deadline:
        for i, (proc, _, _) in enumerate(procs):
            check(proc.poll() is None,
                  f"(v) replica {i} exited {proc.returncode} at start: "
                  f"{fleet_log_tail(tmp, i)}")
        if all(os.path.exists(pf) for _, pf, _ in procs):
            return [int(open(pf).read()) for _, pf, _ in procs]
        time.sleep(0.1)
    check(False, f"(v) the replicas did not come up in {FLEET_BOOT_S} s")


def fleet_wait_tokens(router, reqs):
    deadline = time.monotonic() + FLEET_WAIT_S
    while time.monotonic() < deadline and \
            not any(r.generated for r in reqs):
        router.poll()
        time.sleep(0.02)
    check(any(r.generated for r in reqs), "(vi) no token flowed")


def fleet_chaos(mt, torch, net, prompts, ref, tmp, path):
    """(v) three replica processes on the card behind a ServingRouter in
    this process; (vi) the drain."""
    import os

    import numpy as np
    from incubator_mxnet_tpu_torch.serving import (FINISHED, ServingEngine,
                                                   ServingRouter)
    from incubator_mxnet_tpu_torch.serving import router as router_mod
    procs, router, out = [], None, {}
    try:
        t_boot = time.perf_counter()
        for i in range(FLEET_REPLICAS):
            procs.append(fleet_spawn(tmp, i, FLEET_KILL if i == 0 else ""))
        ports = fleet_ports(procs, tmp)
        out["boot_s"] = time.perf_counter() - t_boot
        mt.tracing.get_recorder().clear()
        # the router module's own handles (a registry reset would leave
        # them out of the registry)
        red0 = router_mod._m_redispatch.value
        fail_hist = router_mod._m_failover
        fail0 = fail_hist.count
        with env_set(mt, MXTPU_FAULT_SPEC=FLEET_NET,
                     MXTPU_FAULT_HANG_S=FLEET_NET_HANG_S):
            router = ServingRouter(
                replicas=[("127.0.0.1", p) for p in ports],
                block_size=ENGINE["block_size"], poll_interval=0.02,
                stale_after=10.0).connect()
            t0 = time.perf_counter()
            reqs = [router.submit(p, NEW_TOKENS, deadline=FLEET_WAIT_S)
                    for p in prompts]
            done = router.wait(reqs, timeout=FLEET_WAIT_S)
            wall = time.perf_counter() - t0
        check(done, f"(v) not every request ended: "
              f"{[r.state for r in reqs]}")
        check(all(r.state == FINISHED for r in reqs),
              f"(v) states {[(r.id, r.state, r.error) for r in reqs]}")
        for r in reqs:
            n = len(mt.tracing.events("router_terminal", rid=r.id))
            check(n == 1, f"(v) request {r.id}: {n} router_terminal events")
        code = procs[0][0].wait(timeout=60)
        check(code == 1, f"(v) replica 0 exited {code}, not 1")
        redispatches = router_mod._m_redispatch.value - red0
        red_events = mt.tracing.events("router_redispatch")
        check(redispatches >= 1 and red_events,
              f"(v) re-dispatches {redispatches}, events {len(red_events)}")
        homes = {}
        for ev in mt.tracing.events():
            if ev.get("event") in ("router_dispatch", "router_redispatch"):
                homes.setdefault(ev["rid"], []).append(ev["replica"])
        even = {homes[r.id][-1] for r in reqs if r.id % 2 == 0}
        odd = {homes[r.id][-1] for r in reqs if r.id % 2 == 1}
        check(len(even) < len(odd),
              f"(v) the shared-prompt requests landed on {sorted(even)}, "
              f"the others on {sorted(odd)}")
        got = {r.id: (r.prompt, list(r.generated)) for r in reqs}
        survivors = [f"replica{i}" for i in range(1, FLEET_REPLICAS)]
        stats = {}
        for name in survivors:
            st = router.replica_stats(name, timeout=30.0)
            cache = {int(k): v for k, v in st["cache_refs"].items()}
            live = {int(k): v for k, v in st["pool_live"].items()}
            check(live == cache and st["num_allocated"]
                  == sum(cache.values()),
                  f"(v) {name} holds blocks beyond its prefix cache: "
                  f"{live} against {cache}")
            stats[name] = {
                "num_allocated": st["num_allocated"],
                "cache_blocks": len(cache),
                "device_peak_bytes": st["memory"].get("device_peak_bytes"),
                "decode_captures": st["stats"]["trace_counts"].get("decode")}
        samples = list(fail_hist._samples)[-(fail_hist.count - fail0):] \
            if fail_hist.count > fail0 else []
        ttft = [r.first_token_ts - r.submit_ts for r in reqs]
        # the same traffic again through the two survivors, now warm (the
        # chaos batch paid each replica's capture and first prefills)
        t0 = time.perf_counter()
        warm = [router.submit(p, NEW_TOKENS, deadline=FLEET_WAIT_S)
                for p in prompts]
        check(router.wait(warm, timeout=FLEET_WAIT_S)
              and all(r.state == FINISHED for r in warm),
              f"(v) warm batch states {[r.state for r in warm]}")
        warm_wall = time.perf_counter() - t0
        warm_ttft = [r.first_token_ts - r.submit_ts for r in warm]
        got_warm = {i: (r.prompt, list(r.generated))
                    for i, r in enumerate(warm)}
        out.update({
            "wall_s": wall,
            "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "warm_survivors": {
                "wall_s": warm_wall,
                "tokens_per_s": len(prompts) * NEW_TOKENS / warm_wall,
                "ttft_p50_s": float(np.percentile(warm_ttft, 50)),
                "ttft_p99_s": float(np.percentile(warm_ttft, 99))},
            "replica0_exit": code, "redispatches": redispatches,
            "redispatched_requests": sorted(
                r.id for r in reqs if r.redispatches),
            "recovery_s": samples,
            "homes_even": sorted(even), "homes_odd": sorted(odd),
            "survivors": stats})
        # (vi) a second batch, drained once tokens flow
        reqs2 = [router.submit(p, NEW_TOKENS, deadline=FLEET_WAIT_S)
                 for p in prompts]
        fleet_wait_tokens(router, reqs2)
        snapdir = os.path.join(tmp, "snaps")
        os.makedirs(snapdir)
        drained = router.drain(wait=True, timeout=120.0,
                               snapshot_dir=snapdir)
        check(drained == set(survivors), f"(vi) drained {drained}")
        for i in range(1, FLEET_REPLICAS):
            code = procs[i][0].wait(timeout=120)
            check(code == 0, f"(vi) replica {i} exited {code}: "
                  f"{fleet_log_tail(tmp, i)}")
        key = {r.id: i for i, r in enumerate(reqs2)}
        restored = {}
        for name in sorted(drained):
            eng = ServingEngine.restore(
                net, os.path.join(snapdir, f"{name}.snap"), **ENGINE)
            res = fleet_counted(mt, path, eng.run)
            states = eng.stats()["terminal_counts"]
            check(set(states) == {FINISHED},
                  f"(vi) restored requests ended {states}")
            check(eng.trace_counts.get("decode", 0) <= 1,
                  "(vi) a restored engine captured twice")
            for rid, toks in res.items():
                p = prompts[key[rid]]
                restored[key[rid]] = (p, toks[len(p):])
            del eng
        live_done = {key[r.id]: (r.prompt, list(r.generated))
                     for r in reqs2 if r.done}
        check(all(r.state == FINISHED for r in reqs2 if r.done),
              "(vi) a drained request ended otherwise than finished")
        lost = [key[r.id] for r in reqs2
                if not r.done and key[r.id] not in restored]
        check(not lost, f"(vi) requests lost: {lost}")
        check(len(restored) > 0 and any(not r.done for r in reqs2),
              "(vi) the drain left no work to restore")
        out["drain"] = {"finished_live": len(live_done),
                        "restored": len(restored),
                        "snapshots": sorted(drained)}
        out["ties"] = fleet_compare(net, torch, got, ref, "fleet")
        out["ties"] += fleet_compare(net, torch, got_warm, ref, "warm")
        out["ties"] += fleet_compare(net, torch, live_done, ref,
                                     "drained_live")
        out["ties"] += fleet_compare(net, torch, restored, ref, "restored")
    except CheckFailed:
        emit({"phase": "fleet", "failed": True,
              "router": router.stats() if router is not None else None,
              "replica_logs": {i: fleet_log_tail(tmp, i)
                               for i in range(len(procs))}})
        raise
    finally:
        if router is not None:
            router.close()
        for proc, _, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()
    return out


def phase_fleet(mt, torch, card):
    """A2's rest on the card at the serve_engine phase's width: the
    hooked engine (i), the watchdog (ii), the auto pool (iii), the perf
    report (iv), the three-replica fleet under the chaos faults (v) and
    its drain (vi).  Every request of every part is held against the
    in-process engine's tokens over ``_build_tiny`` of the replicas'
    spec, but at printed top-two ties within TIE_REL."""
    import shutil
    import tempfile
    from incubator_mxnet_tpu_torch.serving.replica import _build_tiny
    path = {}
    net = _build_tiny(FLEET_SPEC)
    check(net.device.type == DEV, f"_build_tiny built on {net.device}")
    prompts = engine_prompts(MODEL["vocab_size"])
    tmp = tempfile.mkdtemp(prefix="fleet_")
    try:
        # every part keys a request by its place in the traffic: engine
        # and router ids count from 0 in submission order
        ref, engine = fleet_engine(mt, torch, net, prompts, path)
        watchdog = fleet_watchdog(mt, torch, net, prompts, ref, tmp, path)
        auto = fleet_auto_pool(mt, torch, net, prompts, ref, path)
        gc.collect()
        torch.cuda.empty_cache()
        chaos = fleet_chaos(mt, torch, net, prompts, ref, tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not any(k.startswith("flash") for k in path),
          f"the fleet path launched {path}")
    emit({"phase": "fleet", "card": card, "spec": FLEET_SPEC,
          "config": ENGINE, "requests": len(prompts),
          "new_tokens": NEW_TOKENS, "tie_rel": TIE_REL,
          "engine": engine, "watchdog": watchdog, "auto_pool": auto,
          "fleet": chaos, "launches": path})
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return path


def lm_loss(outputs, labels):
    """bench.py's LM loss (bench.py:224-236): logsumexp minus the
    picked logit, in fp32, averaged over tokens."""
    logits = outputs[0].float()
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logits.logsumexp(-1) - picked).mean()


def train_check_cpu(mt, torch, net):
    """(i) one fp32 loss and its gradients on the card (kernels) against
    the same weights on the CPU (plain versions), B=1 x L=256.

    Tolerances: loss rel err <= 1e-4.  Gradients: at this width the
    CPU's own fp32 gradient moves by up to ~3e-3 (per parameter,
    relative norm; median ~3e-4) when its weights are nudged by 1e-7,
    which moves the logits by ~1e-6, as summation order on the card
    does (the forward phase's rel err): ReLU inputs within rounding of
    0 flip.  This run measures that floor and prints it.  So every
    parameter's rel err must be <= 1e-2 and their median <= 3e-3; a
    kernel or plumbing fault gives O(1).  The kernels themselves are
    held elementwise in the kernels_bwd phase."""
    gen = torch.Generator().manual_seed(SEED + 3)
    b, l = TRAIN_CHECK
    x, y = (torch.randint(0, MODEL["vocab_size"], (b, l), generator=gen)
            for _ in range(2))

    def loss_and_grads(model, x, y):
        names, params = zip(*model.named_parameters())
        loss = lm_loss([model(x)], y)
        grads = torch.autograd.grad(loss, params)
        return float(loss.detach()), dict(zip(names, grads))

    def rel_errs(got, ref):
        out = {}
        for name, r in ref.items():
            norm = r.norm().item()
            if norm > 0.0:      # e.g. embedding rows no token uses
                out[name] = (got[name].cpu() - r).norm().item() / norm
        return out

    def summary(errs):
        vals = sorted(errs.values())
        worst = max(errs, key=errs.get)
        return {"median": vals[len(vals) // 2], "worst": errs[worst],
                "worst_param": worst}

    mt.ops.reset_launches()
    card_loss, card_grads = loss_and_grads(net, x.cuda(), y.cuda())
    torch.cuda.synchronize()
    n = {k: mt.ops.LAUNCHES[k] for k in TRAIN_KERNELS}
    check(all(v == MODEL["n_layers"] for v in n.values()),
          f"gradient check launched {n}, not one per layer each")
    cpu_net = build_model("cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in
                             net.state_dict().items()})
    cpu_loss, cpu_grads = loss_and_grads(cpu_net, x, y)
    errs = rel_errs(card_grads, cpu_grads)
    with torch.no_grad():       # the CPU's own floor: nudge by 1e-7
        for p in cpu_net.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    floor = summary(rel_errs(loss_and_grads(cpu_net, x, y)[1], cpu_grads))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    got = summary(errs)
    check(loss_rel <= 1e-4, f"card vs CPU loss rel err {loss_rel} > 1e-4")
    check(got["worst"] <= 1e-2 and got["median"] <= 3e-3,
          f"card vs CPU gradients {got} beyond 1e-2 worst / 3e-3 "
          f"median (CPU's own floor {floor})")
    return {"batch": b, "seq": l, "loss_card": card_loss,
            "loss_cpu": cpu_loss, "loss_rel_err": loss_rel,
            "loss_tol": 1e-4, "grad_rel_err": got,
            "grad_tol": {"worst": 1e-2, "median": 3e-3},
            "cpu_floor_nudge_1e-7": floor,
            "params_checked": len(errs),
            "params_zero_grad_skipped": len(cpu_grads) - len(errs)}


def run_way(mt, torch, make_step, way, x, y, steps, timed, values, prof):
    """``steps`` training steps of a fresh ``make_step()``, called through
    ``_eager_call`` (way "eager": op by op, the yardstick) or as users
    call it (way "captured": on the card the first call captures the
    step as one CUDA graph, each call replays it).  Returns (record,
    (losses, values(step) cloned), [launches of the port's kernels in
    each call]).  The record: losses; the steps before the timed ones
    each end in a synchronize (``warmup_ms_each``); the last ``timed``
    run back to back with one synchronize at the end, as bench.py
    times them: ``step_ms`` is that window over its steps, and
    ``step_ms_median`` the median of the steps' spans between CUDA
    events recorded between them; peak memory (over the run, and over
    the calls after the first, which for the captured way holds the
    warm-up steps, their snapshot and the capture; a replay allocates
    nothing, its intermediates live in the graph's private pool, which
    the reserved bytes at the end count), ``prof(step, call)`` of one
    more step, and the captures."""
    launches = mt.ops.LAUNCHES
    torch.cuda.synchronize()
    gc.collect()        # a step and its StepGraph refer to each other
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_step()
    call = step._eager_call if way == "eager" else step
    losses, warm_ms, per_call = [], [], []

    def one():
        mt.ops.reset_launches()
        losses.append(call(x, y))               # the main path
        per_call.append({k: v for k, v in launches.items() if v})

    for i in range(steps - timed):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            peak_first = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(timed + 1)]
    t0 = time.perf_counter()
    for ev in events[:-1]:
        ev.record()
        one()
    events[-1].record()
    torch.cuda.synchronize()
    window = (time.perf_counter() - t0) * 1e3
    spans = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    final = (torch.stack(losses), [t.detach().clone() for t in values(step)])
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"{way} losses {vals}")
    check(vals[-1] < vals[0], f"{way} loss did not fall: {vals}")
    rec = {"losses": vals, "warmup_ms_each": warm_ms,
           "step_ms": window / timed,
           "step_ms_median": spans[len(spans) // 2],
           "step_ms_min_max": [spans[0], spans[-1]],
           "peak_memory_bytes": max(peak, peak_first),
           "peak_memory_after_first_call_bytes": peak,
           "reserved_bytes": reserved,
           "profile": prof(step, call),
           "captures": dict(step.trace_counts)}
    if way == "captured":
        check(rec["captures"] == {"train_step": 1},
              f"captures {rec['captures']}, not one")
    return rec, final, per_call


def captured_vs_eager(mt, torch, make_step, x, y, steps, timed, values,
                      prof):
    """``run_way`` eager, then captured, from the same seeded start; the
    two ways' losses and ``values(step)`` (parameters, moving stats)
    must be equal bit for bit.  Returns (record, {way: [launches of
    each call]})."""
    recs, finals, counts = {}, {}, {}
    for way in ("eager", "captured"):
        recs[way], finals[way], counts[way] = run_way(
            mt, torch, make_step, way, x, y, steps, timed, values, prof)
    (le, ve), (lc, vc) = finals["eager"], finals["captured"]
    bitwise = {"losses": bool(torch.equal(le, lc)),
               "values": sum(not torch.equal(a, b) for a, b in zip(ve, vc)),
               "values_compared": len(ve)}
    recs["bitwise_equal"] = bitwise
    check(bitwise["losses"] and bitwise["values"] == 0,
          f"captured step vs eager: losses {lc.tolist()} vs {le.tolist()}, "
          f"{bitwise['values']} of {len(ve)} tensors differ")
    return recs, counts


def check_train_launches(mt, counts, ways, what):
    """Each eager step launched flash_fwd, flash_dq and flash_dkv once per
    layer; the captured step launched them at its first call only (the
    warm-up steps and the capture), and one profiled step of each way
    (a replay, for the captured one) ran each kernel once per layer on
    the card."""
    layers = MODEL["n_layers"]
    first = (mt.parallel._graph.WARMUP_STEPS + 1) * layers
    for k in TRAIN_KERNELS:
        eager = [c.get(k, 0) for c in counts["eager"]]
        capt = [c.get(k, 0) for c in counts["captured"]]
        check(all(n == layers for n in eager),
              f"{what} eager steps launched {k} {eager} times, not "
              f"{layers} each")
        check(capt[0] == first and not any(capt[1:]),
              f"{what} captured steps launched {k} {capt} times, not "
              f"{first} at the first call and none at replays")
        for way in ("eager", "captured"):
            n = ways[way]["profile"].get("kernels_by_class", {}).get(k)
            check(n == layers, f"{what} {way}: one step ran {k} {n} times "
                               f"on the card, not {layers}")


def train_dropout(mt, torch):
    """Dropout inside a captured step, on a small TransformerLM (2
    layers, d 256, dropout 0.1, B=4 x L=256, Adam at lr 0 so that only
    the masks move the loss): replays draw fresh masks (three replays,
    three losses), reseeding the generator repeats them bit for bit,
    and the eager step from the same seed gives the same losses.  And
    the mask itself: the Dropout op captured alone on 2^22 ones, two
    replays, each keeping 1 - rate of them within 5 binomial standard
    deviations, the two masks different."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
        TransformerLM
    from incubator_mxnet_tpu_torch.ops.nn import dropout
    from incubator_mxnet_tpu_torch.parallel._graph import StepGraph
    rate = 0.1
    net = TransformerLM(vocab_size=1000, d_model=256, n_layers=2,
                        n_heads=4, max_len=256, dropout=rate, device="cuda")
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(SEED))
    step = mt.parallel.ShardedTrainStep(
        net, "adam", dict(learning_rate=0.0), loss_fn=lm_loss)
    gen = mt.random.generator(SEED + 9, "cuda")
    x = torch.randint(0, 1000, (4, 256),
                      generator=torch.Generator().manual_seed(SEED)).cuda()
    first = [float(step(x, x, generator=gen)) for _ in range(3)]
    gen.manual_seed(SEED + 9)
    again = [float(step(x, x, generator=gen)) for _ in range(3)]
    gen.manual_seed(SEED + 9)
    eager = [float(step._eager_call(x, x, generator=gen)) for _ in range(3)]
    check(len(set(first)) == 3, f"replays drew the same masks: {first}")
    check(again == first, f"reseeded replays {again} vs {first}")
    check(eager == first, f"the eager step from the same seed {eager} "
                          f"vs the replays' {first}")
    n = 1 << 22
    ones = torch.ones(n, device="cuda")
    mgen = mt.random.generator(SEED + 10, "cuda")
    graph = StepGraph(lambda z: dropout(z, p=rate, _rng=mgen,
                                        _training=True) != 0,
                      lambda: [], "dropout")
    masks = [graph((ones,), (mgen,))[0] for _ in range(2)]
    kept = [float(m.float().mean()) for m in masks]
    bound = 5 * math.sqrt(rate * (1 - rate) / n)
    check(all(abs(k - (1 - rate)) <= bound for k in kept),
          f"kept shares {kept}, not {1 - rate} within {bound}")
    check(not torch.equal(masks[0], masks[1]), "two replays, one mask")
    return {"rate": rate, "losses_replays": first,
            "losses_reseeded": again, "losses_eager_same_seed": eager,
            "eager_equal": eager == first, "captures": step.trace_counts,
            "mask_elements": n, "kept_shares": kept,
            "kept_bound": bound}


def phase_train(mt, torch, net, card):
    import numpy as np

    cpu_check = train_check_cpu(mt, torch, net)
    b, l = TRAIN
    vocab = MODEL["vocab_size"]
    rs = np.random.RandomState(0)       # bench.py's tokens and labels
    toks = torch.from_numpy(
        rs.randint(0, vocab, (b, l)).astype(np.int32)).cuda()
    labels = torch.from_numpy(
        rs.randint(0, vocab, (b, l)).astype(np.int32)).cuda()

    def make_step(dtype):
        def make():
            mt.initializer.initialize(net, mt.initializer.Xavier(),
                                      mt.random.generator(SEED))
            return mt.parallel.ShardedTrainStep(
                net, optimizer="adam",
                optimizer_params=dict(learning_rate=1e-4),
                loss_fn=lm_loss, compute_dtype=dtype)
        return make

    def params(step):
        return list(step.params.values())

    ways, counts = captured_vs_eager(
        mt, torch, make_step(torch.bfloat16), toks, labels,
        WARMUP_STEPS + TIMED_STEPS, TIMED_STEPS, params,
        lambda step, call: profile(lambda: call(toks, labels), torch))
    check_train_launches(mt, counts, ways, "bf16 train")
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          "masters are not fp32")
    flops_tok = net.train_flops_per_token(l)
    for way in ("eager", "captured"):
        r = ways[way]
        r["tokens_per_s"] = b * l / r["step_ms"] * 1e3
        r["mfu"] = flops_tok * r["tokens_per_s"] / H100_BF16_FLOPS
    torch.cuda.empty_cache()
    fp32, fp32_counts = captured_vs_eager(
        mt, torch, make_step(None), toks, labels,
        FP32_WARMUP_STEPS + FP32_TIMED_STEPS, FP32_TIMED_STEPS, params,
        lambda step, call: profile(lambda: call(toks, labels), torch))
    check_train_launches(mt, fp32_counts, fp32, "fp32 train")
    for way in ("eager", "captured"):
        fp32[way]["tokens_per_s"] = b * l / fp32[way]["step_ms"] * 1e3
    check(all(p.dtype == torch.float32 for p in net.parameters()),
          "parameters are not fp32")
    torch.cuda.empty_cache()
    drop = train_dropout(mt, torch)
    emit({"phase": "train", "card": card, "cpu_check": cpu_check,
          "batch": b, "seq": l, "optimizer": "adam", "lr": 1e-4,
          "compute_dtype": "bfloat16", "warmup_steps": WARMUP_STEPS,
          "timed_steps": TIMED_STEPS, "train_flops_per_token": flops_tok,
          "mfu_peak": "989 TFLOP/s bf16 dense",
          "graph_warmup_steps": mt.parallel._graph.WARMUP_STEPS,
          "bf16_step": ways, "launches_per_call": counts,
          "fp32_step": {"compute_dtype": "float32",
                        "warmup_steps": FP32_WARMUP_STEPS,
                        "timed_steps": FP32_TIMED_STEPS, **fp32,
                        "launches_per_call": fp32_counts},
          "dropout": drop})
    # the main path is the captured step; the eager yardstick's counts
    # stay in this phase's record (launches_per_call)
    return ({k: [c.get(k, 0) for c in counts["captured"]]
             for k in TRAIN_KERNELS},
            {k: [c.get(k, 0) for c in fp32_counts["captured"]]
             for k in TRAIN_KERNELS},
            {k: {"train": ways["captured"]["profile"]["kernels_by_class"]
                 .get(k, 0),
                 "fp32_train": fp32["captured"]["profile"]
                 ["kernels_by_class"].get(k, 0)}
             for k in TRAIN_KERNELS})


# --------------------------------------------------------------- resnet
# bench.py's headline workload (bench.py:2563-2640): ResNet-50 v1 through
# Gluon, functionalize and ShardedTrainStep (SGD lr 0.1, momentum 0.9,
# wd 1e-4) at batch 32 on 3x224x224, bf16 over fp32 masters.  No hand
# kernel is on this path: convolution, pooling and BatchNorm run through
# cuDNN, the products through cuBLAS.
RESNET_BATCH = 32
RESNET_IMAGE = (3, 224, 224)
RESNET_CHECK_BATCH = 2               # the card-vs-CPU step
# bench.py:39-40.  At lr 0.1 and momentum 0.9 from fresh weights the
# loss on the fixed batch rises for steps 3 to 7 (to ~15 in bf16, ~19 in
# fp32, from 7.8) and then falls below its first value by step ~10, so
# every run of this phase takes the 23 steps before it reads "falling".
RESNET_WARMUP, RESNET_TIMED = 3, 20
RESNET_LOOP_STEPS = RESNET_WARMUP + RESNET_TIMED   # the Trainer loop
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
RESNET_FLOPS_PER_IMG = 3 * 7.826e9   # bench.py:61, train = 3 x forward


def resnet_class(name):
    """The layer a device kernel of the ResNet step belongs to, from its
    name: cuDNN's convolutions (and their layout transposes), batch
    norm, pooling, cuBLAS's products (the dense layer), or the rest."""
    n = name.lower()
    if "implicit" in n or any(t in n for t in (
            "conv", "fprop", "dgrad", "wgrad", "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if "batch_norm" in n or "bn_" in n or "batchnorm" in n:
        return "batchnorm"
    if "pool" in n:
        return "pool"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def resnet_net(mt, torch, device, seed=SEED):
    """resnet50_v1() with Xavier weights from ``seed`` (drawn on the
    CPU, so every device gets the same), its deferred shapes settled."""
    net = mt.gluon.model_zoo.vision.resnet50_v1()
    mt.random.seed(seed)
    net.initialize(mt.init.Xavier(), ctx=device)
    net.infer_shape(torch.zeros(1, 3, 32, 32, device=device))
    return net


def resnet_train_flops(mt, torch, net):
    """Train FLOPs per image of ``net`` at 3x224x224: 3 x the forward's
    multiply-adds x 2 in every convolution and dense layer, from their
    weights and output shapes (bench.py's convention)."""
    from incubator_mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
    dense = mt.gluon.nn.Dense
    counts = []

    def hook(mod, _, out):
        out = out.handle if isinstance(out, mt.nd.NDArray) else out
        per_out = mod.weight[0].numel() if isinstance(mod, _Conv) \
            else mod.weight.shape[1]
        counts.append(2 * per_out * out[0].numel())

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (_Conv, dense))]
    try:
        net.infer_shape(torch.zeros(1, *RESNET_IMAGE,
                                    device=next(net.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return 3 * sum(counts)


def resnet_grads(mt, torch, net, x, y):
    """(loss, {name: gradient}) of one fp32 training forward, the names
    without the net's own prefix."""
    from incubator_mxnet_tpu_torch.parallel.data_parallel import \
        _default_loss
    pure = mt.parallel.functionalize(net)
    params = pure.params()
    outs, _ = pure.apply(params, pure.states(), [x], training=True)
    loss = _default_loss(outs, y)
    grads = torch.autograd.grad(loss, list(params.values()))
    names = [n[len(net.prefix):] for n in params]
    return float(loss.detach()), dict(zip(names, grads))


def rel_errs(got, ref):
    """{name: |got - ref| / |ref|} (norms) over the nonzero refs."""
    return {n: (got[n].cpu() - r).norm().item() / r.norm().item()
            for n, r in ref.items() if r.norm().item() > 0}


def summary(errs):
    vals = sorted(errs.values())
    worst = max(errs, key=errs.get)
    return {"median": vals[len(vals) // 2], "worst": errs[worst],
            "worst_param": worst}


def grad_tolerance(floor):
    """The card-vs-CPU gradient rule of the resnet phase (i): worst
    within max(1e-2, 3x the CPU's own floor), median within max(3e-3,
    3x its median)."""
    return {"worst": max(1e-2, 3 * floor["worst"]),
            "median": max(3e-3, 3 * floor["median"])}


def resnet_check_cpu(mt, torch):
    """(i) card against CPU, fp32, TF32 off: resnet50_v1() from seed 0
    (drawn on the CPU), carried to the card by load_gluon_params; one
    ShardedTrainStep SGD step at B=2 on each.  The losses within 1e-4
    rel; every parameter's gradient (norm's rel err) within 1e-2 and
    their median within 3e-3, or within 3x the CPU's own floor where
    that is larger: the run measures how far the CPU's gradient moves
    when its weights are nudged by 1e-7, as summation order on the card
    moves them.  Fifty BatchNorms at 2 images make that floor large
    (median 1.6e-2 on an H100), so the floor decides there.  The
    moving mean and variance of every BatchNorm after the step within
    1e-4 rel."""
    import numpy as np
    cpu_net = resnet_net(mt, torch, "cpu")
    arrays = {k: p.data().asnumpy()
              for k, p in cpu_net.collect_params().items()}
    card_net = mt.gluon.model_zoo.vision.resnet50_v1()
    mt.convert.load_gluon_params(card_net, arrays, ctx="cuda")
    rs = np.random.RandomState(SEED + 5)
    x = torch.from_numpy(rs.rand(RESNET_CHECK_BATCH, *RESNET_IMAGE)
                         .astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, (RESNET_CHECK_BATCH,))
                         .astype(np.int32))

    card_loss, card_grads = resnet_grads(mt, torch, card_net, x.cuda(),
                                         y.cuda())
    cpu_loss, cpu_grads = resnet_grads(mt, torch, cpu_net, x, y)
    got = summary(rel_errs(card_grads, cpu_grads))
    # the CPU's own floor: its gradient at weights nudged by 1e-7
    gen = np.random.RandomState(SEED + 6)
    floor_net = mt.gluon.model_zoo.vision.resnet50_v1()
    mt.convert.load_gluon_params(floor_net, {
        k: v * (1 + 1e-7 * gen.standard_normal(v.shape)).astype(np.float32)
        if "running" not in k else v for k, v in arrays.items()}, ctx="cpu")
    floor = summary(rel_errs(resnet_grads(mt, torch, floor_net, x, y)[1],
                             cpu_grads))
    del floor_net
    stats = {}
    for net, xb, yb in ((card_net, x.cuda(), y.cuda()), (cpu_net, x, y)):
        step = mt.parallel.ShardedTrainStep(net, "sgd", RESNET_SGD)
        stats[net is card_net] = (float(step(xb, yb)), {
            k[len(net.prefix):]: v.cpu() for k, v in step.states.items()})
        del step
    (card_step, card_stats), (cpu_step, cpu_stats) = stats[True], stats[False]
    stat_err = max((card_stats[k] - v).abs().max().item()
                   / v.abs().max().item() for k, v in cpu_stats.items())
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    step_rel = abs(card_step - cpu_step) / abs(cpu_step)
    check(loss_rel <= 1e-4 and step_rel <= 1e-4,
          f"resnet card vs CPU loss rel err {loss_rel}, step {step_rel}")
    tol = grad_tolerance(floor)
    check(got["worst"] <= tol["worst"] and got["median"] <= tol["median"],
          f"resnet card vs CPU gradients {got} beyond {tol} (CPU's own "
          f"floor {floor})")
    check(stat_err <= 1e-4,
          f"resnet card vs CPU moving stats rel err {stat_err} > 1e-4")
    return {"batch": RESNET_CHECK_BATCH, "loss_card": card_loss,
            "loss_cpu": cpu_loss, "loss_rel_err": loss_rel,
            "step_loss_rel_err": step_rel, "loss_tol": 1e-4,
            "grad_rel_err": got, "grad_tol": tol,
            "cpu_floor_nudge_1e-7": floor, "params_checked": len(cpu_grads),
            "moving_stats_rel_err": stat_err, "moving_stats_tol": 1e-4,
            "moving_stats_checked": len(card_stats)}


def resnet_batch(torch):
    """bench.py's batch (bench.py:2577-2579), on the card."""
    import numpy as np
    rs = np.random.RandomState(0)
    x = np.asarray(rs.rand(RESNET_BATCH, *RESNET_IMAGE), np.float32)
    y = np.asarray(rs.randint(0, 1000, (RESNET_BATCH,)), np.int32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def resnet_timed_steps(torch, step, x, y, warmup, timed):
    """Losses, warm-up ms, step ms and peak memory of ``warmup`` +
    ``timed`` steps."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(warmup)]
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(timed)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return {"losses": losses, "warmup_ms": warm_ms, "step_ms": step_ms,
            "images_per_s": RESNET_BATCH / step_ms * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def steady_peak(torch, fn, calls=2):
    """Peak memory over ``calls`` more calls of ``fn`` (past any first
    call's capture)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def resnet_step_profile(torch, run, run_optimizer):
    """One profiled step (``run()``)'s device ms by class (conv,
    batchnorm, pool, matmul, optimizer, other) and the busy share.  The
    optimizer's elementwise kernels carry no telling name, so its update
    (``run_optimizer()``) is timed alone and moved out of "other"."""
    with device_trace(torch) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by, rows = {}, []
    for e in device_events(prof):
        if e.self_device_time_total:
            ms = e.self_device_time_total / 1e3
            cls = resnet_class(e.key)
            by[cls] = by.get(cls, 0.0) + ms
            rows.append((ms, cls, e.key[:70]))
    busy = sum(by.values())
    opt_ms = device_ms(run_optimizer, torch, "the SGD update", warmup=1,
                       reps=3)
    by["optimizer"] = opt_ms
    by["other"] = by.get("other", 0.0) - opt_ms
    return {"wall_ms": wall, "device_ms": busy,
            "device_busy_share": busy / wall if busy else None,
            "device_ms_by_class": by,
            "top_ms": [[k, c, ms] for ms, c, k in sorted(rows)[::-1][:8]]}


def resnet_loop(mt, torch, x, y):
    """(iv) the imperative Gluon loop: record, SoftmaxCrossEntropyLoss,
    backward, Trainer.step(32), from fresh seeded weights, with cuDNN's
    deterministic algorithms.  The trajectory at lr 0.1 is chaotic (see
    RESNET_WARMUP): under cuDNN's default fp32 algorithms, which differ
    from run to run, a 1e-6 difference at step 2 decides whether the
    loss spikes again before step 23, so the verdict of "falling" would
    change from run to run."""
    net = resnet_net(mt, torch, "cuda")
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", RESNET_SGD)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = mt.nd.NDArray(x), mt.nd.NDArray(y)
    losses, step_ms = [], []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(RESNET_LOOP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mt.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(RESNET_BATCH)
            losses.append(float(loss.mean().asscalar()))  # synchronizes
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = det
    check(all(math.isfinite(v) for v in losses), f"loop losses {losses}")
    check(losses[-1] < losses[0], f"loop loss did not fall: {losses}")
    no_grad = [p.name for p in net.collect_params().values()
               if p.grad_req != "null"
               and not bool((p.grad().handle != 0).any())]
    check(not no_grad, f"loop left parameters without a gradient: "
                       f"{no_grad[:5]}")
    return {"steps": RESNET_LOOP_STEPS, "cudnn_deterministic": True,
            "losses": losses, "step_ms": step_ms, "step_ms_after_first":
            sorted(step_ms[1:])[len(step_ms[1:]) // 2]}


def resnet_ways(mt, torch, x, y, dtype):
    """bench.py's step (functionalize, ShardedTrainStep SGD, ``dtype``
    compute over fp32 masters) from the seeded weights over the warm-up
    and timed steps: eager and captured with cuDNN's deterministic
    algorithms (``captured_vs_eager``: parameters and moving stats
    compared bit for bit; cuDNN's default fp32 algorithms differ from
    run to run even eagerly), then captured with cuDNN's defaults, the
    step as users run it ("captured_default", the headline time)."""

    def make():
        net = resnet_net(mt, torch, "cuda")
        return mt.parallel.ShardedTrainStep(
            mt.parallel.functionalize(net), "sgd", RESNET_SGD,
            compute_dtype=dtype)

    def values(step):
        return list(step.params.values()) + list(step.states.values())

    def prof(step, call):
        # the optimizer alone on zero gradients: the same kernels
        zeros = {n: torch.zeros_like(p) for n, p in step.params.items()}
        out = resnet_step_profile(
            torch, lambda: call(x, y),
            lambda: step.opt.update(step.params, zeros, step.opt_state))
        out["host_profile"] = host_profile(lambda: call(x, y), torch,
                                           calls=1, top=12)
        return out

    steps = RESNET_WARMUP + RESNET_TIMED
    torch.backends.cudnn.deterministic = True
    try:
        ways, counts = captured_vs_eager(mt, torch, make, x, y, steps,
                                         RESNET_TIMED, values, prof)
    finally:
        torch.backends.cudnn.deterministic = False
    ways["cudnn_deterministic"] = True
    ways["captured_default"], _, counts["captured_default"] = run_way(
        mt, torch, make, "captured", x, y, steps, RESNET_TIMED, values,
        prof)
    for way in ("eager", "captured", "captured_default"):
        ways[way]["images_per_s"] = RESNET_BATCH / ways[way]["step_ms"] \
            * 1e3
    return ways, counts


def phase_resnet(mt, torch, card):
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cpu_check = resnet_check_cpu(mt, torch)
    x, y = resnet_batch(torch)
    net = resnet_net(mt, torch, "cuda")
    flops_img = resnet_train_flops(mt, torch, net)
    del net
    drift = abs(flops_img - RESNET_FLOPS_PER_IMG) / RESNET_FLOPS_PER_IMG
    check(drift <= 0.02, f"train FLOPs per image {flops_img} is "
                         f"{drift:.3%} from bench.py's 3 x 7.826e9")
    bf16, bf16_counts = resnet_ways(mt, torch, x, y, torch.bfloat16)
    for way in ("eager", "captured", "captured_default"):
        bf16[way]["mfu"] = flops_img * bf16[way]["images_per_s"] \
            / H100_BF16_FLOPS
    torch.cuda.empty_cache()
    fp32, fp32_counts = resnet_ways(mt, torch, x, y, None)
    torch.cuda.empty_cache()
    loop = resnet_loop(mt, torch, x, y)
    # the Trainer loop and ShardedTrainStep's eager fp32 step do the same
    # arithmetic under cuDNN's deterministic algorithms
    loop["losses_equal_fp32_eager"] = loop["losses"] == \
        fp32["eager"]["losses"]
    check(loop["losses_equal_fp32_eager"],
          f"Gluon loop losses {loop['losses']} are not the fp32 eager "
          f"step's {fp32['eager']['losses']}")
    n = {}
    for c in bf16_counts["captured_default"] \
            + fp32_counts["captured_default"]:
        for k, v in c.items():
            n[k] = n.get(k, 0) + v
    emit({"phase": "resnet", "card": card, "model": "resnet50_v1",
          "batch": RESNET_BATCH, "image": list(RESNET_IMAGE),
          "optimizer": "sgd", **RESNET_SGD, "tf32": tf32,
          "cpu_check": cpu_check, "train_flops_per_image": flops_img,
          "flops_drift_vs_bench": drift, "mfu_peak":
          "989 TFLOP/s bf16 dense", "warmup_steps": RESNET_WARMUP,
          "timed_steps": RESNET_TIMED,
          "graph_warmup_steps": mt.parallel._graph.WARMUP_STEPS,
          "bf16_step": bf16, "fp32_step": fp32, "gluon_loop": loop,
          "kernel_launches": {k: v for k, v in n.items() if v}})
    return n


# ------------------------------------------------------------------ rtc
# The user-kernel path: the four Pallas user kernels' CUDA twins
# (incubator_mxnet_tpu_torch/rtc_examples.py, csrc/rtc/*.cu) built
# through rtc.compile_kernel, and the eager loop of
# examples/custom_pallas_kernel.py grown to an SGD step at full width.
RTC_FULL = (8192, 4096)          # B*L = 8 x 1024 rows by the MLP width
RTC_X = (8192, 1024)             # the path's x; w is (1024, 4096)
RTC_STEPS = 5
RTC_LR = 100.0                   # the loss is a mean over 33.5M entries
RTC_ALPHA, RTC_BETA = 2.0, 0.5   # the example's parameters
# (kernel, test shape and params (the JAX test's own), full-width params;
# alpha 1.7 is no power of two, so an FMA differs from two roundings)
RTC_CASES = (
    ("scale", (2, 3), dict(alpha=3.0), dict(alpha=1.7)),
    ("addone", (32, 16), {}, {}),
    ("fused_scale_shift_relu", (3, 4), dict(alpha=2.0, beta=0.5),
     dict(alpha=1.7, beta=0.3)),
    ("scale_shift", (256, 256), dict(alpha=2.0, beta=-1.0),
     dict(alpha=1.7, beta=0.3)))
RTC_REPLACES = {
    "scale": "tests/test_rtc.py:20",
    "addone": "tests/test_rtc.py:93",
    "fused_scale_shift_relu": "examples/custom_pallas_kernel.py:27",
    "scale_shift": "tools/flash_compile_check.py:90"}
DISPATCH_CALLS = 1000


def rtc_within_tol(name, x, got, ref, params):
    """scale and addone round once in both versions: equal bit for bit.
    x * alpha + beta is one FMA on the card and two roundings in the
    plain version: within 2 ulp of |x * alpha| + |beta|, which bounds
    the gap even where the sum cancels.  Returns the worst |error| over
    its allowance (0 when equal)."""
    diff = (got - ref).abs()
    if name in ("scale", "addone"):
        return math.inf if bool((diff != 0).any()) else 0.0
    import torch
    terms = (x * params["alpha"]).abs() + abs(params["beta"])
    ulp = torch.nextafter(terms, torch.full_like(terms, math.inf)) - terms
    return (diff / (2 * ulp)).max().item()


def rtc_library_call(name, x, params, torch):
    """One PyTorch call that computes the same function, or None."""
    if name == "scale":
        return lambda: torch.mul(x, params["alpha"])
    if name == "addone":
        return lambda: torch.add(x, 1.0)
    if name == "scale_shift":       # beta + alpha * x, broadcast
        beta = torch.tensor(params["beta"], device=x.device)
        return lambda: torch.add(beta, x, alpha=params["alpha"])
    return None                     # no single call fuses relu(ax + b)


def rtc_kernel_checks(ex, torch):
    """Build the four twins (one nvcc each, all together) and hold each
    against its plain version at the JAX test's shape and at full
    width; time kernel, plain version and library call at full width."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ex.NAMES)) as pool:
        built = dict(zip(ex.NAMES, pool.map(
            lambda n: ex.kernel(n).build(), ex.NAMES)))
    build_s = time.perf_counter() - t0
    ptxas = {}
    for b in built.values():
        ptxas.update(ptxas_report(b["log"]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 20)
    rows, entries = [], {}
    for name, shape, params, full_params in RTC_CASES:
        fn, plain = ex.kernel(name), ex.reference(name)
        row = {"name": name}
        for tag, shp, prm in (("test", shape, params),
                              ("full", RTC_FULL, full_params)):
            x = torch.randn(shp, generator=gen, device="cuda")
            got, ref = fn(x, **prm), plain(x, **prm)
            torch.cuda.synchronize()
            worst = rtc_within_tol(name, x, got, ref, prm)
            row[f"{tag}_shape"] = list(shp)
            row[f"{tag}_max_abs_err"] = (got - ref).abs().max().item()
            row[f"{tag}_worst_over_tol"] = worst
            check(worst <= 1.0, f"{name} disagrees with its plain "
                                f"version at {shp}: {row}")
        nbytes = 2 * x.numel() * 4          # read x, write o, once each
        flops = x.numel() * (2 if "beta" in prm else 1)
        row["ms"], row["call_ms"] = timed_ms(lambda: fn(x, **prm), torch,
                                             name)
        row["plain_ms"] = device_ms(lambda: plain(x, **prm), torch,
                                    f"plain {name}")
        lib = rtc_library_call(name, x, prm, torch)
        row["library_ms"], row["library_call_ms"] = \
            timed_ms(lib, torch, f"{name}'s library call") if lib \
            else (None, None)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops,
                                                  H100_FP32_FLOPS)
        row["gbytes_per_s"] = nbytes / row["ms"] / 1e6
        rows.append(row)
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/rtc/{name}.cu",
            "replaces": RTC_REPLACES[name], "launches": None,
            "max_abs_err": row["full_max_abs_err"], "ms": row["ms"],
            "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_call_ms": row["library_call_ms"],
            "shape": list(RTC_FULL), "dtype": "float32",
            "tol": "bit-exact" if name in ("scale", "addone")
                   else "2 ulp of |x*alpha|+|beta|"}
        del x, got, ref
    edges = rtc_scale_edges(ex, torch, gen)
    turns = rtc_scale_turns(ex, torch, gen)
    entries["scale"]["library_turns"] = turns
    addone_turns = rtc_addone_turns(ex, torch, gen)
    entries["addone"]["library_turns"] = addone_turns
    return {"build_seconds": build_s, "ptxas": ptxas, "cases": rows,
            "scale_edges": edges, "scale_turns": turns,
            "addone_turns": addone_turns}, entries


def rtc_scale_edges(ex, torch, gen):
    """scale bit for bit against its plain version where its 16-byte
    path cannot take the whole array: a flat view at an odd offset (x
    misaligned: the scalar loop), n not a multiple of 4 (the scalar
    tail), and n < 4."""
    fn, plain = ex.kernel("scale"), ex.reference("scale")
    flat = torch.randn(RTC_FULL, generator=gen, device="cuda").view(-1)
    cases = {"odd_offset": flat[1:], "n_mod_4_is_3": flat[:1000003],
             "n_below_4": flat[:3], "n_below_4_odd_offset": flat[1:3]}
    rows = {}
    for tag, x in cases.items():
        got, ref = fn(x, alpha=1.7), plain(x, alpha=1.7)
        torch.cuda.synchronize()
        rows[tag] = {"n": x.numel(), "x_offset_bytes": x.data_ptr() % 16,
                     "bitwise_equal": bool(torch.equal(got, ref))}
        check(rows[tag]["bitwise_equal"],
              f"scale disagrees with its plain version: {tag} {rows[tag]}")
    return rows


SCALE_TURNS = 3


def rtc_scale_turns(ex, torch, gen):
    """scale against torch.mul at full width, in turns (device ms, each
    over 20 calls), beside the same source launched on a resident grid
    that loops (132 SMs x 8 blocks of 256) in place of the one-pass
    grid: the two grid shapes its design note compares."""
    x = torch.randn(RTC_FULL, generator=gen, device="cuda")
    spec = ex._SPECS["scale"]
    resident = ex.rtc.compile_kernel(
        (ex.SOURCES / "scale.cu").read_text(), "scale", spec["signature"],
        out_shape=ex._like, block=(ex.BLOCK,), scalars=ex._numel,
        grid=lambda a, **_: (min(ex._scale_grid(a)[0], ex.MAX_BLOCKS),))
    check(bool(torch.equal(resident(x, alpha=1.7), x * 1.7)),
          "scale on the resident grid disagrees with its plain version")
    calls = {"scale": lambda: ex.kernel("scale")(x, alpha=1.7),
             "scale_resident_grid": lambda: resident(x, alpha=1.7),
             "torch_mul": lambda: torch.mul(x, 1.7)}
    ms = {k: [] for k in calls}
    for _ in range(SCALE_TURNS):
        for name, fn in calls.items():
            ms[name].append(device_ms(fn, torch, f"{name} (turns)"))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    return {"ms": ms, "median_ms": med,
            "scale_over_torch_mul": med["scale"] / med["torch_mul"],
            "resident_over_one_pass": med["scale_resident_grid"]
            / med["scale"]}


ADDONE_TURNS = 5


def rtc_addone_turns(ex, torch, gen):
    """addone against torch.add(x, 1) at full width, in ADDONE_TURNS
    interleaved traces (device ms, each over 20 calls; the method of
    tools/scale_variants.py): the medians, and each turn's ratio, whose
    spread says whether a gap between them is real."""
    x = torch.randn(RTC_FULL, generator=gen, device="cuda")
    fn = ex.kernel("addone")
    check(bool(torch.equal(fn(x), torch.add(x, 1.0))),
          "addone disagrees with x + 1")
    calls = {"addone": lambda: fn(x), "torch_add": lambda: torch.add(x, 1.0)}
    ms = {k: [] for k in calls}
    for _ in range(ADDONE_TURNS):
        for name, f in calls.items():
            ms[name].append(device_ms(f, torch, f"{name} (turns)"))
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    ratios = sorted(a / b for a, b in zip(ms["addone"], ms["torch_add"]))
    return {"ms": ms, "median_ms": med,
            "addone_over_torch_add": med["addone"] / med["torch_add"],
            "turn_ratios_min_max": [ratios[0], ratios[-1]]}


def rtc_plain_grad(x, w, t, torch):
    """The path's loss gradient by the plain formula (any dtype)."""
    w = w.clone().requires_grad_()
    z = RTC_ALPHA * (x @ w) + RTC_BETA
    loss = ((torch.relu(z) - t) ** 2).mean()
    return torch.autograd.grad(loss, w)[0]


def rtc_cpu_check(mt, ex, torch, data):
    """One step of the path on the card against the same step on the
    CPU's plain path (fp32, TF32 off).  Loss: rel 1e-5.  Gradient
    (relative norm): the ReLU mask flips where alpha*x.w + beta is
    within rounding of 0, and each flip moves the gradient by a whole
    entry's share; fp32 against float64 already differs by ~9e-5 at
    this shape for that reason.  So the card's gradient must be within
    max(1e-4, 3 x that floor), measured in this run."""
    x, w0, t = data
    out = {}
    for dev in ("cuda", "cpu"):
        xn, wn, tn = (mt.nd.array(a, ctx=dev) for a in (x, w0, t))
        wn.attach_grad()
        loss = ex.train_step(xn, wn, tn, RTC_LR, RTC_ALPHA, RTC_BETA)
        out[dev] = (float(loss.asnumpy()), wn.grad.handle.cpu())
    g64 = rtc_plain_grad(*(a.cuda().double() for a in (x, w0, t)),
                         torch).cpu()

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    floor = rel(out["cpu"][1], g64)
    grad_tol = max(1e-4, 3 * floor)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = rel(out["cuda"][1], out["cpu"][1])
    check(loss_rel <= 1e-5, f"rtc path: card vs CPU loss rel err "
                            f"{loss_rel} > 1e-5")
    check(grad_rel <= grad_tol, f"rtc path: card vs CPU gradient rel err "
                                f"{grad_rel} > {grad_tol} (floor {floor})")
    return {"loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
            "loss_rel_err": loss_rel, "loss_tol": 1e-5,
            "grad_rel_err": grad_rel, "grad_tol": grad_tol,
            "fp32_vs_fp64_floor": floor}


def host_profile(fn, torch, calls=DISPATCH_CALLS, top=10):
    """Where a call's host time goes: cProfile over ``calls`` calls, the
    functions with the most time of their own and with the most time
    under them, in us per call.  The profiler adds its own cost to
    every Python call it sees, so the total is inflated; the shares are
    the measurement."""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())

    def rank(i):        # 2: time of its own, 3: time under it
        rows = sorted(((v[i], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})")
                       for k, v in stats.items()), reverse=True)[:top]
        return [[name, t / calls * 1e6] for t, name in rows]

    return {"profiled_us_per_call": total / calls * 1e6,
            "top_own_us_per_call": rank(2),
            "top_cumulative_us_per_call": rank(3)}


def rtc_dispatch(mt, ex, torch):
    """Host cost of one eager call on a (4, 4) CUDA array, in us: a
    registered op through nd, the bare torch op, an rtc kernel through
    nd and its compile_kernel callable alone; and where the rtc calls'
    time goes (``host_profile``)."""
    a = mt.nd.ones((4, 4))
    t = a.handle

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6

    fn = ex.kernel("scale")
    return {"shape": [4, 4], "calls": DISPATCH_CALLS,
            "nd_relu_us": per_call(lambda: mt.nd.relu(a)),
            "torch_relu_us": per_call(lambda: torch.relu(t)),
            "nd_rtc_scale_us": per_call(
                lambda: mt.nd.rtc_scale(a, alpha=2.0)),
            "compile_kernel_scale_us": per_call(
                lambda: fn(t, alpha=2.0)),
            "torch_mul_us": per_call(lambda: torch.mul(t, 2.0)),
            "host_profile": {
                "compile_kernel_scale": host_profile(
                    lambda: fn(t, alpha=2.0), torch),
                "nd_rtc_scale": host_profile(
                    lambda: mt.nd.rtc_scale(a, alpha=2.0), torch)}}


def rtc_ops_path(mt, ex, torch):
    """Each twin through the user surface at full width, as its JAX
    home uses it: scale registered with its VJP and differentiated
    through nd and autograd (tests/test_rtc.py), addone and scale_shift
    called as compile_kernel callables (tests/test_rtc.py:107,
    tools/flash_compile_check.py:102).  Returns the launch counts."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    x = mt.nd.NDArray(torch.randn(RTC_FULL, generator=gen, device="cuda"))
    x.attach_grad()
    mt.ops.reset_launches()
    with mt.autograd.record():                       # the main path
        y = mt.nd.rtc_scale(x, alpha=3.0)
    y.backward()
    ex.kernel("addone")(x.handle.detach())
    ex.kernel("scale_shift")(x.handle.detach(), alpha=2.0, beta=-1.0)
    torch.cuda.synchronize()
    counts = {n: mt.ops.LAUNCHES[n] for n in ("scale", "addone",
                                             "scale_shift")}
    check(all(n == 1 for n in counts.values()),
          f"rtc ops path launched {counts}, not one each")
    check(bool((x.grad.handle == 3.0).all()), "rtc_scale's VJP")
    return counts


def phase_rtc(mt, torch):
    from incubator_mxnet_tpu_torch import rtc_examples as ex

    kernels, entries = rtc_kernel_checks(ex, torch)
    ex.register_scale_shift_relu()
    fwd, bwd = ex.scale_vjp()
    mt.rtc.register("rtc_scale", ex.kernel("scale"), arg_names=["data"],
                    vjp=(fwd, bwd))
    ops_counts = rtc_ops_path(mt, ex, torch)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(RTC_X, generator=gen)
    w0 = torch.randn(RTC_X[1], RTC_FULL[1], generator=gen) \
        / math.sqrt(RTC_X[1])
    t = torch.randn(RTC_FULL, generator=gen)
    cpu_check = rtc_cpu_check(mt, ex, torch, (x, w0, t))
    xn, wn, tn = (mt.nd.array(a) for a in (x, w0, t))   # None: the card
    wn.attach_grad()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.ops.reset_launches()
    losses, step_ms = [], []
    for _ in range(RTC_STEPS):                           # the main path
        t0 = time.perf_counter()
        loss = ex.train_step(xn, wn, tn, RTC_LR, RTC_ALPHA, RTC_BETA)
        losses.append(float(loss.asnumpy()))             # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = mt.ops.LAUNCHES["fused_scale_shift_relu"]
    peak = torch.cuda.max_memory_allocated()
    check(n == RTC_STEPS, f"rtc path launched fused_scale_shift_relu {n} "
                          f"times in {RTC_STEPS} steps")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"rtc path loss did not fall: {losses}")
    prof = profile(lambda: ex.train_step(xn, wn, tn, RTC_LR, RTC_ALPHA,
                                         RTC_BETA), torch)
    dispatch = rtc_dispatch(mt, ex, torch)
    # the registered flash op on CUDA arrays
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    q, k, v = (torch.randn(2, 128, 64, generator=gen, device="cuda")
               for _ in range(3))
    mt.ops.reset_launches()
    o = mt.nd._internal._flash_attention(*(mt.nd.NDArray(a)
                                           for a in (q, k, v)))
    torch.cuda.synchronize()
    nd_flash = mt.ops.LAUNCHES["flash_fwd"]
    ref, _ = mt.ops.flash._reference_fwd(q, k, v, True, 1 / 8.0)
    err = (o.handle - ref).abs().max().item()
    check(nd_flash == 1, f"nd._flash_attention launched flash_fwd "
                         f"{nd_flash} times")
    check(err <= TOL["float32"] * (1 + ref.abs().max().item()),
          f"nd._flash_attention err {err}")
    emit({"phase": "rtc", "kernels": kernels, "cpu_check": cpu_check,
          "x": list(RTC_X), "w": [RTC_X[1], RTC_FULL[1]],
          "t": list(RTC_FULL), "lr": RTC_LR, "alpha": RTC_ALPHA,
          "beta": RTC_BETA, "steps": RTC_STEPS, "losses": losses,
          "step_ms": step_ms, "peak_memory_bytes": peak,
          "launches": {"rtc_train": n, "rtc_ops": ops_counts},
          "profile": prof, "dispatch": dispatch,
          "nd_flash_attention": {"shape": [2, 128, 64], "launches":
                                 nd_flash, "max_abs_err": err}})
    entries["fused_scale_shift_relu"]["launches_by_path"] = {
        "rtc_train": n}
    for name, c in ops_counts.items():
        entries[name]["launches_by_path"] = {"rtc_ops": c}
    return [entries[n] for n in ex.NAMES], nd_flash

# ------------------------------------------------------------------ module
# The symbolic frontend: Symbol, Executor and Module.fit, as the reference
# trains (example/image-classification/common/fit.py).
MLP_BATCH, MLP_EPOCHS = 64, 5          # examples/train_mnist.py --quick
MLP_TRAIN, MLP_VAL = 2048, 512
MLP_SGD = dict(learning_rate=0.1, momentum=0.9)
MLP_GATE = 0.95                        # examples/train_mnist.py:128
MODULE_FIT_BATCHES = 4                 # (ii)'s checkpointed epoch


def synthetic_mnist(n, rs):
    """examples/train_mnist.py's synthetic MNIST (its lines 44-58):
    class-conditional 28x28 digits, a bright bar whose position and
    orientation encode the class, plus noise; flat (n, 784)."""
    import numpy as np
    x = rs.rand(n, 1, 28, 28).astype(np.float32) * 0.3
    y = rs.randint(0, 10, n)
    for i in range(n):
        c = y[i]
        if c < 5:
            x[i, 0, 4 + 4 * c:7 + 4 * c, 4:24] += 0.7   # h-bar rows
        else:
            x[i, 0, 4:24, 4 + 4 * (c - 5):7 + 4 * (c - 5)] += 0.7
    return x.reshape(n, 784), y.astype(np.float32)


def mnist_mlp(sym):
    """The example's mlp: fc 784-128-64-10, relu, SoftmaxOutput."""
    net = sym.FullyConnected(sym.Variable("data"), name="fc1",
                             num_hidden=128)
    net = sym.Activation(net, name="relu1", act_type="relu")
    net = sym.FullyConnected(net, name="fc2", num_hidden=64)
    net = sym.Activation(net, name="relu2", act_type="relu")
    net = sym.FullyConnected(net, name="fc3", num_hidden=10)
    return sym.SoftmaxOutput(net, name="softmax")


def module_mlp(mt):
    """(i) BASELINE config 1 through Module.fit: NDArrayIter, the acc
    metric and Speedometer; validation accuracy above the example's
    gate."""
    import numpy as np
    rs = np.random.RandomState(SEED)
    xtr, ytr = synthetic_mnist(MLP_TRAIN, rs)
    xva, yva = synthetic_mnist(MLP_VAL, rs)
    train = mt.io.NDArrayIter(xtr, ytr, MLP_BATCH, shuffle=True, seed=SEED)
    val = mt.io.NDArrayIter(xva, yva, MLP_BATCH)
    mod = mt.mod.Module(mnist_mlp(mt.sym), context="cuda")
    speed = mt.callback.Speedometer(MLP_BATCH, 8)
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, num_epoch=MLP_EPOCHS, optimizer="sgd",
            optimizer_params=MLP_SGD, initializer=mt.init.Xavier(),
            batch_end_callback=speed)
    fit_s = time.perf_counter() - t0
    acc = mod.score(val, "acc")[0][1]
    check(acc > MLP_GATE, f"MNIST MLP validation accuracy {acc} <= "
                          f"{MLP_GATE}")
    on_card = {a._data.device.type for a in mod._exec.arg_dict.values()}
    check(on_card == {"cuda"}, f"MLP arrays on {on_card}")
    return {"layers": [784, 128, 64, 10], "batch": MLP_BATCH,
            "epochs": MLP_EPOCHS, "train": MLP_TRAIN, "val": MLP_VAL,
            **MLP_SGD, "val_acc": acc, "gate": MLP_GATE,
            "fit_seconds": fit_s,
            "speedometer_samples_per_s": speed.speed}


def resnet_symbol(mt, net):
    """``net`` traced to a Symbol under a SoftmaxOutput, as bench.py
    traces it (bench.py:67)."""
    return mt.sym.SoftmaxOutput(net._to_symbol(mt.sym.Variable("data")),
                                name="softmax")


def resnet_module(mt, sym, device, arrays, batch, kvstore="local"):
    """A Module of ``sym`` bound for training at ``batch`` on ``device``
    with ``arrays`` ({name: NDArray or array}) as its weights, SGD as
    bench.py's, through ``kvstore``."""
    args = set(sym.list_arguments())
    mod = mt.mod.Module(sym, context=device)
    mod.bind(data_shapes=[("data", (batch,) + RESNET_IMAGE)],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(
        arg_params={k: v for k, v in arrays.items() if k in args},
        aux_params={k: v for k, v in arrays.items() if k not in args})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=RESNET_SGD)
    return mod


def module_loss(mod, y, torch):
    """Softmax cross-entropy (the mean) from the Module's SoftmaxOutput,
    which gives probabilities: a probability that underflows to 0
    counts as the smallest normal float32 (a loss of 87.3 for that
    image), so a diverging step reads large, not inf."""
    p = mod.get_outputs()[0].handle.gather(1, y.long().view(-1, 1))
    return -torch.log(p.clamp_min(torch.finfo(p.dtype).tiny)).mean()


def module_step_values(mt, torch, mod, x, y):
    """(loss, {param: gradient}, {aux: moving stat}) of one training
    forward_backward."""
    batch = mt.io.DataBatch([mt.nd.NDArray(x)], [mt.nd.NDArray(y)])
    mod.forward_backward(batch)
    ex = mod._exec
    return (float(module_loss(mod, y, torch)),
            {k: g.handle for k, g in ex.grad_dict.items()},
            {k: a.handle for k, a in ex.aux_dict.items()})


def module_check_cpu(mt, torch, sym, net):
    """Card against CPU, fp32, TF32 off: one Module forward_backward at
    B=2 from the same weights; the resnet phase (i) rule: losses within
    1e-4 rel, gradients within grad_tolerance of the CPU's own floor
    (its gradient at weights nudged by 1e-7), moving stats within 1e-4
    rel."""
    import numpy as np
    arrays = {k: p.data().asnumpy()
              for k, p in net.collect_params().items()}
    rs = np.random.RandomState(SEED + 5)
    x = torch.from_numpy(rs.rand(RESNET_CHECK_BATCH, *RESNET_IMAGE)
                         .astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, (RESNET_CHECK_BATCH,))
                         .astype(np.float32))
    gen = np.random.RandomState(SEED + 6)
    nudged = {k: v * (1 + 1e-7 * gen.standard_normal(v.shape))
              .astype(np.float32) if "running" not in k else v
              for k, v in arrays.items()}
    out = {}
    for tag, dev, vals in (("card", "cuda", arrays), ("cpu", "cpu", arrays),
                           ("floor", "cpu", nudged)):
        mod = resnet_module(mt, sym, dev, {k: mt.nd.array(v, ctx="cpu")
                                           for k, v in vals.items()},
                            RESNET_CHECK_BATCH)
        out[tag] = module_step_values(mt, torch, mod, x.to(dev), y.to(dev))
        del mod
    (card_loss, card_g, card_s), (cpu_loss, cpu_g, cpu_s) = \
        out["card"], out["cpu"]
    got = summary(rel_errs(card_g, cpu_g))
    floor = summary(rel_errs(out["floor"][1], cpu_g))
    tol = grad_tolerance(floor)
    stat_err = max((card_s[k].cpu() - v).abs().max().item()
                   / v.abs().max().item() for k, v in cpu_s.items())
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(loss_rel <= 1e-4, f"module card vs CPU loss rel err {loss_rel}")
    check(got["worst"] <= tol["worst"] and got["median"] <= tol["median"],
          f"module card vs CPU gradients {got} beyond {tol} (CPU's own "
          f"floor {floor})")
    check(stat_err <= 1e-4,
          f"module card vs CPU moving stats rel err {stat_err} > 1e-4")
    return {"batch": RESNET_CHECK_BATCH, "loss_card": card_loss,
            "loss_cpu": cpu_loss, "loss_rel_err": loss_rel,
            "loss_tol": 1e-4, "grad_rel_err": got, "grad_tol": tol,
            "cpu_floor_nudge_1e-7": floor, "params_checked": len(cpu_g),
            "moving_stats_rel_err": stat_err, "moving_stats_tol": 1e-4,
            "moving_stats_checked": len(cpu_s)}


def module_checkpoint(mt, torch, mod, sym):
    """fit one epoch of MODULE_FIT_BATCHES batches, save_checkpoint,
    Module.load into a fresh Module: its forward equals the trained
    one's bit for bit."""
    import tempfile
    import numpy as np
    rs = np.random.RandomState(SEED + 7)
    n = MODULE_FIT_BATCHES * RESNET_BATCH
    xs = rs.rand(n, *RESNET_IMAGE).astype(np.float32)
    ys = rs.randint(0, 1000, n).astype(np.float32)
    it = mt.io.NDArrayIter(xs, ys, RESNET_BATCH)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1)
    fit_s = time.perf_counter() - t0
    batch = mt.io.DataBatch([mt.nd.array(xs[:RESNET_BATCH], ctx="cuda")],
                            [])
    with tempfile.TemporaryDirectory() as d:
        prefix = f"{d}/resnet50"
        t0 = time.perf_counter()
        mod.save_checkpoint(prefix, 1)
        save_s = time.perf_counter() - t0
        files = sorted(p.rsplit("/", 1)[1] for p in
                       __import__("glob").glob(f"{d}/*"))
        loaded = mt.mod.Module.load(prefix, 1, context="cuda")
    loaded.bind(data_shapes=[("data", (RESNET_BATCH,) + RESNET_IMAGE)],
                label_shapes=[("softmax_label", (RESNET_BATCH,))],
                for_training=False)
    outs = []
    for m in (mod, loaded):
        m.forward(batch, is_train=False)
        outs.append(m.get_outputs()[0].handle)
    equal = bool(torch.equal(outs[0], outs[1]))
    check(equal, "a reloaded ResNet-50 checkpoint's forward differs from "
                 f"the trained Module's ({(outs[0] - outs[1]).abs().max()})")
    return {"fit_batches": MODULE_FIT_BATCHES, "fit_seconds": fit_s,
            "save_seconds": save_s, "files": files,
            "reload_outputs_bitwise_equal": equal}


def module_resnet(mt, torch, launches):
    """(ii) ResNet-50 v1 as a Symbol, trained through Module at bench.py's
    width; returns its record and its main path's launch counts."""
    net = resnet_net(mt, torch, "cuda")
    sym = resnet_symbol(mt, net)
    cpu_check = module_check_cpu(mt, torch, sym, net)
    x, y = resnet_batch(torch)
    yf = y.float()
    weights = {k: p.data().copy() for k, p in net.collect_params().items()}
    mod = resnet_module(mt, sym, "cuda", weights, RESNET_BATCH)
    batch = mt.io.DataBatch([mt.nd.NDArray(x)], [mt.nd.NDArray(yf)])
    # the Module's first step against the Gluon fp32 step's, same weights
    mod.forward_backward(batch)
    first = float(module_loss(mod, yf, torch))
    gstep = mt.parallel.ShardedTrainStep(net, "sgd", RESNET_SGD)
    gluon = float(gstep(x, y))
    del gstep, net
    torch.cuda.empty_cache()
    gluon_rel = abs(first - gluon) / abs(gluon)
    check(gluon_rel <= 1e-5, f"Module first loss {first} vs the Gluon "
                             f"fp32 step's {gluon}: rel {gluon_rel}")
    # the gradients of that forward_backward are discarded: the timed
    # run starts from the same weights as the resnet phase's fp32 step

    def step(_x, _y):
        mod.forward_backward(batch)
        mod.update()
        return module_loss(mod, yf, torch)

    mt.ops.reset_launches()
    timed = resnet_timed_steps(torch, step, x, y, RESNET_WARMUP,
                               RESNET_TIMED)          # the main path
    counts = dict(launches)
    timed["peak_memory_steady_bytes"] = steady_peak(torch,
                                                    lambda: step(x, y))
    timed["reserved_bytes"] = torch.cuda.memory_reserved()
    timed["profile"] = resnet_step_profile(
        torch, lambda: step(x, y), mod.update)
    timed["host_profile"] = host_profile(lambda: step(x, y), torch,
                                         calls=1, top=12)
    ckpt = module_checkpoint(mt, torch, mod, sym)
    del mod
    torch.cuda.empty_cache()
    tpu, tpu_counts = module_resnet_tpu(mt, torch, sym, weights, batch, x,
                                        y, first)
    nodes = len(json.loads(sym.tojson())["nodes"])
    return {"symbol_nodes": nodes, "arguments": len(sym.list_arguments()),
            "aux_states": len(sym.list_auxiliary_states()),
            "cpu_check": cpu_check, "first_loss": first,
            "gluon_fp32_loss": gluon, "loss_rel_vs_gluon": gluon_rel,
            "loss_tol_vs_gluon": 1e-5, "fp32_step": timed,
            "checkpoint": ckpt, "kvstore_tpu": tpu}, counts, tpu_counts


# tests/test_torch_module.py's tolerance between the 'local' and 'tpu'
# routes (test_module_fit_tpu_kvstore_matches_local: rtol 2e-4)
MODULE_TPU_TOL = 2e-4
MODULE_AGREE_STEPS = 2       # the second update is the first momentum's


def module_routes_agree(mt, torch, sym, weights, batch, yf):
    """The 'tpu' route's fused update against the 'local' route's
    Updater: MODULE_AGREE_STEPS steps of each from the same weights,
    under cuDNN's deterministic algorithms (its default fp32 ones differ
    run to run, and at lr 0.1 the loss amplifies that past the third
    step).  Each step's loss within MODULE_TPU_TOL rel; after the steps,
    each parameter's move from the weights (lr, wd, rescale_grad and
    momentum act on it) within MODULE_TPU_TOL of its largest entry, and
    each moving stat within MODULE_TPU_TOL rel."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for kv in ("local", "tpu"):
            mod = resnet_module(mt, sym, "cuda", weights, RESNET_BATCH,
                                kvstore=kv)
            losses = []
            for _ in range(MODULE_AGREE_STEPS):
                mod.forward_backward(batch)
                mod.update()
                losses.append(float(module_loss(mod, yf, torch)))
            arg, aux = mod.get_params()
            out[kv] = (losses, {k: v.handle for k, v in arg.items()},
                       {k: v.handle for k, v in aux.items()})
            del mod
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (ll, lw, la), (tl, tw, ta) = out["local"], out["tpu"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(ll, tl))
    move_err = 0.0
    for k, w in lw.items():
        w0 = weights[k].handle.to(w.device)
        moved = (w - w0).abs().max().item()
        if moved:
            move_err = max(move_err, ((tw[k] - w0) - (w - w0)).abs().max()
                           .item() / moved)
    stat_err = max((ta[k] - v).abs().max().item()
                   / max(v.abs().max().item(), 1e-30) for k, v in la.items())
    check(loss_rel <= MODULE_TPU_TOL,
          f"kvstore='tpu' losses {tl} vs 'local' {ll}: rel {loss_rel}")
    check(move_err <= MODULE_TPU_TOL,
          f"kvstore='tpu' parameter moves vs 'local': {move_err}")
    check(stat_err <= MODULE_TPU_TOL,
          f"kvstore='tpu' moving stats vs 'local': rel {stat_err}")
    return {"steps": MODULE_AGREE_STEPS, "cudnn_deterministic": True,
            "losses_local": ll, "losses_tpu": tl, "loss_rel_err": loss_rel,
            "param_move_err": move_err, "moving_stats_rel_err": stat_err,
            "params_compared": len(lw), "moving_stats_compared": len(la),
            "tol": MODULE_TPU_TOL}


def module_resnet_tpu(mt, torch, sym, weights, batch, x, y, local_first):
    """(ii) the same ResNet-50 Symbol and weights through Module with
    kvstore='tpu': the fused SymbolTrainStep, one CUDA graph replay a
    step.  Its first steps against the 'local' route's
    (``module_routes_agree``); the warm-up and timed steps, the first
    loss within MODULE_TPU_TOL of the 'local' route's; one capture; a
    profiled replay; and fit of MODULE_FIT_BATCHES batches, a
    checkpoint reloaded bit for bit.  Returns its record and its main
    path's launches."""
    yf = y.float()
    agree = module_routes_agree(mt, torch, sym, weights, batch, yf)
    mod = resnet_module(mt, sym, "cuda", weights, RESNET_BATCH,
                        kvstore="tpu")

    def step(_x, _y):
        mod.forward_backward(batch)
        mod.update()
        return module_loss(mod, yf, torch)

    launches = mt.ops.LAUNCHES
    mt.ops.reset_launches()
    timed = resnet_timed_steps(torch, step, x, y, RESNET_WARMUP,
                               RESNET_TIMED)          # the main path
    counts = dict(launches)
    fused = mod._mesh_step
    first = timed["losses"][0]
    rel = abs(first - local_first) / abs(local_first)
    check(rel <= MODULE_TPU_TOL, f"kvstore='tpu' first loss {first} vs "
                                 f"'local' {local_first}: rel {rel}")
    check(fused.trace_counts == {"symbol_train_step": 1},
          f"kvstore='tpu' captures {fused.trace_counts}, not one")
    timed["peak_memory_steady_bytes"] = steady_peak(torch,
                                                    lambda: step(x, y))
    timed["reserved_bytes"] = torch.cuda.memory_reserved()
    zeros = {n: torch.zeros_like(p) for n, p in fused.params.items()}
    timed["profile"] = resnet_step_profile(
        torch, lambda: step(x, y),
        lambda: fused.opt.update(fused.params, zeros, fused.opt_state,
                                 scale=fused._scale, lr=fused._lr))
    timed["host_profile"] = host_profile(lambda: step(x, y), torch,
                                         calls=1, top=12)
    timed["captures"] = dict(fused.trace_counts)
    ckpt = module_checkpoint(mt, torch, mod, sym)
    return {"first_loss": first, "first_loss_rel_vs_local": rel,
            "tol_vs_local": MODULE_TPU_TOL, "vs_local": agree,
            "fp32_step": timed, "checkpoint": ckpt}, counts


def module_rtc(mt, torch, launches):
    """(iii) The fused rtc kernel inside a bound Symbol at the rtc
    phase's width: relu(alpha * (x . w) + beta) against t, loss the
    mean square (MakeLoss), fp32.  ``sym.dot`` is the product, as
    ``nd.dot`` is on the rtc path (rtc_train), so the executor runs the
    very ops that path runs: its outputs and gradient must equal that
    path's bit for bit.  Then 5 SGD steps through Module, one
    fused_scale_shift_relu launch each."""
    from incubator_mxnet_tpu_torch import rtc_examples as ex
    if "scale_shift_relu" not in mt.ops.OPS:
        ex.register_scale_shift_relu()
    S = mt.sym
    w_var = S.Variable("w", shape=(RTC_X[1], RTC_FULL[1]))
    h = S.scale_shift_relu(S.dot(S.Variable("x"), w_var),
                           alpha=RTC_ALPHA, beta=RTC_BETA)
    loss = S.MakeLoss(S.mean(S.square(h - S.Variable("t"))), name="loss")
    graph = S.Group([loss, S.BlockGrad(h, name="h")])
    gen = torch.Generator().manual_seed(SEED)      # phase_rtc's data
    x = torch.randn(RTC_X, generator=gen)
    w0 = torch.randn(RTC_X[1], RTC_FULL[1], generator=gen) \
        / math.sqrt(RTC_X[1])
    t = torch.randn(RTC_FULL, generator=gen)
    xn, tn = mt.nd.array(x, ctx="cuda"), mt.nd.array(t, ctx="cuda")
    # the nd path: one step of rtc_train, and its forward
    wn = mt.nd.array(w0, ctx="cuda")
    h_nd = mt.nd.scale_shift_relu(mt.nd.dot(xn, wn), alpha=RTC_ALPHA,
                                  beta=RTC_BETA)
    wn.attach_grad()
    loss_nd = ex.train_step(xn, wn, tn, RTC_LR, RTC_ALPHA, RTC_BETA)
    grad = mt.nd.zeros(w0.shape, ctx="cuda")
    exe = graph.bind("cuda", {"x": xn, "w": mt.nd.array(w0, ctx="cuda"),
                              "t": tn}, args_grad={"w": grad},
                     grad_req={"w": "write"})
    mt.ops.reset_launches()
    outs = exe.forward_backward()
    torch.cuda.synchronize()
    per_forward = launches["fused_scale_shift_relu"]
    bitwise = {"loss": bool(torch.equal(outs[0].handle, loss_nd.handle)),
               "h": bool(torch.equal(outs[1].handle, h_nd.handle)),
               "grad_w": bool(torch.equal(grad.handle, wn.grad.handle))}
    check(per_forward == 1, f"the bound Symbol launched "
                            f"fused_scale_shift_relu {per_forward} times")
    check(all(bitwise.values()), f"executor vs nd path: {bitwise}")
    mod = mt.mod.Module(graph, data_names=("x", "t"), label_names=None,
                        context="cuda")
    mod.bind(data_shapes=[("x", RTC_X), ("t", RTC_FULL)])
    mod.init_params(arg_params={"w": mt.nd.array(w0, ctx="cuda")})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        learning_rate=RTC_LR, rescale_grad=1.0))
    batch = mt.io.DataBatch([xn, tn], [])
    losses, step_ms = [], []
    mt.ops.reset_launches()
    for _ in range(RTC_STEPS):                           # the main path
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        losses.append(float(mod.get_outputs()[0].asnumpy()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(launches)
    n = counts["fused_scale_shift_relu"]
    check(n == RTC_STEPS, f"Module launched fused_scale_shift_relu {n} "
                          f"times in {RTC_STEPS} steps")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"module rtc loss did not fall: {losses}")
    check(losses[0] == float(loss_nd.asnumpy()),
          "the Module's first loss differs from the nd path's")
    del mod
    tpu, tpu_counts = module_rtc_tpu(mt, torch, graph, w0, xn, tn, loss_nd,
                                     losses)
    return {"x": list(RTC_X), "w": [RTC_X[1], RTC_FULL[1]],
            "t": list(RTC_FULL), "lr": RTC_LR, "steps": RTC_STEPS,
            "launches_per_forward": per_forward,
            "bitwise_equal_to_nd_path": bitwise, "losses": losses,
            "step_ms": step_ms, "kvstore_tpu": tpu}, counts, tpu_counts


def kernel_runs(torch, fn, name):
    """How many times the card ran a kernel whose name holds ``name`` in
    one call of ``fn`` (torch.profiler), and the kernels the trace
    held."""
    with device_trace(torch) as prof:
        fn()
    kernels = [e for e in device_events(prof)
               if not e.key.startswith(("Memcpy", "Memset"))]
    return (sum(e.count for e in kernels if name in e.key),
            sorted(f"{e.key[:48]} x{e.count}" for e in kernels))


def module_rtc_tpu(mt, torch, graph, w0, xn, tn, loss_nd, local_losses):
    """(iii) the rtc Symbol's SGD steps through Module with
    kvstore='tpu' (the fused step, one CUDA graph replay a step): the
    wrapper launches fused_scale_shift_relu at the first call only
    (warm-up steps and capture), one replay runs it once on the card,
    the first loss equals the nd path's bit for bit and the later ones
    the 'local' route's within MODULE_TPU_TOL."""
    launches = mt.ops.LAUNCHES
    mod = mt.mod.Module(graph, data_names=("x", "t"), label_names=None,
                        context="cuda")
    mod.bind(data_shapes=[("x", RTC_X), ("t", RTC_FULL)])
    mod.init_params(arg_params={"w": mt.nd.array(w0, ctx="cuda")})
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params=dict(learning_rate=RTC_LR,
                                             rescale_grad=1.0))
    batch = mt.io.DataBatch([xn, tn], [])
    losses, step_ms, per_call = [], [], []
    for _ in range(RTC_STEPS):                           # the main path
        mt.ops.reset_launches()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        losses.append(float(mod.get_outputs()[0].asnumpy()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append(launches["fused_scale_shift_relu"])
    first = (mt.parallel._graph.WARMUP_STEPS + 1)
    check(per_call == [first] + [0] * (RTC_STEPS - 1),
          f"kvstore='tpu' launched fused_scale_shift_relu {per_call}, not "
          f"{first} at the first call and none at replays")

    def one():
        mod.forward_backward(batch)
        mod.update()

    runs, seen = kernel_runs(torch, one, "fused_scale_shift_relu")
    check(runs == 1, f"one replay ran fused_scale_shift_relu {runs} times; "
                     f"the trace held {seen}")
    check(losses[0] == float(loss_nd.asnumpy()),
          f"kvstore='tpu' first loss {losses[0]} vs the nd path's")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, local_losses))
    check(rel <= MODULE_TPU_TOL, f"kvstore='tpu' losses {losses} vs "
                                 f"'local' {local_losses}")
    check(mod._mesh_step.trace_counts == {"symbol_train_step": 1},
          f"captures {mod._mesh_step.trace_counts}")
    return {"losses": losses, "step_ms": step_ms,
            "launches_per_call": per_call, "runs_per_replay": runs,
            "first_loss_equals_nd_path": True,
            "max_rel_vs_local": rel,
            "captures": dict(mod._mesh_step.trace_counts)}, {
        "fused_scale_shift_relu": sum(per_call)}


def phase_module(mt, torch, card):
    launches = mt.ops.LAUNCHES
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    mt.ops.reset_launches()
    mlp = module_mlp(mt)                                 # the main path
    counts = {k: v for k, v in launches.items() if v}
    resnet, resnet_counts, resnet_tpu = module_resnet(mt, torch, launches)
    torch.cuda.empty_cache()
    rtc, rtc_counts, rtc_tpu = module_rtc(mt, torch, launches)
    tpu = {}
    for c, total in ((resnet_counts, counts), (rtc_counts, counts),
                     (resnet_tpu, tpu), (rtc_tpu, tpu)):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "module", "card": card, "tf32": tf32, "mlp": mlp,
          "resnet50": {"model": "resnet50_v1", "batch": RESNET_BATCH,
                       "image": list(RESNET_IMAGE), "optimizer": "sgd",
                       **RESNET_SGD, "kvstore": "local", **resnet},
          "rtc_symbol": rtc,
          "kernel_launches": {k: v for k, v in counts.items() if v},
          "kernel_launches_kvstore_tpu": {k: v for k, v in tpu.items()
                                          if v}})
    return counts, tpu


# ------------------------------------------------------------ hybridize
# bench.py's graph bench (bench.py:886-996) on the port: its three
# graphs bound at every level, and its CachedOp replay bench.
GRAPH_LEVELS = (0, 1, 2)
CACHEDOP_NET = (24, 64, 32)      # depth x width, batch (bench.py:957)
CACHEDOP_CALLS = 200             # replays timed after the first call


def graph_mlp(S, depth=4, width=256, classes=10, batch=32):
    """bench.py's ``_graph_mlp``: an MLP and a softmax-CE loss written
    out in primitives."""
    x = S.Variable("data")
    label = S.Variable("label")
    h = x
    for i in range(depth):
        h = S.Activation(
            S.FullyConnected(h, num_hidden=width, name=f"fc{i}"),
            act_type="relu", name=f"act{i}")
    logits = S.FullyConnected(h, num_hidden=classes, name="mlphead")
    m = S.max(logits, axis=-1, keepdims=True)
    z = logits - m
    lse = S.log(S.sum(S.exp(z), axis=-1, keepdims=True))
    logp = z - lse
    onehot = S.one_hot(label, depth=classes)
    loss = 0.0 - S.mean(S.sum(logp * onehot, axis=-1))
    shapes = {"data": (batch, width), "label": (batch,)}
    return S.Group([logits, loss]), shapes


def graph_resnet_block(mt, channels=64, hw=16, batch=2):
    """bench.py's ``_graph_resnet_block``: BasicBlockV1 traced through
    the Gluon symbol frontend (its shapes settled on the CPU)."""
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        BasicBlockV1
    with mt.name.Prefix("rb_"):
        blk = BasicBlockV1(channels, 1, in_channels=channels)
    blk.initialize(mt.init.Xavier(), ctx=mt.cpu())
    blk(mt.nd.NDArray(torch.zeros(batch, channels, hw, hw)))
    with mt.name.Prefix("rb_"):
        out = blk._to_symbol(mt.sym.Variable("data"))
    return out, {"data": (batch, channels, hw, hw)}


def graph_transformer_step(S, B=4, L=64, D=128, H=4, n_layers=2, V=1000):
    """bench.py's ``_graph_transformer_step``: a decoder-LM training
    graph with layernorm, GELU and the causal mask written out."""
    dh = D // H

    def layer_norm(t, tag):
        g, b = S.Variable(f"{tag}_gamma"), S.Variable(f"{tag}_beta")
        mu = S.mean(t, axis=-1, keepdims=True)
        xc = t - mu
        var = S.mean(xc * xc, axis=-1, keepdims=True)
        return (xc / S.sqrt(var + 1e-5)) * g + b

    def split_heads(t):
        t = S.Reshape(t, shape=(B, L, H, dh))
        t = S.transpose(t, axes=(0, 2, 1, 3))
        return S.Reshape(t, shape=(B * H, L, dh))

    def attention(y, tag):
        q = S.FullyConnected(y, num_hidden=D, flatten=False,
                             no_bias=True, name=f"{tag}_q")
        k = S.FullyConnected(y, num_hidden=D, flatten=False,
                             no_bias=True, name=f"{tag}_k")
        v = S.FullyConnected(y, num_hidden=D, flatten=False,
                             no_bias=True, name=f"{tag}_v")
        scale = S.full((1,), float(dh)) ** -0.5     # folds to a constant
        scores = S.batch_dot(split_heads(q), split_heads(k),
                             transpose_b=True) * scale
        rows = S.Reshape(S.arange(0, L), shape=(L, 1))
        cols = S.Reshape(S.arange(0, L), shape=(1, L))
        neg = (S.broadcast_greater_equal(rows, cols) - 1.0) * 1e9
        attn = S.softmax(S.broadcast_add(scores, neg), axis=-1)
        ctx = S.Reshape(
            S.transpose(S.Reshape(S.batch_dot(attn, split_heads(v)),
                                  shape=(B, H, L, dh)),
                        axes=(0, 2, 1, 3)), shape=(B, L, D))
        return S.FullyConnected(ctx, num_hidden=D, flatten=False,
                                no_bias=True, name=f"{tag}_o")

    def gelu(t):
        return 0.5 * t * (1.0 + S.erf(t / 1.4142135623730951))

    tokens = S.Variable("tokens")
    labels = S.Variable("labels")
    h = S.Embedding(tokens, S.Variable("embed_weight"), input_dim=V,
                    output_dim=D, name="embed")
    for i in range(n_layers):
        h = h + attention(layer_norm(h, f"l{i}_ln1"), f"l{i}")
        u = S.FullyConnected(layer_norm(h, f"l{i}_ln2"),
                             num_hidden=4 * D, flatten=False,
                             name=f"l{i}_ff1")
        h = h + S.FullyConnected(gelu(u), num_hidden=D, flatten=False,
                                 name=f"l{i}_ff2")
    logits = S.FullyConnected(layer_norm(h, "lnf"), num_hidden=V,
                              flatten=False, name="lmhead")
    m = S.max(logits, axis=-1, keepdims=True)
    z = logits - m
    lse = S.log(S.sum(S.exp(z), axis=-1, keepdims=True))
    loss = 0.0 - S.mean(
        S.sum((z - lse) * S.one_hot(labels, depth=V), axis=-1))
    shapes = {"tokens": (B, L), "labels": (B, L),
              "embed_weight": (V, D),
              "lmhead_weight": (V, D), "lmhead_bias": (V,),
              "lnf_gamma": (D,), "lnf_beta": (D,)}
    for i in range(n_layers):
        for ln in (f"l{i}_ln1", f"l{i}_ln2"):
            shapes[f"{ln}_gamma"] = (D,)
            shapes[f"{ln}_beta"] = (D,)
        for w in "qkvo":
            shapes[f"l{i}_{w}_weight"] = (D, D)
        shapes[f"l{i}_ff1_weight"] = (4 * D, D)
        shapes[f"l{i}_ff1_bias"] = (4 * D,)
        shapes[f"l{i}_ff2_weight"] = (D, 4 * D)
        shapes[f"l{i}_ff2_bias"] = (D,)
    return S.Group([logits, loss]), shapes


def bench_graphs(mt):
    """The three graphs of bench.py's graph bench: name -> (symbol,
    input shapes)."""
    return {"mlp": graph_mlp(mt.sym),
            "resnet_block": graph_resnet_block(mt),
            "transformer_lm_step": graph_transformer_step(mt.sym)}


def graph_values(shapes_by_name):
    """bench.py's values for a bound graph (numpy seed 42, by sorted
    name): integer labels and tokens in [0, 10), the rest uniform in
    [-0.05, 0.05)."""
    import numpy as np
    rl = np.random.RandomState(42)
    vals = {}
    for name in sorted(shapes_by_name):
        shape = shapes_by_name[name]
        if name in ("label", "labels", "tokens"):
            vals[name] = rl.randint(0, 10, shape).astype("float32")
        else:
            vals[name] = (rl.rand(*shape) * 0.1 - 0.05).astype("float32")
    return vals


def bind_at_level(mt, symbol, shapes, level, ctx):
    """(outputs as tensors, graph_report) of ``symbol`` bound on ``ctx``
    at ``MXTPU_GRAPH_OPT=level`` with ``graph_values``."""
    import os
    old = os.environ.get("MXTPU_GRAPH_OPT")
    os.environ["MXTPU_GRAPH_OPT"] = str(level)
    try:
        exe = symbol.simple_bind(ctx, grad_req="null", **shapes)
    finally:
        if old is None:
            del os.environ["MXTPU_GRAPH_OPT"]
        else:
            os.environ["MXTPU_GRAPH_OPT"] = old
    vals = graph_values({k: v.shape for k, v in exe.arg_dict.items()})
    exe.copy_params_from({k: mt.nd.array(v, ctx=ctx)
                          for k, v in vals.items()})
    return [o.handle for o in exe.forward()], exe.graph_report


def cachedop_net(mt, ctx):
    """bench.py's CachedOp bench net: 24 x Dense(64, relu) + Dense(10),
    Xavier weights from seed 0."""
    depth, width, _ = CACHEDOP_NET
    with mt.name.Prefix("gbench_"):
        net = mt.gluon.nn.HybridSequential()
        for _ in range(depth):
            net.add(mt.gluon.nn.Dense(width, activation="relu"))
        net.add(mt.gluon.nn.Dense(10))
    mt.random.seed(SEED)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    return net


def per_call_ms(fn, torch, calls):
    """Host ms per call of ``calls`` calls that each end in a device
    synchronize (bench.py's ``net(x).asnumpy()`` loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def hybridize_cachedop(mt, torch):
    """(i) bench.py's CachedOp bench on the card: eager ms per call, then
    hybridized: the first call captures, 200 more replay (ms per call);
    one trace (capture) after 201 same-shape calls, two after a second
    shape; replays equal the eager output bit for bit."""
    import numpy as np
    depth, width, batch = CACHEDOP_NET
    net = cachedop_net(mt, "cuda")
    rs = np.random.RandomState(0)
    x = mt.nd.array(rs.rand(batch, width).astype("float32"), ctx="cuda")
    x2 = mt.nd.array(rs.rand(batch // 2, width).astype("float32"),
                     ctx="cuda")
    per_call_ms(lambda: net(x), torch, 3)                  # warm-up
    eager_ms = per_call_ms(lambda: net(x), torch, 30)
    eager = net(x).handle.clone()
    eager2 = net(x2).handle.clone()
    net.hybridize()
    first = net(x).handle.clone()                          # the capture
    replay_ms = per_call_ms(lambda: net(x), torch, CACHEDOP_CALLS)
    same_shape = dict(net._cached_op.stats())
    second = net(x2).handle.clone()
    stats = net._cached_op.stats()
    bitwise = {"first": bool(torch.equal(first, eager)),
               "replay": bool(torch.equal(net(x).handle, eager)),
               "second_shape": bool(torch.equal(second, eager2))}
    check(same_shape["traces"] == 1,
          f"{same_shape} after {CACHEDOP_CALLS + 1} same-shape calls")
    check(stats["traces"] == 2, f"{stats} after a second shape")
    check(all(bitwise.values()), f"CachedOp replay vs eager: {bitwise}")
    return {"depth": depth, "width": width, "batch": batch,
            "eager_ms_per_call": eager_ms, "replay_ms_per_call": replay_ms,
            "replay_speedup": eager_ms / replay_ms,
            "stats_after_201_same_shape_calls": same_shape,
            "stats_after_second_shape": stats,
            "bitwise_equal_to_eager": bitwise}


def hybridize_resnet_inference(mt, torch):
    """(ii) resnet50_v1() inference at B=32 on bench.py's batch, eager
    and hybridized (graph mode, one capture), under deterministic cuDNN:
    outputs bit-equal; ms per call each."""
    x, _ = resnet_batch(torch)
    xs = mt.nd.NDArray(x)
    net = resnet_net(mt, torch, "cuda")
    torch.backends.cudnn.deterministic = True
    try:
        eager = net(xs).handle.clone()
        eager_ms = wall_ms(lambda: net(xs), torch, reps=5)
        net.hybridize()
        out = net(xs).handle.clone()                       # the capture
        replay_ms = wall_ms(lambda: net(xs), torch, reps=5)
        again = net(xs).handle
        stats = net._cached_op.stats()
    finally:
        torch.backends.cudnn.deterministic = False
    equal = bool(torch.equal(out, eager)) and bool(torch.equal(again, eager))
    check(equal, "hybridized resnet50 inference differs from eager: max "
                 f"{(out - eager).abs().max().item()}")
    check(stats["traces"] == 1 and stats["modes"] == ["graph"],
          f"resnet50 CachedOp {stats}")
    return {"batch": RESNET_BATCH, "eager_ms": eager_ms,
            "hybridized_ms": replay_ms, "bitwise_equal": equal,
            "stats": stats, "cudnn_deterministic": True}


HYBRID_COMPARE_STEPS = 3       # steps held bit for bit against eager


def hybridize_trainer_loop(mt, torch):
    """(iii) phase resnet (iv)'s imperative loop (autograd.record,
    SoftmaxCrossEntropyLoss, backward, Trainer.step(32)) hybridized, 23
    steps from the seeded weights, beside the same loop not hybridized
    for HYBRID_COMPARE_STEPS + 2 steps, under deterministic cuDNN: the
    first HYBRID_COMPARE_STEPS losses, the parameters and the moving
    stats after them equal bit for bit; one capture (the recorded
    forward and its backward) for the one key."""
    x, y = resnet_batch(torch)
    xs, ys = mt.nd.NDArray(x), mt.nd.NDArray(y)

    def loop(hybrid, steps):
        net = resnet_net(mt, torch, "cuda")
        if hybrid:
            net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", RESNET_SGD)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        losses, ms, snap = [], [], None
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mt.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(RESNET_BATCH)
            losses.append(float(loss.mean().asscalar()))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i + 1 == HYBRID_COMPARE_STEPS:
                snap = [p.data().handle.clone()
                        for p in net.collect_params().values()]
        return net, losses, ms, snap

    torch.backends.cudnn.deterministic = True
    try:
        _, e_losses, e_ms, e_snap = loop(False, HYBRID_COMPARE_STEPS + 2)
        release(torch)
        net, h_losses, h_ms, h_snap = loop(True, RESNET_LOOP_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    n = HYBRID_COMPARE_STEPS
    differ = sum(not torch.equal(a, b) for a, b in zip(e_snap, h_snap))
    stats = net._cached_op.stats()
    check(h_losses[:n] == e_losses[:n],
          f"hybridized loop losses {h_losses[:n]} vs eager {e_losses[:n]}")
    check(differ == 0, f"{differ} of {len(e_snap)} parameters and moving "
                       f"stats differ after {n} hybridized steps")
    check(stats["traces"] == 1 and stats["entries"] == 1,
          f"hybridized loop CachedOp {stats}")
    check(all(math.isfinite(v) for v in h_losses), f"losses {h_losses}")
    check(h_losses[-1] < h_losses[0], f"loop loss did not fall: {h_losses}")

    def median(v):
        return sorted(v)[len(v) // 2]
    return {"steps": RESNET_LOOP_STEPS, "losses": h_losses,
            "eager_losses": e_losses, "step_ms": h_ms,
            "step_ms_after_first": median(h_ms[1:]),
            "eager_step_ms_after_first": median(e_ms[1:]),
            "bitwise_equal_first_steps": n, "tensors_compared": len(e_snap),
            "stats": stats, "cudnn_deterministic": True}


CHAIN_CALLS = 3                # one block applied in a chain, an unrolled cell


def hybridize_chained(mt, torch):
    """(vi) one hybridized block applied CHAIN_CALLS times in a chain
    under one autograd.record() (an unrolled cell: every call after the
    first has the same key while the earlier ones wait for the
    backward), two iterations, in graph mode and in jit mode
    (MXTPU_GRAPH_OPT=0): the input's and every parameter's gradient
    equal the same chain's not hybridized, bit for bit; each call
    waiting for the backward holds a captured pair of its own
    (CHAIN_CALLS captures, none more at the second iteration)."""
    import os
    import numpy as np
    _, width, batch = CACHEDOP_NET
    x0 = np.random.RandomState(1).rand(batch, width).astype("float32")
    out = {}
    for mode, level in (("graph", None), ("jit", "0")):
        with mt.name.Prefix(f"chain{mode}_"):
            net = mt.gluon.nn.HybridSequential()
            net.add(mt.gluon.nn.Dense(width, in_units=width,
                                      activation="tanh"))
        mt.random.seed(SEED)
        net.initialize(mt.init.Xavier(), ctx="cuda")

        def chain():
            x = mt.nd.array(x0, ctx="cuda")
            x.attach_grad()
            with mt.autograd.record():
                h = x
                for _ in range(CHAIN_CALLS):
                    h = net(h)
                y = h.sum()
            y.backward()
            return [x.grad.handle.clone()] + [
                p.grad().handle.clone()
                for p in net.collect_params().values()]

        eager = chain()
        net.hybridize()
        old = os.environ.get("MXTPU_GRAPH_OPT")
        if level is not None:
            os.environ["MXTPU_GRAPH_OPT"] = level
        try:
            runs = [chain() for _ in range(2)]
        finally:
            if old is None:
                os.environ.pop("MXTPU_GRAPH_OPT", None)
            else:
                os.environ["MXTPU_GRAPH_OPT"] = old
        stats = net._cached_op.stats()
        equal = [all(torch.equal(a, b) for a, b in zip(run, eager))
                 for run in runs]
        check(all(equal),
              f"chained hybridized gradients ({mode}) vs eager: {equal}")
        check(stats["traces"] == CHAIN_CALLS and stats["entries"] == 1
              and stats["modes"] == [mode],
              f"chained CachedOp {stats}: not one {mode} pair per "
              f"waiting call")
        out[mode] = {"bitwise_equal_to_eager": equal, "stats": stats}
    return {"calls": CHAIN_CALLS, "width": width, "batch": batch, **out}


def hybridize_rtc(mt, torch):
    """(iv) examples/custom_pallas_kernel.py's hybridized block (its
    hybrid_forward calls F.scale_shift_relu) at the rtc phase's width,
    fp32 (8192, 4096): under autograd.record the replayed forward and
    its backward give the nd path's output and gradient bit for bit;
    one replay runs fused_scale_shift_relu once on the card.  Returns
    (record, launches of the kernel on this path)."""
    from incubator_mxnet_tpu_torch import rtc_examples as ex
    if "scale_shift_relu" not in mt.ops.OPS:
        ex.register_scale_shift_relu()
    launches = mt.ops.LAUNCHES

    class Net(mt.gluon.HybridBlock):
        def hybrid_forward(self, F, v):
            return F.scale_shift_relu(v, alpha=RTC_ALPHA, beta=RTC_BETA)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31)
    data = torch.randn(RTC_FULL, generator=gen, device="cuda")
    x = mt.nd.NDArray(data.clone())
    x.attach_grad()
    with mt.autograd.record():
        y_nd = mt.nd.scale_shift_relu(x, alpha=RTC_ALPHA, beta=RTC_BETA)
    y_nd.backward()
    net = Net()
    net.hybridize()
    xh = mt.nd.NDArray(data.clone())
    xh.attach_grad()
    per_call = []

    def one():
        mt.ops.reset_launches()
        with mt.autograd.record():
            out = net(xh)                                # the main path
        out.backward()
        per_call.append(launches["fused_scale_shift_relu"])
        return out

    y = one()
    bitwise = {"out": bool(torch.equal(y.handle, y_nd.handle)),
               "grad": bool(torch.equal(xh.grad.handle, x.grad.handle))}
    for _ in range(2):
        one()
    runs, seen = kernel_runs(torch, one, "fused_scale_shift_relu")
    # a call outside record() replays a capture of its own
    mt.ops.reset_launches()
    again = bool(torch.equal(net(xh).handle, y_nd.handle))
    torch.cuda.synchronize()
    infer_launches = launches["fused_scale_shift_relu"]
    infer_runs, _ = kernel_runs(torch, lambda: net(xh),
                                "fused_scale_shift_relu")
    stats = net._cached_op.stats()
    first = mt.parallel._graph.WARMUP_STEPS + 1
    check(all(bitwise.values()) and again,
          f"hybridized rtc block vs nd path: {bitwise}, no-record {again}")
    check(runs == 1, f"one recorded replay ran fused_scale_shift_relu "
                     f"{runs} times; the trace held {seen}")
    check(infer_runs == 1, f"one replay ran fused_scale_shift_relu "
                           f"{infer_runs} times")
    check(per_call[0] == first and not any(per_call[1:]),
          f"hybridized rtc launches per call {per_call}, not {first} at the "
          f"first call and none at replays")
    check(infer_launches == first, f"the capture outside record() launched "
                                   f"{infer_launches} times, not {first}")
    check(stats["modes"] == ["graph"] and stats["traces"] == 2,
          f"rtc CachedOp {stats}: not one capture per route")
    return {"shape": list(RTC_FULL), "bitwise_equal_to_nd": bitwise,
            "runs_per_recorded_replay": runs, "runs_per_replay": infer_runs,
            "launches_per_recorded_call": per_call,
            "launches_first_unrecorded_call": infer_launches,
            "stats": stats}, sum(per_call) + infer_launches


def hybridize_graphs(mt, torch):
    """(v) bench.py's three graphs bound on the card at levels 0, 1 and
    2: outputs bit-equal across levels; the node counts."""
    out = {}
    for name, (symbol, shapes) in bench_graphs(mt).items():
        outs, nodes = {}, {}
        for level in GRAPH_LEVELS:
            got, rep = bind_at_level(mt, symbol, shapes, level, "cuda")
            outs[level] = [t.clone() for t in got]
            nodes[level] = [rep["nodes_before"], rep["nodes_after"]] \
                if level else None
        equal = {lv: all(torch.equal(a, b)
                         for a, b in zip(outs[0], outs[lv]))
                 for lv in GRAPH_LEVELS[1:]}
        check(all(equal.values()),
              f"{name}: outputs differ across levels {equal}")
        check(all(bool(torch.isfinite(t).all()) for t in outs[0]),
              f"{name}: non-finite outputs")
        out[name] = {"nodes_before_after": nodes, "bitwise_equal": equal}
    return out


def release(torch):
    """Free what the last part held: a hybridized block and its CachedOp
    refer to each other, so their captured graphs' pools go at a
    collection."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_hybridize(mt, torch, card):
    launches = mt.ops.LAUNCHES
    mt.ops.reset_launches()
    cachedop = hybridize_cachedop(mt, torch)
    resnet = hybridize_resnet_inference(mt, torch)
    release(torch)
    loop = hybridize_trainer_loop(mt, torch)
    release(torch)
    rtc, rtc_launches = hybridize_rtc(mt, torch)
    graphs = hybridize_graphs(mt, torch)
    chained = hybridize_chained(mt, torch)
    release(torch)
    check(not any(v for k, v in launches.items()
                  if k != "fused_scale_shift_relu"),
          f"the hybridize phase launched {dict(launches)}")
    emit({"phase": "hybridize", "card": card, "cachedop_bench": cachedop,
          "resnet50_inference": resnet, "trainer_loop": loop,
          "rtc_block": rtc, "graphs": graphs, "chained": chained})
    return {"fused_scale_shift_relu": rtc_launches}, {
        "fused_scale_shift_relu": rtc["runs_per_replay"]}


# ------------------------------------------------------------------ moe
# bench.py's MoE configuration (MXTPU_BENCH_MOE=8, bench.py:181-235): the
# transformer width with top-2 routing over 8 experts.
MOE_EXPERTS = 8
MOE_CF = 1.25
MOE_TRAIN_BATCHES = (8, 4, 2)     # B x L=1024: the first whose peak fits
MOE_PEAK_LIMIT = 60e9
MOE_SERVE = (4, 128)
MOE_WARMUP, MOE_TIMED = 1, 3


def moe_loss(outputs, labels):
    """bench.py's MoE loss: its LM loss plus 0.01 x the router aux."""
    return lm_loss(outputs, labels) + 0.01 * outputs[1]


def moe_model(mt, device):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import \
        TransformerLM
    return TransformerLM(**MODEL, moe_experts=MOE_EXPERTS,
                         moe_capacity_factor=MOE_CF, device=device)


def moe_forward(mt, torch, net):
    """forward at B=8 x L=1024: logits and aux finite, flash_fwd once per
    layer; the card against the CPU's plain path at B=1 x L=256 (the
    same T on both, so the same expert capacities), rel 1e-3."""
    launches = mt.ops.LAUNCHES
    b, l = FORWARD
    layers = MODEL["n_layers"]
    gen = torch.Generator().manual_seed(SEED + 41)
    toks = torch.randint(0, MODEL["vocab_size"], (b, l), generator=gen)
    toks = toks.cuda()
    with torch.inference_mode():
        mt.ops.reset_launches()
        logits, aux = net(toks)                          # the main path
        torch.cuda.synchronize()
        n = launches["flash_fwd"]
        check(n == layers, f"moe forward launched flash_fwd {n} times")
        check(tuple(logits.shape) == (b, l, MODEL["vocab_size"]),
              "moe logits shape")
        check(bool(torch.isfinite(logits).all()) and
              math.isfinite(float(aux)), "non-finite moe logits or aux")
        del logits
        ms = wall_ms(lambda: net(toks), torch)
        prof = profile(lambda: net(toks), torch)
        cpu_net = moe_model(mt, "cpu")
        cpu_net.load_state_dict({k: v.cpu() for k, v in
                                 net.state_dict().items()})
        short = toks[:1, :256]
        got, got_aux = net(short)
        ref, ref_aux = cpu_net(short.cpu())
        rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        aux_rel = abs(float(got_aux) - float(ref_aux)) / abs(float(ref_aux))
    check(rel <= 1e-3, f"moe card vs CPU logits rel err {rel} > 1e-3")
    check(aux_rel <= 1e-3, f"moe card vs CPU aux rel err {aux_rel}")
    return {"batch": b, "seq": l, "flash_launches": n, "ms_per_forward": ms,
            "tokens_per_s": b * l / ms * 1e3, "aux": float(aux),
            "cpu_rel_err": rel, "cpu_aux_rel_err": aux_rel,
            "cpu_tol": 1e-3, "profile": prof}, n, cpu_net


def moe_generate(mt, torch, net, cpu_net):
    """generate for 4 prompts of 128 tokens, 32 new each, greedy.  Expert
    capacity is set by the tokens of one call (the prefill's B x P, a
    decode step's B), so a teacher-forced forward over the finished
    sequences routes with other capacities from the first decoded token
    on: its argmax must give the first new token (the prefill's T), and
    every token must equal the CPU's generate() on the same weights,
    both but where the top-two logits tie (TIE_REL, printed).  The
    teacher-forced agreement over all tokens is printed."""
    launches = mt.ops.LAUNCHES
    b, p = MOE_SERVE
    gen = torch.Generator().manual_seed(SEED + 42)
    prompts = torch.randint(0, MODEL["vocab_size"], (b, p), generator=gen)
    mt.ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = net.generate(prompts.cuda(), max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    n = launches["flash_fwd"]
    check(n == MODEL["n_layers"], f"moe prefill launched flash_fwd {n}")
    check(tuple(out.shape) == (b, p + NEW_TOKENS), "moe generate shape")
    with torch.inference_mode():
        logits, _ = net(prompts.cuda())
        first_margin = [tie_margin(logits[i, -1].float())
                        for i in range(b)]
        tf_logits, _ = net(out[:, :-1].long())
    first = logits[:, -1].argmax(-1).to(out.dtype)
    ties = [i for i in range(b) if first_margin[i] <= TIE_REL]
    first_ok = all(int(first[i]) == int(out[i, p]) for i in range(b)
                   if i not in ties)
    check(first_ok, f"first new tokens {out[:, p].tolist()} vs the "
                    f"forward's argmax {first.tolist()}")
    agree_tf = (tf_logits.argmax(-1)[:, p - 1:] == out[:, p:]).float() \
        .mean().item()
    ref = cpu_net.generate(prompts, max_new_tokens=NEW_TOKENS)
    differ = []
    for i in range(b):
        bad = (ref[i, p:] != out[i, p:].cpu()).nonzero()
        if len(bad):
            differ.append([i, int(bad[0])])
    margins = []
    for i, j in differ:           # a tie at the first difference only
        with torch.inference_mode():
            lg, _ = net(out[i:i + 1, :p + j].long())
        margins.append(tie_margin(lg[0, -1].float()))
    check(all(m <= TIE_REL for m in margins),
          f"moe generate differs from the CPU's at {differ} with top-two "
          f"margins {margins}")
    ms = wall_ms(lambda: net.generate(prompts.cuda(), NEW_TOKENS), torch)
    return {"requests": b, "prompt": p, "new_tokens": NEW_TOKENS,
            "flash_launches": n, "first_call_ms": gen_ms, "generate_ms": ms,
            "tokens_per_s": b * NEW_TOKENS / ms * 1e3,
            "first_token_ties": ties,
            "differs_from_cpu_at": differ, "tie_margins": margins,
            "teacher_forced_agree": agree_tf}, n


def moe_train(mt, torch, net):
    """The bf16 ShardedTrainStep (Adam lr 1e-4, loss CE + 0.01 aux) at
    the first batch of MOE_TRAIN_BATCHES whose peak stays under 60 GB:
    eager and captured from the same weights, losses finite and falling
    and equal bit for bit, parameters too, one capture, each flash kernel
    once per layer per step."""
    import numpy as np
    # the start of each way, on the host: 3.7 GB the card need not hold
    snapshot = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    vocab = MODEL["vocab_size"]
    l = TRAIN[1]
    tried = {}
    for b in MOE_TRAIN_BATCHES:
        rs = np.random.RandomState(0)
        toks = torch.from_numpy(
            rs.randint(0, vocab, (b, l)).astype(np.int32)).cuda()
        labels = torch.from_numpy(
            rs.randint(0, vocab, (b, l)).astype(np.int32)).cuda()

        def make():
            net.load_state_dict(snapshot)
            return mt.parallel.ShardedTrainStep(
                net, optimizer="adam",
                optimizer_params=dict(learning_rate=1e-4),
                loss_fn=moe_loss, compute_dtype=torch.bfloat16)

        try:
            ways, counts = captured_vs_eager(
                mt, torch, make, toks, labels, MOE_WARMUP + MOE_TIMED,
                MOE_TIMED, lambda step: list(step.params.values()),
                lambda step, call: profile(lambda: call(toks, labels),
                                           torch))
        except torch.cuda.OutOfMemoryError as exc:
            tried[b] = f"out of memory: {str(exc)[:120]}"
            release(torch)        # the failed steps' graphs hold memory
            continue
        peak = max(ways[w]["peak_memory_bytes"] for w in ("eager",
                                                          "captured"))
        tried[b] = peak
        if peak < MOE_PEAK_LIMIT:
            break
        release(torch)
    else:
        check(False, f"no MoE train batch fits under 60 GB: {tried}")
    check_train_launches(mt, counts, ways, "moe train")
    flops_tok = net.train_flops_per_token(l)
    for way in ("eager", "captured"):
        r = ways[way]
        r["tokens_per_s"] = b * l / r["step_ms"] * 1e3
        r["mfu_bf16_peak"] = flops_tok * r["tokens_per_s"] / H100_BF16_FLOPS
    del snapshot
    return {"batch": b, "seq": l, "batches_tried": tried,
            "optimizer": "adam", "lr": 1e-4, "compute_dtype": "bfloat16",
            "loss": "CE + 0.01 aux", "train_flops_per_token": flops_tok,
            "steps": ways, "launches_per_call": counts}, \
        {k: [c.get(k, 0) for c in counts["captured"]]
         for k in TRAIN_KERNELS}, \
        {k: ways["captured"]["profile"]["kernels_by_class"].get(k, 0)
         for k in TRAIN_KERNELS}


def phase_moe(mt, torch, card):
    release(torch)
    net = moe_model(mt, None)                # None: the CUDA card
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(SEED))
    n_params = sum(p.numel() for p in net.parameters())
    fwd, fwd_n, cpu_net = moe_forward(mt, torch, net)
    serve, serve_n = moe_generate(mt, torch, net, cpu_net)
    del cpu_net
    torch.cuda.empty_cache()
    train, train_launches, replay_runs = moe_train(mt, torch, net)
    emit({"phase": "moe", "card": card, "params": n_params,
          "experts": MOE_EXPERTS, "capacity_factor": MOE_CF,
          "forward": fwd, "generate": serve, "train": train})
    del net
    torch.cuda.empty_cache()
    return {"forward": fwd_n, "generate": serve_n,
            "train": train_launches}, replay_runs


# ------------------------------------------------------------------ ops
# The samplers (ops/random_op.py), the ordering ops (ops/order.py) and
# the linear-algebra ops (ops/la.py) on the card.
OPS_DRAWS = 1_000_000
OPS_SE = 5.0            # a moment within 5 of its standard errors
# op -> (parameters, mean, variance); the tensor-parameter ops draw for
# one parameter set, given as the op's tensor inputs
SAMPLERS = {
    "_random_uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    "_random_normal": (dict(loc=1.0, scale=2.0), 1.0, 4.0),
    "_random_gamma": (dict(alpha=2.5, beta=1.5), 3.75, 5.625),
    "_random_exponential": (dict(lam=2.0), 0.5, 0.25),
    "_random_poisson": (dict(lam=4.0), 4.0, 4.0),
    "_random_negative_binomial": (dict(k=3, p=0.4), 4.5, 11.25),
    "_random_generalized_negative_binomial": (dict(mu=2.0, alpha=0.5),
                                              2.0, 4.0),
    "_random_randint": (dict(low=-3, high=7, dtype="int32"), 1.5, 8.25),
}
TENSOR_SAMPLERS = {
    "_sample_uniform": ([[-1.0], [3.0]], 1.0, 16 / 12),
    "_sample_normal": ([[1.0], [2.0]], 1.0, 4.0),
    "_sample_gamma": ([[2.5], [1.5]], 3.75, 5.625),
    "_sample_exponential": ([[2.0]], 0.5, 0.25),
    "_sample_poisson": ([[4.0]], 4.0, 4.0),
    "_sample_multinomial": ([[[0.1, 0.2, 0.3, 0.4]]], 2.0, 1.0),
}
LA_TOL = 1e-10          # float64, card against the CPU (max err / max)


def ops_draw(mt, torch, name, ctx):
    nd = mt.nd
    if name in SAMPLERS:
        return getattr(nd._internal, name)(
            shape=(OPS_DRAWS,), ctx=ctx, **SAMPLERS[name][0])
    if name == "_shuffle":
        return nd._internal._shuffle(nd.arange(OPS_DRAWS, ctx=ctx))
    arrays = [nd.array(a, ctx=ctx) for a in TENSOR_SAMPLERS[name][0]]
    return getattr(nd._internal, name)(*arrays, shape=(OPS_DRAWS,))


def ops_samplers(mt, torch):
    """Each sampler's moments over 10^6 draws on the card, in standard
    errors (the variance's from the fourth moment of the draws); a seed
    repeats its draws and another does not; torch's own CUDA generator
    is never drawn from."""
    ctx = mt.gpu(0)
    z = {}
    cuda_state = torch.cuda.get_rng_state()
    t_start = time.perf_counter()
    for name in list(SAMPLERS) + list(TENSOR_SAMPLERS) + ["_shuffle"]:
        mt.random.seed(SEED)
        a = ops_draw(mt, torch, name, ctx)
        mt.random.seed(SEED)
        b = ops_draw(mt, torch, name, ctx)
        mt.random.seed(SEED + 1)
        c = ops_draw(mt, torch, name, ctx)
        check(a.handle.device.type == "cuda", f"{name} drew off the card")
        check(torch.equal(a.handle, b.handle), f"{name}: a seed did not "
                                               "repeat its draws")
        check(not torch.equal(a.handle, c.handle),
              f"{name}: another seed drew the same")
        t = a.handle.double().reshape(-1)
        if name == "_shuffle":
            check(torch.equal(t.sort().values, torch.arange(
                OPS_DRAWS, device=t.device, dtype=t.dtype)),
                "_shuffle is not a permutation")
            mean, var = (OPS_DRAWS - 1) / 2, (OPS_DRAWS ** 2 - 1) / 12
        else:
            _, mean, var = SAMPLERS.get(name) or TENSOR_SAMPLERS[name]
        m, v = t.mean().item(), t.var(unbiased=False).item()
        m4 = ((t - m) ** 4).mean().item()
        zm = (m - mean) / math.sqrt(var / OPS_DRAWS)
        zv = (v - var) / math.sqrt(max(m4 - v * v, 1e-30) / OPS_DRAWS)
        z[name] = [zm, zv]
        check(abs(zm) < OPS_SE and abs(zv) < OPS_SE,
              f"{name}: mean {m} (want {mean}), variance {v} (want "
              f"{var}): {zm:.2f} and {zv:.2f} standard errors")
    # the user-facing samplers (random.* is nd.random.*) on the card
    r = mt.random
    probs = mt.nd.array([[0.25, 0.75]], ctx=ctx)
    surface = [r.uniform(shape=(8,), ctx=ctx), r.normal(shape=(8,), ctx=ctx),
               r.gamma(shape=(8,), ctx=ctx), r.exponential(shape=(8,), ctx=ctx),
               r.poisson(shape=(8,), ctx=ctx),
               r.negative_binomial(shape=(8,), ctx=ctx),
               r.generalized_negative_binomial(shape=(8,), ctx=ctx),
               r.randint(0, 5, shape=(8,), ctx=ctx),
               r.shuffle(mt.nd.arange(8, ctx=ctx)),
               *r.multinomial(probs, shape=(8,), get_prob=True)]
    check(all(a.handle.device.type == "cuda" and
              bool(torch.isfinite(a.handle.float()).all()) for a in surface),
          "a random.* sampler drew off the card or gave a non-finite "
          "value")
    check(torch.equal(cuda_state, torch.cuda.get_rng_state()),
          "a sampler drew from torch's own CUDA generator")
    return {"draws": OPS_DRAWS, "z_mean_var": z,
            "seconds": time.perf_counter() - t_start}


def ops_order(mt, torch):
    """sort, argsort and topk on the card bit-equal to the CPU on small
    integers (ties everywhere)."""
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randint(0, 10, (256, 1000), generator=gen).float()
    card, cpu = mt.nd.NDArray(x.cuda()), mt.nd.NDArray(x)
    cases = 0
    for asc in (True, False):
        for axis in (-1, 0, None):
            for op in ("sort", "argsort"):
                a = getattr(mt.nd, op)(card, axis=axis, is_ascend=asc)
                b = getattr(mt.nd, op)(cpu, axis=axis, is_ascend=asc)
                check(torch.equal(a.handle.cpu(), b.handle),
                      f"{op}(axis={axis}, is_ascend={asc}) differs")
                cases += 1
        for axis in (-1, 0):
            for rt in ("indices", "value", "mask", "both"):
                kw = dict(axis=axis, k=5, ret_typ=rt, is_ascend=asc)
                a, b = mt.nd.topk(card, **kw), mt.nd.topk(cpu, **kw)
                a = a if isinstance(a, list) else [a]
                b = b if isinstance(b, list) else [b]
                check(all(torch.equal(p.handle.cpu(), q.handle)
                          for p, q in zip(a, b)),
                      f"topk({kw}) differs from the CPU")
                cases += 1
    big = mt.nd.NDArray(torch.randn(4096, 4096, device="cuda"))
    return {"cases": cases, "bit_equal": True,
            "topk_ms_4096x4096_k5": wall_ms(
                lambda: mt.nd.topk(big, k=5, ret_typ="both"), torch),
            "sort_ms_4096x4096": wall_ms(lambda: mt.nd.sort(big), torch)}


def _rows_signed(t):
    idx = t.abs().argmax(-1, keepdim=True)
    return t * t.gather(-1, idx).sign()


def ops_linalg(mt, torch):
    """Each _linalg_ op and khatri_rao in float64 on the card against
    the CPU (cuSOLVER and cuBLAS against LAPACK); syevd's eigenvector
    rows and gelqf's Q rows sign-normalised, gelqf's L by magnitude."""
    gen = torch.Generator().manual_seed(SEED)
    n, b = 64, 4

    def r(*s):
        return torch.rand(*s, generator=gen, dtype=torch.float64)

    a = r(b, n, n)
    spd = a @ a.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64)
    low = torch.linalg.cholesky(spd)
    B, Bt, C = r(b, n, 32), r(b, 32, n), r(b, n, 32)
    cases = [("gemm", [a, B, C], dict(alpha=0.5, beta=2.0)),
             ("gemm2", [a, B], dict(transpose_a=True)),
             ("potrf", [spd], {}), ("potri", [low], {}),
             ("trmm", [low, B], {}), ("trsm", [low, B], {}),
             ("trsm", [low, Bt], dict(rightside=True, transpose=True)),
             ("sumlogdiag", [low], {}), ("syrk", [B], {}),
             ("syevd", [spd], {}), ("gelqf", [r(b, 32, n)], {})]
    worst = {}
    for name, ins, kw in cases:
        outs = []
        for dev in ("cuda", "cpu"):
            y = getattr(mt.nd.linalg, name)(
                *[mt.nd.NDArray(t.to(dev)) for t in ins], **kw)
            outs.append([o.handle.cpu() for o in
                         (y if isinstance(y, list) else [y])])
        got, ref = outs
        if name == "syevd":
            got[0], ref[0] = _rows_signed(got[0]), _rows_signed(ref[0])
        if name == "gelqf":
            got = [got[0].abs(), _rows_signed(got[1])]
            ref = [ref[0].abs(), _rows_signed(ref[1])]
        err = max(((g - e).abs().max() / e.abs().max()).item()
                  for g, e in zip(got, ref))
        key = name if name not in worst else name + "_" + str(len(worst))
        worst[key] = err
        check(err < LA_TOL, f"linalg.{name}{kw}: card vs CPU {err}")
    kr = [r(8, 16), r(32, 16), r(4, 16)]
    got = mt.nd.khatri_rao(*[mt.nd.NDArray(t.cuda()) for t in kr])
    ref = mt.nd.khatri_rao(*[mt.nd.NDArray(t) for t in kr])
    err = ((got.handle.cpu() - ref.handle).abs().max()
           / ref.handle.abs().max()).item()
    check(err < LA_TOL, f"khatri_rao: card vs CPU {err}")
    worst["khatri_rao"] = err
    return {"dtype": "float64", "tol": LA_TOL, "max_rel_err": worst}


def phase_ops(mt, torch, card):
    launches = mt.ops.LAUNCHES
    mt.ops.reset_launches()
    samplers = ops_samplers(mt, torch)
    order = ops_order(mt, torch)
    linalg = ops_linalg(mt, torch)
    counts = {k: v for k, v in launches.items() if v}
    emit({"phase": "ops", "card": card, "samplers": samplers,
          "order": order, "linalg": linalg, "kernel_launches": counts})
    return counts


# ------------------------------------------------------------------ rnn
# (i) the fused RNN op at the word LM's width; (ii) the Gluon word LM
# (examples/word_language_model.py's RNNModel, untied) at the width of
# the "large" PTB LSTM of Zaremba, Sutskever & Vinyals (2014); (iii)
# config 3, examples/lstm_bucketing.py's bucketed LSTM LM through
# BucketingModule at that script's defaults, PTB's vocabulary and the
# reference example's buckets.
WORD_LM = dict(vocab=10000, emsize=1500, nhid=1500, nlayers=2, bptt=35,
               batch=20, dropout=0.65, lr=5.0, clip=0.25)
WORD_LM_STEPS = 12
RNN_OP_TOL = {"out": 1e-4, "grad": 1e-3}     # max err / max |CPU|
LSTM_BUCKETING = dict(num_hidden=200, num_embed=200, num_layers=2,
                      batch=32, lr=0.01, vocab=10000, sentences=2000,
                      buckets=(10, 20, 30, 40, 50, 60))
LSTM_BUCKETING_MAX_EPOCHS = 15
# examples/word_language_model.py's corpus: a small template grammar
WORD_LM_SENTS = ["the cat sat on the mat", "the dog ran in the park",
                 "a bird flew over the tree", "the cat ran after the bird",
                 "a dog sat under the tree"]


def rnn_class(name):
    """cuDNN's recurrent kernels, matrix products (cuBLAS, and cuDNN's
    own GEMMs), or the rest."""
    low = name.lower()
    if any(t in low for t in ("rnn", "lstm", "gru", "persist")):
        return "cudnn_rnn"
    return "matmul" if kernel_class(name) == "matmul" else "other"


def rnn_op_case(mt, torch, mode, bidir, device):
    """Outputs and gradients of the RNN op at the word LM's width on
    ``device`` (weights and inputs from one seeded CPU generator)."""
    wl = WORD_LM
    T, N, C, H, L = wl["bptt"], wl["batch"], wl["emsize"], wl["nhid"], \
        wl["nlayers"]
    D = 2 if bidir else 1
    gen = torch.Generator().manual_seed(SEED)
    n = mt.ops.rnn.rnn_param_size(mode, L, C, H, bidir)
    bound = 1 / math.sqrt(H)
    ins = [torch.randn(T, N, C, generator=gen),
           (torch.rand(n, generator=gen) * 2 - 1) * bound,
           torch.randn(L * D, N, H, generator=gen) * 0.5]
    if mode == "lstm":
        ins.append(torch.randn(L * D, N, H, generator=gen) * 0.5)
    xs = [mt.nd.NDArray(t.to(device)) for t in ins]
    for x in xs:
        x.attach_grad()
    with mt.autograd.record():
        outs = mt.nd.RNN(*xs, state_size=H, num_layers=L, mode=mode,
                         bidirectional=bidir, state_outputs=True)
        ws = [torch.rand(o.shape, generator=gen) for o in outs]
        loss = None
        for o, w in zip(outs, ws):
            t = (o * mt.nd.NDArray(w.to(device))).sum()
            loss = t if loss is None else loss + t
    loss.backward()
    return [o.handle.cpu() for o in outs], [x.grad.handle.cpu()
                                            for x in xs]


def rnn_op_checks(mt, torch):
    """(i) every mode, one way and bidirectional, card against CPU."""
    res = {}
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bidir in (False, True):
            card = rnn_op_case(mt, torch, mode, bidir, "cuda")
            cpu = rnn_op_case(mt, torch, mode, bidir, "cpu")
            errs = [max(((g - e).abs().max() / e.abs().max()).item()
                        for g, e in zip(card[k], cpu[k]))
                    for k in (0, 1)]
            check(all(math.isfinite(e) for e in errs)
                  and errs[0] < RNN_OP_TOL["out"]
                  and errs[1] < RNN_OP_TOL["grad"],
                  f"RNN {mode} bidirectional={bidir}: card vs CPU "
                  f"outputs {errs[0]}, gradients {errs[1]}")
            res[f"{mode}{'_bi' if bidir else ''}"] = errs
    return {"tol": RNN_OP_TOL, "max_rel_err_out_grad": res}


def word_lm_model(mt, device, dropout):
    """examples/word_language_model.py's RNNModel, tied as the example
    builds it by default (the decoder's weight is the encoder's, through
    ``params=``), with dropout on the embedding, between the LSTM layers
    and on its output (the reference Gluon example's and Zaremba et
    al.'s placement)."""
    wl = WORD_LM

    class RNNModel(mt.gluon.Block):
        def __init__(self, vocab, emsize, nhid, nlayers, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = mt.gluon.nn.Embedding(vocab, emsize)
                self.drop = mt.gluon.nn.Dropout(dropout)
                self.rnn = mt.gluon.rnn.LSTM(
                    nhid, num_layers=nlayers, layout="TNC",
                    input_size=emsize, dropout=dropout)
                self.decoder = mt.gluon.nn.Dense(
                    vocab, flatten=False, in_units=nhid,
                    params=self.encoder.params)

        def forward(self, x, state):
            emb = self.drop(self.encoder(x))
            out, state = self.rnn(emb, state)
            return self.decoder(self.drop(out)), state

    net = RNNModel(wl["vocab"], wl["emsize"], wl["nhid"], wl["nlayers"])
    mt.random.seed(SEED)
    net.initialize(mt.initializer.Xavier(), ctx=device)
    check(net.decoder.weight is net.encoder.weight,
          "the word LM's decoder is not tied to its encoder")
    return net


def word_lm_data(torch):
    """The example's corpus as (rows, batch) token ids (bptt rows a
    step), the ids inside PTB's vocabulary."""
    import numpy as np
    rs = np.random.RandomState(SEED)
    wl = WORD_LM
    need = (WORD_LM_STEPS + 2) * wl["bptt"] * wl["batch"] + wl["batch"]
    toks = []
    while len(toks) < need:
        toks += WORD_LM_SENTS[rs.randint(len(WORD_LM_SENTS))].split() + \
            ["<eos>"]
    vocab = sorted(set(toks))
    ids = np.array([vocab.index(t) for t in toks[:need]], np.float32)
    nb = len(ids) // wl["batch"]
    return torch.from_numpy(ids[:nb * wl["batch"]].reshape(
        wl["batch"], nb).T.copy())


def word_lm_step(mt, net, trainer, loss_fn, x, y, state):
    """The example's step: record, loss, backward, clip_global_norm,
    Trainer.step(1); returns (loss NDArray, new detached state)."""
    V = WORD_LM["vocab"]
    state = [s.detach() for s in state]
    with mt.autograd.record():
        out, state = net(x, state)
        loss = loss_fn(out.reshape(-1, V), y.reshape(-1)).mean()
    loss.backward()
    grads = [p.grad() for p in net.collect_params().values()
             if p.grad_req != "null"]
    mt.gluon.utils.clip_global_norm(grads, WORD_LM["clip"])
    trainer.step(1)
    return loss, state


def word_lm_check_cpu(mt, torch, data):
    """(ii) one step at dropout 0: the card's loss and gradients against
    the CPU's from the same weights."""
    wl = WORD_LM
    nets = {"cpu": word_lm_model(mt, mt.cpu(), 0.0)}
    arrays = {k: p.data().asnumpy()
              for k, p in nets["cpu"].collect_params().items()}
    nets["cuda"] = word_lm_model(mt, mt.gpu(0), 0.0)
    mt.convert.load_gluon_params(nets["cuda"], arrays, ctx=mt.gpu(0))
    res = {}
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for dev, net in nets.items():
        ctx = mt.gpu(0) if dev == "cuda" else mt.cpu()
        x = mt.nd.NDArray(data[:wl["bptt"]].to(ctx.device))
        y = mt.nd.NDArray(data[1:wl["bptt"] + 1].to(ctx.device))
        state = net.rnn.begin_state(wl["batch"], ctx=ctx)
        with mt.autograd.record():
            out, _ = net(x, state)
            loss = loss_fn(out.reshape(-1, wl["vocab"]),
                           y.reshape(-1)).mean()
        loss.backward()
        res[dev] = (float(loss.asscalar()),
                    {k[len(net.prefix):]: p.grad().handle.cpu()
                     for k, p in net.collect_params().items()})
    (lc, gc_), (lg, gg) = res["cpu"], res["cuda"]
    errs = {k: ((gg[k] - g).abs().max() / g.abs().max()).item()
            for k, g in gc_.items() if g.abs().max() > 0}
    worst = max(errs, key=errs.get)
    check(abs(lg - lc) <= 1e-5 * abs(lc),
          f"word LM loss: card {lg}, CPU {lc}")
    check(errs[worst] < RNN_OP_TOL["grad"],
          f"word LM gradient {worst}: card vs CPU {errs[worst]}")
    del nets
    return {"loss_card": lg, "loss_cpu": lc, "grad_max_rel_err": errs}


def word_lm_train(mt, torch, data):
    """(ii) the timed steps at dropout 0.65 from the seeded weights."""
    wl = WORD_LM
    ctx = mt.gpu(0)
    base = torch.cuda.memory_allocated()     # what earlier phases hold
    net = word_lm_model(mt, ctx, wl["dropout"])
    n_params = sum(p.numel() for p in net.parameters())
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": wl["lr"]})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    d = data.cuda()
    state = net.rnn.begin_state(wl["batch"], ctx=ctx)

    def xy(i):
        r = i * wl["bptt"]
        return (mt.nd.NDArray(d[r:r + wl["bptt"]]),
                mt.nd.NDArray(d[r + 1:r + 1 + wl["bptt"]]))

    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(WORD_LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state = word_lm_step(mt, net, trainer, loss_fn, *xy(i),
                                   state)
        losses.append(float(loss.asscalar()))       # synchronizes
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(v) for v in losses), f"word LM {losses}")
    check(losses[-1] < losses[0], f"word LM loss did not fall: {losses}")
    box = {"state": state}

    def one_step():
        loss, box["state"] = word_lm_step(mt, net, trainer, loss_fn,
                                          *xy(0), box["state"])

    with device_trace(torch) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by, rows = {}, []
    for e in device_events(prof):
        if e.self_device_time_total:
            ms = e.self_device_time_total / 1e3
            by[rnn_class(e.key)] = by.get(rnn_class(e.key), 0.0) + ms
            rows.append((ms, e.key[:60]))
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = wl["bptt"] * wl["batch"]
    del net, trainer
    return {"params": n_params, **wl, "losses": losses,
            "step_ms": step_ms, "step_ms_median_after_first": med,
            "tokens_per_s": tokens / med * 1e3,
            "peak_bytes_over_start": peak,
            "device_ms_by_class": by, "profiled_wall_ms": wall,
            "device_busy_share": sum(by.values()) / wall,
            "top_ms": [[k, ms] for ms, k in sorted(rows)[::-1][:6]]}


def make_corpus(rs, vocab, n_sentences):
    """examples/lstm_bucketing.py's corpus: Markov-chain sentences, token
    t -> (2t+1) mod vocab with prob .8, random otherwise (ids 1..vocab;
    0 is the pad label)."""
    sents = []
    for _ in range(n_sentences):
        length = rs.randint(5, 41)
        tok = rs.randint(1, vocab + 1)
        sent = [tok]
        for _ in range(length - 1):
            if rs.rand() < 0.8:
                tok = (2 * tok + 1) % vocab + 1
            else:
                tok = rs.randint(1, vocab + 1)
            sent.append(tok)
        sents.append(sent)
    return sents


def lstm_bucketing(mt, torch):
    """(iii) config 3: examples/lstm_bucketing.py's sym_gen and loop
    through BucketingModule on the card, epochs until the last one's
    perplexity is below 60% of the first's and below the vocabulary."""
    import numpy as np
    cfg = LSTM_BUCKETING
    nh, ne, nl, batch = cfg["num_hidden"], cfg["num_embed"], \
        cfg["num_layers"], cfg["batch"]
    import random as pyrandom
    vocab_ids = cfg["vocab"] + 1        # + the pad id 0
    rs = np.random.RandomState(SEED)
    sents = make_corpus(rs, cfg["vocab"], cfg["sentences"])
    # the iterator shuffles with Python's and numpy's global generators
    pyrandom.seed(SEED)
    np.random.seed(SEED)
    it = mt.rnn.BucketSentenceIter(sents, batch_size=batch,
                                   buckets=list(cfg["buckets"]),
                                   invalid_label=0)
    S = mt.sym

    def sym_gen(seq_len):
        data = S.Variable("data")
        label = S.Variable("softmax_label")
        embed = S.Embedding(data, input_dim=vocab_ids, output_dim=ne,
                            name="embed")
        tnc = S.swapaxes(embed, dim1=0, dim2=1)
        params = S.Variable("rnn_parameters")
        init_h = S.zeros((nl, batch, nh))
        init_c = S.zeros((nl, batch, nh))
        out = S.RNN(tnc, params, init_h, init_c, state_size=nh,
                    num_layers=nl, mode="lstm", name="rnn")
        ntc = S.swapaxes(out, dim1=0, dim2=1)
        pred = S.Reshape(ntc, shape=(-1, nh))
        pred = S.FullyConnected(pred, num_hidden=vocab_ids, name="pred")
        lab = S.Reshape(label, shape=(-1,))
        pred = S.SoftmaxOutput(pred, lab, name="softmax", use_ignore=True,
                               ignore_label=0, normalization="valid")
        return pred, ("data",), ("softmax_label",)

    psize = mt.ops.rnn.rnn_param_size("lstm", nl, ne, nh)

    def shapes_for(bkey):
        return ([mt.io.DataDesc("data", (batch, bkey)),
                 mt.io.DataDesc("rnn_parameters", (psize,))],
                [mt.io.DataDesc("softmax_label", (batch, bkey))])

    base = torch.cuda.memory_allocated()     # what earlier phases hold
    binds = {}
    bind = mt.module.Module.bind

    def counted_bind(self, data_shapes, *a, **kw):
        key = dict((d[0], d[1]) if not hasattr(d, "name")
                   else (d.name, d.shape) for d in data_shapes)["data"][1]
        binds[key] = binds.get(key, 0) + 1
        return bind(self, data_shapes, *a, **kw)

    mt.module.Module.bind = counted_bind
    try:
        mod = mt.mod.BucketingModule(
            sym_gen, default_bucket_key=it.default_bucket_key,
            context=mt.gpu(0))
        dsh, lsh = shapes_for(it.default_bucket_key)
        mod.bind(data_shapes=dsh, label_shapes=lsh)
        mt.random.seed(SEED)
        mod.init_params(mt.initializer.Mixed(
            [".*rnn_parameters", ".*"],
            [mt.initializer.Uniform(0.1), mt.initializer.Xavier()]))
        mod.init_optimizer(kvstore=None, optimizer="adam",
                           optimizer_params=(("learning_rate", cfg["lr"]),))
        metric = mt.metric.Perplexity(ignore_label=0)
        ppls, by_bucket, tokens, seconds = [], {}, 0, 0.0
        torch.cuda.reset_peak_memory_stats()
        for epoch in range(LSTM_BUCKETING_MAX_EPOCHS):
            metric.reset()
            it.reset()
            for b in it:
                b.provide_data, b.provide_label = shapes_for(b.bucket_key)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mod.forward(b, is_train=True)
                mod.backward()
                mod.update()
                mod.update_metric(metric, b.label)    # synchronizes
                dt = time.perf_counter() - t0
                by_bucket.setdefault(b.bucket_key, []).append(dt * 1e3)
                seconds += dt
                tokens += int((b.label[0].asnumpy() != 0).sum())
            ppls.append(metric.get()[1])
            if epoch >= 1 and ppls[-1] < 0.6 * ppls[0] \
                    and ppls[-1] < cfg["vocab"]:
                break
    finally:
        mt.module.Module.bind = bind
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(p) for p in ppls), f"perplexities {ppls}")
    check(ppls[-1] < 0.6 * ppls[0] and ppls[-1] < cfg["vocab"],
          f"config 3 perplexity gate: {ppls} after "
          f"{LSTM_BUCKETING_MAX_EPOCHS} epochs")
    check(all(v == 1 for v in binds.values()),
          f"a bucket bound more than once: {binds}")
    return {**{k: list(v) if isinstance(v, tuple) else v
               for k, v in cfg.items()}, "epochs": len(ppls),
            "perplexity": ppls, "binds_per_bucket": binds,
            "batch_ms_median_by_bucket": {
                k: sorted(v)[len(v) // 2] for k, v in sorted(
                    by_bucket.items())},
            "batches_by_bucket": {k: len(v) for k, v in
                                  sorted(by_bucket.items())},
            "tokens_per_s": tokens / seconds,
            "peak_bytes_over_start": peak}


def rnn_cells(mt, torch):
    """The Gluon cells (gluon.rnn, gluon.contrib.rnn) unrolled on the
    card against the CPU from the same weights, outside training (the
    modifier cells' masks then do nothing), max error over max."""
    R, CR = mt.gluon.rnn, mt.gluon.contrib.rnn
    makers = {
        "lstm_cell": lambda: R.LSTMCell(64, input_size=32),
        "gru_cell": lambda: R.GRUCell(64, input_size=32),
        "rnn_cell": lambda: R.RNNCell(64, activation="relu", input_size=32),
        "zoneout_residual": lambda: R.ZoneoutCell(R.ResidualCell(
            R.GRUCell(32, input_size=32)), 0.3, 0.2),
        "variational_dropout": lambda: CR.VariationalDropoutCell(
            R.LSTMCell(64, input_size=32), 0.3, 0.3, 0.3),
        "conv2d_lstm_cell": lambda: CR.Conv2DLSTMCell(
            (32, 8, 8), 16, i2h_kernel=3, h2h_kernel=3, i2h_pad=1),
    }
    gen = torch.Generator().manual_seed(SEED)
    errs = {}
    for name, make in makers.items():
        shape = (8, 12, 32, 8, 8) if name.startswith("conv") \
            else (8, 12, 32)
        x = torch.rand(*shape, generator=gen)
        vl = torch.tensor([12, 3, 7, 12, 1, 9, 5, 12]).float()
        outs = []
        for ctx in (mt.gpu(0), mt.cpu()):
            cell = make()
            mt.random.seed(SEED)
            cell.initialize(mt.initializer.Xavier(), ctx=ctx)
            out, states = cell.unroll(
                12, mt.nd.NDArray(x.to(ctx.device)), layout="NTC",
                valid_length=None if name.startswith("conv")
                else mt.nd.NDArray(vl.to(ctx.device)))
            outs.append([out.handle.cpu()] + [s.handle.cpu()
                                              for s in states])
        errs[name] = max(((g - e).abs().max() / e.abs().max()).item()
                         for g, e in zip(*outs))
        check(errs[name] < RNN_OP_TOL["out"],
              f"{name}: card vs CPU {errs[name]}")
    return {"max_rel_err": errs}


def rnn_hybridized(mt, torch):
    """(iv) a HybridBlock holding rnn.LSTM, hybridized: its CachedOp entry
    (jit mode: the RNN op draws from a generator) is captured as a CUDA
    graph pair with cuDNN's RNN inside, and each replay's output and
    gradient equal the block's eager call bit for bit."""

    class Model(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.rnn = mt.gluon.rnn.LSTM(256, num_layers=2,
                                             input_size=128, layout="NTC")
                self.out = mt.gluon.nn.Dense(10, flatten=False,
                                             in_units=256)

        def hybrid_forward(self, F, x):
            return self.out(self.rnn(x))

    net = Model()
    mt.random.seed(SEED)
    net.initialize(mt.initializer.Xavier(), ctx=mt.gpu(0))
    gen = torch.Generator().manual_seed(SEED)
    x = mt.nd.NDArray(torch.randn(16, 35, 128, generator=gen).cuda())
    w = net.rnn._param("l0_h2h_weight")

    def step():
        with mt.autograd.record():
            y = net(x)
            (y * y).sum().backward()
        return y.handle.clone(), w.grad().handle.clone()

    eager = [step() for _ in range(2)]
    net.hybridize()
    replays = [step() for _ in range(3)]
    equal = all(torch.equal(a, b) for r in replays
                for a, b in zip(r, eager[0]))
    stats = net._cached_op.stats()
    captures = net._cached_op.trace_count
    check(equal, "the hybridized LSTM block's replay differs from its "
                 "eager call")
    check(stats["modes"] == ["jit"] and captures == 1,
          f"hybridized LSTM block: {stats}, {captures} captures")
    replay_ms = wall_ms(step, torch, reps=5)
    net.hybridize(False)
    eager_ms = wall_ms(step, torch, reps=5)
    return {"bit_equal": equal, "captures": captures,
            "modes": stats["modes"], "step_ms_replay": replay_ms,
            "step_ms_eager": eager_ms}


def phase_rnn(mt, torch, card):
    launches = mt.ops.LAUNCHES
    op = rnn_op_checks(mt, torch)
    data = word_lm_data(torch)
    check_cpu = word_lm_check_cpu(mt, torch, data)
    release(torch)
    mt.ops.reset_launches()                  # the main path
    lm = word_lm_train(mt, torch, data)
    release(torch)
    bucketing = lstm_bucketing(mt, torch)
    counts = {k: v for k, v in launches.items() if v}
    release(torch)
    hybrid = rnn_hybridized(mt, torch)
    cells = rnn_cells(mt, torch)
    release(torch)
    emit({"phase": "rnn", "card": card, "rnn_op": op, "cells": cells,
          "hybridized_lstm_block": hybrid})
    emit({"phase": "rnn", "card": card, "word_lm": lm,
          "word_lm_vs_cpu": {k: v for k, v in check_cpu.items()
                             if k != "grad_max_rel_err"},
          "word_lm_grad_worst": max(check_cpu["grad_max_rel_err"].values())})
    emit({"phase": "rnn", "card": card, "lstm_bucketing": bucketing,
          "kernel_launches": counts})
    return counts


# ------------------------------------------------------------------ detect
# Config 4 (SSD, examples/ssd_train.py) and the ops of the detection, CTC
# and contrib slice at the sizes their models give them, each held
# against the port on the CPU with the same inputs.  The card is DEV.
DEV = "cuda"
# the SSD300 anchor layout (examples/ssd_train.py:150-164, after the
# reference's example/ssd/symbol/symbol_builder.py): feature maps and
# anchors a pixel
SSD300_FMAPS = ((38, 4), (19, 6), (10, 6), (5, 6), (3, 4), (1, 4))
SSD300_RATIOS = (1.0, 2.0, 0.5, 3.0, 1.0 / 3)
SSD_BATCH, SSD_CLASSES, SSD_LABELS = 32, 21, 16   # VOC's 20 + background
SSD_NMS = 0.45
SSD_TOPK = 400                   # SSD300's setting (contrib_det.py:264)
SSD_CPU_IMAGES = 4               # the CPU side of the nms_topk=-1 check
NEAR = 1e-6                      # a mining key or IoU this close: a tie
NMS_EDGE = 65536                 # the sweep's most rows in registers
NMS_CLUSTERS = (1024, 128)       # above them: groups x boxes a group
NMS_FOLD = (8, 8250, 256)        # images x copies, rows: a batch > 65535
NMS_EDGE_SIDES = (0.002, 0.05)   # its random boxes' sides, unit square
MASK_CHUNK = 1 << 28             # mask elements a plain-version chunk
ADV_BATCH = 8                    # images of the adversarial NMS cases
# FLOP of one IoU test in the plain version's ops (_iou_corner: minimum,
# maximum, subtract, clamp for each of w and h, the product, the union's
# add and subtract, union > 0, the division, >= the threshold;
# _proposal_iou: +1 to w and h, no union > 0) and of one box's area
NMS_PAIR_FLOPS = {False: 14, True: 15}
NMS_AREA_FLOPS = {False: 3, True: 5}
DET_TOL = 1e-5
# config 4 at --quick (examples/ssd_train.py:189-196)
SSD_QUICK = dict(iters=160, images=64, batch=16, size=48, lr=0.1)
SSD_SIZES = ((0.3, 0.45), (0.6, 0.8))             # ssd_train.py:98-100
SSD_RATIOS = ((1.0, 2.0, 0.5),) * 2
SSD_NUM_CLASSES = 2
# Faster R-CNN / R-FCN: a 600x1000 image under VGG16's stride 16
RCNN_FEAT = (38, 63)
RCNN_ROIS = 300
RCNN_CHANNELS = 512
RFCN = dict(output_dim=21, group_size=7, pooled_size=7)
# speech_ctc.py at --quick (examples/speech_ctc.py:24-43, 89-91)
SPEECH = dict(phones=8, frame_dim=16, max_label=6, max_frames=26,
              hidden=48, batch=32, steps=200, lr=1e-3, clip=1.0)
# ctc_loss at a character-level English ASR size: 26 letters, space,
# apostrophe and the blank
CTC_SHAPE = dict(T=100, B=32, C=29, L=40)


def rel_err(got, ref, torch):
    """max |got - ref| over max |ref| (ref on the CPU)."""
    got = got.detach().float().cpu()
    ref = ref.detach().float().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)) \
        .item()


def ssd300_anchors(mt, ctx):
    nd = mt.nd
    anchors = []
    for hw, k in SSD300_FMAPS:
        feat = nd.zeros((1, 1, hw, hw), ctx=ctx)
        anchors.append(nd.contrib.MultiBoxPrior(
            feat, sizes=(0.2, 0.27), ratios=SSD300_RATIOS[:k - 1]))
    return nd.concat(*anchors, dim=1)


def ssd300_data(np):
    """Labels (32, 16, 5): 1 to 16 boxes an image, padded with -1 rows;
    class logits and box offsets for the 8732 anchors."""
    rs = np.random.RandomState(SEED)
    A = sum(hw * hw * k for hw, k in SSD300_FMAPS)
    label = np.full((SSD_BATCH, SSD_LABELS, 5), -1.0, np.float32)
    for b in range(SSD_BATCH):
        for j in range(rs.randint(1, SSD_LABELS + 1)):
            w, h = rs.uniform(0.05, 0.6, 2)
            x0, y0 = rs.uniform(0, 1 - w), rs.uniform(0, 1 - h)
            label[b, j] = [rs.randint(0, SSD_CLASSES - 1), x0, y0, x0 + w,
                           y0 + h]
    logits = rs.randn(SSD_BATCH, SSD_CLASSES, A).astype(np.float32)
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    loc = (rs.randn(SSD_BATCH, 4 * A) * 0.1).astype(np.float32)
    return label, logits, prob, loc


def mining_near_cutoff(mt, torch, anchor, label, logits, cls_t):
    """(B, A) bool: the anchors whose hard-negative mining key lies
    within NEAR of the image's cut-off key (CPU tensors)."""
    cd = mt.ops.contrib_det
    valid = torch.cumprod((label[:, :, 0] != -1).int(), 1) == 1
    iou = torch.where(valid[:, None, :],
                      cd._iou_corner(anchor.reshape(-1, 4), label[..., 1:5]),
                      -1.0)
    positive = cls_t > 0
    cand = ~positive & (iou.amax(2) < 0.5)
    key = torch.where(cand, torch.softmax(logits, 1)[:, 0], math.inf)
    srt = torch.sort(key, 1).values
    num_pos = positive.sum(1)
    num_neg = torch.minimum((num_pos * 3.0).long(), key.shape[1] - num_pos)
    near = torch.zeros_like(cand)
    for b in range(key.shape[0]):
        n = int(num_neg[b])
        for r in (n - 1, n):
            if 0 <= r < key.shape[1] and math.isfinite(srt[b, r]):
                near[b] |= (key[b] - srt[b, r]).abs() <= NEAR
    return near


def first_near_tie(mt, torch, prob, loc, anchor, kwargs):
    """(first, nkeep) of one image's MultiBoxDetection ``kwargs`` on the
    CPU: ``first`` is the first row, in score order, whose fate a pair
    of the NMS window with IoU within NEAR of the threshold can decide
    (the later row of such a pair of one class, of any two classes with
    ``force_suppress``; None if no pair is that close), and ``nkeep``
    the rows the sweep takes.  A near tie can change only the rows from
    ``first`` to ``nkeep``."""
    cd = mt.ops.contrib_det
    nms, (cls_s, _, boxes_s, _) = cd.detection_sweep_inputs(
        prob, loc, anchor, **kwargs)
    k = int(nms[3][0])
    iou = cd._iou_corner(boxes_s[0, :k], boxes_s[0, :k])
    near = torch.triu((iou - kwargs["nms_threshold"]).abs() <= NEAR,
                      diagonal=1)
    if not kwargs.get("force_suppress", False):
        near &= cls_s[0, :k, None] == cls_s[0, None, :k]
    if not near.any():
        return None, k
    return int(near.nonzero()[:, 1].min()), k


def compare_detections(mt, torch, got, ref, prob, loc, anchor, kwargs):
    """The rows that differ, all decided by a near-threshold IoU, of
    (B, A, 6) detections, card against the CPU's ``ref`` of ``kwargs`` on
    the CPU inputs ``prob``, ``loc``, ``anchor``.  Every differing row
    must lie where a near tie of its image can decide it (between
    ``first_near_tie``'s rows); every other row must agree."""
    got = got.cpu()
    bad = 0
    for b in range(ref.shape[0]):
        same_cls = got[b, :, 0] == ref[b, :, 0]
        close = ((got[b, :, 1:] - ref[b, :, 1:]).abs() <= DET_TOL).all(1)
        rows = (~(same_cls & close)).nonzero()[:, 0]
        if not len(rows):
            continue
        first, k = first_near_tie(mt, torch, prob[b:b + 1], loc[b:b + 1],
                                  anchor, kwargs)
        check(first is not None,
              f"image {b}: {len(rows)} detections differ from the CPU's, "
              f"and no pair of one class has an IoU within {NEAR} of "
              f"{kwargs['nms_threshold']}")
        lo, hi = int(rows.min()), int(rows.max())
        check(first <= lo and hi < k,
              f"image {b}: detections differ at rows {lo} to {hi}, "
              f"outside the rows {first} to {k - 1} that its near tie "
              f"can decide")
        bad += len(rows)
    return bad


def detect_ssd300(mt, torch, np, launches):
    """(i) MultiBoxTarget and MultiBoxDetection at SSD300's 8732 anchors,
    B=32, card against the CPU."""
    nd = mt.nd
    label, logits, prob, loc = ssd300_data(np)
    anchor = ssd300_anchors(mt, DEV)
    A = anchor.shape[1]
    check(A == 8732, f"SSD300 layout gives {A} anchors")
    card = {k: nd.array(v, ctx=DEV) for k, v in
            (("label", label), ("logits", logits), ("prob", prob),
             ("loc", loc))}
    torch.cuda.synchronize()
    mt.ops.reset_launches()                          # the path
    target = nd.contrib.MultiBoxTarget(anchor, card["label"],
                                       card["logits"],
                                       negative_mining_ratio=3.0)
    det400 = nd.contrib.MultiBoxDetection(
        card["prob"], card["loc"], anchor, nms_threshold=SSD_NMS,
        nms_topk=SSD_TOPK)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    det_all = nd.contrib.MultiBoxDetection(
        card["prob"], card["loc"], anchor, nms_threshold=SSD_NMS)
    torch.cuda.synchronize()
    peak_all = torch.cuda.max_memory_allocated() - base
    counts = {k: v for k, v in launches.items() if v}
    # the NMS makes no (B, k, k) tensor: less than one bool mask's bytes
    check(peak_all < SSD_BATCH * A * A,
          f"MultiBoxDetection at nms_topk=-1 peaked at {peak_all} bytes, "
          f"as much as a ({SSD_BATCH}, {A}, {A}) mask")
    ms = {
        "target": wall_ms(lambda: nd.contrib.MultiBoxTarget(
            anchor, card["label"], card["logits"],
            negative_mining_ratio=3.0), torch),
        "detection_topk400": wall_ms(lambda: nd.contrib.MultiBoxDetection(
            card["prob"], card["loc"], anchor, nms_threshold=SSD_NMS,
            nms_topk=SSD_TOPK), torch),
        "detection_all": wall_ms(lambda: nd.contrib.MultiBoxDetection(
            card["prob"], card["loc"], anchor, nms_threshold=SSD_NMS),
            torch)}
    # the CPU, same inputs
    cpu = {k: torch.from_numpy(v) for k, v in
           (("label", label), ("logits", logits), ("prob", prob),
            ("loc", loc))}
    cd = mt.ops.contrib_det
    anc = anchor.handle.cpu()
    ref_t = cd.multibox_target(anc, cpu["label"], cpu["logits"],
                               negative_mining_ratio=3.0)
    got_t = [t.handle.cpu() for t in target]
    loc_err = (got_t[0] - ref_t[0]).abs().max().item()
    check(loc_err <= DET_TOL, f"loc_target card vs CPU {loc_err}")
    near = mining_near_cutoff(mt, torch, anc, cpu["label"], cpu["logits"],
                              ref_t[2])
    differ = (got_t[2] != ref_t[2]) | (got_t[1] != ref_t[1]).reshape(
        SSD_BATCH, A, 4).any(2)
    far = int((differ & ~near).sum())
    check(far == 0, f"{far} anchors' cls_target/loc_mask differ from the "
                    f"CPU's away from the mining cut-off")
    top400 = {"nms_threshold": SSD_NMS, "nms_topk": SSD_TOPK}
    every = {"nms_threshold": SSD_NMS}
    ref400 = cd.multibox_detection(cpu["prob"], cpu["loc"], anc, **top400)
    n = SSD_CPU_IMAGES
    ref_all = cd.multibox_detection(cpu["prob"][:n], cpu["loc"][:n], anc,
                                    **every)
    d400 = compare_detections(mt, torch, det400.handle, ref400,
                              cpu["prob"], cpu["loc"], anc, top400)
    dall = compare_detections(mt, torch, det_all.handle[:n], ref_all,
                              cpu["prob"][:n], cpu["loc"][:n], anc, every)
    kept = (det_all.handle[..., 0] >= 0).sum(1).float()
    return {"anchors": A, "batch": SSD_BATCH, "classes": SSD_CLASSES,
            "label_rows": SSD_LABELS, "ms": ms,
            "peak_bytes_topk_all": peak_all,
            "loc_target_max_abs_err": loc_err,
            "target_differ_near_cutoff": int((differ & near).sum()),
            "positives_per_image": float((got_t[2] > 0).float().sum(1)
                                         .mean()),
            "detections_differ_near_tie": {"topk400": d400, "all": dall},
            "kept_per_image_all": float(kept.mean())}, counts


def iou_tests(torch, cls, alive, nkeep, out):
    """The IoU tests greedy NMS needs on these inputs: each taken row i
    below nkeep (alive in ``out``: on the boxes route a taken row stays
    alive) against each later row in play of its class (of any class
    when ``cls`` is None)."""
    k = alive.shape[1]
    taken = out & (torch.arange(k, device=out.device)[None, :]
                   < nkeep[:, None])
    groups = [(taken, alive)] if cls is None else [
        (taken & (cls == c), alive & (cls == c)) for c in torch.unique(cls)]
    tests = 0
    for t, w in groups:
        before = torch.cumsum(t.to(torch.int64), 1) - t.to(torch.int64)
        tests += int((before * w).sum())
    return tests


def boxes_bound(torch, args, out):
    """nms_boxes's bound: the larger of (i) its operations, the IoU
    tests these inputs need (``iou_tests``) at NMS_PAIR_FLOPS each (one
    more with a class test) and each box's area, over the fp32 rate
    outside the tensor cores, and (ii) its bytes, boxes, classes and
    alive read once, nkeep read, alive written.  -> (ms, "operations"
    or "bytes", tests)."""
    boxes, cls, alive, nkeep, _, force, pixel = args
    cls = None if force else cls
    B, k = alive.shape
    tests = iou_tests(torch, cls, alive, nkeep, out)
    per_test = NMS_PAIR_FLOPS[bool(pixel)] + (cls is not None)
    ops_ms = (tests * per_test + B * k * NMS_AREA_FLOPS[bool(pixel)]) \
        / H100_FP32_FLOPS * 1e3
    nbytes = B * k * (16 + 4 * (cls is not None) + 2) + 8 * B
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), (
        "operations" if ops_ms >= bytes_ms else "bytes"), tests


def edge_nms_inputs(torch):
    """nms_boxes's arguments at its largest size, B=1 and NMS_EDGE
    rows: random corner boxes in the unit square with sides in
    NMS_EDGE_SIDES, 20 classes, nine rows in ten in play, nkeep every
    row, SSD300's threshold."""
    n = NMS_EDGE
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    lo, hi = NMS_EDGE_SIDES
    side = lo + (hi - lo) * torch.rand((1, n, 2), generator=gen, device=DEV)
    corner = torch.rand((1, n, 2), generator=gen, device=DEV) * (1 - side)
    cls = torch.randint(0, 20, (1, n), generator=gen, device=DEV)
    alive = torch.rand((1, n), generator=gen, device=DEV) < 0.9
    return (torch.cat([corner, corner + side], 2), cls.float(), alive,
            torch.full((1,), n, dtype=torch.int64, device=DEV), SSD_NMS,
            False, False)


def adversarial_nms(torch, np, batch, k, force, pixel):
    """nms_boxes's arguments built to meet its traps, ``batch`` x ``k``
    rows: boxes on a grid (1/64 of the unit, or whole pixels with
    ``pixel``), so many IoUs are exact, with zero areas; pairs whose IoU
    is exactly 9/20, which fp32 rounds to float32(0.45), the threshold;
    duplicates; boxes with one or all coordinates NaN; 20 classes; a few
    rows out of play; nkeep below k in some images."""
    rs = np.random.RandomState(SEED + 3)
    unit = 1.0 if pixel else 1.0 / 64
    lo = rs.randint(0, 60, (batch, k, 2))
    hi = lo + rs.randint(0, 9, (batch, k, 2)) - pixel
    boxes = np.concatenate([lo, hi], 2).astype(np.float64)
    for r in range(0, k - 1, 11):     # IoU 9/20: widths 10 and 19, overlap 9
        x, y = boxes[:, r, 0], boxes[:, r, 1]
        boxes[:, r] = np.stack([x, y, x + 10 - pixel, y + 1 - pixel], 1)
        boxes[:, r + 1] = np.stack([x + 1, y, x + 20 - pixel,
                                    y + 1 - pixel], 1)
    boxes[:, 7::13] = boxes[:, 6:-1:13][:, :boxes[:, 7::13].shape[1]]
    boxes = (boxes * unit).astype(np.float32)
    boxes[:, 5::97] = np.nan
    boxes[:, 9::89, 2] = np.nan
    cls = rs.randint(0, 20, (batch, k)).astype(np.float32)
    cls[:, 1::11] = cls[:, 0:-1:11][:, :cls[:, 1::11].shape[1]]
    alive = rs.rand(batch, k) < 0.97
    nkeep = rs.randint(k // 2, k + 1, batch)
    nkeep[0] = k
    t = {name: torch.from_numpy(v).to(DEV) for name, v in
         (("boxes", boxes), ("cls", cls), ("alive", alive),
          ("nkeep", nkeep.astype(np.int64)))}
    return (t["boxes"], None if pixel else t["cls"], t["alive"], t["nkeep"],
            SSD_NMS, force, pixel)


def nms_cases(mt, torch, np):
    """nms_boxes's arguments on the card, by case: MultiBoxDetection's on
    (i)'s inputs at nms_topk 400 and -1, Proposal's on (v)'s at pre_n
    6000, ``adversarial_nms`` at SSD300's window (with and without
    force_suppress) and at the RPN's (+1-pixel IoU), and
    ``edge_nms_inputs``."""
    cd = mt.ops.contrib_det
    _, _, prob, loc = ssd300_data(np)
    anchor = ssd300_anchors(mt, DEV).handle
    A = anchor.shape[1]
    pd, ld = (torch.from_numpy(a).to(DEV) for a in (prob, loc))
    cases = {f"ssd300_k{k if k > 0 else A}":
             cd.detection_sweep_inputs(pd, ld, anchor,
                                       nms_threshold=SSD_NMS,
                                       nms_topk=k)[0]
             for k in (SSD_TOPK, -1)}
    cases["rpn_k6000"] = cd.proposal_sweep_inputs(
        *cd._proposal_args(*(torch.from_numpy(a).to(DEV)
                             for a in rcnn_inputs(np, 1)),
                           (4.0, 8.0, 16.0, 32.0), (0.5, 1.0, 2.0), 16),
        6000, 0.7, 16.0)[0]
    cases[f"adversarial_force_k{A}"] = adversarial_nms(
        torch, np, ADV_BATCH, A, True, False)
    cases[f"adversarial_k{A}"] = adversarial_nms(torch, np, ADV_BATCH, A,
                                                 False, False)
    cases["adversarial_rpn_k6000"] = adversarial_nms(torch, np, 1, 6000,
                                                     False, True)
    cases[f"edge_k{NMS_EDGE}"] = edge_nms_inputs(torch)
    return cases


def row_chunks(k):
    """Slices of k rows, each of at most MASK_CHUNK mask elements."""
    step = max(1, min(k, MASK_CHUNK // max(k, 1)))
    return [slice(r, min(k, r + step)) for r in range(0, k, step)]


def plain_mask(cd, torch, args):
    """nms_boxes's (B, k, k) mask on ``args`` by its plain version's
    torch ops (``_boxes_mask``), an image and ``row_chunks`` at a time:
    the ops are elementwise, so these are ``_boxes_masks``'s bits."""
    boxes, cls, alive, _, thr, force, pixel = args
    B, k = alive.shape
    sup = torch.empty((B, k, k), dtype=torch.bool, device=alive.device)
    for b in range(B):
        for rows in row_chunks(k):
            sup[b, rows] = cd._boxes_mask(
                boxes[b], None if cls is None else cls[b], alive[b], thr,
                force, pixel, rows)
    return sup


def words_match(cd, torch, words, sup, nkeep):
    """Whether the pair test's packed words equal the plain mask packed
    by ``_pack_plain`` wherever the pair test writes them: rows below
    nkeep, from the row's diagonal word on."""
    B, k = sup.shape[:2]
    cols = torch.arange(words.shape[2], device=sup.device)
    for b in range(B):
        for rows in row_chunks(k):
            r = torch.arange(k, device=sup.device)[rows]
            written = (r[:, None] < nkeep[b]) \
                & (cols[None, :] >= r[:, None] // 32)
            packed = cd._pack_plain(sup[b:b + 1, rows])[0]
            if not torch.equal(words[b, rows][written], packed[written]):
                return False
    return True


def detect_nms(mt, torch, np):
    """(ii) nms_boxes against its plain version on the card, bit for bit,
    on ``nms_cases``: the pair test's words against the plain mask
    (``plain_mask``) packed by ``_pack_plain`` where it writes them, the
    alive rows against the plain route (the mask, then
    ``_sweep_plain``); device ms of a call and, from the same trace, of
    its pair test and its sweep; the plain version's ms (one call
    between CUDA events, mask and sweep) and the bound."""
    cd = mt.ops.contrib_det
    out = []
    for tag, args in nms_cases(mt, torch, np).items():
        B, n = args[2].shape
        sup = []
        mask_ms = call_ms(lambda: sup.append(plain_mask(cd, torch, args)),
                          torch, warmup=0, reps=1)
        sup = sup[0]
        ref = []
        sweep_plain_ms = call_ms(lambda: ref.append(
            cd._sweep_plain(sup, args[2], args[3])), torch, warmup=0,
            reps=1)
        ref = ref[0]
        _, words = cd._boxes_launch(*args, sweep=False)
        words_equal = words_match(cd, torch, words, sup, args[3])
        check(words_equal, f"the pair test's words differ from the plain "
                           f"mask's ({tag})")
        del sup, words
        got = cd.nms_boxes(*args)
        same = torch.equal(got, ref)
        check(same, f"nms_boxes differs from its plain version ({tag})")
        bound, bound_by, tests = boxes_bound(torch, args, ref)
        ms, split = device_split_ms(
            lambda: cd.nms_boxes(*args), torch, f"nms_boxes {tag}",
            ("nms_pair_kernel", "nms_sweep_kernel"), reps=5)
        out.append({
            "case": tag, "batch": B, "rows": n, "words_equal": words_equal,
            "bit_equal": same, "alive": int(ref.sum()),
            "force_suppress": args[5], "pixel_offset": args[6], "ms": ms,
            "pair_ms": split["nms_pair_kernel"],
            "sweep_ms": split["nms_sweep_kernel"],
            "plain_ms": mask_ms + sweep_plain_ms,
            "plain_mask_ms": mask_ms, "bound_ms": bound,
            "bound_by": bound_by, "iou_tests": tests})
        release(torch)
    return out


def cluster_nms_inputs(torch, np):
    """nms_boxes's arguments above the sweep's register limit: one image
    of NMS_CLUSTERS[0] x NMS_CLUSTERS[1] boxes, each group inside a cell
    of its own on a grid (cells 1 apart, boxes within 0.8 of a cell, so
    no box meets another group's), the groups' rows interleaved in
    score order (a random permutation: every row block of 32 mixes
    groups), 2 classes, 19 rows in 20 in play, nkeep every row, SSD300's
    threshold.  Also returns each row's group."""
    groups, per = NMS_CLUSTERS
    k = groups * per
    rs = np.random.RandomState(SEED + 5)
    group = rs.permutation(k) // per
    side = int(np.ceil(np.sqrt(groups)))
    origin = np.stack([group % side, group // side], -1).astype(np.float32)
    lo = rs.rand(k, 2).astype(np.float32) * 0.5
    hi = lo + 0.05 + rs.rand(k, 2).astype(np.float32) * 0.25
    boxes = np.concatenate([origin + lo, origin + hi], -1)[None]
    cls = rs.randint(0, 2, (1, k)).astype(np.float32)
    alive = rs.rand(1, k) < 0.95
    t = [torch.from_numpy(a).to(DEV) for a in (boxes, cls, alive)]
    return (t[0], t[1], t[2], torch.full((1,), k, dtype=torch.int64,
                                         device=DEV),
            SSD_NMS, False, False), group


def cluster_oracle(cd, torch, args, group):
    """Greedy NMS splits by group when no box meets another group's: the
    plain version (``_boxes_masks``, then ``_sweep_plain``) on each
    group's rows alone, in order, the groups as the images of one batch,
    scattered back to their rows."""
    boxes, cls, alive, _, thr, force, pixel = args
    rows = torch.from_numpy(group.argsort(kind="stable")).to(DEV)
    G, per = NMS_CLUSTERS
    sub = [t[0, rows].reshape(G, per, *t.shape[2:])
           for t in (boxes, cls, alive)]
    nkeep = torch.full((G,), per, dtype=torch.int64, device=DEV)
    kept = cd._sweep_plain(cd._boxes_masks(*sub, nkeep, thr, force, pixel),
                           sub[2], nkeep)
    out = torch.zeros_like(alive)
    out[0, rows] = kept.reshape(-1)
    return out


def detect_nms_clusters(mt, torch, np):
    """(ii)'s case above 65536 rows: nms_boxes on ``cluster_nms_inputs``
    (the sweep's alive words in shared memory) bit-equal to
    ``cluster_oracle``; device ms of a call and of its pair test and
    sweep, the oracle's ms, the bound and the peak memory (the pair
    test's words are n * n / 8 bytes)."""
    cd = mt.ops.contrib_det
    args, group = cluster_nms_inputs(torch, np)
    B, n = args[2].shape
    check(n > NMS_EDGE, f"the cluster case has {n} rows")
    ref = []
    plain_ms = call_ms(lambda: ref.append(cluster_oracle(cd, torch, args,
                                                         group)),
                       torch, warmup=0, reps=1)
    ref = ref[0]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = cd.nms_boxes(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    same = torch.equal(got, ref)
    check(same, f"nms_boxes at {n} rows differs from the cluster oracle")
    bound, bound_by, tests = boxes_bound(torch, args, ref)
    ms, split = device_split_ms(
        lambda: cd.nms_boxes(*args), torch, f"nms_boxes clusters_k{n}",
        ("nms_pair_kernel", "nms_sweep_shared_kernel"), reps=3)
    fold = detect_nms_fold(mt, torch, np)
    return {"case": f"clusters_k{n}", "batch": B, "rows": n,
            "groups": NMS_CLUSTERS[0], "batch_fold": fold,
            "words_equal": None,
            "bit_equal": same, "alive": int(ref.sum()),
            "force_suppress": False, "pixel_offset": False, "ms": ms,
            "pair_ms": split["nms_pair_kernel"],
            "sweep_ms": split["nms_sweep_shared_kernel"],
            "plain_ms": plain_ms, "plain_what": "cluster oracle",
            "bound_ms": bound, "bound_by": bound_by, "iou_tests": tests,
            "peak_bytes": peak}


def detect_nms_fold(mt, torch, np):
    """A batch above 65535 images (folded into the pair test's grid):
    ``adversarial_nms``'s NMS_FOLD[0] images of NMS_FOLD[2] rows, each
    repeated NMS_FOLD[1] times, bit-equal to the plain version of the
    distinct images repeated; one call's ms."""
    cd = mt.ops.contrib_det
    images, copies, k = NMS_FOLD
    args = adversarial_nms(torch, np, images, k, False, False)
    boxes, cls, alive, nkeep, thr, force, pixel = args
    ref = cd._sweep_plain(cd._boxes_masks(boxes, cls, alive, nkeep, thr,
                                          force, pixel), alive, nkeep)
    big = [t.repeat((copies,) + (1,) * (t.dim() - 1))
           for t in (boxes, cls, alive, nkeep)]
    got = cd.nms_boxes(*big, thr, force, pixel)
    same = torch.equal(got, ref.repeat(copies, 1))
    check(same, f"nms_boxes over {images * copies} images differs from "
                f"its plain version")
    ms = call_ms(lambda: cd.nms_boxes(*big, thr, force, pixel), torch,
                 warmup=1, reps=3)
    return {"batch": images * copies, "rows": k, "bit_equal": same,
            "call_ms": ms}


# examples/ssd_train.py's model, loop and AP (its lines 46-146, 189-257)

def ssd_make_dataset(np, rs, n, size):
    x = rs.rand(n, 3, size, size).astype(np.float32) * 0.2
    labels = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        wide = rs.rand() < 0.5
        w = rs.uniform(0.4, 0.7)
        h = w * rs.uniform(0.35, 0.55)
        if not wide:
            w, h = h, w
        cx, cy = rs.uniform(w / 2, 1 - w / 2), rs.uniform(h / 2, 1 - h / 2)
        x0, y0, x1, y1 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
        xi = [int(v * size) for v in (x0, y0, x1, y1)]
        x[i, :, xi[1]:xi[3], xi[0]:xi[2]] += 1.0
        labels[i, 0] = [0.0 if wide else 1.0, x0, y0, x1, y1]
    return x, labels


def ssd_build_net(mt):
    nn = mt.gluon.nn
    per_px = len(SSD_SIZES[0]) + len(SSD_RATIOS[0]) - 1
    net = nn.HybridSequential(prefix="trunk_")
    with net.name_scope():
        for ch in (16, 32):
            net.add(nn.Conv2D(ch, 3, padding=1), nn.Activation("relu"),
                    nn.MaxPool2D(2))
        net.add(nn.Conv2D(32, 3, padding=1), nn.Activation("relu"))
    down = nn.HybridSequential(prefix="down_")
    with down.name_scope():
        down.add(nn.MaxPool2D(2), nn.Conv2D(32, 3, padding=1),
                 nn.Activation("relu"))
    heads = [(nn.Conv2D((SSD_NUM_CLASSES + 1) * per_px, 3, padding=1,
                        prefix=f"cls{s}_"),
              nn.Conv2D(4 * per_px, 3, padding=1, prefix=f"loc{s}_"))
             for s in range(2)]
    return [net, down] + [h for pair in heads for h in pair]


def ssd_forward(nd, blocks, xb):
    net, down, c0, l0, c1, l1 = blocks
    f1 = net(xb)
    f2 = down(f1)
    anchors, cls_preds, loc_preds = [], [], []
    for clsh, loch, feat, sizes, ratios in (
            (c0, l0, f1, SSD_SIZES[0], SSD_RATIOS[0]),
            (c1, l1, f2, SSD_SIZES[1], SSD_RATIOS[1])):
        anchors.append(nd.contrib.MultiBoxPrior(feat, sizes=sizes,
                                                ratios=ratios))
        c = clsh(feat)
        b = c.shape[0]
        cls_preds.append(nd.transpose(c, axes=(0, 2, 3, 1)).reshape(
            (b, -1, SSD_NUM_CLASSES + 1)))
        loc_preds.append(nd.transpose(loch(feat), axes=(0, 2, 3, 1))
                         .reshape((b, -1)))
    return (nd.concat(*anchors, dim=1), nd.concat(*cls_preds, dim=1),
            nd.concat(*loc_preds, dim=1))


def ssd_loss(nd, anchor, cls_pred, loc_pred, lb, one):
    cp_t = nd.transpose(cls_pred, axes=(0, 2, 1))
    loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
        anchor, lb, cp_t, negative_mining_ratio=3.0)
    valid = cls_t >= 0
    logp = nd.log_softmax(cls_pred, axis=-1)
    lc = -nd.pick(logp, nd.maximum(cls_t, 0), axis=-1) * valid
    n_valid = nd.maximum(valid.sum(), one)
    n_pos = nd.maximum(loc_m.sum() / 4.0, one)
    ll = nd.smooth_l1((loc_pred - loc_t) * loc_m, scalar=1.0)
    return lc.sum() / n_valid + ll.sum() / n_pos


def ssd_ap(np, nd, blocks, x, labels, ctx):
    """The example's single-point AP: each image's best detection
    matched to its box at IoU >= 0.5 and the right class."""
    anchor, cls_pred, loc_pred = ssd_forward(nd, blocks, nd.array(x,
                                                                  ctx=ctx))
    cls_prob = nd.transpose(nd.softmax(cls_pred, axis=-1), axes=(0, 2, 1))
    dets = nd.contrib.MultiBoxDetection(cls_prob, loc_pred, anchor,
                                        threshold=0.3,
                                        nms_threshold=0.45).asnumpy()
    tp = 0
    for i in range(len(labels)):
        gt = labels[i, 0]
        det = dets[i][dets[i][:, 0] >= 0]
        if not len(det):
            continue
        best = det[np.argmax(det[:, 1])]
        ix0, iy0 = max(best[2], gt[1]), max(best[3], gt[2])
        ix1, iy1 = min(best[4], gt[3]), min(best[5], gt[4])
        inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
        a1 = (best[4] - best[2]) * (best[5] - best[3])
        a2 = (gt[3] - gt[1]) * (gt[4] - gt[2])
        iou = inter / max(a1 + a2 - inter, 1e-9)
        tp += iou >= 0.5 and int(best[0]) == int(gt[0])
    return tp / max(len(labels), 1)


def ssd_blocks(mt, ctx):
    blocks = ssd_build_net(mt)
    for blk in blocks:
        blk.initialize(mt.initializer.Xavier(), ctx=ctx)
        blk.hybridize()
    return blocks


def ssd_grads(mt, blocks, xb, lb, ctx):
    nd = mt.nd
    with mt.autograd.record():
        loss = ssd_loss(nd, *ssd_forward(nd, blocks, xb), lb,
                        nd.array([1.0], ctx=ctx))
    loss.backward()
    params = {}
    for blk in blocks:
        params.update(blk.collect_params())
    return float(loss.asnumpy()[0]), {k: p.grad().handle.cpu()
                                      for k, p in params.items()}


def detect_train(mt, torch, np, launches):
    """(iii) config 4: examples/ssd_train.py --quick on the card (blocks
    hybridized), its gate; one step against the CPU from the same
    weights."""
    nd = mt.nd
    q = SSD_QUICK
    rs = np.random.RandomState(0)
    mt.random.seed(0)
    x, labels = ssd_make_dataset(np, rs, q["images"], q["size"])
    blocks = ssd_blocks(mt, DEV)
    ssd_forward(nd, blocks, nd.array(x[:2], ctx=DEV))  # settle shapes
    # one step, card against the CPU, from the card's first weights
    cpu_blocks = ssd_blocks(mt, "cpu")
    ssd_forward(nd, cpu_blocks, nd.array(x[:2], ctx="cpu"))
    for blk, cblk in zip(blocks, cpu_blocks):
        mt.convert.load_gluon_params(
            cblk, {k: p.data().asnumpy()
                   for k, p in blk.collect_params().items()}, ctx="cpu")
    sel = np.arange(q["batch"])
    card_loss, card_g = ssd_grads(mt, blocks, nd.array(x[sel], ctx=DEV),
                                  nd.array(labels[sel], ctx=DEV), DEV)
    cpu_loss, cpu_g = ssd_grads(mt, cpu_blocks, nd.array(x[sel], ctx="cpu"),
                                nd.array(labels[sel], ctx="cpu"), "cpu")
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_worst = max(rel_err(card_g[k], cpu_g[k], torch) for k in cpu_g)
    check(loss_rel <= 1e-4, f"SSD loss card {card_loss} vs CPU {cpu_loss}")
    check(grad_worst <= 1e-3, f"SSD gradient card vs CPU {grad_worst}")
    del cpu_blocks

    params = {}
    for blk in blocks:
        params.update(blk.collect_params())
    trainer = mt.gluon.Trainer(params, "sgd", dict(
        learning_rate=q["lr"], momentum=0.9, wd=1e-4))
    one = nd.array([1.0], ctx=DEV)
    B = q["batch"]
    torch.cuda.synchronize()
    mt.ops.reset_launches()                          # the main path
    t0 = time.perf_counter()
    first = None
    for it in range(q["iters"]):
        sel = rs.randint(0, q["images"], B)
        xb = nd.array(x[sel], ctx=DEV)
        lb = nd.array(labels[sel], ctx=DEV)
        with mt.autograd.record():
            loss = ssd_loss(nd, *ssd_forward(nd, blocks, xb), lb, one)
        loss.backward()
        trainer.step(B)
        if it == 0:
            first = float(loss.asnumpy()[0])
            t1 = time.perf_counter()
    final = float(loss.asnumpy()[0])
    ms_iter = (time.perf_counter() - t1) * 1e3 / (q["iters"] - 1)
    ap = ssd_ap(np, nd, blocks, x, labels, DEV)
    counts = {k: v for k, v in launches.items() if v}
    check(final < 0.7 * first and ap > 0.5,
          f"config 4 gate: first loss {first}, final {final}, AP {ap}")
    captures = {type(b).__name__ + str(i): b._cached_op.trace_count
                for i, b in enumerate(blocks)}
    return {"image": q["size"], "images": q["images"], "batch": B,
            "iters": q["iters"], "sgd": {"lr": q["lr"], "momentum": 0.9,
                                         "wd": 1e-4},
            "first_loss": first, "final_loss": final, "ap": ap,
            "ms_per_iter": ms_iter,
            "seconds": time.perf_counter() - t0,
            "captures": sum(captures.values()),
            "vs_cpu": {"loss_rel": loss_rel, "grad_worst": grad_worst}}, \
        counts


def detect_block(mt):
    class MultiBox(mt.gluon.HybridBlock):
        """MultiBoxPrior, MultiBoxTarget and MultiBoxDetection in one
        block."""

        def hybrid_forward(self, F, feat, label, cls, loc):
            anchor = F.contrib.MultiBoxPrior(
                feat, sizes=(0.2, 0.27), ratios=SSD300_RATIOS)
            t = F.contrib.MultiBoxTarget(anchor, label, cls,
                                         negative_mining_ratio=3.0)
            d = F.contrib.MultiBoxDetection(
                F.softmax(cls, axis=1), loc, anchor, nms_threshold=SSD_NMS,
                nms_topk=SSD_TOPK)
            return t[0], t[1], t[2], d

    return MultiBox()


def detect_capture(mt, torch, np, launches):
    """(iv) no host sync: the three MultiBox ops in one hybridized block
    captured once, replays bit-equal to the eager call; the same graph
    as a Symbol binds (shape inference on meta) and equals the nd
    path."""
    nd, S = mt.nd, mt.sym
    label, _, _, _ = ssd300_data(np)
    rs = np.random.RandomState(SEED + 1)
    hw = SSD300_FMAPS[1][0]
    A = hw * hw * (1 + len(SSD300_RATIOS))
    feat = rs.rand(SSD_BATCH, 8, hw, hw).astype(np.float32)
    cls = rs.randn(SSD_BATCH, SSD_CLASSES, A).astype(np.float32)
    loc = (rs.randn(SSD_BATCH, 4 * A) * 0.1).astype(np.float32)
    args = [nd.array(a, ctx=DEV) for a in (feat, label, cls, loc)]
    net = detect_block(mt)
    eager = [o.handle.clone() for o in net(*args)]
    net.hybridize()
    mt.ops.reset_launches()
    replays = [[o.handle.clone() for o in net(*args)] for _ in range(4)]
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches.items() if v}
    equal = all(torch.equal(a, b) for r in replays
                for a, b in zip(r, eager))
    stats = net._cached_op.stats()
    captures = net._cached_op.trace_count
    check(equal, "the hybridized MultiBox block's replays differ from its "
                 "eager call")
    check(captures == 1, f"MultiBox block captured {captures} times")
    replay_ms = wall_ms(lambda: net(*args), torch, reps=5)
    net.hybridize(False)
    eager_ms = wall_ms(lambda: net(*args), torch, reps=5)
    cls_v = S.var("cls")
    anchor = S.contrib.MultiBoxPrior(S.var("feat"), sizes=(0.2, 0.27),
                                     ratios=SSD300_RATIOS)
    target = S.contrib.MultiBoxTarget(anchor, S.var("label"), cls_v,
                                      negative_mining_ratio=3.0)
    det = S.contrib.MultiBoxDetection(S.softmax(cls_v, axis=1),
                                      S.var("loc"), anchor,
                                      nms_threshold=SSD_NMS,
                                      nms_topk=SSD_TOPK)
    exe = S.Group(list(target) + [det]).simple_bind(
        DEV, grad_req="null", feat=feat.shape, label=label.shape,
        cls=cls.shape, loc=loc.shape)
    outs = exe.forward(is_train=False, feat=feat, label=label, cls=cls,
                       loc=loc)
    sym_equal = all(torch.equal(o.handle, e) for o, e in zip(outs, eager))
    check(sym_equal, "the MultiBox Symbol differs from the nd path")
    return {"anchors": A, "bit_equal": equal, "captures": captures,
            "modes": stats["modes"],
            "replay_ms": replay_ms, "eager_ms": eager_ms,
            "symbol_bit_equal": sym_equal}, counts


def rcnn_inputs(np, B):
    rs = np.random.RandomState(SEED + 2)
    H, W = RCNN_FEAT
    cls_prob = rs.rand(B, 24, H, W).astype(np.float32)
    bbox = (rs.randn(B, 48, H, W) * 0.2).astype(np.float32)
    im_info = np.tile(np.array([[600, 1000, 1]], np.float32), (B, 1))
    return cls_prob, bbox, im_info


def compare_rois(mt, torch, got, ref, cpu_inputs, thr):
    """Rows of (N, 5) rois that differ from the CPU's beyond 1e-4 of the
    largest coordinate; a difference needs an IoU within NEAR of the
    threshold among the boxes the CPU swept."""
    got = got.cpu()
    scale = ref[:, 1:].abs().max()
    differ = int(((got - ref).abs() > 1e-4 * scale).any(1).sum())
    if differ:
        cd = mt.ops.contrib_det
        _, (boxes, _) = cd.proposal_sweep_inputs(
            *cd._proposal_args(*cpu_inputs, (4.0, 8.0, 16.0, 32.0),
                               (0.5, 1.0, 2.0), 16), 6000, thr, 16.0)
        n = sum(int(torch.triu((cd._proposal_iou(b) - thr).abs() <= NEAR,
                               diagonal=1).sum()) for b in boxes)
        check(n > 0, f"{differ} rois differ from the CPU's and no IoU lies "
                     f"within {NEAR} of {thr}")
    return differ


def grads_card_cpu(mt, torch, name, inputs, wrt, params, ct_seed):
    """The op forward and the gradient of a weighted sum with respect to
    ``wrt`` on the card and on the CPU, same inputs; (out errors, grad
    errors) as max error over max."""
    fn = mt.ops.OPS[name].fn
    outs = {}
    for dev in (DEV, "cpu"):
        xs = [torch.from_numpy(a).to(dev) for a in inputs]
        for i in wrt:
            xs[i].requires_grad_(True)
        out = fn(*xs, **params)
        g = torch.Generator().manual_seed(ct_seed)
        ct = torch.randn(out.shape, generator=g).to(dev)
        grads = torch.autograd.grad(out, [xs[i] for i in wrt], ct)
        outs[dev] = (out.detach(), grads)
    (out, grads), (rout, rgrads) = outs[DEV], outs["cpu"]
    return rel_err(out, rout, torch), [rel_err(a, b, torch)
                                       for a, b in zip(grads, rgrads)]


def detect_rcnn(mt, torch, np, launches):
    """(v) Faster R-CNN and R-FCN scale: Proposal at its defaults,
    MultiProposal at B=2, ROIPooling, PSROIPooling and
    DeformableConvolution, card against the CPU."""
    out = {}
    rois = None
    runs = {}
    mt.ops.reset_launches()                          # the path
    for name, B in (("_contrib_Proposal", 1), ("_contrib_MultiProposal", 2)):
        inputs = rcnn_inputs(np, B)
        card = [torch.from_numpy(a).to(DEV) for a in inputs]
        runs[name] = (inputs, card, mt.ops.OPS[name].fn(*card,
                                                        output_score=True))
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches.items() if v}
    for name, (inputs, card, (got, got_s)) in runs.items():
        fn = mt.ops.OPS[name].fn
        ms = wall_ms(lambda: fn(*card), torch)
        cpu = [torch.from_numpy(a) for a in inputs]
        ref, ref_s = fn(*cpu, output_score=True)
        differ = compare_rois(mt, torch, got, ref, cpu, 0.7)
        check(torch.equal(got[:, 0].cpu(), ref[:, 0]),
              f"{name} batch indices differ from the CPU's")
        out[name] = {"batch": len(inputs[0]), "rois": list(got.shape),
                     "ms": ms, "rows_differ": differ,
                     "score_max_abs_err": (got_s.cpu() - ref_s).abs().max()
                     .item()}
        if rois is None:
            rois = got.cpu().numpy()
    H, W = RCNN_FEAT
    rs = np.random.RandomState(SEED + 3)
    data = rs.randn(1, RCNN_CHANNELS, H, W).astype(np.float32)
    t0 = time.perf_counter()
    o, g = grads_card_cpu(mt, torch, "ROIPooling", [data, rois], [0],
                          dict(pooled_size=(7, 7), spatial_scale=1 / 16), 1)
    check(o <= 1e-4 and g[0] <= 1e-3, f"ROIPooling card vs CPU {o}, {g}")
    out["ROIPooling"] = {"data": list(data.shape), "rois": RCNN_ROIS,
                         "out_err": o, "grad_err": g[0],
                         "seconds": time.perf_counter() - t0}
    ps = rs.randn(1, RFCN["output_dim"] * RFCN["group_size"] ** 2, H,
                  W).astype(np.float32)
    t0 = time.perf_counter()
    o, g = grads_card_cpu(mt, torch, "_contrib_PSROIPooling", [ps, rois],
                          [0], dict(spatial_scale=1 / 16, **RFCN), 2)
    check(o <= 1e-4 and g[0] <= 1e-3, f"PSROIPooling card vs CPU {o}, {g}")
    out["PSROIPooling"] = {"data": list(ps.shape), "out_err": o,
                           "grad_err": g[0],
                           "seconds": time.perf_counter() - t0}
    offset = (rs.randn(1, 18, H, W) * 2).astype(np.float32)
    weight = (rs.randn(RCNN_CHANNELS, RCNN_CHANNELS, 3, 3) * 0.02) \
        .astype(np.float32)
    bias = rs.randn(RCNN_CHANNELS).astype(np.float32)
    t0 = time.perf_counter()
    o, g = grads_card_cpu(
        mt, torch, "_contrib_DeformableConvolution",
        [data, offset, weight, bias], [0, 1, 2, 3],
        dict(kernel=(3, 3), pad=(1, 1), num_filter=RCNN_CHANNELS), 3)
    check(o <= 1e-4 and max(g) <= 1e-3,
          f"DeformableConvolution card vs CPU {o}, {g}")
    out["DeformableConvolution"] = {"filters": RCNN_CHANNELS, "out_err": o,
                                    "grad_err": max(g),
                                    "seconds": time.perf_counter() - t0}
    return out, counts


def edit_distance(a, b):
    """examples/common.py's Levenshtein distance."""
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, dp[0] = dp[0], i
        for j, cb in enumerate(b, 1):
            prev, dp[j] = dp[j], min(dp[j] + 1, dp[j - 1] + 1,
                                     prev + (ca != cb))
    return dp[-1]


def speech_utterances(np, rs, n, templates):
    """examples/speech_ctc.py:45-62."""
    s = SPEECH
    X = np.zeros((n, s["max_frames"], s["frame_dim"]), np.float32)
    Y = np.full((n, s["max_label"]), -1, np.float32)
    xl = np.zeros(n, np.float32)
    yl = np.zeros(n, np.float32)
    for i in range(n):
        nl = rs.randint(3, s["max_label"] + 1)
        labels = rs.randint(0, s["phones"], nl)
        t = 0
        for ph in labels:
            for _ in range(rs.randint(2, 5)):
                if t >= s["max_frames"]:
                    break
                X[i, t] = templates[ph] + \
                    rs.randn(s["frame_dim"]).astype(np.float32) * 0.3
                t += 1
        Y[i, :nl] = labels
        xl[i], yl[i] = t, nl
    return X, Y, xl, yl


def speech_ctc(mt, torch, np):
    """(vi) examples/speech_ctc.py --quick on the card: BiLSTM + Dense,
    CTCLoss with lengths, clip_global_norm, Adam; its gate."""
    s = SPEECH
    nd = mt.nd

    class AcousticModel(mt.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.lstm = mt.gluon.rnn.LSTM(
                    s["hidden"], num_layers=1, bidirectional=True,
                    layout="NTC", input_size=s["frame_dim"])
                self.proj = mt.gluon.nn.Dense(s["phones"] + 1,
                                              flatten=False)

        def forward(self, x):
            h, _ = self.lstm(x, self.lstm.begin_state(x.shape[0],
                                                      ctx=x.context))
            return self.proj(h)

    mt.random.seed(0)
    rs = np.random.RandomState(0)
    templates = rs.randn(s["phones"], s["frame_dim"]).astype(np.float32) * 2
    net = AcousticModel()
    net.initialize(mt.init.Xavier(), ctx=DEV)
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": s["lr"]})
    ctc = mt.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")

    def ler(n_eval=64):
        X, Y, xl, yl = speech_utterances(np, np.random.RandomState(1),
                                         n_eval, templates)
        logits = net(nd.array(X, ctx=DEV)).asnumpy()
        errs = tot = 0
        for i in range(n_eval):
            path = logits[i][:int(xl[i])].argmax(1)
            hyp, prev = [], -1
            for p in path:
                if p != prev and p != s["phones"]:
                    hyp.append(int(p))
                prev = p
            ref = [int(c) for c in Y[i][:int(yl[i])]]
            errs += edit_distance(hyp, ref)
            tot += len(ref)
        return errs / tot

    init_ler = ler()
    first = last = None
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    t0 = time.perf_counter()
    for _ in range(s["steps"]):
        X, Y, xl, yl = speech_utterances(np, rs, s["batch"], templates)
        xs = [nd.array(a, ctx=DEV) for a in (X, Y, xl, yl)]
        with mt.autograd.record():
            loss = ctc(net(xs[0]), *xs[1:]).mean()
        loss.backward()
        mt.gluon.utils.clip_global_norm([p.grad() for p in params],
                                        s["clip"])
        trainer.step(s["batch"])
        last = float(loss.asnumpy().reshape(-1)[0])
        first = last if first is None else first
    ms = (time.perf_counter() - t0) * 1e3 / s["steps"]
    final_ler = ler()
    check(final_ler < 0.15 and last < 0.5 * first,
          f"speech_ctc gate: LER {final_ler}, losses {first} -> {last}")
    return {"steps": s["steps"], "batch": s["batch"], "first_loss": first,
            "last_loss": last, "init_ler": init_ler, "ler": final_ler,
            "ms_per_step": ms}


def ctc_check(mt, torch, np):
    """(vi) ctc_loss at T=100, B=32, C=29, labels up to 40, with data
    and label lengths, both blank modes: costs and gradients card
    against the CPU, an impossible alignment's 1e30, ms of forward and
    backward."""
    c = CTC_SHAPE
    rs = np.random.RandomState(SEED + 4)
    fn = mt.ops.OPS["ctc_loss"].fn
    out = {}
    for blank in ("first", "last"):
        data = rs.randn(c["T"], c["B"], c["C"]).astype(np.float32)
        lab_len = rs.randint(5, c["L"] + 1, c["B"])
        dat_len = rs.randint(c["T"] // 2, c["T"] + 1, c["B"])
        # impossible: 40 labels in 30 frames
        lab_len[0], dat_len[0] = c["L"], c["L"] * 3 // 4
        pad, lo, hi = (0, 1, c["C"]) if blank == "first" else \
            (-1, 0, c["C"] - 1)
        label = np.full((c["B"], c["L"]), pad, np.float32)
        for i in range(c["B"]):
            label[i, :lab_len[i]] = rs.randint(lo, hi, lab_len[i])
        inputs = [data, label, dat_len.astype(np.float32),
                  lab_len.astype(np.float32)]
        params = dict(use_data_lengths=True, use_label_lengths=True,
                      blank_label=blank)
        res = {}
        for dev in (DEV, "cpu"):
            xs = [torch.from_numpy(a).to(dev) for a in inputs]
            xs[0].requires_grad_(True)
            cost = fn(*xs, **params)
            mask = cost < 1e29
            (g,) = torch.autograd.grad((cost * mask).sum(), xs[0])
            res[dev] = (cost.detach().cpu(), g.cpu())
            if dev == DEV:
                def step():
                    cst = fn(*xs, **params)
                    torch.autograd.grad((cst * (cst < 1e29)).sum(), xs[0])
                ms = wall_ms(step, torch)
        (cost, g), (rcost, rg) = res[DEV], res["cpu"]
        possible = rcost < 1e29
        cost_rel = ((cost - rcost).abs() / rcost.abs())[possible].max() \
            .item()
        grad_err = (g - rg).abs().max().item()
        check(float(cost[0]) == float(rcost[0]) == float(np.float32(1e30)),
              f"impossible alignment costs {cost[0]} (CPU {rcost[0]})")
        check(cost_rel <= 1e-5 and grad_err <= 1e-4 and
              bool(torch.isfinite(g).all()),
              f"ctc_loss ({blank}) card vs CPU: cost {cost_rel}, grad "
              f"{grad_err}")
        out[blank] = {"cost_rel_err": cost_rel, "grad_max_abs_err":
                      grad_err, "impossible_cost": float(cost[0]),
                      "fwd_bwd_ms": ms}
    return out


def seq_stages(S):
    """mnist_mlp split after relu2: fc1-relu1-fc2-relu2, then fc3 under
    the SoftmaxOutput."""
    net = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=128)
    net = S.Activation(net, name="relu1", act_type="relu")
    net = S.FullyConnected(net, name="fc2", num_hidden=64)
    head = S.Activation(net, name="relu2", act_type="relu")
    tail = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"), name="fc3",
                                            num_hidden=10), name="softmax")
    return head, tail


def detect_sequential(mt, torch, np):
    """(vii) phase module (i)'s MNIST MLP as two Modules chained by
    SequentialModule (labels on the last): its gate; one epoch from the
    same weights moves the parameters as the single Module does; a
    PythonLossModule tail trains."""
    rs = np.random.RandomState(SEED)
    xtr, ytr = synthetic_mnist(MLP_TRAIN, rs)
    xva, yva = synthetic_mnist(MLP_VAL, rs)

    def chain(tail=None):
        head, last = seq_stages(mt.sym)
        seq = mt.mod.SequentialModule()
        seq.add(mt.mod.Module(head, label_names=[], context=DEV))
        seq.add(tail or mt.mod.Module(last, context=DEV), take_labels=True)
        return seq

    seq = chain()
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    seq.fit(mt.io.NDArrayIter(xtr, ytr, MLP_BATCH, shuffle=True, seed=SEED),
            num_epoch=MLP_EPOCHS, optimizer="sgd", optimizer_params=MLP_SGD,
            initializer=mt.init.Xavier())
    fit_s = time.perf_counter() - t0
    acc = seq.score(mt.io.NDArrayIter(xva, yva, MLP_BATCH), "acc")[0][1]
    check(acc > MLP_GATE, f"SequentialModule MLP accuracy {acc}")
    # one epoch from the same weights: the chain and one Module
    weights = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    moved = {}
    for name, mod in (("seq", chain()), ("one", mt.mod.Module(
            mnist_mlp(mt.sym), context=DEV))):
        mod.fit(mt.io.NDArrayIter(xtr, ytr, MLP_BATCH), num_epoch=1,
                optimizer="sgd", optimizer_params=MLP_SGD,
                arg_params={k: mt.nd.array(v, ctx=DEV)
                            for k, v in weights.items()})
        moved[name] = {k: v.asnumpy() for k, v in mod.get_params()[0]
                       .items()}
    worst = max(float(np.abs(moved["seq"][k] - moved["one"][k]).max())
                for k in weights)
    check(worst <= 1e-5, f"SequentialModule vs Module after an epoch "
                         f"{worst}")

    def softmax_ce_grad(label, pred):
        p = torch.softmax(pred.handle, 1)
        p[torch.arange(len(p), device=p.device), label.handle.long()] -= 1
        return mt.nd.NDArray(p / len(p))

    head, _ = seq_stages(mt.sym)
    lin = mt.mod.Module(mt.sym.FullyConnected(
        mt.sym.Variable("data"), name="fc3", num_hidden=10),
        label_names=[], context=DEV)
    py = mt.mod.SequentialModule()
    py.add(mt.mod.Module(head, label_names=[], context=DEV))
    py.add(lin)
    py.add(mt.mod.PythonLossModule(grad_func=softmax_ce_grad),
           take_labels=True)
    py.fit(mt.io.NDArrayIter(xtr, ytr, MLP_BATCH, shuffle=True, seed=SEED),
           num_epoch=2, optimizer="sgd", optimizer_params=MLP_SGD,
           initializer=mt.init.Xavier())
    hits = 0
    for batch in mt.io.NDArrayIter(xva, yva, MLP_BATCH):
        py.forward(batch, is_train=False)
        hits += int((py.get_outputs()[0].asnumpy().argmax(1)
                     == batch.label[0].asnumpy()).sum())
    py_acc = hits / MLP_VAL
    check(py_acc > 0.9, f"PythonLossModule chain accuracy {py_acc}")
    return {"val_acc": acc, "gate": MLP_GATE, "fit_seconds": fit_s,
            "epoch_vs_module_max_abs": worst,
            "python_loss_val_acc": py_acc}


def contrib_misc_cases(np):
    rs = np.random.RandomState(SEED + 5)

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    H, W = RCNN_FEAT
    rois = np.concatenate([np.zeros((RCNN_ROIS, 1), np.float32),
                           rs.uniform(0, 500, (RCNN_ROIS, 2)),
                           rs.uniform(500, 999, (RCNN_ROIS, 2))],
                          1).astype(np.float32)
    x = r(32, 4096)
    lo, hi = np.float32(-3.0), np.float32(3.0)
    # name: (inputs, params, differentiable inputs, "bit" or tolerance)
    return {
        "_contrib_fft": ([x], {}, [0], 1e-5),
        "_contrib_ifft": ([r(32, 2 * 4096)], {}, [0], 1e-5),
        "_contrib_count_sketch": (
            [x, rs.randint(0, 1024, 4096).astype(np.float32),
             rs.choice([-1, 1], 4096).astype(np.float32)],
            dict(out_dim=1024), [0], 1e-5),
        "_contrib_quantize": ([x, np.array([lo]), np.array([hi])], {}, [],
                              "bit"),
        "_contrib_dequantize": (
            [rs.randint(0, 256, (32, 4096)).astype(np.uint8),
             np.array([lo]), np.array([hi])], {}, [], "bit"),
        # FlowNetC's correlation layer (Dosovitskiy et al. 2015)
        "Correlation": ([r(2, 256, 48, 64), r(2, 256, 48, 64)],
                        dict(kernel_size=1, max_displacement=20, stride1=1,
                             stride2=2, pad_size=20), [0, 1], 1e-4),
        "_contrib_DeformablePSROIPooling": (
            [r(1, RFCN["output_dim"] * RFCN["group_size"] ** 2, H, W), rois,
             r(RCNN_ROIS, 2, 7, 7, scale=0.5)],
            dict(spatial_scale=1 / 16, part_size=7, sample_per_part=2,
                 trans_std=0.1, **RFCN), [0, 2], 1e-4),
        "IdentityAttachKLSparseReg": (
            [np.clip(r(256, 1024, scale=0.2) + 0.5, 0.01, 0.99)],
            dict(sparseness_target=0.1, penalty=0.1), [0], 1e-5),
        "cast_storage": ([x], {}, [0], "bit"),
        "_sparse_cast_storage": ([x], {}, [0], "bit"),
        "reshape_like": ([x, r(4096, 32)], {}, [0], "bit"),
        "_sparse_retain": ([x, rs.choice(32, 8, replace=False)
                            .astype(np.float32)], {}, [0], "bit"),
        "_square_sum": ([x], dict(axis=1), [0], 1e-5),
        "_scatter_elemwise_div": ([x, r(32, 4096) + 4.0], {}, [0, 1], 1e-5),
        "_scatter_plus_scalar": ([x], dict(scalar=1.5), [0], "bit"),
        "_scatter_minus_scalar": ([x], dict(scalar=0.5), [0], "bit"),
    }


def detect_contrib_misc(mt, torch, np):
    """(viii) the contrib_misc names on the card against the CPU: the
    forward bit for bit where marked (quantize and dequantize among
    them), else within the tolerance as max error over max; the
    gradients within 1e-4 (max error over max); the plugin hooks
    raise."""
    out = {}
    for name, (inputs, params, wrt, tol) in contrib_misc_cases(np).items():
        fn = mt.ops.OPS[name].fn
        res = {}
        for dev in (DEV, "cpu"):
            xs = [torch.from_numpy(a).to(dev) for a in inputs]
            for i in wrt:
                xs[i].requires_grad_(True)
            o = fn(*xs, **params)
            o = list(o) if isinstance(o, tuple) else [o]
            grads = []
            if wrt:
                g = torch.Generator().manual_seed(7)
                cts = [torch.randn(t.shape, generator=g).to(dev) for t in o]
                grads = torch.autograd.grad(o, [xs[i] for i in wrt], cts)
            res[dev] = ([t.detach().cpu() for t in o],
                        [t.cpu() for t in grads])
        (o, g), (ro, rg) = res[DEV], res["cpu"]
        if tol == "bit":
            err = 0.0 if all(torch.equal(a, b) for a, b in zip(o, ro)) \
                else math.inf
        else:
            err = max(rel_err(a, b, torch) for a, b in zip(o, ro))
        gerr = max((rel_err(a, b, torch) for a, b in zip(g, rg)),
                   default=0.0)
        check(err <= (0.0 if tol == "bit" else tol) and gerr <= 1e-4,
              f"{name} card vs CPU: out {err}, grad {gerr}")
        out[name] = [err, gerr]
    x = mt.nd.ones((2, 2), ctx=DEV)
    for name in ("_NDArray", "_Native"):
        try:
            getattr(mt.nd._internal, name)(x)
            check(False, f"{name} ran")
        except NotImplementedError:
            pass
    return out


def phase_detect(mt, torch, card):
    import numpy as np
    launches = mt.ops.LAUNCHES
    t = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        t[name] = round(time.perf_counter() - t0, 2)
        release(torch)
        return res

    ssd300, c_ssd300 = part("ssd300", detect_ssd300, mt, torch, np,
                            launches)
    boxes = part("nms", detect_nms, mt, torch, np)
    boxes.append(part("nms_clusters", detect_nms_clusters, mt, torch, np))
    train, c_train = part("train", detect_train, mt, torch, np, launches)
    capture, c_capture = part("capture", detect_capture, mt, torch, np,
                              launches)
    rcnn, c_rcnn = part("rcnn", detect_rcnn, mt, torch, np, launches)
    speech = part("speech_ctc", speech_ctc, mt, torch, np)
    ctc = part("ctc_loss", ctc_check, mt, torch, np)
    seq = part("sequential", detect_sequential, mt, torch, np)
    misc = part("contrib_misc", detect_contrib_misc, mt, torch, np)
    by_path = {"detect_ssd300": c_ssd300, "detect_train": c_train,
               "detect_capture": c_capture, "detect_rcnn": c_rcnn}
    # the ops go from the boxes (the pair test and the sweep), never
    # through a (B, k, k) mask
    for path, counts in by_path.items():
        check(counts.get("nms_boxes", 0) > 0,
              f"{path} launched no nms_boxes: {counts}")
        check(set(counts) == {"nms_boxes"}, f"{path} launched {counts}")
    main = next(r for r in boxes                 # the default nms_topk
                if r["case"] == f"ssd300_k{ssd300['anchors']}")
    emit({"phase": "detect", "card": card, "seconds": t, "ssd300": {
        k: ssd300[k] for k in ("ms", "peak_bytes_topk_all",
                               "loc_target_max_abs_err",
                               "target_differ_near_cutoff",
                               "detections_differ_near_tie")},
        "nms_boxes": [{k: r[k] for k in (
            "case", "words_equal", "bit_equal", "ms", "pair_ms",
            "sweep_ms", "plain_ms", "bound_ms", "bound_by")}
            for r in boxes], "nms_clusters_peak_bytes": boxes[-1][
                "peak_bytes"], "nms_batch_fold": boxes[-1]["batch_fold"],
        "config4": {k: train[k] for k in ("first_loss", "final_loss", "ap",
                                          "ms_per_iter", "vs_cpu")},
        "capture": {k: capture[k] for k in ("bit_equal", "captures",
                                            "symbol_bit_equal",
                                            "replay_ms", "eager_ms")},
        "rcnn": {k: {kk: v for kk, v in r.items()
                     if kk in ("ms", "rows_differ", "out_err", "grad_err")}
                 for k, r in rcnn.items()},
        "speech_ctc": {k: speech[k] for k in ("first_loss", "last_loss",
                                              "ler", "ms_per_step")},
        "ctc_loss": ctc, "sequential": seq,
        "contrib_misc_worst": [max(v[0] for v in misc.values()),
                               max(v[1] for v in misc.values())]})
    source = "incubator_mxnet_tpu_torch/csrc/nms_sweep.cu"
    replaces = ("incubator_mxnet_tpu/ops/contrib_det.py:287 "
                "(lax.while_loop) and :516 (lax.fori_loop), with the "
                "(k, k) masks they sweep (:270-278, :505-511): the port's "
                "own kernel, no Pallas kernel")
    entry = {
        "name": "nms_boxes", "route": "cuda", "source": source,
        "kernels": ["nms_pair_kernel", "nms_sweep_kernel",
                    "nms_sweep_shared_kernel"],
        "replaces": replaces, "max_abs_err": 0.0, "ms": main["ms"],
        "pair_ms": main["pair_ms"], "sweep_ms": main["sweep_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "shape": [main["batch"], main["rows"]],
        "tol": "bit-exact",
        "cases": [{k: r[k] for k in ("case", "ms", "pair_ms", "sweep_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "iou_tests")}
                  for r in boxes],
        "launches_by_path": {p: c.get("nms_boxes", 0)
                             for p, c in by_path.items()}}
    return [entry], by_path


# ------------------------------------------------------------------ sparse
# Config 5, the sparse linear classifier (examples/linear_classification.py,
# ref: MXNet 0.12's example/sparse/linear_classification.py), through
# incubator_mxnet_tpu_torch/tools/linear_classification.py: (i) the
# example's --quick size and gate; (ii) its default size against the same
# loop on the CPU; (iii) the reference example's width on Avazu-app
# (1,000,000 features, batch 8192) with make_libsvm's rows synthesized in
# bulk at 20 nonzeros a row, 20 steps.
SPARSE_DEFAULT_TOL = 0.01
AVAZU = dict(dim=1_000_000, batch=8192, nnz=20, steps=20, lr=3.0)
AVAZU_CHECK_STEPS = 2            # the steps held against the CPU


def avazu_batches(mt, np):
    """AVAZU["steps"] CSR batches (host) of make_libsvm's distribution at
    Avazu-app's width: each row binomial(dim, nnz / dim) distinct
    columns (at least one), ascending, values uniform in [0.1, 1.1)
    rounded to 4 decimals as its text is, the label the sign of the
    row's margin under a seeded N(0, 4) weight plus 0.05 N(0, 1) noise.
    Made in bulk with numpy; returns [(CSRNDArray, labels)]."""
    a = AVAZU
    rs = np.random.RandomState(SEED)
    dim, bs = a["dim"], a["batch"]
    true_w = (rs.randn(dim) * 2).astype(np.float32)
    out = []
    for _ in range(a["steps"]):
        nnz = np.maximum(1, rs.binomial(dim, a["nnz"] / dim, bs))
        rows = np.repeat(np.arange(bs), nnz)
        cols = rs.randint(0, dim, rows.shape[0])
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        keep = np.ones(len(cols), bool)        # drop a repeated column
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        rows, cols = rows[keep], cols[keep]
        vals = np.round(rs.rand(len(cols)) + 0.1, 4).astype(np.float32)
        indptr = np.zeros(bs + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=bs), out=indptr[1:])
        margin = np.bincount(rows, weights=vals * true_w[cols],
                             minlength=bs)
        y = (margin + 0.05 * rs.randn(bs) > 0).astype(np.float32)
        x = mt.nd.sparse.csr_matrix((vals, cols, indptr), shape=(bs, dim),
                                    ctx=mt.cpu())
        out.append((x, y))
    return out


def avazu_store(mt, ctx):
    """The example's store on ``ctx``: the (dim, 1) weight at zero, the
    lazy sgd_update store-side, and its row-sparse pull target."""
    import numpy as np
    sparse = mt.nd.sparse
    kv = mt.kv.create("local")
    kv.init("weight", mt.nd.zeros((AVAZU["dim"], 1), ctx=ctx))
    kv.set_updater(lambda key, grad, stored: sparse.sgd_update(
        stored, grad, lr=AVAZU["lr"]))
    w_rsp = sparse.row_sparse_array(np.zeros((1, 1), np.float32),
                                    shape=(AVAZU["dim"], 1), ctx=ctx)
    return kv, w_rsp


def avazu_step(mt, np, kv, w_rsp, x, y, bias):
    """One step of the example's loop (:123-138); returns (bias, the
    row-sparse gradient)."""
    sparse = mt.nd.sparse
    kv.row_sparse_pull("weight", out=w_rsp, row_ids=x.indices)
    logits = sparse.dot(x, w_rsp).asnumpy()[:, 0] + bias
    p = 1.0 / (1.0 + np.exp(-logits))
    gl = mt.nd.array(((p - y) / len(y))[:, None].astype(np.float32))
    gw = sparse.dot(x, gl, transpose_a=True, forward_stype="row_sparse")
    kv.push("weight", gw)
    return bias - AVAZU["lr"] * float((p - y).mean()), gw


def avazu_rows(kv, w_rsp, gw):
    """(pulled row ids, pulled rows, the updated weight's rows at the
    gradient's ids), on the host."""
    stored = kv._store["weight"]._data
    idx = gw.indices._data.to(stored.device).long()
    return (w_rsp.indices.asnumpy(), w_rsp.data.asnumpy(),
            stored.index_select(0, idx).cpu().numpy())


def sparse_avazu(mt, torch, np):
    """(iii): AVAZU["steps"] steps on the card, wall ms a step (each ends
    in the logits' host copy), rows pulled a step and peak memory; the
    first AVAZU_CHECK_STEPS steps' pulled rows and updated weight rows
    against the CPU's (ids bit for bit, values rel 1e-5); then
    ``call_ms`` of each part alone on the last batch: the pull, the
    logits' dot (its rows' dense view rebuilt each call), the csr.T
    gradient and the lazy sgd_update."""
    sparse = mt.nd.sparse
    batches = avazu_batches(mt, np)
    nnz = [int(x.data.shape[0]) for x, _ in batches]
    checks = {}
    for dev, ctx in (("cpu", mt.cpu()), ("cuda", mt.gpu(0))):
        with ctx:
            kv, w_rsp = avazu_store(mt, ctx)
            bias, got = 0.0, []
            for x, y in batches[:AVAZU_CHECK_STEPS]:
                bias, gw = avazu_step(mt, np, kv, w_rsp, x, y, bias)
                got.append(avazu_rows(kv, w_rsp, gw))
            checks[dev] = got
        del kv, w_rsp
    errs = []
    for (ci, cr, cw), (gi, gr, gw_) in zip(checks["cpu"], checks["cuda"]):
        check(np.array_equal(ci, gi), "Avazu step: pulled row ids differ")
        for a, b in ((gr, cr), (gw_, cw)):
            errs.append(float(np.abs(a - b).max()
                              / max(np.abs(b).max(), 1e-30)))
    check(max(errs) <= 1e-5, f"Avazu step vs the CPU: {errs}")
    ctx = mt.gpu(0)
    release(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with ctx:
        kv, w_rsp = avazu_store(mt, ctx)
        bias, step_ms, pulled = 0.0, [], []
        for x, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bias, gw = avazu_step(mt, np, kv, w_rsp, x, y, bias)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            pulled.append(int(w_rsp.indices.shape[0]))
        peak = torch.cuda.max_memory_allocated() - base
        x, y = batches[-1]
        stored = kv._store["weight"]
        gl = mt.nd.array(np.full((AVAZU["batch"], 1), 1e-4, np.float32))

        def logits():
            w_rsp._dense_cache = None
            sparse.dot(x, w_rsp)

        parts = {
            "row_sparse_pull": lambda: kv.row_sparse_pull(
                "weight", out=w_rsp, row_ids=x.indices),
            "dot": logits,
            "dot_csrT_row_sparse": lambda: sparse.dot(
                x, gl, transpose_a=True, forward_stype="row_sparse"),
            "sgd_update_lazy": lambda: sparse.sgd_update(stored, gw,
                                                         lr=1e-9)}
        alone = {k: call_ms(fn, torch, warmup=2, reps=10)
                 for k, fn in parts.items()}
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    return {"features": AVAZU["dim"], "batch": AVAZU["batch"],
            "nnz_per_row_target": AVAZU["nnz"],
            "nnz_per_row": sum(nnz) / len(nnz) / AVAZU["batch"],
            "steps": len(batches), "step_ms": step_ms,
            "step_ms_median_after_first": med,
            "rows_pulled_per_step": pulled, "peak_bytes_over_start": peak,
            "part_ms_alone": alone, "vs_cpu_max_rel_err": max(errs),
            "bias": bias}


def phase_sparse(mt, torch, card):
    import numpy as np
    from incubator_mxnet_tpu_torch.tools import linear_classification as lc
    launches = mt.ops.LAUNCHES
    ex = lc.example()
    out = {}
    mt.ops.reset_launches()                  # the main path
    for tag, quick in (("quick", True), ("default", False)):
        dim, n, epochs, batch, density = lc.sizes(quick)
        t0 = time.perf_counter()
        train, val = lc.make_batches(mt, dim, n, batch, density, ex)
        data_s = time.perf_counter() - t0
        runs = {}
        for dev, ctx in (("cuda", mt.gpu(0)), ("cpu", mt.cpu())):
            if quick and dev == "cpu":
                continue
            with ctx:
                t0 = time.perf_counter()
                r = lc.run_loop(mt, train, val, dim, epochs, ex=ex)
                r.pop("weight")
                r = {k: v if not isinstance(v, float) or math.isfinite(v)
                     else str(v) for k, v in r.items()}
                r["seconds"] = time.perf_counter() - t0
                r["steps_per_s"] = r["steps"] / r["train_seconds"]
            runs[dev] = r
        if quick:
            lc.gate(runs["cuda"])
        else:
            # the example's own NLL is nan at this size in either
            # package (its float32 clip); the float64 one is compared
            for k in ("final_nll_f64", "val_acc"):
                check(abs(runs["cuda"][k] - runs["cpu"][k])
                      <= SPARSE_DEFAULT_TOL,
                      f"config 5 {k}: card {runs['cuda'][k]}, CPU "
                      f"{runs['cpu'][k]}")
        out[tag] = dict(runs, dim=dim, rows=n, epochs=epochs, batch=batch,
                        data_seconds=data_s)
    release(torch)
    out["avazu_width"] = sparse_avazu(mt, torch, np)
    counts = {k: v for k, v in launches.items() if v}
    release(torch)
    emit({"phase": "sparse", "card": card, **out,
          "kernel_launches": counts})
    return counts


# ------------------------------------------------------------------ vision
# The model zoo's other families at each one's reference variant and
# published input (224, or 299 for Inception3), B=32, eval mode.
VISION = (("alexnet", 224), ("vgg16", 224), ("squeezenet1_1", 224),
          ("densenet121", 224), ("mobilenet1_0", 224),
          ("inception_v3", 299))
VISION_BATCH = 32
VISION_TOL = 1e-3                # card vs CPU at B=1, max err / max
VISION_TRAIN_STEPS = 5
VISION_SGD = dict(learning_rate=0.01, momentum=0.9)


def vision_net(mt, name, ctx):
    mt.random.seed(SEED)
    net = mt.gluon.model_zoo.vision.get_model(name)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    return net


def vision_family(mt, torch, name, side, tmp):
    """One family: the card's eager forward at B=1 against the CPU's on
    the same weights (a .params file); then at B=VISION_BATCH the eager
    forward and the hybridized one (its first call captures, later calls
    replay), bit-equal, each one's ms and img/s."""
    import os
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    net = vision_net(mt, name, mt.gpu(0))
    one = torch.rand((1, 3, side, side), generator=gen, device=DEV)
    card = net(mt.nd.NDArray(one)).handle
    path = os.path.join(tmp, f"{name}.params")
    net.save_parameters(path)
    cpu_net = mt.gluon.model_zoo.vision.get_model(name)
    cpu_net.load_parameters(path, ctx=mt.cpu())
    ref = cpu_net(mt.nd.NDArray(one.cpu())).handle
    err = ((card.cpu() - ref).abs().max() / ref.abs().max()).item()
    check(err <= VISION_TOL and bool(torch.isfinite(card).all()),
          f"{name}: card vs CPU {err}")
    del cpu_net
    x = mt.nd.NDArray(torch.rand((VISION_BATCH, 3, side, side),
                                 generator=gen, device=DEV))
    eager = net(x).handle
    eager_ms = wall_ms(lambda: net(x).wait_to_read(), torch, reps=5)
    net.hybridize()
    hybrid = net(x).handle
    hybrid_ms = wall_ms(lambda: net(x).wait_to_read(), torch, reps=5)
    same = torch.equal(eager, hybrid)
    check(same, f"{name}: the hybridized forward differs from the eager")
    stats = net._cached_op.stats()
    check(stats["traces"] == 1 and "capture_skipped" not in stats,
          f"{name}: {stats}")
    return {"input": side, "params": sum(p.numel()
                                         for p in net.parameters()),
            "card_vs_cpu_b1": err, "bit_equal": same,
            "eager_ms": eager_ms, "hybrid_ms": hybrid_ms,
            "eager_img_s": VISION_BATCH / eager_ms * 1e3,
            "hybrid_img_s": VISION_BATCH / hybrid_ms * 1e3,
            "captures": stats["traces"]}


def vision_train(mt, torch):
    """inception_v3: VISION_TRAIN_STEPS gluon.Trainer SGD steps on one
    fixed batch of B=VISION_BATCH at 299; the loss must fall."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    net = vision_net(mt, "inception_v3", mt.gpu(0))
    x = mt.nd.NDArray(torch.rand((VISION_BATCH, 3, 299, 299),
                                 generator=gen, device=DEV))
    y = mt.nd.NDArray(torch.randint(0, 1000, (VISION_BATCH,),
                                    generator=gen, device=DEV).float())
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", VISION_SGD)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, step_ms = [], []
    for _ in range(VISION_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(VISION_BATCH)
        losses.append(float(loss.mean().asscalar()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"inception_v3 training loss did not fall: {losses}")
    return {"losses": losses, "step_ms": step_ms}


def phase_vision(mt, torch, card):
    import tempfile
    launches = mt.ops.LAUNCHES
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mt.ops.reset_launches()                  # the main path
    try:
        with tempfile.TemporaryDirectory() as tmp:
            nets = {}
            for name, side in VISION:
                nets[name] = vision_family(mt, torch, name, side, tmp)
                release(torch)
        train = vision_train(mt, torch)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    counts = {k: v for k, v in launches.items() if v}
    release(torch)
    emit({"phase": "vision", "card": card, "batch": VISION_BATCH,
          "nets": nets, "inception_v3_train": train,
          "kernel_launches": counts})
    return counts


# ---------------------------------------------------------------------------
# phase data: the input pipeline (recordio, image, io, gluon.data) and the
# frontends beside it (profiler, predictor, test_utils)
# ---------------------------------------------------------------------------

DATA_RAW = (10000, 100 * 1024)   # (i) records x bytes each
DATA_IMAGES = 1280               # (ii) ImageNet-stored JPEGs: 40 batches
DATA_SHORT, DATA_LONG = 256, 341  # shorter side 256 at 4:3
DATA_QUALITY = 95
DATA_STEPS = 40                  # (iii) Module.fit steps
DATA_EPOCHS = 2                  # (ii) timed epochs
# train_imagenet.py's normalization (example/image-classification/common/
# data.py: --rgb-mean 123.68,116.779,103.939, --rgb-std 1,1,1)
DATA_MEAN = (123.68, 116.779, 103.939)
DATA_STD = (1.0, 1.0, 1.0)
DATA_STRESS = 500                # (iv) host batches at each depth
DATA_DEPTHS = (1, 2, 4)
DATA_LOADER_WORKERS = 4          # (v)
DATA_LOADER_CHECKED = 8          # (v) batches held against num_workers=0
DATA_GLUON_STEPS = 20
DATA_PROFILED_STEPS = 5          # (vi)
DATA_PREDICT_TOL = 1e-5
DATA_DET = dict(images=256, side=300, batch=16, iters=10, lr=0.1)
# (vii): the reference's tolerances (test_utils.check_consistency)
DATA_CONSISTENCY = {
    "Convolution": ("conv", {"data": (8, 16, 28, 28),
                             "conv_weight": (32, 16, 3, 3),
                             "conv_bias": (32,)}),
    "BatchNorm": ("bn", {"data": (8, 16, 14, 14), "bn_gamma": (16,),
                         "bn_beta": (16,)}),
    "FullyConnected": ("fc", {"data": (16, 256), "fc_weight": (128, 256),
                              "fc_bias": (128,)}),
    "Pooling": ("pool", {"data": (8, 16, 28, 28)}),
    "softmax": ("softmax", {"data": (64, 1000)}),
}


def data_threads():
    import os
    return min(os.cpu_count() or 1, 16)


def data_jpeg(np, Image, rs, i):
    """One synthetic ImageNet-stored JPEG: shorter side 256 at 4:3,
    quality 95.  Three in four are smooth (a coarse random field,
    bilinearly enlarged, with mild noise), one in four is textured: noise
    alone would make records far larger than photographs."""
    h, w = (DATA_SHORT, DATA_LONG) if i % 2 else (DATA_LONG, DATA_SHORT)
    if i % 4:
        coarse = (rs.rand(6, 8, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h),
                                                        Image.BILINEAR),
                         np.float32)
        img += rs.normal(0, 6, img.shape)
    else:
        img = rs.rand(h, w, 3) * 255
    import io as _io
    buf = _io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=DATA_QUALITY)
    return buf.getvalue()


def data_write_images(mt, np, path, n):
    """``n`` records of data_jpeg images (labels i % 1000) with an .idx;
    encoded on the host's threads.  Returns (seconds, bytes)."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    t0 = time.perf_counter()

    def one(i):
        return data_jpeg(np, Image, np.random.RandomState(SEED + i), i)
    with ThreadPoolExecutor(data_threads()) as pool:
        jpegs = list(pool.map(one, range(n)))
    rio = mt.recordio
    w = rio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i, jpg in enumerate(jpegs):
        w.write_idx(i, rio.pack(rio.IRHeader(0, float(i % 1000), i, 0),
                                jpg))
    w.close()
    return time.perf_counter() - t0, sum(len(j) for j in jpegs)


def data_recordio(mt, np, tmp):
    """(i) 10,000 records of 100 KB written, then read back, through the
    native backend; MB/s of each (the read comes from the page cache:
    warm)."""
    import os
    check(mt.recordio.backend_name() == "native",
          f"recordio backend {mt.recordio.backend_name()}, not native")
    n, size = DATA_RAW
    block = np.random.RandomState(SEED).randint(0, 256, size + n,
                                                dtype=np.uint8).tobytes()
    path = os.path.join(tmp, "raw.rec")
    w = mt.recordio.MXRecordIO(path, "w")
    t0 = time.perf_counter()
    for i in range(n):
        w.write(block[i:i + size])
    w.close()
    write_s = time.perf_counter() - t0
    r = mt.recordio.MXRecordIO(path, "r")
    t0 = time.perf_counter()
    got = [r.read() for _ in range(n)]
    read_s = time.perf_counter() - t0
    end = r.read()
    r.close()
    bad = sum(g != block[i:i + size] for i, g in enumerate(got))
    check(bad == 0 and end is None,
          f"recordio read back {bad} differing records")
    total = n * size
    file_bytes = os.path.getsize(path)
    os.remove(path)
    return {"records": n, "record_bytes": size, "backend": "native",
            "file_bytes": file_bytes,
            "write_mb_s": total / write_s / 1e6,
            "read_mb_s": total / read_s / 1e6, "read": "warm page cache"}


def data_record_iter(mt, path):
    """An ImageRecordIter as train_imagenet.py builds it, from fixed
    seeds."""
    import random
    import numpy as np
    np.random.seed(SEED)
    random.seed(SEED)
    return mt.io.ImageRecordIter(
        path_imgrec=path, data_shape=RESNET_IMAGE, batch_size=RESNET_BATCH,
        shuffle=True, rand_crop=True, rand_mirror=True,
        mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1], mean_b=DATA_MEAN[2],
        std_r=DATA_STD[0], std_g=DATA_STD[1], std_b=DATA_STD[2],
        preprocess_threads=data_threads())


def data_iter_alone(mt, path):
    """(ii) the iterator alone: img/s over DATA_EPOCHS epochs, then the
    first epoch again from its state_dict, bit for bit.  Returns its
    record and the first epoch's host batches (the materialized batches
    of (iii))."""
    import numpy as np
    it = data_record_iter(mt, path)
    start = it.state_dict()
    epochs, seconds = [], []
    for e in range(DATA_EPOCHS):
        if e:
            it.reset()
        t0 = time.perf_counter()
        epochs.append([(b.data[0].handle, b.label[0].handle, b.pad)
                       for b in it])
        seconds.append(time.perf_counter() - t0)
    first = epochs[0]
    check(len(first) == DATA_IMAGES // RESNET_BATCH,
          f"{len(first)} batches in an epoch of {DATA_IMAGES} images")
    it.load_state_dict(start)
    it.reset()
    again = [(b.data[0].handle, b.label[0].handle, b.pad) for b in it]
    differ = sum(not (bool((a[0] == b[0]).all()) and
                      bool((a[1] == b[1]).all()) and a[2] == b[2])
                 for a, b in zip(first, again))
    check(len(again) == len(first) and differ == 0,
          f"the resumed epoch differs from the first in {differ} batches")
    second_differs = any(not bool((a[0] == b[0]).all())
                         for a, b in zip(first, epochs[1]))
    check(second_differs, "the second epoch repeated the first")
    images = sum(RESNET_BATCH - p for _, _, p in first)
    decoders = dict(it.decoder_counts)
    return {"images": images, "batch": RESNET_BATCH,
            "preprocess_threads": data_threads(),
            "epoch_seconds": seconds,
            "images_per_s": DATA_EPOCHS * images / sum(seconds),
            "decoder": it.last_decoder, "decoder_batches": decoders,
            "resume_bit_equal": True, "batches_compared": len(first),
            "mean": list(DATA_MEAN), "std": list(DATA_STD)}, first


class _CardBatches:
    """Batches built on the card before the loop, as a DataIter (the
    yardstick of (iii): the same loop without the pipeline)."""

    def __init__(self, mt, batches, provide_data, provide_label):
        self._mt, self._batches = mt, batches
        self.batch_size = RESNET_BATCH
        self.provide_data, self.provide_label = provide_data, provide_label
        self._i = 0

    def reset(self):
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._batches):
            raise StopIteration
        x, y = self._batches[self._i]
        self._i += 1
        nd = self._mt.nd
        return self._mt.io.DataBatch([nd.NDArray(x)], [nd.NDArray(y)])

    next = __next__


DATA_BUSY_STEPS = (20, 25)       # (iii): the steps traced for the busy share


def data_fit(mt, torch, sym, weights, train):
    """One epoch of Module.fit(kvstore='tpu') over ``train``; each step's
    loss (the SoftmaxOutput's cross-entropy), the host clock at each
    step's end, and the device's busy share (kernel time over wall time)
    over the steps DATA_BUSY_STEPS, traced by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    mod = resnet_module(mt, sym, "cuda", weights, RESNET_BATCH,
                        kvstore="tpu")
    losses, ends = [], []
    trace = profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])
    traced = {}

    def on_batch(param):
        y = param.locals["data_batch"].label[0].handle
        losses.append(module_loss(mod, y.float(), torch))
        ends.append(time.perf_counter())
        if param.nbatch + 1 == DATA_BUSY_STEPS[0]:
            torch.cuda.synchronize()
            trace.start()
            traced["t0"] = time.perf_counter()
        elif param.nbatch + 1 == DATA_BUSY_STEPS[1]:
            torch.cuda.synchronize()
            traced["wall_ms"] = (time.perf_counter() - traced["t0"]) * 1e3
            trace.stop()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=1, batch_end_callback=on_batch,
            kvstore="tpu", optimizer="sgd", optimizer_params=RESNET_SGD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    steady = (ends[-1] - ends[4]) / (len(ends) - 5)
    busy_ms = sum(e.self_device_time_total for e in device_events(trace)) \
        / 1e3
    check(busy_ms > 0, "the traced steps hold no device time")
    return mod, {"losses": losses, "seconds": wall,
                 "steady_step_ms": steady * 1e3,
                 "steady_images_per_s": RESNET_BATCH / steady,
                 "captures": dict(mod._mesh_step.trace_counts),
                 "busy_steps": list(DATA_BUSY_STEPS),
                 "busy_wall_ms": traced["wall_ms"],
                 "device_busy_ms": busy_ms,
                 "device_busy_share": busy_ms / traced["wall_ms"]}


def data_config2(mt, torch, path, host_batches, iter_rate, tmp):
    """(iii) config 2 as the reference runs it: ResNet-50 v1 as a Symbol,
    Module.fit(kvstore='tpu') over DevicePrefetchIter(ImageRecordIter),
    against the same Module fed the same batches built on the card
    before the loop; both from one copy of the initial weights.  Returns
    the pipeline's Module, its checkpoint's prefix, the Symbol, the
    initial weights and the record."""
    import os
    net = resnet_net(mt, torch, "cuda")
    sym = resnet_symbol(mt, net)
    weights = {k: p.data().copy() for k, p in net.collect_params().items()}
    del net
    staged = [(x.cuda(), y.cuda()) for x, y, _ in host_batches[:DATA_STEPS]]
    provide = data_record_iter(mt, path)
    card = _CardBatches(mt, staged, provide.provide_data,
                        provide.provide_label)
    del provide
    base_mod, base = data_fit(mt, torch, sym, weights, card)
    del base_mod, card, staged
    torch.cuda.empty_cache()
    train = mt.io.DevicePrefetchIter(data_record_iter(mt, path),
                                     ctx=mt.tpu(0))
    mod, piped = data_fit(mt, torch, sym, weights, train)
    differ = [i for i, (a, b) in enumerate(zip(piped["losses"],
                                               base["losses"])) if a != b]
    check(len(piped["losses"]) == DATA_STEPS and not differ,
          f"pipeline losses differ from the pre-staged run at steps "
          f"{differ[:8]}: {piped['losses'][:4]} vs {base['losses'][:4]}")
    step_rate = base["steady_images_per_s"]
    pace = "pipeline" if iter_rate < step_rate else "step"
    prefix = os.path.join(tmp, "config2")
    mod.save_checkpoint(prefix, 1)
    return mod, prefix, sym, weights, {
        "model": "resnet50_v1", "steps": DATA_STEPS, "batch": RESNET_BATCH,
        "kvstore": "tpu", "cudnn_deterministic": True, "tf32": False,
        "losses_bit_equal": True, "losses": piped["losses"],
        "pipeline": {k: piped[k] for k in (
            "seconds", "steady_step_ms", "steady_images_per_s", "captures",
            "busy_steps", "busy_wall_ms", "device_busy_ms",
            "device_busy_share")},
        "pipeline_steps_per_s": DATA_STEPS / piped["seconds"],
        "pipeline_images_per_s_end_to_end":
            DATA_STEPS * RESNET_BATCH / piped["seconds"],
        "prestaged": {k: base[k] for k in (
            "seconds", "steady_step_ms", "steady_images_per_s",
            "device_busy_ms", "device_busy_share")},
        "iterator_images_per_s": iter_rate,
        "paced_by": pace}


class _IndexedBatches:
    """(iv)'s host batches: batch i is filled with i."""

    def __init__(self, torch, n, shape):
        self._torch, self._n, self._shape = torch, n, shape
        self.batch_size = shape[0]
        self._i = 0

    def next(self):
        from incubator_mxnet_tpu_torch import io, nd
        if self._i >= self._n:
            raise StopIteration
        i = self._i
        self._i += 1
        x = self._torch.full(self._shape, float(i))
        y = self._torch.full(self._shape[:1], float(i))
        return io.DataBatch([nd.NDArray(x)], [nd.NDArray(y)])

    def reset(self):
        self._i = 0

    def state_dict(self):
        raise NotImplementedError


def data_copy_stress(mt, torch):
    """(iv) DevicePrefetchIter at each depth over DATA_STRESS host
    batches filled from their index; the consumer first sleeps on its
    stream past the copy's time, then counts on the card the elements
    of the staged batch that differ from its index.  The copy's GB/s
    from pinned memory is timed alone between CUDA events."""
    shape = (RESNET_BATCH,) + RESNET_IMAGE
    nbytes = 4 * math.prod(shape)
    pinned = torch.empty(shape, pin_memory=True)
    dev = torch.empty(shape, device="cuda")
    dev.copy_(pinned, non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        dev.copy_(pinned, non_blocking=True)
    end.record()
    end.synchronize()
    copy_ms = start.elapsed_time(end) / 20
    del dev, pinned
    # a sleep that outlasts the copy: cycles at the SM clock
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") \
        else 2e9
    cycles = int(3 * copy_ms * 1e-3 * clock_hz)
    out = {}
    for depth in DATA_DEPTHS:
        it = mt.io.DevicePrefetchIter(_IndexedBatches(torch, DATA_STRESS,
                                                      shape),
                                      ctx=mt.tpu(0), depth=depth)
        mismatched = torch.zeros((), dtype=torch.int64, device="cuda")
        seen = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, batch in enumerate(it):
            torch.cuda._sleep(cycles)
            mismatched += (batch.data[0].handle != i).sum()
            mismatched += (batch.label[0].handle != i).sum()
            seen += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = int(mismatched.item())
        check(seen == DATA_STRESS and bad == 0,
              f"DevicePrefetchIter depth {depth}: {bad} mismatched "
              f"elements over {seen} batches")
        out[str(depth)] = {"batches": seen, "mismatches": bad,
                           "seconds": wall}
    return {"batch_bytes": nbytes, "sleep_cycles": cycles,
            "copy_ms": copy_ms, "copy_gb_s": nbytes / copy_ms / 1e6,
            "depths": out}


def data_decode_crop(record):
    """(v)'s transform, run in the DataLoader's workers: unpack a record,
    decode it (image.imdecode), crop the center 224 x 224, and normalize
    as (ii) does; numpy out."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mt
    header, jpg = mt.recordio.unpack(record)
    img = mt.image.imdecode(jpg).asnumpy()
    h, w = img.shape[:2]
    side = RESNET_IMAGE[1]
    y0, x0 = (h - side) // 2, (w - side) // 2
    crop = img[y0:y0 + side, x0:x0 + side].astype(np.float32)
    crop = (crop - np.asarray(DATA_MEAN, np.float32)) \
        / np.asarray(DATA_STD, np.float32)
    return crop.transpose(2, 0, 1).copy(), np.float32(header.label)


def data_gluon(mt, torch, path):
    """(v) gluon.data.DataLoader over a RecordFileDataset of (ii)'s .rec
    with DATA_LOADER_WORKERS process workers: its first batches bit-equal
    to num_workers=0's, its rate alone, and the Gluon ResNet-50 v1
    Trainer fed from it."""
    gd = mt.gluon.data
    dataset = gd.RecordFileDataset(path).transform(data_decode_crop)

    def loader(workers):
        return gd.DataLoader(dataset, batch_size=RESNET_BATCH,
                             shuffle=False, num_workers=workers)

    sync = iter(loader(0))
    ref = [next(sync) for _ in range(DATA_LOADER_CHECKED)]
    del sync
    t0 = time.perf_counter()
    got = []
    for i, batch in enumerate(loader(DATA_LOADER_WORKERS)):
        if i < DATA_LOADER_CHECKED:
            got.append(batch)
        if i + 1 == DATA_GLUON_STEPS:
            break
    alone_s = time.perf_counter() - t0
    differ = sum(not (bool((a[0].handle == b[0].handle).all()) and
                      bool((a[1].handle == b[1].handle).all()))
                 for a, b in zip(ref, got))
    check(len(got) == DATA_LOADER_CHECKED and differ == 0,
          f"DataLoader process workers: {differ} of {len(got)} batches "
          "differ from num_workers=0's")
    net = resnet_net(mt, torch, "cuda")
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", RESNET_SGD)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(loader(DATA_LOADER_WORKERS)):
        xs = mt.nd.NDArray(x.handle.cuda())
        ys = mt.nd.NDArray(y.handle.cuda())
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(RESNET_BATCH)
        losses.append(loss.mean())
        if i + 1 == DATA_GLUON_STEPS:
            break
    losses = [float(v.asscalar()) for v in losses]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    check(len(losses) == DATA_GLUON_STEPS and
          all(math.isfinite(v) for v in losses), f"Gluon losses {losses}")
    del net, trainer
    return {"workers": DATA_LOADER_WORKERS, "process_workers": True,
            "batches_bit_equal": DATA_LOADER_CHECKED,
            "loader_images_per_s": DATA_GLUON_STEPS * RESNET_BATCH
            / alone_s,
            "loop_images_per_s": DATA_GLUON_STEPS * RESNET_BATCH / loop_s,
            "steps": DATA_GLUON_STEPS, "losses": losses}


def data_predictor(mt, torch, mod, prefix, host_batch):
    """(vi) the Predictor over (iii)'s checkpoint on the card, against
    Module.predict on one batch (fp32, TF32 off); its latency."""
    import numpy as np
    x, y = host_batch[0].numpy(), host_batch[1].numpy()
    shapes = {"data": x.shape, "softmax_label": y.shape}
    pred = mt.Predictor(f"{prefix}-symbol.json", f"{prefix}-0001.params",
                        shapes)
    check(pred._exec._ctx.type == "cuda", "the Predictor is not on the card")

    def run():
        pred.forward(data=x, softmax_label=y)
        return pred.get_output(0).asnumpy()

    got = run()
    want = mod.predict(mt.io.NDArrayIter(x, y, batch_size=len(x)))
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(rel <= DATA_PREDICT_TOL,
          f"Predictor vs Module.predict: rel {rel} > {DATA_PREDICT_TOL}")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"rel_err_vs_module_predict": rel, "tol": DATA_PREDICT_TOL,
            "batch": len(x), "predict_ms_median": sorted(times)[5],
            "predict_ms_min": min(times)}


def data_profiler(mt, torch, sym, weights, path, tmp):
    """(vi) the profiler on around DATA_PROFILED_STEPS steps of (iii)'s
    loop (its Module, kvstore='tpu', fed by the pipeline) with an nd
    loss read each step: the framework trace holds one event per
    dispatched op (counted through the dispatch hook), the device trace
    names cuDNN's convolution and batch-norm kernels; the device's busy
    share over those steps."""
    import json
    import os
    import re
    mod = resnet_module(mt, sym, "cuda", weights, RESNET_BATCH,
                        kvstore="tpu")
    it = mt.io.DevicePrefetchIter(data_record_iter(mt, path),
                                  ctx=mt.tpu(0))
    batches = iter(it)
    for _ in range(2):                        # capture outside the window
        mod.forward_backward(next(batches))
        mod.update()
    nd = mt.nd
    monitor = mt.monitor
    dispatched = []
    saved = (monitor.active, monitor.observe_op)
    monitor.active = lambda: True
    monitor.observe_op = lambda name, outs: dispatched.append(name)
    framework = os.path.join(tmp, "profile.json")
    mt.profiler.set_config(filename=framework, mode="coarse")
    logdir = os.path.join(tmp, "device_trace")
    torch.cuda.synchronize()
    try:
        mt.profiler.start_xla_trace(logdir)
        mt.profiler.set_state("run")
        t0 = time.perf_counter()
        for _ in range(DATA_PROFILED_STEPS):
            batch = next(batches)
            mod.forward_backward(batch)
            mod.update()
            prob = mod.get_outputs()[0]
            loss = -nd.log(nd.pick(prob, batch.label[0], axis=-1)).mean()
        loss.asnumpy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        mt.profiler.set_state("stop")
        device = mt.profiler.stop_xla_trace()
    finally:
        monitor.active, monitor.observe_op = saved
        mt.profiler.set_state("stop")
    mt.profiler.dump_profile()
    with open(framework) as f:
        events = json.load(f)["traceEvents"]
    ops = [e["name"] for e in events if e.get("ph") == "X"]
    check(ops == dispatched and len(ops) >= DATA_PROFILED_STEPS,
          f"framework trace holds {len(ops)} op events for "
          f"{len(dispatched)} dispatched ops")
    with open(device) as f:
        dev_events = json.load(f)["traceEvents"]
    kernels = [e for e in dev_events if e.get("cat") == "kernel"]
    conv = [e["name"] for e in kernels if re.search(
        r"conv|fprop|dgrad|wgrad|xmma|implicit_gemm", e["name"], re.I)]
    bn = [e["name"] for e in kernels if re.search(
        r"bn_|batch_?norm|batchnorm", e["name"], re.I)]
    check(conv and bn, f"device trace: {len(conv)} convolution and "
                       f"{len(bn)} batch-norm kernels")
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"framework_trace_bytes": os.path.getsize(framework),
            "framework_op_events": len(ops),
            "dispatched_ops": len(dispatched),
            "device_trace_bytes": os.path.getsize(device),
            "device_kernel_events": len(kernels),
            "conv_kernel_events": len(conv), "bn_kernel_events": len(bn),
            "conv_kernel_example": conv[0][:80],
            "bn_kernel_example": bn[0][:80],
            "profiled_steps": DATA_PROFILED_STEPS, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top5_device_ms": [[k[:80], v] for k, v in top]}


def data_consistency(mt):
    """(vii) test_utils.check_consistency of five Symbols between cpu()
    and the card, at the reference's tolerances."""
    S = mt.sym
    syms = {
        "Convolution": S.Convolution(S.Variable("data"), num_filter=32,
                                     kernel=(3, 3), pad=(1, 1), name="conv"),
        "BatchNorm": S.BatchNorm(S.Variable("data"), name="bn"),
        "FullyConnected": S.FullyConnected(S.Variable("data"),
                                           num_hidden=128, name="fc"),
        "Pooling": S.Pooling(S.Variable("data"), kernel=(3, 3),
                             stride=(2, 2), pool_type="max", name="pool"),
        "softmax": S.softmax(S.Variable("data"), name="softmax"),
    }
    out = {}
    for op, sym in syms.items():
        shapes = DATA_CONSISTENCY[op][1]
        try:
            res = mt.test_utils.check_consistency(
                sym, [dict(ctx=mt.cpu(), shapes=shapes),
                      dict(ctx=mt.tpu(0), shapes=shapes)])
        except AssertionError as exc:
            raise CheckFailed(f"check_consistency({op}): {exc}") from None
        (co, cg, _), (go, gg, _) = res
        out[op] = {"out_max_abs_err": max(float(abs(a - b).max())
                                          for a, b in zip(go, co)),
                   "grad_max_abs_err": max((float(abs(gg[k] - cg[k]).max())
                                            for k in cg), default=0.0)}
    return {"rtol": 1e-4, "atol": 1e-5, "ops": out}


def data_det_rec(mt, np, path):
    """DATA_DET's detection .rec: 300 x 300 JPEGs, one to three boxes
    each (class 0 wide, 1 tall), brighter than the background."""
    from PIL import Image
    import io as _io
    rs = np.random.RandomState(SEED)
    side = DATA_DET["side"]
    rio = mt.recordio
    w = rio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(DATA_DET["images"]):
        img = rs.rand(side, side, 3) * 50
        objs = []
        for _ in range(1 + i % 3):
            wide = rs.rand() < 0.5
            bw = rs.uniform(0.25, 0.45)
            bh = bw * rs.uniform(0.4, 0.6)
            if not wide:
                bw, bh = bh, bw
            x0, y0 = rs.uniform(0, 1 - bw), rs.uniform(0, 1 - bh)
            px = [int(v * side) for v in (x0, y0, x0 + bw, y0 + bh)]
            img[px[1]:px[3], px[0]:px[2]] += 150
            objs += [0.0 if wide else 1.0, x0, y0, x0 + bw, y0 + bh]
        buf = _io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=DATA_QUALITY)
        label = np.asarray([2, 5] + objs, np.float32)
        w.write_idx(i, rio.pack(rio.IRHeader(0, label, i, 0),
                                buf.getvalue()))
    w.close()
    return path + ".rec"


def data_detection(mt, torch, np, tmp):
    """(viii) ImageDetIter over DATA_DET's .rec feeds config 4's SSD loop
    (the detect phase's blocks, loss and SGD) on the card; its loss
    falls."""
    import os
    import random
    rec = data_det_rec(mt, np, os.path.join(tmp, "det"))
    q = DATA_DET
    shape = (3, q["side"], q["side"])
    random.seed(SEED)
    np.random.seed(SEED)
    augs = mt.image.CreateDetAugmenter(shape, rand_mirror=True,
                                       mean=np.zeros(3),
                                       std=np.full(3, 255.0))
    it = mt.image.ImageDetIter(q["batch"], shape, path_imgrec=rec,
                               shuffle=True, aug_list=augs)
    nd = mt.nd
    mt.random.seed(0)
    blocks = ssd_blocks(mt, DEV)
    params = {}
    for blk in blocks:
        params.update(blk.collect_params())
    trainer = mt.gluon.Trainer(params, "sgd", dict(
        learning_rate=q["lr"], momentum=0.9, wd=1e-4))
    one = nd.array([1.0], ctx=DEV)
    losses, load_s = [], 0.0
    t0 = time.perf_counter()
    for _ in range(q["iters"]):
        t1 = time.perf_counter()
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            batch = it.next()
        xb = nd.array(batch.data[0], ctx=DEV)
        lb = nd.array(batch.label[0], ctx=DEV)
        load_s += time.perf_counter() - t1
        with mt.autograd.record():
            loss = ssd_loss(nd, *ssd_forward(nd, blocks, xb), lb, one)
        loss.backward()
        trainer.step(q["batch"])
        losses.append(float(loss.asnumpy()[0]))
    seconds = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"(viii) SSD loss did not fall: {losses}")
    return {"images": q["images"], "side": q["side"], "batch": q["batch"],
            "iters": q["iters"], "label_shape": list(it.provide_label[0]
                                                      .shape),
            "losses": losses, "seconds": seconds, "load_seconds": load_s}


# (ix) the multi-process data service
DATA_SERVICE_WORKERS = (1, 2, 4, 6)    # timed: an epoch after a warm one
DATA_SERVICE_CONTRACT = (1, 2, 4)      # held against ImageRecordIter
DATA_SERVICE_DEPTH = 4                 # MXTPU_DATA_RING_DEPTH's default
DATA_SERVICE_RESUME = (4, 3, 7)        # W, then W', after 7 batches
DATA_SERVICE_KILLED = 12               # batches of the SIGKILL stream
DATA_SERVICE_REMOTE = 8                # batches with a remote shard


def data_service_iter(mt, path, workers, augment=True, **kw):
    """A DataServiceIter as train_imagenet.py's ImageRecordIter
    (augment=True) or with random crop and mirror off, from fixed
    seeds."""
    import random
    import numpy as np
    np.random.seed(SEED)
    random.seed(SEED)
    return mt.io.DataServiceIter(
        path_imgrec=path, data_shape=RESNET_IMAGE, batch_size=RESNET_BATCH,
        num_workers=workers, shuffle=True, rand_crop=augment,
        rand_mirror=augment, mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1],
        mean_b=DATA_MEAN[2], std_r=DATA_STD[0], std_g=DATA_STD[1],
        std_b=DATA_STD[2], preprocess_threads=1, **kw)


def _host_batches(it, limit=None):
    out = []
    for b in it:
        out.append((b.data[0].handle, b.label[0].handle, b.pad))
        if limit is not None and len(out) == limit:
            break
    return out


def _differing(got, ref):
    """Indices of the batches of ``got`` that differ from ``ref``'s
    (data, label or pad), and whether the counts differ."""
    bad = [i for i, (a, b) in enumerate(zip(got, ref))
           if not (a[2] == b[2] and bool((a[0] == b[0]).all())
                   and bool((a[1] == b[1]).all()))]
    return bad + (["count"] if len(got) != len(ref) else [])


def data_service_probe(mt, decoder):
    """The host the workers run on: CPUs, /dev/shm against the rings of
    each timed worker count, and the decoder."""
    import os
    from incubator_mxnet_tpu_torch.data_service import (
        build_decode_spec as build)
    st = os.statvfs("/dev/shm")
    slot = 64 + RESNET_BATCH * (3 * RESNET_IMAGE[1] * RESNET_IMAGE[2] + 1) * 4
    rings = {w: w * DATA_SERVICE_DEPTH * slot for w in DATA_SERVICE_WORKERS}
    free = st.f_bavail * st.f_frsize
    return {"cpu_count": os.cpu_count(),
            "cpu_affinity": len(os.sched_getaffinity(0)),
            "shm_bytes": st.f_blocks * st.f_frsize, "shm_free_bytes": free,
            "slot_bytes": slot, "depth": DATA_SERVICE_DEPTH,
            "ring_bytes_by_workers": rings,
            "rings_fit": {w: b <= free for w, b in rings.items()},
            # random crop keeps the native decoder off (config 2's
            # augmentation decodes with PIL wherever it runs)
            "worker_decoder": {
                "center_crop": "native" if build(RESNET_IMAGE)["native"]
                else decoder,
                "random_crop": "native" if build(
                    RESNET_IMAGE, rand_crop=True)["native"] else decoder}}


def data_service_contract(mt, path):
    """The merged stream at W = 1, 2, 4 without random augmentation
    against ImageRecordIter's, bit for bit."""
    import random
    import numpy as np
    np.random.seed(SEED)
    random.seed(SEED)
    ref = _host_batches(mt.io.ImageRecordIter(
        path_imgrec=path, data_shape=RESNET_IMAGE, batch_size=RESNET_BATCH,
        shuffle=True, mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1],
        mean_b=DATA_MEAN[2], std_r=DATA_STD[0], std_g=DATA_STD[1],
        std_b=DATA_STD[2], preprocess_threads=data_threads()))
    check(len(ref) == DATA_STEPS, f"ImageRecordIter gave {len(ref)} batches")
    out = {}
    for w in DATA_SERVICE_CONTRACT:
        t0 = time.perf_counter()
        with data_service_iter(mt, path, w, augment=False) as svc:
            got = _host_batches(svc)
        bad = _differing(got, ref)
        check(not bad, f"the service at W={w} differs from "
                       f"ImageRecordIter at batches {bad[:8]}")
        out[w] = {"batches": len(got), "bit_equal": True,
                  "seconds": time.perf_counter() - t0}
    return out


def _probe_workers(outdir):
    """Make every worker forked from now on write, at its first epoch,
    whether CUDA is initialized in it.  Returns the undo."""
    import os
    from incubator_mxnet_tpu_torch.data_service import worker
    run = worker._run_shard

    def probed(ring, spec):
        t = sys.modules.get("torch")
        rec = {"pid": os.getpid(), "torch_imported": t is not None,
               "cuda_initialized": bool(t is not None
                                        and t.cuda.is_initialized()),
               "in_bad_fork": bool(t is not None
                                   and t.cuda._is_in_bad_fork())}
        with open(os.path.join(outdir, f"w{os.getpid()}.json"), "w") as f:
            json.dump(rec, f)
        return run(ring, spec)
    worker._run_shard = probed

    def undo():
        worker._run_shard = run
    return undo


def data_service_rates(mt, torch, path, tmp):
    """img/s of the service alone at each timed W, over an epoch after a
    warm one, with train_imagenet.py's augmentation; W=4's warm epoch
    bit-equal to W=1's (the same seed); the workers' CUDA state.
    Returns the record and W=1's first epoch (the stream the later
    parts are held against)."""
    import os
    probes = os.path.join(tmp, "worker_probes")
    os.makedirs(probes, exist_ok=True)
    check(torch.cuda.is_initialized(),
          "CUDA is not initialized in the parent before the fork")
    undo = _probe_workers(probes)
    first, rates = None, {}
    try:
        for w in DATA_SERVICE_WORKERS:
            t0 = time.perf_counter()
            with data_service_iter(mt, path, w) as svc:
                spawn_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                warm = _host_batches(svc)
                warm_s = time.perf_counter() - t0
                if first is None:
                    first = warm
                else:
                    bad = _differing(warm, first)
                    check(not bad, f"the augmented stream at W={w} differs "
                                   f"from W={DATA_SERVICE_WORKERS[0]}'s at "
                                   f"batches {bad[:8]}")
                del warm
                svc.reset()
                t0 = time.perf_counter()
                n = sum(RESNET_BATCH - p for _, _, p in _host_batches(svc))
                sec = time.perf_counter() - t0
                stats = svc.stats()
            rates[w] = {"images": n, "seconds": sec, "images_per_s": n / sec,
                        "warm_seconds": warm_s, "spawn_seconds": spawn_s,
                        "restarts": stats["restarts"]}
    finally:
        undo()
    workers = [json.load(open(os.path.join(probes, f)))
               for f in sorted(os.listdir(probes))]
    check(len(workers) >= sum(DATA_SERVICE_WORKERS),
          f"{len(workers)} worker probes for {sum(DATA_SERVICE_WORKERS)} "
          "workers")
    hot = [r for r in workers if r["cuda_initialized"]]
    check(not hot, f"CUDA is initialized in workers {hot[:3]}")
    return {"rates": rates,
            "augmented_bit_equal_across_workers": True,
            "workers_probed": len(workers),
            "workers_import_torch": all(r["torch_imported"]
                                        for r in workers),
            "workers_cuda_initialized": False,
            "workers_in_bad_fork": sorted({r["in_bad_fork"]
                                           for r in workers}),
            "parent_cuda_initialized_before_fork": True}, first


def data_service_config2(mt, torch, sym, weights, path, first, workers):
    """Config 2 from DevicePrefetchIter(DataServiceIter) at ``workers``:
    40 Module.fit steps, losses bit-equal to ``first`` staged on the
    card beforehand; the telemetry spans of the fit."""
    tel = mt.telemetry
    staged = [(x.cuda(), y.cuda()) for x, y, _ in first[:DATA_STEPS]]
    card = _CardBatches(
        mt, staged, [mt.io.DataDesc("data", (RESNET_BATCH,) + RESNET_IMAGE)],
        [mt.io.DataDesc("softmax_label", (RESNET_BATCH,))])
    base_mod, base = data_fit(mt, torch, sym, weights, card)
    del base_mod, card, staged
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tel.get_registry().reset()
    with data_service_iter(mt, path, workers) as svc:
        train = mt.io.DevicePrefetchIter(svc, ctx=mt.tpu(0))
        mod, piped = data_fit(mt, torch, sym, weights, train)
        stats = svc.stats()
    peak = torch.cuda.max_memory_allocated()
    del mod, train
    differ = [i for i, (a, b) in enumerate(zip(piped["losses"],
                                               base["losses"])) if a != b]
    check(len(piped["losses"]) == DATA_STEPS and not differ,
          f"service losses differ from the pre-staged run at steps "
          f"{differ[:8]}: {piped['losses'][:4]} vs {base['losses'][:4]}")
    hists = tel.snapshot()["histograms"]
    spans = {}
    for name in ("data_wait", "forward_backward", "optimizer",
                 "host_sync"):
        h = hists.get(f"span_{name}_seconds")
        check(h is not None and h["count"] >= DATA_STEPS,
              f"span {name}: {h}")
        spans[name] = {"count": h["count"], "sum_s": h["sum"],
                       "p50_s": h["p50"], "p90_s": h["p90"]}
    data_share = spans["data_wait"]["sum_s"] / piped["seconds"]
    return {"workers": workers, "steps": DATA_STEPS,
            "losses_bit_equal": True, "losses": piped["losses"],
            "seconds": piped["seconds"],
            "steps_per_s": DATA_STEPS / piped["seconds"],
            "images_per_s_end_to_end":
                DATA_STEPS * RESNET_BATCH / piped["seconds"],
            "steady_step_ms": piped["steady_step_ms"],
            "steady_images_per_s": piped["steady_images_per_s"],
            "device_busy_share": piped["device_busy_share"],
            "busy_steps": piped["busy_steps"],
            "spans": spans, "data_wait_share_of_fit": data_share,
            "peak_card_bytes": peak,
            "peak_card_bytes_over_start": peak - start_bytes,
            "service_restarts": stats["restarts"],
            "prestaged": {k: base[k] for k in (
                "seconds", "steady_step_ms", "steady_images_per_s",
                "device_busy_share")}}


def data_service_resume_kill(mt, path, first):
    """A state_dict at W=4 after 7 batches restored at W=3; a worker
    SIGKILLed mid-epoch."""
    import os
    import signal
    import warnings
    w, w_new, k = DATA_SERVICE_RESUME
    with data_service_iter(mt, path, w) as svc:
        head = _host_batches(svc, limit=k)
        state = svc.state_dict()
    check(not _differing(head, first[:k]), "the stream before the state")
    with data_service_iter(mt, path, w_new) as svc:
        svc.load_state_dict(state)
        svc.reset()                   # fit's epoch-start reset keeps it
        nxt = _host_batches(svc, limit=1)
    check(not _differing(nxt, first[k:k + 1]),
          f"the batch after a state_dict at W={w} restored at W={w_new} "
          "is not the uninterrupted stream's")
    tel, tr = mt.telemetry, mt.tracing
    tel.get_registry().reset()
    tr.reset_for_tests()
    with data_service_iter(mt, path, w, ring_depth=1) as svc:
        got = _host_batches(svc, limit=2)
        victim = svc._procs[1].pid
        os.kill(victim, signal.SIGKILL)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got += _host_batches(svc, limit=DATA_SERVICE_KILLED - 2)
        restarts = svc._restarts
    bad = _differing(got, first[:DATA_SERVICE_KILLED])
    check(not bad, f"the stream after a SIGKILL differs at {bad[:8]}")
    counted = tel.snapshot()["counters"].get(
        "data_service_worker_restarts_total")
    dead = tr.events("data_service_worker_dead")
    restart = tr.events("data_service_worker_restart")
    check(restarts == 1 and counted == 1 and dead and restart,
          f"SIGKILL: restarts {restarts}, counter {counted}, events "
          f"{len(dead)} dead and {len(restart)} restart")
    return {"resume": {"workers": w, "restored_at": w_new,
                       "after_batches": k, "next_batch_equal": True},
            "sigkill": {"workers": w, "ring_depth": 1, "killed_pid": victim,
                        "batches": len(got), "bit_identical": True,
                        "restarts": restarts,
                        "data_service_worker_restarts_total": counted,
                        "events": {"data_service_worker_dead": len(dead),
                                   "data_service_worker_restart":
                                       len(restart)}}}


def data_service_remote(mt, path, first, tmp):
    """A RemoteShardServer in a subprocess (the CLI) takes the last of 2
    shards over loopback."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    pf = os.path.join(tmp, "data_net.port")
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.data_service.net",
         "--shards", "1", "--port-file", pf], cwd=root, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        while not os.path.exists(pf):
            check(proc.poll() is None and time.perf_counter() - t0 < 120,
                  "the RemoteShardServer subprocess did not start: "
                  + (proc.stderr.read().decode()[-2000:]
                     if proc.poll() is not None else "timed out"))
            time.sleep(0.05)
        up_s = time.perf_counter() - t0
        addr = f"127.0.0.1:{int(open(pf).read())}"
        t0 = time.perf_counter()
        with data_service_iter(mt, path, 2, remote_addrs=[addr]) as svc:
            got = _host_batches(svc, limit=DATA_SERVICE_REMOTE)
            stats = svc.stats()
        sec = time.perf_counter() - t0
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)
    bad = _differing(got, first[:DATA_SERVICE_REMOTE])
    check(not bad, f"the stream with a remote shard differs at {bad[:8]}")
    check(stats["remote_shards"] == 1 and stats["restarts"] == 0,
          f"remote shard stats {stats['remote_shards']} remote, "
          f"{stats['restarts']} restarts")
    return {"shards": 2, "remote": addr, "batches": len(got),
            "bit_identical": True, "server_start_seconds": up_s,
            "seconds": sec, "restarts": 0}


def data_service(mt, torch, path, decoder, iter_rate, sym, weights, tmp):
    """(ix) the data service on the card host."""
    from incubator_mxnet_tpu_torch.resilience import DataPipelineError
    t = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        t[name] = time.perf_counter() - t0
        return res

    probe = data_service_probe(mt, decoder)
    try:
        contract = part("contract", data_service_contract, mt, path)
        rates, first = part("rates", data_service_rates, mt, torch, path,
                            tmp)
        best = max(rates["rates"],
                   key=lambda w: rates["rates"][w]["images_per_s"])
        config2 = part("config2", data_service_config2, mt, torch, sym,
                       weights, path, first, best)
        release(torch)
        resume = part("resume_kill", data_service_resume_kill, mt, path,
                      first)
        remote = part("remote", data_service_remote, mt, path, first, tmp)
    except DataPipelineError as exc:
        raise CheckFailed(f"data service: {type(exc).__name__}: {exc}; "
                          f"host {probe}") from exc
    return {"host": probe, "contract_no_augmentation": contract,
            "alone": rates, "image_record_iter_images_per_s": iter_rate,
            "best_workers": best, "config2": config2, **resume,
            "remote_shard": remote, "seconds": t}


def data_decoder(mt):
    """Which JPEG decoder this host has: 'native' (src/imgdec on
    libjpeg), 'pil', or None; and why the native one is missing."""
    import importlib.util
    native = mt.image.native_dec.available()
    pil = importlib.util.find_spec("PIL") is not None
    return ("native" if native else "pil" if pil else None,
            {"native": native, "native_why": mt.image.native_dec.why(),
             "pil": pil})


def phase_data(mt, torch, card):
    import os
    import tempfile
    import numpy as np
    launches = mt.ops.LAUNCHES
    decoder, decoders = data_decoder(mt)
    check(decoder is not None,
          f"no JPEG decoder on this host: {decoders}")
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mt.ops.reset_launches()
    t = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        t[name] = time.perf_counter() - t0
        return res

    try:
        with tempfile.TemporaryDirectory() as tmp:
            raw = part("recordio", data_recordio, mt, np, tmp)
            rec = os.path.join(tmp, "imagenet")
            enc_s, enc_bytes = part("encode", data_write_images, mt, np,
                                    rec, DATA_IMAGES)
            rec += ".rec"
            alone, host_batches = part("iterator", data_iter_alone, mt, rec)
            mod, prefix, sym, weights, config2 = part(
                "config2", data_config2, mt, torch, rec, host_batches,
                alone["images_per_s"], tmp)
            config2["peak_card_bytes_over_phase_start"] = \
                torch.cuda.max_memory_allocated() - base_bytes
            predictor = part("predictor", data_predictor, mt, torch, mod,
                             prefix, host_batches[0])
            del mod
            release(torch)
            service = part("service", data_service, mt, torch, rec,
                           decoder, alone["images_per_s"], sym, weights,
                           tmp)
            release(torch)
            profiled = part("profiler", data_profiler, mt, torch, sym,
                            weights, rec, tmp)
            release(torch)
            stress = part("copy_stress", data_copy_stress, mt, torch)
            del host_batches
            gluon = part("gluon", data_gluon, mt, torch, rec)
            release(torch)
            consistency = part("consistency", data_consistency, mt)
            detection = part("detection", data_detection, mt, torch, np,
                             tmp)
            release(torch)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    counts = {k: v for k, v in launches.items() if v}
    check(not counts, f"phase data launched kernels of the port: {counts}")
    emit({"phase": "data", "card": card, "cpu_count": os.cpu_count(),
          "jpeg_decoder": decoder, "decoders": decoders,
          "seconds": t,
          "recordio": raw,
          "images": {"records": DATA_IMAGES, "jpeg_bytes": enc_bytes,
                     "mean_jpeg_bytes": enc_bytes / DATA_IMAGES,
                     "encode_seconds": enc_s, "quality": DATA_QUALITY,
                     "stored": [DATA_SHORT, DATA_LONG]},
          "image_record_iter": alone, "config2": config2,
          "data_service": service,
          "copy_stress": stress, "gluon": gluon, "predictor": predictor,
          "profiler": profiled, "check_consistency": consistency,
          "image_det_iter": detection,
          "kernel_launches": counts,
          "hand_kernels": "none: decode, augmentation and batching run on "
                          "the host, the copy is a DMA"})
    return counts


# ---------------------------------------------------------- operability
# The perf observatory, the step guard and loss scaling, the memory
# preflight and OOM ladder, and divergence rollback on the card.
OPS_STEPS = 9                     # (i) guarded ResNet-50 Trainer steps
OPS_BAD = (3, 6)                  # (i) the steps whose gradients go bad
OPS_GUARD_INTERVAL = 4
OPS_STATIC_SCALE = 2.0 ** 15      # (ii)
OPS_STATIC_STEPS = 4
OPS_DYNAMIC_STEPS = 6             # (ii): overflow at 2, growth at 5
OPS_SCALE_WINDOW = 2
OPS_MAX_BAD = 3                   # (iii) MXTPU_MAX_BAD_STEPS
OPS_CLOCK_REPLAYS = 20            # (iv)
OPS_PLAN_GATE = 0.20              # (v) the JAX planner's own tolerance
OPS_MFU_GATE = 0.05               # (iv) clock vs timed MFU
OPS_RESNET_FLOPS_GATE = 0.02      # (iv)
OPS_ACCUM_TOL = 1e-5              # (vi) the grad_accum rung's loss
OPS_MARGIN = 0.05                 # MXTPU_MEM_GATE_MARGIN's default


@contextlib.contextmanager
def env_set(mt, **kw):
    """The MXTPU_* settings ``kw`` for the scope (restored after), with
    the fault-injection counters reset on the way in and out."""
    import os
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    mt.resilience.reset_faults()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        mt.resilience.reset_faults()


def counter(mt, name):
    return mt.telemetry.get_registry().counter(name).value


def ops_loop_values(trainer, net):
    """Clones of every trainable parameter, every optimizer-state tensor
    and the step count: what a skipped step must leave as it was (the
    forward still moves BatchNorm's moving stats, as an unguarded
    forward does)."""
    vals = [p._var.detach().clone() for p in net.collect_params().values()
            if p.grad_req != "null"]
    vals += [t.detach().clone() for t in
             trainer._fstate.get("mom", {}).values()]
    return vals, trainer._optimizer.num_update


def ops_guarded_loop(mt, torch, x, y, steps, bad=(), guarded=True,
                     scale_env=None, hybridize=False):
    """``steps`` of phase resnet (iv)'s imperative loop (deterministic
    cuDNN) from the seeded weights; ``bad`` are the guarded steps whose
    gradients the grad:nonfinite injection poisons.  Returns (losses,
    ms per step, per bad step whether every value stayed bit-equal,
    steps run under sync-debug "error", the trainer, the net)."""
    settings = dict(scale_env or {})
    if guarded:
        settings.update(
            MXTPU_NONFINITE_POLICY="skip",
            MXTPU_GUARD_INTERVAL=OPS_GUARD_INTERVAL,
            MXTPU_FAULT_SPEC=",".join(
                f"grad:nonfinite:{s}:{'nan' if i % 2 == 0 else 'inf'}"
                for i, s in enumerate(bad)))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with env_set(mt, **settings):
            net = resnet_net(mt, torch, "cuda")
            if hybridize:
                net.hybridize()
            trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                       RESNET_SGD)
            loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
            xs, ys = mt.nd.NDArray(x), mt.nd.NDArray(y)
            losses, ms, kept, quiet, scales = [], [], {}, 0, []
            for i in range(1, steps + 1):
                before = ops_loop_values(trainer, net) if i in bad \
                    else None
                used = trainer.loss_scale
                due = not guarded or \
                    trainer.guard.steps % trainer.guard.interval == 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # the steps between guard reads must not synchronize
                torch.cuda.set_sync_debug_mode(0 if due else "error")
                try:
                    with mt.autograd.record():
                        loss = loss_fn(net(xs), ys) * used
                    loss.backward()
                    trainer.step(RESNET_BATCH)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                quiet += not due
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                # a power of two: the division is exact
                losses.append(loss.handle.detach().mean() / used)
                scales.append(trainer.loss_scale)
                if before is not None:
                    vals, count = ops_loop_values(trainer, net)
                    kept[i] = all(torch.equal(a, b)
                                  for a, b in zip(before[0], vals))
            losses = [float(v) for v in losses]
    finally:
        torch.backends.cudnn.deterministic = det
    return {"losses": losses, "ms": ms, "kept": kept, "quiet_steps": quiet,
            "scales": scales, "trainer": trainer, "net": net}


def ops_trainer_guard(mt, torch, x, y):
    """(i) the step guard on phase resnet (iv)'s Trainer loop."""
    ref = ops_guarded_loop(mt, torch, x, y, OPS_STEPS - len(OPS_BAD),
                           guarded=False)
    got = ops_guarded_loop(mt, torch, x, y, OPS_STEPS, bad=OPS_BAD)
    tr = got["trainer"]
    good = [v for i, v in enumerate(got["losses"], 1) if i not in OPS_BAD]
    check(all(got["kept"].values()) and len(got["kept"]) == len(OPS_BAD),
          f"a skipped step changed a parameter or momentum: {got['kept']}")
    check(tr._optimizer.num_update == OPS_STEPS - len(OPS_BAD),
          f"step count {tr._optimizer.num_update} after "
          f"{len(OPS_BAD)} skipped of {OPS_STEPS}")
    reads = (OPS_STEPS - 1) // OPS_GUARD_INTERVAL + 1
    check(tr.guard.skipped_steps == len(OPS_BAD)
          and tr.guard.checks == reads,
          f"guard skipped {tr.guard.skipped_steps}, read "
          f"{tr.guard.checks} times")
    check(good == ref["losses"],
          f"guarded losses {good} vs the unguarded run's {ref['losses']}")
    check(got["quiet_steps"] == OPS_STEPS - reads,
          f"{got['quiet_steps']} steps under sync-debug 'error'")
    med = lambda v: sorted(v[1:])[len(v[1:]) // 2]
    return {"steps": OPS_STEPS, "bad_steps": list(OPS_BAD),
            "guard_interval": OPS_GUARD_INTERVAL,
            "bad_steps_bit_equal": got["kept"],
            "losses_equal_unguarded": True,
            "step_count": tr._optimizer.num_update,
            "guard_reads": tr.guard.checks,
            "steps_without_sync": got["quiet_steps"],
            "guarded_ms": got["ms"], "unguarded_ms": ref["ms"],
            "guarded_ms_median": med(got["ms"]),
            "unguarded_ms_median": med(ref["ms"]),
            "unguarded_losses": ref["losses"]}, ref["losses"]


def ops_loss_scaling(mt, torch, x, y, unscaled):
    """(ii) a static scale of 2^15 against the unscaled loop, and a
    dynamic one backing off at an injected overflow and growing back,
    on the hybridized net (one capture)."""
    static = ops_guarded_loop(
        mt, torch, x, y, OPS_STATIC_STEPS, guarded=False,
        scale_env={"MXTPU_LOSS_SCALE": OPS_STATIC_SCALE})
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(static["losses"], unscaled))
    check(rel <= 1e-6, f"static loss scale: losses {static['losses']} "
                       f"vs unscaled {unscaled[:OPS_STATIC_STEPS]}")
    back = counter(mt, "loss_scale_backoffs_total")
    grow = counter(mt, "loss_scale_growths_total")
    dyn = ops_guarded_loop(
        mt, torch, x, y, OPS_DYNAMIC_STEPS, guarded=False,
        hybridize=True,
        scale_env={"MXTPU_LOSS_SCALE": OPS_STATIC_SCALE,
                   "MXTPU_LOSS_SCALE_DYNAMIC": 1,
                   "MXTPU_LOSS_SCALE_WINDOW": OPS_SCALE_WINDOW,
                   "MXTPU_FAULT_SPEC": "grad:nonfinite:2:inf"})
    tr = dyn["trainer"]
    s = OPS_STATIC_SCALE
    want = [s, s / 2, s / 2, s, s, s * 2]
    check(dyn["scales"] == want, f"dynamic scales {dyn['scales']}, not "
                                 f"{want}")
    check(tr.guard.policy == "skip" and tr.guard.skipped_steps == 1,
          f"dynamic scaling: policy {tr.guard.policy}, skipped "
          f"{tr.guard.skipped_steps}")
    check(counter(mt, "loss_scale_backoffs_total") - back == 1
          and counter(mt, "loss_scale_growths_total") - grow == 2,
          "loss scale counters")
    stats = dyn["net"]._cached_op.stats()
    check(stats["traces"] == 1, f"hybridized net captured "
                                f"{stats['traces']} times, not once")
    check(all(math.isfinite(v) for v in dyn["losses"]),
          f"dynamic losses {dyn['losses']}")
    return {"static_scale": OPS_STATIC_SCALE,
            "static_losses": static["losses"],
            "static_max_rel_err": rel,
            "static_bit_equal": static["losses"]
            == unscaled[:OPS_STATIC_STEPS],
            "dynamic_scales": dyn["scales"],
            "dynamic_window": OPS_SCALE_WINDOW,
            "dynamic_losses": dyn["losses"],
            "dynamic_captures": stats["traces"]}


def ops_module_rollback(mt, torch, kvstore, tmp):
    """(iii) phase module (i)'s MNIST MLP through Module.fit with a
    checkpoint after its first epoch, then OPS_MAX_BAD consecutive bad
    steps: DivergedError, one rollback to that checkpoint; the fit
    resumed from it meets the example's gate."""
    import numpy as np
    rs = np.random.RandomState(SEED)
    xtr, ytr = synthetic_mnist(MLP_TRAIN, rs)
    xva, yva = synthetic_mnist(MLP_VAL, rs)
    train = mt.io.NDArrayIter(xtr, ytr, MLP_BATCH, shuffle=True, seed=SEED)
    val = mt.io.NDArrayIter(xva, yva, MLP_BATCH)
    prefix = f"{tmp}/mlp_{kvstore}"
    per_epoch = MLP_TRAIN // MLP_BATCH
    first_bad = per_epoch + 5
    spec = ",".join(f"grad:nonfinite:{first_bad + k}:nan"
                    for k in range(OPS_MAX_BAD))
    mod = mt.mod.Module(mnist_mlp(mt.sym), context="cuda")
    mt.random.seed(SEED)
    kw = dict(eval_data=val, kvstore=kvstore, optimizer="sgd",
              optimizer_params=MLP_SGD, initializer=mt.init.Xavier(),
              checkpoint_prefix=prefix)
    rolled = counter(mt, "rollbacks_total")
    with env_set(mt, MXTPU_NONFINITE_POLICY="skip",
                 MXTPU_MAX_BAD_STEPS=OPS_MAX_BAD, MXTPU_FAULT_SPEC=spec):
        mod.fit(train, num_epoch=1, **kw)
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True,
                            data_iter=train)
        saved = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        diverged = False
        try:
            mod.fit(train, begin_epoch=1, num_epoch=MLP_EPOCHS, **kw)
        except mt.resilience.DivergedError:
            diverged = True
        check(diverged, f"{kvstore}: {OPS_MAX_BAD} bad steps did not "
                        "raise DivergedError")
        n_roll = counter(mt, "rollbacks_total") - rolled
        check(n_roll == 1, f"{kvstore}: {n_roll} rollbacks, not 1")
        back = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        check(all(np.array_equal(back[k], saved[k]) for k in saved),
              f"{kvstore}: the rollback did not restore the checkpoint")
        mod.fit(train, begin_epoch=1, num_epoch=MLP_EPOCHS, **kw)
    acc = mod.score(val, "acc")[0][1]
    check(acc > MLP_GATE, f"{kvstore}: accuracy {acc} after the rollback "
                          f"<= {MLP_GATE}")
    return {"kvstore": kvstore, "bad_steps": [first_bad + k for k in
                                              range(OPS_MAX_BAD)],
            "rollbacks": n_roll, "val_acc": acc,
            "guard_skipped": mod._guard.skipped_steps,
            "captures": (mod._mesh_step.trace_counts
                         if mod._mesh_step is not None else None)}


def ops_exit_code(mt, tmp):
    """(iii) a child that diverges with the exit hook installed exits
    13 (a tiny Module.fit on the CPU, every gradient poisoned)."""
    import os
    code = (
        "import numpy as np, incubator_mxnet_tpu_torch as mt\n"
        "mt.resilience.install_diverged_exithook()\n"
        "x = np.random.RandomState(0).rand(64, 10).astype('f4')\n"
        "it = mt.io.NDArrayIter(x, np.zeros(64, 'f4'), 16)\n"
        "s = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(\n"
        "    mt.sym.Variable('data'), num_hidden=4), name='softmax')\n"
        "mt.mod.Module(s, context=mt.cpu()).fit(it, num_epoch=2)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(mt.__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               MXTPU_NONFINITE_POLICY="skip", MXTPU_MAX_BAD_STEPS="2",
               MXTPU_FAULT_SPEC="grad:nonfinite:*:nan",
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    check(r.returncode == 13 and "DivergedError" in r.stderr,
          f"diverging child exited {r.returncode}: {r.stderr[-400:]}")
    return r.returncode


def ops_lm(mt, torch, **kw):
    """bench.py's transformer step (phase train's) from the seeded
    weights: bf16 over fp32 masters, Adam lr 1e-4, B=8 x L=1024."""
    net = build_model("cuda")
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(SEED))
    return mt.parallel.ShardedTrainStep(
        net, "adam", dict(learning_rate=1e-4), loss_fn=lm_loss,
        compute_dtype=torch.bfloat16, **kw)


def ops_tokens(torch):
    import numpy as np
    b, l = TRAIN
    rs = np.random.RandomState(0)       # bench.py's tokens and labels
    v = MODEL["vocab_size"]
    return [torch.from_numpy(rs.randint(0, v, (b, l)).astype(np.int32))
            .cuda() for _ in range(2)]


def ops_clock(mt, torch, card, toks, labels):
    """(iv) cost_analysis arms the clock on the captured transformer
    step; over OPS_CLOCK_REPLAYS replays the clock's train_mfu against
    the MFU this script times between CUDA events on the same steps,
    both over caps_for(card)'s bf16 peak."""
    step = ops_lm(mt, torch)
    t0 = time.perf_counter()
    cost = step.cost_analysis(toks, labels)
    cost_s = time.perf_counter() - t0
    check(cost is not None and cost["flops"] > 0, f"cost {cost}")
    clock = step._perf_clock
    check(clock is not None and clock.on_card, "cost_analysis armed no "
                                               "card clock")
    clock._interval = OPS_CLOCK_REPLAYS
    clock.arm(tokens_per_step=TRAIN[0] * TRAIN[1])
    caps = mt.perf.caps_for(torch.device("cuda"))
    check(caps.kind in card.lower() or not caps.nominal,
          f"caps {caps.kind} for {card}")
    step(toks, labels)                   # capture; opens the window
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    host0 = time.perf_counter()
    for _ in range(OPS_CLOCK_REPLAYS - 1):
        step(toks, labels)
    end.record()
    host_ms = (time.perf_counter() - host0) * 1e3
    torch.cuda.synchronize()
    clock.poll()
    steps = OPS_CLOCK_REPLAYS - 1
    timed_ms = start.elapsed_time(end)
    peak = caps.peak("bfloat16")
    timed_mfu = cost["flops"] * steps / (timed_ms / 1e3) / peak
    clock_mfu = mt.telemetry.get_registry().gauge("train_mfu").value
    check(list(clock.windows) and clock.windows[-1][0] == steps,
          f"clock windows {list(clock.windows)}")
    check(abs(clock_mfu - timed_mfu) <= OPS_MFU_GATE * timed_mfu,
          f"clock MFU {clock_mfu} vs timed {timed_mfu}")
    tok_s = mt.telemetry.get_registry().gauge("train_tokens_per_sec").value
    check(tok_s > 0, f"train_tokens_per_sec {tok_s}")
    prof = profile(lambda: step(toks, labels), torch)
    layers = MODEL["n_layers"]
    for k in TRAIN_KERNELS:
        n = prof.get("kernels_by_class", {}).get(k)
        check(n == layers, f"(iv) a replay ran {k} {n} times, not "
                           f"{layers}")
    return {"counted_flops": cost["flops"], "counted_bytes": cost["bytes"],
            "cost_analysis_s": cost_s,
            "analytic_flops": step.block.train_flops_per_token(TRAIN[1])
            * TRAIN[0] * TRAIN[1],
            "caps": caps.as_dict(), "replays": steps,
            "timed_ms": timed_ms, "host_enqueue_ms": host_ms,
            "timed_mfu": timed_mfu, "clock_mfu": clock_mfu,
            "host_wall_mfu": cost["flops"] * steps / (host_ms / 1e3)
            / peak, "clock_window": list(clock.windows)[-1],
            "tokens_per_s_gauge": tok_s,
            "replay_profile": prof,
            "captures": dict(step.trace_counts)}


def ops_resnet_cost(mt, torch, net):
    """(iv) ResNet-50's analytic train FLOPs (symbol_cost x 3) against
    the port's own count (phase resnet's) and FlopCounterMode's, and
    Module.perf_report's roofline table of its Symbol at B=32."""
    sym = resnet_symbol(mt, net)
    rep = mt.perf.symbol_cost(sym, {"data": (1,) + RESNET_IMAGE,
                                    "softmax_label": (1,)}).scaled(3.0)
    own = resnet_train_flops(mt, torch, net)
    with torch.no_grad():
        counted = mt.perf.counted_cost(
            lambda: net(torch.zeros(1, *RESNET_IMAGE, device="cuda")))
    drift_own = abs(rep.flops - own) / own
    drift_counted = abs(rep.flops - 3 * counted["flops"]) \
        / (3 * counted["flops"])
    check(drift_own <= OPS_RESNET_FLOPS_GATE
          and drift_counted <= OPS_RESNET_FLOPS_GATE,
          f"ResNet-50 analytic {rep.flops} vs own {own} ({drift_own:.3%}) "
          f"and FlopCounterMode {3 * counted['flops']} "
          f"({drift_counted:.3%})")
    mod = mt.mod.Module(sym, context="cuda")
    mod.bind(data_shapes=[("data", (RESNET_BATCH,) + RESNET_IMAGE)],
             label_shapes=[("softmax_label", (RESNET_BATCH,))])
    report = mod.perf_report()
    del mod
    return {"analytic_train_flops_per_image": rep.flops,
            "own_train_flops_per_image": own,
            "flop_counter_train_flops_per_image": 3 * counted["flops"],
            "drift_own": drift_own, "drift_flop_counter": drift_counted,
            "perf_report": report}


def ops_measure(mt, run, before):
    """Peak bytes allocated over ``run()`` (``perf.cuda_live_bytes``)
    less ``before``, what was live before the measured object existed."""
    peak, at_call = mt.perf.cuda_live_bytes(run)
    return peak + at_call - before


def ops_retain_fit(mt, live, plan, measured):
    """The share of the elementwise outputs kept at which the plan would
    equal the measurement (the planner's constant: _ELEMENTWISE_RETAIN)."""
    ew = live.get("elementwise_bytes") or 0.0
    if not ew:
        return None
    heavy = live["retained_bytes"] \
        - mt.perf.memory_planner._ELEMENTWISE_RETAIN * ew
    return (measured - (plan.total() - plan.activations) - heavy) / ew


def ops_planner(mt, torch, net50, toks, labels):
    """(v) plan_memory against torch.cuda.max_memory_allocated over a
    step, less the bytes live before the step's object existed: the
    MNIST MLP's Module, ResNet-50's Symbol through Module (B=32, fp32)
    and the transformer step (eager, then captured)."""
    out = {}
    for name, sym, shape in (
            ("mlp", mnist_mlp(mt.sym), (MLP_BATCH, 784)),
            ("resnet50", resnet_symbol(mt, net50),
             (RESNET_BATCH,) + RESNET_IMAGE)):
        release(torch)
        before = torch.cuda.memory_allocated()
        mod = mt.mod.Module(sym, context="cuda")
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (shape[0],))])
        mod.init_params(initializer=mt.init.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params=MLP_SGD)
        xb = torch.rand(shape, device="cuda")
        yb = torch.randint(0, 10, (shape[0],), device="cuda").float()
        batch = mt.io.DataBatch([mt.nd.NDArray(xb)], [mt.nd.NDArray(yb)])

        def run():
            mod.forward_backward(batch)
            mod.update()

        run()                       # the momentum exists after a step
        measured = ops_measure(mt, run, before)
        # the Module's plan, with the momentum the updater now holds
        plan = mod._plan_maker(
            mod._bound_shapes(), True,
            mt.perf.tree_bytes([s.handle for s in
                                mod._updater.states.values()]))(False, 1)
        ratio = plan.total() / measured
        out[name] = {"plan": plan.as_dict(), "measured_bytes": measured,
                     "plan_over_measured": ratio}
        del mod, batch
    check(abs(out["mlp"]["plan_over_measured"] - 1) <= OPS_PLAN_GATE,
          f"MLP plan/measured {out['mlp']['plan_over_measured']}")
    for way in ("eager", "captured"):
        release(torch)
        before = torch.cuda.memory_allocated()
        step = ops_lm(mt, torch)
        plan = step.memory_analysis(toks, labels)
        call = step._eager_call if way == "eager" else step
        # the first call: the captured way's warm-up, snapshot, capture
        first = ops_measure(mt, lambda: call(toks, labels), before)
        measured = ops_measure(mt, lambda: call(toks, labels), before)
        out[f"transformer_{way}"] = {
            "plan": plan.as_dict(), "measured_bytes": measured,
            "first_call_bytes": first,
            "plan_over_measured": plan.total() / measured,
            "elementwise_bytes": step._mem_liveness["elementwise_bytes"],
            "retain_that_fits": ops_retain_fit(mt, step._mem_liveness,
                                               plan, measured)}
        del step, call
    r = out["transformer_eager"]["plan_over_measured"]
    check(abs(r - 1) <= OPS_PLAN_GATE,
          f"transformer eager plan/measured {r}")
    return out


def ops_first_step(mt, torch, toks, labels, before, env=None):
    """A fresh seeded transformer step's first call under ``env``:
    (step, its loss, the peak bytes over the call less ``before``, the
    parameters after it, cloned); ``step.reserved_peak`` is the
    allocator's reserved peak over the call, less what it held before."""
    with env_set(mt, **(env or {})):
        step = ops_lm(mt, torch)
        out = []
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        peak = ops_measure(mt, lambda: out.append(step(toks, labels)),
                           before)
        step.reserved_peak = torch.cuda.max_memory_reserved() - reserved
    return (step, float(out[0]), peak,
            [p.detach().clone() for p in step.params.values()])


def ops_ladder(mt, torch, toks, labels):
    """(vi) MXTPU_HBM_BYTES under the transformer step's plan: the
    preflight takes remat (the first step's loss and parameters
    bit-equal to the plain step's); lower, the grad_accum rungs, up to
    the first whose plan fits (at this width grad_accum=2's accumulator
    tree costs more than its halved activations save, so the ladder
    passes it: the loss within rel OPS_ACCUM_TOL); under every rung a
    MemoryPlanError.  Then the runtime OOM (``ops_runtime_oom``)."""
    release(torch)
    base = torch.cuda.memory_allocated()
    plain, loss_plain, peak_plain, vals_plain = ops_first_step(
        mt, torch, toks, labels, base)
    reserved_plain = plain.reserved_peak
    plan = plain.memory_analysis(toks, labels)
    plans = {(r, a): plain._memory_plan(r, a).total()
             for r, a in ((True, 1), (True, 2), (True, 4), (True, 8))}
    check(plain.remat is False and plain.grad_accum == 1,
          "the plain step took a rung")
    del plain
    remat_plan = plans[(True, 1)]
    accum = next((a for a in (2, 4, 8) if plans[(True, a)] < remat_plan),
                 None)
    check(remat_plan < plan.total() and accum is not None,
          f"plans {plan.total()}, {plans}")
    out = {"plan": plan.as_dict(),
           "rung_plans": {f"remat={r},grad_accum={a}": v
                          for (r, a), v in plans.items()},
           "plain_loss": loss_plain, "plain_first_call_peak_bytes":
           peak_plain}
    degr = counter(mt, "memory_plan_degrades_total")
    runs = {}
    for rung, cap, knobs in (("remat", remat_plan, (True, 1)),
                             (f"grad_accum={accum}", plans[(True, accum)],
                              (True, accum))):
        release(torch)
        before = torch.cuda.memory_allocated()
        hbm = int(cap / (1 - OPS_MARGIN)) + 1
        step, loss, peak, vals = ops_first_step(
            mt, torch, toks, labels, before, {"MXTPU_HBM_BYTES": hbm})
        check((step.remat, step.grad_accum) == knobs,
              f"rung {rung}: step took {(step.remat, step.grad_accum)}")
        runs[rung] = {"hbm_bytes": hbm, "loss": loss,
                      "first_call_peak_bytes": peak, "vals": vals,
                      "first_call_reserved_bytes": step.reserved_peak,
                      "plan_bytes": step._mem_plan.total()}
        del step
    n_rungs = 1 + 1 + (2, 4, 8).index(accum) + 1
    check(counter(mt, "memory_plan_degrades_total") - degr == n_rungs,
          f"the ladder's degrade counter moved "
          f"{counter(mt, 'memory_plan_degrades_total') - degr}, not "
          f"{n_rungs}")
    bit = loss_plain == runs["remat"]["loss"] and all(
        torch.equal(a, b) for a, b in zip(vals_plain,
                                          runs["remat"]["vals"]))
    check(bit, f"remat step {runs['remat']['loss']} vs plain "
               f"{loss_plain}: not bit-equal")
    rel = abs(runs[f"grad_accum={accum}"]["loss"] - loss_plain) \
        / abs(loss_plain)
    check(rel <= OPS_ACCUM_TOL, f"grad_accum={accum} loss rel err {rel}")
    del vals_plain
    for r in runs.values():
        del r["vals"]
    release(torch)
    with env_set(mt, MXTPU_HBM_BYTES=int(1e9)):
        step = ops_lm(mt, torch)
        try:
            step(toks, labels)
            dry = None
        except mt.resilience.MemoryPlanError as exc:
            dry = exc.rungs
        check(dry == ["remat", "grad_accum=2", "grad_accum=4",
                      "grad_accum=8"], f"dry ladder: {dry}")
        del step
    out.update(rungs=runs, accum_rung=accum, accum_rel_err=rel,
               remat_bit_equal=bit, dry_ladder_rungs=dry)
    out["plain_first_call_reserved_bytes"] = reserved_plain
    out["runtime_oom"] = ops_runtime_oom(
        mt, torch, toks, labels, reserved_plain,
        runs["remat"]["first_call_reserved_bytes"])
    return out


def allocator_settings(torch, text):
    """Set the caching allocator's ``text`` options in this process."""
    fn = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    fn(text)


def ops_runtime_oom(mt, torch, toks, labels, reserved_plain,
                    reserved_remat):
    """(vi) the caching allocator capped (``set_per_process_memory_
    fraction``, which bounds the bytes it reserves) three quarters of the
    way from the remat step's first-call reserved peak to the plain
    step's: the plain step's OOM becomes an OomError, takes the remat
    rung (oom_retries_total 1), and the retry captures once and gives a
    finite loss.  The preflight plans against the datasheet's capacity,
    so it steps in nowhere here; under MXTPU_MEM_POLICY=off the runtime
    ladder is off too, as in the JAX package, and the same OOM is raised
    as an OomError."""
    total = torch.cuda.get_device_properties(0).total_memory
    release(torch)
    base = torch.cuda.memory_reserved()
    limit = base + reserved_remat + 0.75 * (reserved_plain - reserved_remat)
    out = {"limit_bytes": limit, "fraction": limit / total,
           "reserved_before": base}
    retries = counter(mt, "oom_retries_total")
    # without expandable segments the capped allocator's cache splits
    # into pieces no 1000-MiB block fits (2 to 3 GB of them on the card),
    # and the retry would fail on fragmentation, not on its need
    allocator_settings(torch, "expandable_segments:True")
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        with env_set(mt, MXTPU_MEM_POLICY="off"):
            step = ops_lm(mt, torch)
            raised = None
            try:
                step(toks, labels)
            except mt.resilience.OomError as exc:
                raised = type(exc.__cause__).__name__
            check(raised is not None, "policy off: no OomError under the "
                                      "cap")
            del step
        out["policy_off_raised"] = raised
        release(torch)
        step = ops_lm(mt, torch)
        loss = float(step(toks, labels))
        n = counter(mt, "oom_retries_total") - retries
        check(n == 1 and step.remat and math.isfinite(loss)
              and step.trace_counts == {"train_step": 1},
              f"runtime OOM: {n} retries, remat {step.remat}, loss {loss}, "
              f"captures {step.trace_counts}")
        evs = mt.tracing.events("mem_degrade", cause="runtime_oom")
        out.update(oom_retries=n, rung=evs[-1]["rung"] if evs else None,
                   loss=loss, captures=dict(step.trace_counts))
        del step
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        release(torch)
        allocator_settings(torch, "expandable_segments:False")
    return out


def phase_operability(mt, torch, card):
    import tempfile
    degrades = counter(mt, "memory_plan_degrades_total")
    check(degrades == 0, f"an earlier phase took {degrades} degrade "
                         "rungs")
    unplanned = dict(mt.perf.memory_planner.PLAN_FAILURES)
    check(not unplanned, f"the preflight could not plan {unplanned}")
    launches = mt.ops.LAUNCHES
    x, y = resnet_batch(torch)
    guard, unscaled = ops_trainer_guard(mt, torch, x, y)
    release(torch)
    scaling = ops_loss_scaling(mt, torch, x, y, unscaled)
    release(torch)
    with tempfile.TemporaryDirectory() as tmp:
        rollback = [ops_module_rollback(mt, torch, kv, tmp)
                    for kv in ("local", "tpu")]
        exit_code = ops_exit_code(mt, tmp)
    release(torch)
    toks, labels = ops_tokens(torch)
    mt.ops.reset_launches()
    clock = ops_clock(mt, torch, card, toks, labels)     # the main path
    counts = {k: v for k, v in launches.items() if v}
    release(torch)
    net50 = resnet_net(mt, torch, "cuda")
    resnet_cost = ops_resnet_cost(mt, torch, net50)
    planner = ops_planner(mt, torch, net50, toks, labels)
    del net50
    ladder = ops_ladder(mt, torch, toks, labels)
    emit({"phase": "operability", "card": card,
          "memory_plan_degrades_before": degrades,
          "plan_failures_before": unplanned,
          "trainer_guard": guard, "loss_scaling": scaling,
          "module_rollback": rollback, "diverged_child_exit": exit_code,
          "clock": clock, "resnet_cost": resnet_cost,
          "planner": planner, "ladder": ladder,
          "kernel_launches": counts})
    return counts


# ----------------------------------------------------------------- dist
# A9a: dist on torch.distributed, the dp x tp ShardedTrainStep and the
# reshardable checkpoint, at bench.py's transformer width (MODEL, TRAIN:
# B=8 x L=1024, bf16 over fp32 masters, Adam lr 1e-4).  (i) one rank
# over NCCL in this process; (ii) two ranks on the one card over gloo
# (NCCL refuses two ranks on one device), dp=2 at B=4 a rank, each a
# child process (``--dist-child``).  (iii), Megatron tp=2 over gloo on
# CUDA tensors, is not run: on the card's torch, gloo takes every
# collective of torch.distributed for CUDA tensors, but the functional
# all_gather that DTensor's Shard -> Replicate (and Shard -> Shard)
# redistributions call crashes its process (SIGSEGV in ``wait_tensor``;
# ``incubator_mxnet_tpu_torch/tools/gloo_cuda_probe.py``), and a tp step
# gathers activations and gradients that way.  Two ranks share the card,
# so the times are correctness numbers, not scaling.
DIST_STEPS = 3
DIST_WAIT_S = 400                 # every child wait has this deadline
DIST_TP_NOT_RUN = (
    "not run: gloo's functional all_gather on CUDA tensors (DTensor's "
    "Shard -> Replicate) crashes its process on this torch "
    "(tools/gloo_cuda_probe.py); tp is held on the CPU "
    "(tests/test_torch_sharded_checkpoint.py)")


def dist_free_port():
    """A port free on every local address (a store listens on all of
    them), to be bound at once: a port picked long before its bind can
    be taken meanwhile by any socket on the host."""
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def dist_coordinator(rank, tmp):
    """(ii)'s coordinator address, into MXTPU_COORD_ADDR: rank 0 picks
    the port just before its join and publishes it in ``tmp/coord``;
    rank 1 waits for that file."""
    import os
    path = os.path.join(tmp, "coord")
    if rank == 0:
        addr = f"localhost:{dist_free_port()}"
        with open(path + ".part", "w") as f:
            f.write(addr)
        os.replace(path + ".part", path)
    else:
        deadline = time.time() + DIST_WAIT_S
        while not os.path.exists(path):
            check(time.time() < deadline, "rank 0 published no port")
            time.sleep(0.05)
        with open(path) as f:
            addr = f.read()
    os.environ["MXTPU_COORD_ADDR"] = addr


def dist_prints(mt, torch, tree):
    """{leaf key: [sum of its 32-bit patterns, the same weighted by
    position mod 65521 + 1]} of a checkpoint tree, on the card: equal
    trees print equal, and a moved bit moves both sums."""
    from incubator_mxnet_tpu_torch.parallel.checkpoint import _flatten
    out = {}
    for key, leaf in _flatten(tree):
        t = leaf.detach().to("cuda").contiguous().reshape(-1)
        bits = t.view(torch.int32).long()
        w = torch.arange(bits.numel(), device="cuda") % 65521 + 1
        out[key] = [int(bits.sum()), int((bits * w).sum())]
    return out


def dist_step(mt, torch, seed=SEED, **kw):
    net = build_model("cuda")
    mt.initializer.initialize(net, mt.initializer.Xavier(),
                              mt.random.generator(seed))
    return mt.parallel.ShardedTrainStep(
        net, optimizer="adam", optimizer_params=dict(learning_rate=1e-4),
        loss_fn=lm_loss, compute_dtype=torch.bfloat16, **kw)


def dist_tokens(torch):
    import numpy as np
    b, l = TRAIN
    rs = np.random.RandomState(0)       # bench.py's tokens and labels
    return [torch.from_numpy(rs.randint(0, MODEL["vocab_size"], (b, l))
                             .astype(np.int32)) for _ in range(2)]


def dist_allreduce_rate(mt, torch, n):
    """GB/s of one dist.allreduce_sum of ``n`` fp32 values (bytes over
    seconds between CUDA events, host staging of gloo included)."""
    buf = torch.ones(n, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mt.dist.allreduce_sum(buf)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check(float(out[0]) == mt.dist.num_workers(), "allreduce value")
    return {"bytes": 4 * n, "seconds": sec, "gb_per_s": 4 * n / sec / 1e9}


def dist_one_rank(mt, torch, toks, labels):
    """(i): a one-rank NCCL group; every collective; the dp=1 step on
    the world's mesh is one captured graph, bit-equal to the step made
    without a mesh."""
    mt.dist.init(coordinator_address=f"localhost:{dist_free_port()}",
                 num_workers_=1, rank_=0)
    try:
        check(mt.dist.group_backend() == "nccl" and mt.dist.backend(1)
              == "nccl", f"one rank joined {mt.dist.group_backend()}")
        v = torch.arange(4.0, device="cuda")
        check(torch.equal(mt.dist.allreduce_sum({"v": v})["v"], v)
              and torch.equal(mt.dist.allreduce_max(v), v)
              and torch.equal(mt.dist.broadcast([v])[0], v),
              "one-rank collectives changed their value")
        mt.dist.barrier("chip_smoke")
        rate = dist_allreduce_rate(mt, torch, 1 << 26)
        mesh = mt.parallel.make_mesh()
        check(mesh.size == 1 and not mesh.spans_world, f"mesh {mesh}")
        mt.ops.reset_launches()
        step = dist_step(mt, torch, mesh=mesh)
        losses = [step(toks, labels) for _ in range(DIST_STEPS)]
        counts = {k: mt.ops.LAUNCHES[k] for k in TRAIN_KERNELS}
        check(step.trace_counts.get("train_step") == 1,
              f"captures {step.trace_counts}")
        got = ([float(x) for x in losses],
               [p.detach().clone() for p in step.params.values()])
        ms = call_ms(lambda: step(toks, labels), torch, warmup=1, reps=5)
        del step
        release(torch)
    finally:
        mt.dist.shutdown()
    plain = dist_step(mt, torch)
    ref = [float(plain(toks, labels)) for _ in range(DIST_STEPS)]
    same = ref == got[0] and all(
        torch.equal(a, b) for a, b in zip(got[1], plain.params.values()))
    check(same, f"dp=1 step in the NCCL world {got[0]} vs plain {ref}")
    del plain, got
    release(torch)
    layers = MODEL["n_layers"]
    first = (mt.parallel._graph.WARMUP_STEPS + 1) * layers
    check(all(n == first for n in counts.values()),
          f"(i) launched {counts}, not {first} each at its capture")
    return {"backend": "nccl", "losses": ref, "bitwise_equal_plain": same,
            "captures": 1, "step_ms": ms, "allreduce": rate,
            "launches": counts}


def dist_child(rank, tmp):
    """One rank of (ii): joins, builds its step, waits for the parent's
    ``start`` file (the parent's own timed work is done by then), runs
    the dp=2 steps, saves, restores into a fresh step at world 2 and
    writes rank<r>.json."""
    import os
    import torch
    import incubator_mxnet_tpu_torch as mt
    torch.backends.cuda.matmul.allow_tf32 = False
    dist_coordinator(rank, tmp)
    mt.dist.init()
    check(mt.dist.group_backend() == "gloo" and mt.dist.num_workers() == 2,
          f"joined {mt.dist.group_backend()} x {mt.dist.num_workers()}")
    mesh = mt.parallel.make_mesh()
    check(mesh.shape["dp"] == 2 and mesh.spans_world, f"mesh {mesh}")
    toks, labels = (t.cuda() for t in dist_tokens(torch))
    step = dist_step(mt, torch, mesh=mesh)
    deadline = time.time() + DIST_WAIT_S
    while not os.path.exists(os.path.join(tmp, "start")):
        check(time.time() < deadline, "no start from the parent")
        time.sleep(0.1)
    mt.ops.reset_launches()
    t0 = time.perf_counter()
    losses = [float(step(toks, labels))]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += [float(step(toks, labels)) for _ in range(DIST_STEPS - 1)]
    step_ms = (time.perf_counter() - t0) / (DIST_STEPS - 1) * 1e3
    counts = {k: mt.ops.LAUNCHES[k] for k in TRAIN_KERNELS}
    check("train_step" not in step.trace_counts, "a gloo step captured")
    rate = dist_allreduce_rate(mt, torch, sum(
        p.numel() for p in step.params.values()))
    ckpt = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    step.save_checkpoint(ckpt)
    save_s = time.perf_counter() - t0
    prints = dist_prints(mt, torch, step._ckpt_tree())
    if rank == 0:
        with open(os.path.join(tmp, "saved.json"), "w") as f:
            json.dump(prints, f)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    fresh = dist_step(mt, torch, seed=SEED + 1, mesh=mesh)
    t0 = time.perf_counter()
    fresh.load_checkpoint(ckpt)
    restore_s = time.perf_counter() - t0
    back = dist_prints(mt, torch, fresh._ckpt_tree())
    mt.dist.barrier("restored")
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "first_step_s": first_s,
                   "step_ms": step_ms, "launches": counts,
                   "allreduce": rate, "save_s": save_s,
                   "restore_world2_s": restore_s,
                   "restore_world2_bitwise": back == prints,
                   "prints": prints,
                   "mem_peak": torch.cuda.max_memory_allocated()}, f)
    mt.dist.shutdown()
    return 0


def dist_wait(procs, paths, logs):
    import os
    deadline = time.time() + DIST_WAIT_S
    while not all(os.path.exists(p) for p in paths):
        for i, p in enumerate(procs):
            if p.poll() not in (None, 0):
                logs[i].flush()
                with open(logs[i].name, "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
                raise CheckFailed(f"dist rank {i} exited {p.returncode}:"
                                  f"\n{tail}")
        check(time.time() < deadline, f"dist ranks gave no {paths}")
        time.sleep(0.1)
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def dist_spawn(tmp):
    """The two ranks of (ii), started at once: they import, join and
    build while this process runs (i).  Rank 0 picks the coordinator's
    port (``dist_coordinator``): (i)'s sockets open meanwhile."""
    import os
    env = dict(os.environ, MXTPU_NUM_WORKERS="2")
    env.pop("MXTPU_COORD_ADDR", None)
    procs, logs = [], []
    for r in range(2):
        logs.append(open(os.path.join(tmp, f"rank{r}.log"), "wb"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-child",
             str(r), tmp], env=dict(env, MXTPU_WORKER_RANK=str(r)),
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=logs[r], stderr=subprocess.STDOUT))
    return procs, logs


def dist_two_ranks(mt, torch, toks, labels, tmp, procs, logs):
    """(ii): two gloo ranks on the card, dp=2 at B=4 a rank, against one
    process's step on B=8; the checkpoint saved at world 2 and restored
    at world 1 here while the ranks restore it at world 2, bit for
    bit."""
    import os
    ref = dist_step(mt, torch)
    ref_losses = [float(ref._eager_call(toks, labels))
                  for _ in range(DIST_STEPS)]
    del ref
    release(torch)
    open(os.path.join(tmp, "start"), "w").close()
    (prints,) = dist_wait(procs, [os.path.join(tmp, "saved.json")], logs)
    one = dist_step(mt, torch, seed=SEED + 1)
    t0 = time.perf_counter()
    one.load_checkpoint(os.path.join(tmp, "ckpt"))
    restore1_s = time.perf_counter() - t0
    world1 = dist_prints(mt, torch, one._ckpt_tree()) == prints
    del one
    release(torch)
    ranks = dist_wait(procs, [os.path.join(tmp, f"rank{r}.json")
                              for r in range(2)], logs)
    for p in procs:
        p.wait(timeout=DIST_WAIT_S)
        check(p.returncode == 0, f"a dist rank exited {p.returncode}")
    tol = TOL["bfloat16"]
    for r, rec in enumerate(ranks):
        rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                      ref_losses))
        check(rel <= tol, f"rank {r} losses {rec['losses']} vs one "
                          f"process's B=8 {ref_losses}: rel {rel} > {tol}")
        rec["loss_rel_err"] = rel
    check(ranks[0]["prints"] == ranks[1]["prints"] == prints,
          "the two ranks' states differ")
    check(world1, "restore at world 1 is not bit-equal to the save")
    check(all(r["restore_world2_bitwise"] for r in ranks),
          "restore at world 2 is not bit-equal to the save")
    layers = MODEL["n_layers"]
    for r, rec in enumerate(ranks):
        check(all(n == layers * DIST_STEPS
                  for n in rec["launches"].values()),
              f"rank {r} launched {rec['launches']}, not {layers} a step")
        del rec["prints"]
    return {"backend": "gloo", "dp": 2, "batch_per_rank": TRAIN[0] // 2,
            "ref_losses_B8": ref_losses, "loss_tol_rel": tol,
            "ranks": ranks, "restore_world1_s": restore1_s,
            "restore_world1_bitwise": world1,
            "launches": {k: sum(rec["launches"][k] for rec in ranks)
                         for k in TRAIN_KERNELS}}


def phase_dist(mt, torch, card):
    import tempfile
    toks, labels = (t.cuda() for t in dist_tokens(torch))
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = dist_spawn(tmp)
        try:
            t0 = time.perf_counter()
            one = dist_one_rank(mt, torch, toks, labels)
            one["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            two = dist_two_ranks(mt, torch, toks, labels, tmp, procs, logs)
            two["seconds"] = time.perf_counter() - t0
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
    emit({"phase": "dist", "card": card, "steps": DIST_STEPS,
          "batch": TRAIN[0], "seq": TRAIN[1], "compute_dtype": "bfloat16",
          "one_rank_nccl": one, "two_ranks_gloo": two,
          "megatron_tp2_gloo": DIST_TP_NOT_RUN})
    return {k: one["launches"][k] + two["launches"][k]
            for k in TRAIN_KERNELS}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import incubator_mxnet_tpu_torch as mt
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        keeps = {"start": trace_keeps(torch)}
        seconds = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t0
            return out

        timed("build", phase_build, mt, card)
        entry = timed("kernels", phase_kernels, mt, torch)
        bwd_entries = timed("kernels_bwd", phase_kernels_bwd, mt, torch)
        net, fwd_launches = timed("forward", phase_forward, mt, torch)
        serve_launches = timed("serve", phase_serve, mt, torch, net)
        engine_launches = timed("serve_engine", phase_serve_engine, mt,
                                torch, net)
        fleet_launches = timed("fleet", phase_fleet, mt, torch, card)
        train_launches, fp32_launches, replay_runs = timed(
            "train", phase_train, mt, torch, net, card)
        del net
        resnet_launches = timed("resnet", phase_resnet, mt, torch, card)
        rtc_entries, nd_flash = timed("rtc", phase_rtc, mt, torch)
        module_launches, module_tpu = timed("module", phase_module, mt,
                                            torch, card)
        hyb_launches, hyb_runs = timed("hybridize", phase_hybridize, mt,
                                       torch, card)
        moe_launches, moe_runs = timed("moe", phase_moe, mt, torch, card)
        ops_launches = timed("ops", phase_ops, mt, torch, card)
        rnn_launches = timed("rnn", phase_rnn, mt, torch, card)
        nms_entries, detect_launches = timed("detect", phase_detect, mt,
                                             torch, card)
        sparse_launches = timed("sparse", phase_sparse, mt, torch, card)
        vision_launches = timed("vision", phase_vision, mt, torch, card)
        data_launches = timed("data", phase_data, mt, torch, card)
        ops_launches_19 = timed("operability", phase_operability, mt,
                                torch, card)
        dist_launches = timed("dist", phase_dist, mt, torch, card)
        keeps["end"] = trace_keeps(torch)
        emit({"phase_seconds": seconds, "device_ms_traces": TRACES,
              "trace_keeps": keeps})
        entry["launches_by_path"] = {"forward": fwd_launches,
                                     "serve": serve_launches,
                                     "serve_engine":
                                         engine_launches["flash_fwd"],
                                     "train": train_launches["flash_fwd"],
                                     "fp32_train": fp32_launches["flash_fwd"],
                                     "nd": nd_flash}
        entry["launches_by_path"].update(
            moe_forward=moe_launches["forward"],
            moe_generate=moe_launches["generate"],
            moe_train=moe_launches["train"]["flash_fwd"])
        entry["runs_per_replay"] = dict(replay_runs["flash_fwd"],
                                        moe_train=moe_runs["flash_fwd"])
        for e in bwd_entries:
            e["launches_by_path"] = {
                "serve_engine": engine_launches[e["name"]],
                "train": train_launches[e["name"]],
                "fp32_train": fp32_launches[e["name"]],
                "moe_train": moe_launches["train"][e["name"]]}
            e["runs_per_replay"] = dict(replay_runs[e["name"]],
                                        moe_train=moe_runs[e["name"]])
            e["fp32_train"]["launches"] = sum(fp32_launches[e["name"]])
        # the paths whose phases keep every kernel's count; the sweep's
        # entry has no key for a path that kept the flash counts alone
        for e in [entry] + bwd_entries + rtc_entries + nms_entries:
            e["launches_by_path"]["resnet"] = resnet_launches.get(
                e["name"], 0)
            e["launches_by_path"]["module"] = module_launches.get(
                e["name"], 0)
            e["launches_by_path"]["module_tpu"] = module_tpu.get(
                e["name"], 0)
            e["launches_by_path"]["hybridize"] = hyb_launches.get(
                e["name"], 0)
            e["launches_by_path"]["ops"] = ops_launches.get(e["name"], 0)
            e["launches_by_path"]["rnn"] = rnn_launches.get(e["name"], 0)
            e["launches_by_path"]["sparse"] = sparse_launches.get(
                e["name"], 0)
            e["launches_by_path"]["vision"] = vision_launches.get(
                e["name"], 0)
            e["launches_by_path"]["data"] = data_launches.get(e["name"], 0)
            e["launches_by_path"]["fleet"] = fleet_launches.get(e["name"],
                                                                0)
            e["launches_by_path"]["operability"] = ops_launches_19.get(
                e["name"], 0)
            e["launches_by_path"]["dist"] = dist_launches.get(e["name"], 0)
            if e["name"] in hyb_runs:
                e["runs_per_replay"] = {"hybridize": hyb_runs[e["name"]]}
            for path, counts in detect_launches.items():
                e["launches_by_path"][path] = counts.get(e["name"], 0)
            e["launches"] = sum(
                n if isinstance(n, int) else sum(n)
                for n in e["launches_by_path"].values())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(card)
    emit({"kernels": [entry] + bwd_entries + rtc_entries + nms_entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        import faulthandler
        faulthandler.enable()       # a crashed rank's stack reaches its log
        sys.exit(dist_child(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
